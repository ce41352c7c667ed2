"""Pure-Python GPT-2/Qwen BPE tokenizer (a copy of
qwen3_tts_tpu/frontend/tokenizer.py without the optional native BPE core;
tests pin its ids equal to the original).

Behavioral parity with the reference Swift tokenizer
(reference Qwen3Tokenizer.swift:1-375):
  - loads tokenizer.json (model.vocab + model.merges + added_tokens), or the
    vocab.json + merges.txt + tokenizer_config.json fallback (load :72-163)
  - added_tokens with special=true are matched greedily longest-first before
    BPE (splitWithSpecialTokens :193-248)
  - smart quotes/apostrophes normalized to ASCII (normalizeQuotes :311-320)
  - GPT-2 split regex, char-level BPE with " "->"Ġ" and "\n"->"Ċ" mapping
    (bpe :322-374), byte fallback to "<0xXX>" tokens (encodeRegularText :254-291)
  - decode joins token strings then maps Ġ->space, Ċ->newline (decode :293-308)
  - unloaded tokenizer falls back to raw UTF-8 bytes (encode :165-168)
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping

import regex as _regex

# GPT-2 pre-tokenization split pattern (reference Qwen3Tokenizer.swift:251)
_SPLIT_PATTERN = _regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

_QUOTE_MAP = {
    "’": "'",
    "‘": "'",
    "‛": "'",
    "“": '"',
    "”": '"',
    "‟": '"',
}


def normalize_quotes(text: str) -> str:
    """Smart-quote normalization (reference Qwen3Tokenizer.swift:311-320)."""
    for src, dst in _QUOTE_MAP.items():
        text = text.replace(src, dst)
    return text


class Qwen3Tokenizer:
    """BPE tokenizer with special-token handling."""

    _MAX_CACHE = 10000

    def __init__(
        self,
        model_path: str | os.PathLike | None = None,
        *,
        vocab: Mapping[str, int] | None = None,
        merges: Iterable[str] | None = None,
    ):
        self.vocab: dict[str, int] = {}
        self.tokens: dict[int, str] = {}
        self.merges: dict[str, int] = {}
        self.special_tokens: list[str] = []
        self.loaded = False
        self._cache: dict[str, list[str]] = {}

        if vocab is not None:
            # Manual init (reference Qwen3Tokenizer.swift:56-70)
            self.vocab = dict(vocab)
            self.tokens = {v: k for k, v in self.vocab.items()}
            for i, merge in enumerate(merges or []):
                self.merges[merge] = i
            self.special_tokens = self._detect_special_tokens_by_convention()
            self.loaded = True
        elif model_path is not None:
            try:
                self._load(os.fspath(model_path))
                self.loaded = True
            except (OSError, KeyError, ValueError, json.JSONDecodeError):
                self.loaded = False

    # -- loading ----------------------------------------------------------

    def _detect_special_tokens_by_convention(self) -> list[str]:
        specials = [
            k
            for k in self.vocab
            if (k.startswith("<|") and k.endswith("|>"))
            or (k.startswith("<") and k.endswith(">") and " " not in k)
        ]
        return sorted(specials, key=len, reverse=True)

    def _load(self, path: str) -> None:
        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_json):
            with open(tok_json, "r", encoding="utf-8") as f:
                data = json.load(f)
            self.vocab = dict(data["model"]["vocab"])
            self.tokens = {v: k for k, v in self.vocab.items()}
            for i, pair in enumerate(data["model"]["merges"]):
                if isinstance(pair, str):
                    # merges may be "a b" strings or ["a","b"] pairs
                    parts = pair.split(" ")
                    if len(parts) == 2:
                        self.merges[pair] = i
                elif len(pair) == 2:
                    self.merges[pair[0] + " " + pair[1]] = i
            added_special: list[str] = []
            for token in data.get("added_tokens") or []:
                self.vocab[token["content"]] = token["id"]
                self.tokens[token["id"]] = token["content"]
                if token.get("special"):
                    added_special.append(token["content"])
            self.special_tokens = sorted(added_special, key=len, reverse=True)
        else:
            vocab_json = os.path.join(path, "vocab.json")
            merges_txt = os.path.join(path, "merges.txt")
            if not (os.path.exists(vocab_json) and os.path.exists(merges_txt)):
                raise FileNotFoundError("Tokenizer files not found.")
            with open(vocab_json, "r", encoding="utf-8") as f:
                self.vocab = json.load(f)
            self.tokens = {v: k for k, v in self.vocab.items()}
            with open(merges_txt, "r", encoding="utf-8") as f:
                idx = 0
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    parts = line.split(" ")
                    if len(parts) == 2:
                        self.merges[line] = idx
                    idx += 1
            cfg_json = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_json):
                try:
                    with open(cfg_json, "r", encoding="utf-8") as f:
                        cfg = json.load(f)
                    added_special = []
                    for id_str, token in (cfg.get("added_tokens_decoder") or {}).items():
                        tid = int(id_str)
                        self.vocab[token["content"]] = tid
                        self.tokens[tid] = token["content"]
                        if token.get("special"):
                            added_special.append(token["content"])
                    self.special_tokens = sorted(added_special, key=len, reverse=True)
                except (OSError, ValueError, KeyError, json.JSONDecodeError):
                    pass

        if not self.special_tokens:
            self.special_tokens = self._detect_special_tokens_by_convention()

    # -- encoding ---------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        if not self.loaded:
            return list(text.encode("utf-8"))

        normalized = normalize_quotes(text)
        ids: list[int] = []
        for segment in self._split_with_special_tokens(normalized):
            seg_id = self.vocab.get(segment)
            if seg_id is not None and segment in self._special_set:
                ids.append(seg_id)
            elif seg_id is not None:
                # Exact-vocab match for whole segment (matches reference, which
                # checks vocab membership for every segment: Qwen3Tokenizer.swift:179)
                ids.append(seg_id)
            else:
                ids.extend(self._encode_regular(segment))
        return ids

    @property
    def _special_set(self) -> set[str]:
        return set(self.special_tokens)

    def _split_with_special_tokens(self, text: str) -> list[str]:
        """Split into special-token and regular-text segments
        (reference Qwen3Tokenizer.swift:193-248)."""
        if not self.special_tokens or "<" not in text:
            return [text]

        segments: list[str] = []
        remaining = text
        while remaining:
            matched = None
            for special in self.special_tokens:
                if remaining.startswith(special):
                    matched = special
                    break
            if matched is not None:
                segments.append(matched)
                remaining = remaining[len(matched):]
                continue

            lt = remaining.find("<")
            if lt == -1:
                segments.append(remaining)
                remaining = ""
            elif lt == 0:
                nxt = remaining.find("<", 1)
                if nxt == -1:
                    segments.append(remaining)
                    remaining = ""
                else:
                    segments.append(remaining[:nxt])
                    remaining = remaining[nxt:]
            else:
                segments.append(remaining[:lt])
                remaining = remaining[lt:]
        return segments

    def _encode_regular(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in _SPLIT_PATTERN.findall(text) or [text]:
            ids.extend(self._encode_token_python(token))
        return ids

    def _encode_token_python(self, token: str) -> list[int]:
        ids: list[int] = []
        for piece in self._bpe(token):
            pid = self.vocab.get(piece)
            if pid is not None:
                ids.append(pid)
            else:
                for byte in piece.encode("utf-8"):
                    bid = self.vocab.get("<0x%02X>" % byte)
                    if bid is not None:
                        ids.append(bid)
        return ids

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached

        space_char = "Ġ" if "Ġ" in self.vocab else " "      # Ġ
        newline_char = "Ċ" if "Ċ" in self.vocab else "\n"  # Ċ
        word = [
            space_char if c == " " else newline_char if c == "\n" else c
            for c in token
        ]
        if not word:
            return []

        while len(word) > 1:
            min_rank = None
            best_idx = None
            for i in range(len(word) - 1):
                rank = self.merges.get(word[i] + " " + word[i + 1])
                if rank is not None and (min_rank is None or rank < min_rank):
                    min_rank = rank
                    best_idx = i
            if best_idx is None:
                break
            word[best_idx] = word[best_idx] + word[best_idx + 1]
            del word[best_idx + 1]

        if len(self._cache) >= self._MAX_CACHE:
            # Drop half the cache (reference Qwen3Tokenizer.swift:366-371).
            # encode() may run on many threads at once (TTSService.submit
            # tokenizes on the caller's thread) — two threads can race this
            # eviction with overlapping key snapshots, so deletion must
            # tolerate already-evicted keys (pop, not del).
            for key in list(self._cache.keys())[: self._MAX_CACHE // 2]:
                self._cache.pop(key, None)
        self._cache[token] = word
        return word

    # -- decoding ---------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        if not self.loaded:
            return ""
        out = "".join(self.tokens.get(int(i), "") for i in ids)
        return out.replace("Ġ", " ").replace("Ċ", "\n")
