"""TTS prompt assembly in embedding space (counterpart of
qwen3_tts_tpu/models/prompt.py::assemble_prompt, every mode):

  [instruct | ICL (ref text + ref semantic codes)]? ⧺ role(3 text tokens) ⧺
  [tts_pad × padCount, tts_bos] + codecEmbed[:-1]   (elementwise sum) ⧺
  (text token 3 + codec_bos embed)

where codecEmbed = [nothink, think_bos, think_eos, speaker?, pad, bos] and
the speaker slot holds a built-in speaker's codec embedding or a speaker
embedding (unprojected). The trailing text hidden = proj(embed(text tokens
4..N-6)) ⧺ tts_eos is fed one embed per decode step. assemble_prompt gives
exact-length prompts; assemble_prompt_padded gives them padded to the
serving buckets (the submit path of service.py), with the real lengths in
PromptData.p / .t.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Qwen3TTSConfig
from . import talker as talker_mod

MIN_PROMPT_TOKENS = 9


@dataclass
class PromptData:
    input_embeds: torch.Tensor     # [1, P, H]
    trailing_hidden: torch.Tensor  # [1, T, H]
    tts_pad_embed: torch.Tensor    # [1, 1, H]
    # set by assemble_prompt_padded: the tensors above are bucket-padded and
    # these are the real lengths (None: the tensors are exact-length)
    p: int | None = None
    t: int | None = None


def pd_lengths(pd: PromptData) -> tuple[int, int]:
    """(prompt, trailing) row counts, padded and exact-length alike."""
    p = pd.p if pd.p is not None else int(pd.input_embeds.shape[1])
    t = pd.t if pd.t is not None else int(pd.trailing_hidden.shape[1])
    return p, t


def _ids(vals, dev: torch.device) -> torch.Tensor:
    """int64 ids on `dev`. On CUDA through pinned memory, non-blocking: a
    pageable copy would wait for all the stream's queued work (a decode
    chunk in flight on the serving path)."""
    t = torch.as_tensor(np.asarray(vals, np.int64))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _user_turn(params: dict, tokenizer, text: str, t) -> torch.Tensor:
    """Projected embeddings of a "<|im_start|>user\\n{text}<|im_end|>\\n" turn."""
    ids = tokenizer.encode(f"<|im_start|>user\n{text}<|im_end|>\n")
    return talker_mod.encode_text(params, t(ids))[None]


def assemble_prompt(
    params: dict,
    config: Qwen3TTSConfig,
    tokenizer,
    text: str,
    speaker: str = "",
    instruct: str | None = None,
    speaker_embedding=None,
    reference_transcript: str | None = None,
    reference_audio_codes=None,
) -> PromptData | None:
    """Prompt embeddings for any mode; None when the text is shorter than 9
    tokens. A named speaker takes the speaker slot, else a speaker
    embedding; the prefix is the instruct, else the ICL reference (needs a
    non-empty transcript and codes; only the first codebook row conditions),
    else a speaker string that names no built-in speaker, read as an
    instruct."""
    use_icl = (reference_audio_codes is not None and reference_transcript is not None
               and len(reference_transcript) > 0)
    speaker_id = config.spk_id.get(speaker.lower())
    dev = params["norm"]["w"].device
    chat_text = f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"
    chat_ids = tokenizer.encode(chat_text)
    n = len(chat_ids)
    if n < MIN_PROMPT_TOKENS:
        return None

    def t(vals):
        return _ids(vals, dev)

    ids = t(chat_ids)

    tts = talker_mod.encode_text(
        params, t([config.tts_bos_token_id, config.tts_eos_token_id, config.tts_pad_token_id])
    )[None]
    tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
    prefix = talker_mod.encode_audio(
        params, t([config.codec_nothink_id, config.codec_think_bos_id,
                   config.codec_think_eos_id]))[None]
    suffix = talker_mod.encode_audio(params, t([config.codec_pad_id, config.codec_bos_id]))[None]
    if speaker_id is not None:
        spk = talker_mod.encode_audio(params, t([speaker_id]))[None]
        codec_embed = torch.cat([prefix, spk, suffix], dim=1)
    elif speaker_embedding is not None:
        spk = speaker_embedding
        if not isinstance(spk, torch.Tensor):
            spk = torch.from_numpy(np.asarray(spk, np.float32))
        spk = spk.reshape(1, 1, -1).to(dev, prefix.dtype)
        if spk.shape[-1] != prefix.shape[-1]:
            raise ValueError(
                f"speaker_embedding dim {spk.shape[-1]} != talker hidden {prefix.shape[-1]}; "
                "the embedding joins the codec stream unprojected"
            )
        codec_embed = torch.cat([prefix, spk, suffix], dim=1)
    else:
        codec_embed = torch.cat([prefix, suffix], dim=1)

    role_embed = talker_mod.encode_text(params, ids[0:3])[None]
    pad_count = codec_embed.shape[1] - 2
    combined = torch.cat([tts_pad.expand(1, pad_count, -1), tts_bos], dim=1)
    combined = combined + codec_embed[:, :-1]

    lead = None
    if instruct:
        lead = _user_turn(params, tokenizer, instruct, t)
    elif use_icl:
        lead = _user_turn(params, tokenizer, reference_transcript, t)
        sem = reference_audio_codes[0] if len(reference_audio_codes) else []
        if len(sem) > 0:
            lead = torch.cat([lead, talker_mod.encode_audio(params, t(sem))[None]], dim=1)
    elif speaker and speaker_id is None and speaker_embedding is None:
        lead = _user_turn(params, tokenizer, speaker, t)

    first_text = talker_mod.encode_text(params, ids[3:4])[None] + codec_embed[:, -1:]
    parts = [role_embed, combined, first_text]
    input_embeds = torch.cat(parts if lead is None else [lead, *parts], dim=1)

    if n - 9 > 0:
        trailing = talker_mod.encode_text(params, ids[4:n - 5])[None]
        trailing_hidden = torch.cat([trailing, tts_eos], dim=1)
    else:
        trailing_hidden = tts_eos
    return PromptData(input_embeds, trailing_hidden, tts_pad)


def assemble_prompt_padded(params: dict, config: Qwen3TTSConfig, tokenizer, text: str, *,
                           prompt_bucket: int, trailing_bucket: int,
                           **kwargs) -> PromptData | None:
    """assemble_prompt's prompt padded with zeros to the serving buckets
    ([1, prompt_bucket, H], [1, trailing_bucket, H]) with p / t set; None
    for too-short text. A prompt over the buckets comes back exact-length,
    so the caller's bucket check reports its real lengths. Every mode goes
    through assemble_prompt, so the real rows equal its rows bit for bit."""
    return _pad_prompt_data(assemble_prompt(params, config, tokenizer, text, **kwargs),
                            prompt_bucket, trailing_bucket)


def _pad_prompt_data(pd: PromptData | None, pb: int, tb: int) -> PromptData | None:
    """An exact-length prompt padded with zeros to the buckets; unchanged
    when it does not fit (the caller's bucket check reports it)."""
    if pd is None:
        return None
    p, t = pd.input_embeds.shape[1], pd.trailing_hidden.shape[1]
    if p > pb or t > tb:
        return pd
    e, tr = pd.input_embeds, pd.trailing_hidden
    embeds = torch.zeros(1, pb, e.shape[2], dtype=e.dtype, device=e.device)
    trailing = torch.zeros(1, tb, tr.shape[2], dtype=tr.dtype, device=tr.device)
    embeds[:, :p] = e
    trailing[:, :t] = tr
    return PromptData(embeds, trailing, pd.tts_pad_embed, p=p, t=t)
