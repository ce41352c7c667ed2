"""Natural-boundary text chunking for long-text TTS (a copy of
qwen3_tts_tpu/frontend/chunker.py, pinned to it by
tests/test_torch_chunker.py).

Split text into chunks of at most `max_words` words at, in priority order,
sentence ends, semicolon/colon, comma, conjunctions, phrase starters, then a
hard word-boundary cut; chunks shorter than `MIN_WORDS` never result from a
natural break.
"""

from __future__ import annotations

DEFAULT_MAX_WORDS = 35
MIN_WORDS = 8

_CONJUNCTIONS = [
    " and then ", " and ", " but ", " or ", " so ", " because ",
    " when ", " while ", " although ", " however ", " therefore ",
    " meanwhile ", " afterwards ", " finally ", " then ",
]

_PHRASE_STARTERS = [
    " in the ", " on the ", " at the ", " for the ", " with the ",
    " to the ", " from the ", " into the ", " onto the ",
]


def _word_count(text: str) -> int:
    return len(text.split())


def _find_sentence_end(text: str) -> int | None:
    """Position just after the last sentence-ending punctuation followed by
    whitespace or the end, at least MIN_WORDS * 4 characters in."""
    last_end = None
    min_chunk_length = MIN_WORDS * 4
    n = len(text)
    for index, char in enumerate(text):
        if char in ".!?":
            if index + 1 >= n or text[index + 1].isspace():
                if index >= min_chunk_length:
                    last_end = index + 1
    return last_end


def _find_natural_break(text: str, max_words: int) -> str:
    words = text.split()
    if len(words) <= max_words:
        return text

    window = " ".join(words[:max_words])

    bp = _find_sentence_end(window)
    if bp is not None:
        chunk = window[:bp]
        if _word_count(chunk) >= MIN_WORDS:
            return chunk

    for punct in (";", ":"):
        idx = window.rfind(punct)
        if idx != -1:
            chunk = window[: idx + 1]
            if _word_count(chunk) >= MIN_WORDS:
                return chunk

    idx = window.rfind(",")
    if idx != -1:
        chunk = window[: idx + 1]
        if _word_count(chunk) >= MIN_WORDS:
            return chunk

    lower = window.lower()
    for conjunction in _CONJUNCTIONS:
        idx = lower.rfind(conjunction)
        if idx != -1:
            chunk = window[:idx]
            if _word_count(chunk) >= MIN_WORDS:
                return chunk

    for starter in _PHRASE_STARTERS:
        idx = lower.rfind(starter)
        if idx != -1:
            chunk = window[:idx]
            if _word_count(chunk) >= MIN_WORDS:
                return chunk

    return window


def chunk_text(text: str, max_words: int = DEFAULT_MAX_WORDS) -> list[str]:
    """Split `text` into natural chunks of at most `max_words` words."""
    trimmed = text.strip()
    if not trimmed:
        return []
    if _word_count(trimmed) <= max_words:
        return [trimmed]

    chunks: list[str] = []
    remaining = trimmed
    while remaining:
        piece = _find_natural_break(remaining, max_words)
        trimmed_piece = piece.strip()
        if trimmed_piece:
            chunks.append(trimmed_piece)
        remaining = remaining[len(piece):].strip()
    return chunks


def estimate_tokens(text: str) -> int:
    """About 5 codec tokens per word, at least 50."""
    return max(50, _word_count(text) * 5)
