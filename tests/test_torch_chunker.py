"""The port's copy of the long-text chunker, pinned to the JAX package's
original: the same chunks for texts that exercise every break rule, and the
same token estimate."""

import numpy as np
import pytest

from qwen3_tts_tpu.frontend import chunker as jchunker
from qwen3_tts_tpu_torch.frontend import chunker as tchunker

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu xi "
         "omicron pi rho sigma tau upsilon phi chi psi omega").split()


def texts() -> list[str]:
    rng = np.random.default_rng(0)
    out = ["", "   ", "Short one.", "One two three four five six seven eight nine ten."]
    seps = [" ", " ", " ", ", ", "; ", ": ", ". ", "! ", "? ", " and ", " but then ",
            " in the ", " with the ", " because "]
    for n in (30, 36, 60, 90, 150, 240):
        parts = []
        for _ in range(n):
            parts.append(WORDS[rng.integers(len(WORDS))])
            parts.append(seps[rng.integers(len(seps))])
        out.append("".join(parts).strip())
    out.append(" ".join(["word"] * 100))  # no break anywhere: hard cuts
    return out


@pytest.mark.parametrize("max_words", [35, 12])
def test_chunk_text_matches_the_original(max_words):
    for text in texts():
        assert tchunker.chunk_text(text, max_words) == jchunker.chunk(text, max_words), text
        assert tchunker.estimate_tokens(text) == jchunker.estimate_tokens(text)
