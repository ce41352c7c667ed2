"""The port's bucket-padded prompt assembly (qwen3_tts_tpu_torch/models/
prompt.py::assemble_prompt_padded, pd_lengths) against the JAX package's on
the CPU in fp32, on the same numpy weights (JAX random init) and one
tokenizer: the built-in-speaker and plain prompts (the JAX side one jitted
call), the other modes (an instruct, a free-form speaker string, a speaker
embedding), a prompt over the buckets returned exact-length, and too-short
text. The port pads assemble_prompt's rows in every mode. Tolerance: rel RMS <=
1e-6 on each whole padded tensor (fp32 projections, sums in another
order); lengths exactly equal; rows past the lengths zero."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.testing import FakeByteTokenizer, config_to_json_dict, tiny_models
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import prompt as tprompt

torch.set_num_threads(1)
PB, TB = 64, 128
REL = 1e-6
TEXT = "Padded assembly of this text must match the JAX package."


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


@pytest.fixture(scope="module")
def both():
    jcfg, params, _ = tiny_models(seed=5)
    params = jax.tree.map(np.asarray, params)
    tcfg = Qwen3TTSConfig.from_json(config_to_json_dict(jcfg))
    return ((jax.tree.map(jnp.asarray, params), jcfg), (to_torch(params), tcfg))


class WordTokenizer:
    """One id per whitespace-separated word: short enough prompts to reach
    the under-9-token case (the byte tokenizer spends 9 on the chat
    template alone)."""

    def encode(self, text: str) -> list[int]:
        return [zlib.crc32(w.encode()) % 256 for w in text.split()]


def assemble(both, text, pb=PB, tb=TB, tok=None, **kw):
    (jp, jcfg), (tp, tcfg) = both
    tok = tok or FakeByteTokenizer()
    jpd = jprompt.assemble_prompt_padded(jp, jcfg, tok, text, prompt_bucket=pb,
                                         trailing_bucket=tb, **kw)
    tpd = tprompt.assemble_prompt_padded(tp, tcfg, tok, text, prompt_bucket=pb,
                                         trailing_bucket=tb, **kw)
    assert (jpd is None) == (tpd is None)
    if tpd is None:
        return None
    assert tprompt.pd_lengths(tpd) == jprompt.pd_lengths(jpd)
    assert (tpd.p, tpd.t) == (jpd.p, jpd.t)
    for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
        assert rel_rms(getattr(tpd, name), getattr(jpd, name)) <= REL, (name, kw)
    return tpd


@pytest.mark.parametrize("speaker", ["aiden", ""])
def test_padded_path_matches_jax(both, speaker):
    """A built-in speaker and no speaker (JAX's jitted padded path): padded
    to the buckets, zero past the lengths, and the port's real rows equal
    its eager prompt's bit for bit."""
    pd = assemble(both, TEXT, speaker=speaker)
    p, t = tprompt.pd_lengths(pd)
    assert pd.input_embeds.shape[1] == PB and pd.trailing_hidden.shape[1] == TB
    assert p == (9 if speaker else 8) and t > 1
    assert not pd.input_embeds[:, p:].any() and not pd.trailing_hidden[:, t:].any()
    (_, _), (tp, tcfg) = both
    eager = tprompt.assemble_prompt(tp, tcfg, FakeByteTokenizer(), TEXT, speaker=speaker)
    assert (p, t) == (eager.input_embeds.shape[1], eager.trailing_hidden.shape[1])
    assert torch.equal(pd.input_embeds[:, :p], eager.input_embeds)
    assert torch.equal(pd.trailing_hidden[:, :t], eager.trailing_hidden)


def test_fallbacks_match_jax(both):
    """An instruct (with a built-in speaker and without), a speaker string
    that names no built-in speaker, and a speaker embedding (assemble_prompt
    padded after, in both packages): the same rows as JAX's, and as the
    port's own eager prompt."""
    (_, _), (tp, tcfg) = both
    emb = np.random.default_rng(0).standard_normal(tcfg.hidden_size).astype(np.float32)
    cases = [dict(speaker="aiden", instruct="Speak slowly and warmly."),
             dict(instruct="A bright young voice."),
             dict(speaker="a calm, low narrator"),
             dict(speaker_embedding=emb)]
    for kw in cases:
        pd = assemble(both, TEXT, **kw)
        eager = tprompt.assemble_prompt(tp, tcfg, FakeByteTokenizer(), TEXT, **kw)
        p, t = tprompt.pd_lengths(pd)
        assert (p, t) == (eager.input_embeds.shape[1], eager.trailing_hidden.shape[1]), kw
        assert torch.equal(pd.input_embeds[:, :p], eager.input_embeds), kw
        assert torch.equal(pd.trailing_hidden[:, :t], eager.trailing_hidden), kw


def test_over_bucket_and_short_text_match_jax(both):
    """A trailing text past the bucket, and a prompt past the prompt bucket
    (an instruct), come back exact-length (p / t unset) so the caller's
    bucket check reports the real lengths; text under 9 tokens gives None,
    and the shortest text over it a one-row trailing (tts_eos alone)."""
    long = "words " * 30
    pd = assemble(both, long, speaker="aiden")
    p, t = tprompt.pd_lengths(pd)
    assert t > TB and pd.trailing_hidden.shape[1] == t and pd.t is None
    pd = assemble(both, TEXT, pb=12, speaker="aiden", instruct="An instruct longer than 12.")
    assert pd.input_embeds.shape[1] > 12 and pd.p is None
    words = WordTokenizer()  # the chat template is 2 words + the text's
    assert assemble(both, "hi", speaker="aiden", tok=words) is None
    assert assemble(both, "six words of text are here", tok=words) is None
    pd = assemble(both, "seven words of text are here now", speaker="aiden", tok=words)
    assert tprompt.pd_lengths(pd) == (9, 1)
