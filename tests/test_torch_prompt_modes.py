"""The port's prompt assembly in every mode against the JAX package's
assemble_prompt on the CPU in fp32, on identical weights (JAX random init,
the same numpy tree into both) and one tokenizer.json: VoiceDesign and
CustomVoice instructs, a free-form speaker string read as an instruct, ICL
with and without reference codes (instruct beats ICL), and a speaker
embedding, including the width check. Tolerance: rel max <= 1e-5 on every
row (two fp32 projections, sums in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.frontend.tokenizer import Qwen3Tokenizer as JTokenizer
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.frontend.tokenizer import Qwen3Tokenizer
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.testing import config_to_json_dict, tiny_talker_config

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks every prompt mode."
REL = 1e-5


def rel_max(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("prompt_modes")
    with open(d / "tokenizer.json", "w") as f:
        json.dump(jtesting.make_tiny_tokenizer_json(), f)
    tcfg = tiny_talker_config()
    jcfg = JConfig.from_json(config_to_json_dict(tcfg))
    params = jax.tree.map(np.asarray, jtalker.init_talker_params(jcfg, jax.random.PRNGKey(3)))
    jside = (jax.tree.map(jnp.asarray, params), jcfg, JTokenizer(str(d)))
    tside = (to_torch(params), Qwen3TTSConfig.from_json(config_to_json_dict(tcfg)),
             Qwen3Tokenizer(str(d)))
    return jside, tside


def assert_same(both, **kwargs):
    (jp, jcfg, jtok), (tp, tcfg, ttok) = both
    jpd = jprompt.assemble_prompt(jp, jcfg, jtok, TEXT, **kwargs)
    tpd = tprompt.assemble_prompt(tp, tcfg, ttok, TEXT, **kwargs)
    for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
        assert rel_max(getattr(tpd, name), getattr(jpd, name)) <= REL, (name, kwargs)
    return tpd


@pytest.mark.parametrize("speaker", ["", "aiden", "a calm, low voice"])
def test_instruct_and_free_form_speaker_prompts_match(both, speaker):
    """VoiceDesign (no speaker), CustomVoice (a built-in speaker) and a
    free-form speaker string, each alone and under an instruct."""
    plain = assert_same(both, speaker=speaker)
    designed = assert_same(both, speaker=speaker, instruct="Speak slowly and warmly.")
    if speaker in ("", "aiden"):
        assert designed.input_embeds.shape[1] > plain.input_embeds.shape[1]


def test_icl_and_speaker_embedding_prompts_match(both):
    """ICL with and without codes (an instruct takes precedence over it, an
    empty transcript turns it off), and a speaker embedding in the speaker
    slot (a built-in speaker takes the slot first; a width other than the
    talker's hidden size raises)."""
    codes = [list(np.random.default_rng(0).integers(0, 2048, 11)), list(range(11))]
    with_codes = assert_same(both, reference_transcript="The reference words.",
                             reference_audio_codes=codes)
    empty = assert_same(both, reference_transcript="The reference words.",
                        reference_audio_codes=[])
    assert with_codes.input_embeds.shape[1] == empty.input_embeds.shape[1] + 11
    assert_same(both, reference_transcript="", reference_audio_codes=codes)
    over = assert_same(both, instruct="Bright.", reference_transcript="The reference words.",
                       reference_audio_codes=codes)
    assert over.input_embeds.shape[1] < with_codes.input_embeds.shape[1]

    (_, jcfg, _), (tp, tcfg, ttok) = both
    emb = np.random.default_rng(1).standard_normal(jcfg.hidden_size).astype(np.float32)
    named = assert_same(both, speaker="aiden")
    cloned = assert_same(both, speaker_embedding=emb)
    assert cloned.input_embeds.shape == named.input_embeds.shape
    # a built-in speaker takes the slot before an embedding does
    assert_same(both, speaker="aiden", speaker_embedding=emb)
    with pytest.raises(ValueError, match="speaker_embedding dim"):
        tprompt.assemble_prompt(tp, tcfg, ttok, TEXT, speaker_embedding=emb[:-1])
