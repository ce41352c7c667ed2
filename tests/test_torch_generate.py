"""The port's generation on a model directory written by the port's own
testing helpers (the writer chip_smoke.py uses at full width), loaded on
the CPU in fp32: generate and generate_stream run end to end, the stop
conditions freeze the frame count, sampled draws follow the
torch.Generator, and every prompt mode synthesizes."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.ops import sampling as tsamp
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the whole slice end to end."


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_dir") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return tpipe.Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)


def test_unported_prompt_modes_raise(tpl):
    """The instruct, free-form speaker, ICL and speaker-embedding prompts
    give audio; only a speaker embedding of the wrong width raises."""
    spf = tpl._samples_per_frame
    runs = [
        tpl.generate(TEXT, "aiden", instruct="calm", max_tokens=4),
        tpl.generate(TEXT, "not a built-in speaker", max_tokens=4),
        tpl.generate_icl(TEXT, "Reference words.", [[5, 9, 11], [1, 2, 3]], max_tokens=4),
        tpl.generate(TEXT, speaker_embedding=np.zeros(tpl.config.hidden_size, np.float32),
                     max_tokens=4),
    ]
    for audio in runs:
        assert 0 < len(audio) <= 4 * spf and np.isfinite(audio).all()
    with pytest.raises(ValueError, match="speaker_embedding dim"):
        tpl.generate(TEXT, speaker_embedding=np.zeros(3, np.float32), max_tokens=4)


def test_stop_conditions_freeze_the_frame_count(tpl):
    """EOS stops at once; pads stop when more than MAX_CONSECUTIVE_PAD come in
    a row; after a stop nothing more is emitted (the device-side count the
    chunk returns)."""
    cfg = tpl.config
    pd = tprompt.assemble_prompt(tpl.params, cfg, tpl.tokenizer, TEXT, speaker="aiden")

    def run(code0s):
        state = tgen.prefill(tpl.params, pd, cfg)
        flags = []
        for c in code0s:
            frame = torch.full((16,), 7, dtype=torch.long)
            frame[0] = c
            _, emitted = tgen.decode_step(tpl.params, tpl.cp_params, state, cfg,
                                          temperature=0.0, generator=None,
                                          track_cp_penalty=False, forced_frame=frame)
            flags.append(bool(emitted))
        return flags, bool(state["eos"])

    assert run([5, 9, cfg.codec_eos_token_id, 5]) == ([True, True, False, False], True)
    pads = [cfg.codec_pad_id] * (tgen.MAX_CONSECUTIVE_PAD + 2)
    flags, eos = run(pads)
    assert eos and flags == [True] * tgen.MAX_CONSECUTIVE_PAD + [False, False]
    assert run([cfg.codec_pad_id] * 3 + [11] + [cfg.codec_pad_id] * 3) == ([True] * 7, False)


def test_sampling_draws_stay_valid_and_follow_the_generator():
    v = 3072
    logits = torch.zeros(v)
    mask = tsamp.talker_valid_mask(v)
    draws = [
        int(tsamp.sample_token(logits, torch.Generator().manual_seed(s), 0.9,
                               valid_mask=mask))
        for s in range(50)
    ]
    assert all(mask[d] for d in draws)
    again = int(tsamp.sample_token(logits, torch.Generator().manual_seed(7), 0.9,
                                   valid_mask=mask))
    assert again == draws[7]


def test_generate_and_stream_run_end_to_end(tpl):
    spf = tpl._samples_per_frame
    for temperature in (0.0, 0.85):
        audio = tpl.generate(TEXT, "aiden", temperature=temperature, max_tokens=20, seed=0)
        assert audio.dtype == np.float32 and np.isfinite(audio).all()
        assert 0 < len(audio) <= 20 * spf and len(audio) % spf == 0
    again = tpl.generate(TEXT, "aiden", max_tokens=20, seed=0)
    np.testing.assert_array_equal(again, tpl.generate(TEXT, "aiden", max_tokens=20, seed=0))
    chunks = list(tpl.generate_stream(TEXT, "aiden", max_tokens=30, seed=1))
    pos = 0
    for ch in chunks:
        assert ch.token_range[0] == pos and len(ch.samples) == (ch.token_range[1] - pos) * spf
        pos = ch.token_range[1]
    assert chunks[-1].is_final and len(chunks[-1].samples) == 0
