"""The port's pipeline against the JAX pipeline on the CPU in fp32, with the
megakernels off, in the two configurations that run packed weights: a
pre-quantized tiny dir (uniform 4-bit group 64, written by the port's
write_prequantized_model_dir: every talker and code-predictor linear and
table kept packed) and the mixed 4/6-bit runtime mode on a dense tiny dir.
The port runs K7's plain version and the gather-dequant lookups; JAX its jnp
path (quantized_matmul_ref) and its own lookups.

Tolerances, as in test_torch_pipeline.py: prompt rows 1e-5 (two fp32
projections); per-step logits and waveforms rel RMS 1e-4 (fp32 through
several layers, sums in another order). The decode loop is held
teacher-forced: JAX's greedy frames are fed into the port step by step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.testing import (
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
    write_prequantized_model_dir,
)

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the packed weights end to end."
FRAMES = 18


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def rel_max(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module", params=["prequant", "mixed_4_6"])
def pipes(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param) / "model")
    if request.param == "prequant":
        write_prequantized_model_dir(d, tiny_talker_config(), tiny_decoder_config())
        mode = "int8"
    else:
        write_model_dir(d, tiny_talker_config(), tiny_decoder_config(),
                        weight_dtype=torch.float32)
        mode = "mixed_4_6"
    jpl = jpipe.Qwen3TTSPipeline(
        d, jpipe.Qwen3TTSPipelineConfiguration(
            runtime_quantization_mode=mode, use_cp_megakernel=False,
            use_talker_megakernel=False, use_vocoder_kernels=False,
        ), dtype=jnp.float32,
    )
    tpl = tpipe.Qwen3TTSPipeline(
        d, tpipe.Qwen3TTSPipelineConfiguration(runtime_quantization_mode=mode),
        device="cpu", dtype=torch.float32,
    )
    # every talker / cp linear and the tables are packed in both modes
    for tree in (tpl.params["layers"], tpl.cp_params["layers"]):
        for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
            assert tree[name]["wq"].dtype == torch.uint32, name
    for entry in (tpl.params["text_embedding"], tpl.params["codec_head"],
                  tpl.cp_params["lm_head"], tpl.cp_params["codec_embedding"]):
        assert "wq" in entry
    if mode == "mixed_4_6":  # 6-bit qkv: 64 inputs in 12 words
        assert tpl.params["layers"]["qkv_proj"]["wq"].shape[-1] == 12
    return jpl, tpl


def test_prompt_rows_and_teacher_forced_logits(pipes):
    jpl, tpl = pipes
    cfg = jpl.config
    jpd = jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, TEXT, speaker="aiden")
    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
        assert rel_max(getattr(tpd, name), getattr(jpd, name)) <= 1e-5, name

    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    logits, frames = [np.asarray(state["logits"])], []
    for _ in range(FRAMES):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))

    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert rel_rms(ts["logits"], logits[0]) <= 1e-4
    for i, frame in enumerate(frames):
        out, emitted = tgen.decode_step(
            tpl.params, tpl.cp_params, ts, tpl.config, temperature=0.0, generator=None,
            track_cp_penalty=True, forced_frame=torch.from_numpy(frame).long(),
        )
        assert bool(emitted)
        np.testing.assert_array_equal(out.numpy(), frame)
        assert rel_rms(ts["logits"], logits[i + 1]) <= 1e-4, i


def test_waveform_on_jax_codes(pipes):
    jpl, tpl = pipes
    frames = jpl._generate_codes(TEXT, "aiden", temperature=0.0, max_tokens=30, seed=0)
    assert len(frames) > 10
    ref = jpl._decode_to_audio(frames)
    got = tpl._decode_to_audio(frames)
    assert got.shape == ref.shape == (len(frames) * tpl._samples_per_frame,)
    assert rel_rms(got, ref) <= 1e-4
