"""The port's single-stream slice against the JAX pipeline on the CPU in
fp32, both loading one tiny model directory written with the JAX package's
export helpers. The tiny talker has every linear input width a multiple of
64 (hidden 64, text hidden 128, code predictor 64 = 4 x 16 heads), so the
int8 runtime quantization covers every linear and K3's plain version
carries them all; the port runs its vocoder through the K4/K5/K6 plain
versions, the JAX pipeline through its plain jnp vocoder.

Tolerances: prompt rows 1e-5 (two fp32 projections); per-step logits and
waveforms rel RMS 1e-4 (fp32 through several layers, sums in another order).
The decode loop is held teacher-forced: JAX's greedy frames are fed into the
port step by step, since free-running greedy codes may flip at near-ties."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.io import safetensors_io as jst
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.testing import tiny_talker_config

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the whole slice end to end."


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


def write_dir(path) -> None:
    """A loadable model dir from the JAX package's init + export helpers."""
    cfg = JConfig.from_json(jtesting.config_to_json_dict(tiny_talker_config()))
    os.makedirs(os.path.join(path, "speech_tokenizer"))
    tp = jtalker.init_talker_params(cfg, jax.random.PRNGKey(0))
    cp = jcp.init_cp_params(cfg.code_predictor_config, cfg.hidden_size, jax.random.PRNGKey(1))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(jtesting.config_to_json_dict(cfg), f)
    jst.save_file(jtesting.export_talker_checkpoint(tp, cp, cfg),
                  os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(jtesting.make_tiny_tokenizer_json(), f)
    dec = jtesting.tiny_decoder_config(codebook_size=2048)
    voc = jvoc.init_vocoder_params(dec, jax.random.PRNGKey(2))
    with open(os.path.join(path, "speech_tokenizer", "config.json"), "w") as f:
        json.dump({"decoder_config": jtesting.decoder_config_to_json_dict(dec),
                   "decode_upsample_rate": dec.total_upsample}, f)
    jst.save_file(jtesting.export_vocoder_checkpoint(voc, dec),
                  os.path.join(path, "speech_tokenizer", "model.safetensors"))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("slice") / "model")
    write_dir(d)
    jpl = jpipe.Qwen3TTSPipeline(
        d, jpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=False, use_talker_megakernel=False, use_vocoder_kernels=False
        ), dtype=jnp.float32,
    )
    tpl = tpipe.Qwen3TTSPipeline(
        d, tpipe.Qwen3TTSPipelineConfiguration(use_vocoder_kernels=True),
        device="cpu", dtype=torch.float32)
    assert "w8" in tpl.cp_params["layers"]["qkv_proj"]
    assert "w8" in tpl.params["text_projection"]["fc1"]
    assert tpl.vocoder_params["kernel"]["pre_transformer"] is not None
    return d, jpl, tpl


def test_prompt_embeds_match(pipes):
    _, jpl, tpl = pipes
    jpd = jprompt.assemble_prompt(jpl.params, jpl.config, jpl.tokenizer, TEXT, speaker="aiden")
    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
        assert rel_max(getattr(tpd, name), getattr(jpd, name)) <= 1e-5, name


def test_teacher_forced_decode_shadow(pipes):
    """24 frames (past the step-15 window trim): JAX decodes greedily one
    frame per chunk; the port replays JAX's frames and its talker logits
    must match JAX's at every step."""
    _, jpl, tpl = pipes
    cfg = jpl.config
    jpd = jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, TEXT, speaker="aiden")
    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    logits, frames = [np.asarray(state["logits"])], []
    for _ in range(24):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))
    assert int(state["step"]) == 24 and int(state["window_start"]) == 0

    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
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
    assert int(ts["step"]) == 24 and int(ts["total_len"]) == p + 24


def jax_frames(jpl, n=40) -> np.ndarray:
    return jpl._generate_codes(TEXT, "aiden", temperature=0.0, max_tokens=n, seed=0)


def test_vocoder_on_jax_codes(pipes):
    _, jpl, tpl = pipes
    frames = jax_frames(jpl)
    assert len(frames) > 20
    ref = jpl._decode_to_audio(frames)
    got = tpl._decode_to_audio(frames)
    assert got.shape == ref.shape == (len(frames) * tpl._samples_per_frame,)
    assert rel_rms(got, ref) <= 1e-4


def test_stream_chunks_match_jax_on_the_same_codes(pipes, monkeypatch):
    """Both pipelines stream the same codes (JAX's greedy frames with pad
    frames mixed in): chunk token ranges, the two is_final flags and the
    samples agree."""
    _, jpl, tpl = pipes
    frames = jax_frames(jpl, 45)
    frames[[5, 17, 18]] = 2148  # pad frames, filtered out by both

    def fake_stream_codes(*args, chunk_steps, **kwargs):
        for i in range(0, len(frames), chunk_steps):
            yield frames[i:i + chunk_steps]

    monkeypatch.setattr(jgen, "stream_codes", fake_stream_codes)
    monkeypatch.setattr(tgen, "stream_codes", fake_stream_codes)
    ref = list(jpl.generate_stream(TEXT, "aiden", seed=0))
    got = list(tpl.generate_stream(TEXT, "aiden", seed=0))
    assert [(c.token_range, c.is_final) for c in got] == [
        (c.token_range, c.is_final) for c in ref
    ]
    assert [c.is_final for c in got].count(True) == 2
    for g, r in zip(got, ref):
        if len(r.samples):
            assert rel_rms(g.samples, r.samples) <= 1e-4
