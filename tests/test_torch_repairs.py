"""Three places where the port departed from the JAX package, each pinned:
the kernel switches follow the environment as the JAX pipeline's do, the
`w8r` product of prefill keeps its fp32 result before the dequant (checked
in bf16, where rounding the product first shows), and generate_stream
defers each window's pull by one window without changing a chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops.quant import quantize_rowwise_int8_np
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the streaming windows."
ENVS = ("QWEN3TTS_TALKER_KERNEL", "QWEN3TTS_CP_KERNEL", "QWEN3TTS_VOCODER_KERNEL")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("repairs") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return d


def test_kernel_switches_follow_the_environment(model_dir, monkeypatch):
    """The JAX pipeline's rules (qwen3_tts_tpu/pipeline.py, `_knob`),
    restated: a set variable wins, on unless it reads 0 / false / no / off
    / empty after strip and lower-casing; unset, the configuration value
    holds; None is auto, which the port reads as "the device is CUDA"."""
    off = ("0", "false", "no", "off", "")
    for env in (None, "0", "1", "false", "No", " OFF ", "", "yes", "TRUE", "2"):
        for cfg in (None, True, False):
            for device in (torch.device("cpu"), torch.device("cuda")):
                if env is None:
                    monkeypatch.delenv("QWEN3TTS_CP_KERNEL", raising=False)
                    want = device.type == "cuda" if cfg is None else cfg
                else:
                    monkeypatch.setenv("QWEN3TTS_CP_KERNEL", env)
                    want = env.strip().lower() not in off
                assert tpipe._knob(cfg, "QWEN3TTS_CP_KERNEL", device) is want, (env, cfg)
    # the pipeline applies all three: variables over configuration values
    monkeypatch.setenv("QWEN3TTS_TALKER_KERNEL", "0")
    monkeypatch.setenv("QWEN3TTS_CP_KERNEL", "1")
    monkeypatch.setenv("QWEN3TTS_VOCODER_KERNEL", "on")
    pc = tpipe.Qwen3TTSPipelineConfiguration(
        use_talker_megakernel=True, use_cp_megakernel=False, use_vocoder_kernels=False)
    pl = tpipe.Qwen3TTSPipeline(model_dir, pc, device="cpu", dtype=torch.float32)
    assert "kernel" not in pl.params and "kernel" in pl.cp_params
    assert "kernel" in pl.vocoder_params
    # unset, None is auto: all off on the CPU, as before for the megakernels
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)
    pl = tpipe.Qwen3TTSPipeline(model_dir, device="cpu", dtype=torch.float32)
    assert not any("kernel" in t for t in (pl.params, pl.cp_params, pl.vocoder_params))


def test_w8r_linear_bf16_matches_jax_linear():
    """[64, 1024] x [3072, 1024] rowwise int8 in bf16, the prefill shape of
    the 0.6B qkv. Both sides round only their final result to bf16, so
    they differ where fp32 sums in another order cross a bf16 rounding
    boundary: rel RMS <= 5e-4. Rounding the product to bf16 before the
    dequant, as the port once did, gives ~2e-3 here."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3072, 1024)) * 0.05).astype(np.float32)
    w += (rng.standard_normal((3072, 1)) * 0.01).astype(np.float32)  # row offsets m
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    q, s, m = quantize_rowwise_int8_np(w)
    jtree = {"w8r": jnp.asarray(q), "s": jnp.asarray(s[None]), "m": jnp.asarray(m[None])}
    ref = jlinear.linear(jtree, jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(jax.block_until_ready(ref).astype(jnp.float32), np.float64)
    ttree = {"w8r": torch.from_numpy(q), "s": torch.from_numpy(s[None]),
             "m": torch.from_numpy(m[None])}
    got = tlinear.linear(ttree, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    rel = np.sqrt(((got - ref) ** 2).mean() / (ref ** 2).mean())
    assert rel <= 5e-4, rel


def test_stream_defers_each_pull_by_one_window(model_dir, monkeypatch):
    """The first window is pulled as soon as it is queued; every later full
    window only after the next one is queued. Each chunk is bit-identical
    to decoding its window alone (the serial scheme), token ranges tile
    the stream, and is_final comes on the remainder and the sentinel."""
    pl = tpipe.Qwen3TTSPipeline(model_dir, device="cpu", dtype=torch.float32)
    events, windows = [], []
    dispatch = pl._dispatch_decode_with_context

    def recording(frames, left_context):
        i = len(windows)
        windows.append((frames.copy(), None if left_context is None else left_context.copy()))
        events.append(("queue", i))
        pull, ctx = dispatch(frames, left_context)

        def logged():
            events.append(("pull", i))
            return pull()

        return logged, ctx

    monkeypatch.setattr(pl, "_dispatch_decode_with_context", recording)
    chunks = list(pl.generate_stream(TEXT, "aiden", max_tokens=60, seed=3))
    monkeypatch.undo()
    assert len(windows) >= 4, "the stream should decode at least three full windows"
    order = {e: n for n, e in enumerate(events)}
    assert order[("pull", 0)] < order[("queue", 1)]
    full = [i for i, c in enumerate(chunks) if not c.is_final]
    for i in full[1:-1]:
        assert order[("queue", i + 1)] < order[("pull", i)], i
    assert [c.is_final for c in chunks[len(full):]] == [True, True]
    assert [c.token_range for c in chunks[:-1]] == [
        (a, a + len(f)) for a, f in zip(np.cumsum([0] + [len(f) for f, _ in windows]),
                                        [f for f, _ in windows])]
    assert chunks[-1].token_range == (chunks[-2].token_range[1],) * 2
    for chunk, (frames, left) in zip(chunks, windows):
        serial, _ = pl._decode_with_context(frames, left)
        assert np.array_equal(chunk.samples, tpipe.sanitize_samples(serial))
