"""Serving at B = 32 on the card (marked `cuda`; skipped where there is no
GPU). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_serving_b32.py -q --noconftest

- K6 and the SEANet block's upsample on block 3 of the 0.6B vocoder (bf16
  weights) at 40 and 64 rows of 110 frames, 211,200 positions a row: one
  tensor-core conv launch a conv (the units' six, the upsample's one:
  calls of the C entry that launches it once), and the rows on either side
  of the old 65,535-tile cap of gridDim.y (39 rows) held against the plain
  versions at TOL bf16 (2e-2, chip_smoke's); with fp32 weights, the exact
  GEMM of csrc/gemm.cuh, whose grid had its row tiles on y too (capped at
  19 rows), at 20 rows against the plain version at TOL fp32 (1e-4).
- The K3 configuration's lockstep step at B = 32 at tiny widths in fp32:
  every linear on K3 at M = 32 (64 on the code predictor's first pass),
  past M0, so on the tile; the graph's replays bit for bit the same steps
  run eagerly (frames and every state array), and each replay launches the
  capture's K3 kernels, the tile's by name."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.cuda import _build
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk
from qwen3_tts_tpu_torch.testing import (
    random_vocoder_params,
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
)

pytestmark = pytest.mark.cuda
TOL_BF16, TOL_FP32 = 2e-2, 1e-4
B = 32


def need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def rel_rms(got, ref) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt().clamp_min(1e-30))


def conv_kernels(fn, entry: str = "qt_units_conv"):
    """(fn's result, its calls of the C entry `entry`, each one kernel
    launch: qt_conv_mma_kernel's, or with fp32 weights the GEMM's)."""
    lib = _build.lib()
    real, calls = getattr(lib, entry), []

    def counting(*args):
        calls.append(args)
        return real(*args)

    setattr(lib, entry, counting)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        setattr(lib, entry, real)
    return out, len(calls)


@pytest.mark.parametrize("rows,dtype", [(40, torch.bfloat16), (64, torch.bfloat16),
                                        (20, torch.float32)])
def test_block3_at_rows_of_110_frames_matches_plain(rows, dtype):
    need_gpu()
    cfg = TokenizerDecoderConfig()
    dense = random_vocoder_params(cfg, seed=0, device="cuda")
    blocks = dense["decoder"]["blocks"]
    bp = vk.build_seanet_block_params(
        blocks[-1], cfg.upsample_rates[-1], dtype,
        tail={"snake": dense["decoder"]["out_snake"], "conv": dense["decoder"]["out_conv"]})
    entry, tol = ("qt_units_conv", TOL_BF16) if dtype == torch.bfloat16 else ("qt_units_gemm",
                                                                             TOL_FP32)
    t_in = 4 * 110 * int(np.prod(cfg.upsample_rates[:-1]))  # 70,400 rows into block 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(rows, t_in, bp["snake_a"].shape[0], generator=gen, device="cuda")
         * 0.5).to(dtype)
    up_before, units_before = vk.upsample_launches, vk.launches
    y, n_up = conv_kernels(lambda: vk.block_upsample(bp, x, rate=cfg.upsample_rates[-1]), entry)
    wav, n_units = conv_kernels(lambda: vk.residual_units_fused(bp, y), entry)
    # bf16: the units' six convs (the tail its own kernel); fp32: six GEMMs
    # and the tail's
    assert (n_up, n_units) == (1, 6 if dtype == torch.bfloat16 else 7)
    assert (vk.upsample_launches - up_before, vk.launches - units_before) == (1, 1)
    assert y.shape == (rows, 110 * 1920, bp["u_w1"].shape[-1]) and wav.shape == (rows, 110 * 1920)
    for r in sorted({r for r in (0, 38, 39, 40, rows - 1) if r < rows}):  # both sides of the cap
        sl = slice(r, r + 1)
        ref_y = vk.block_upsample_plain(bp, x[sl], rate=cfg.upsample_rates[-1])
        assert rel_rms(y[sl].float(), ref_y.float()) <= tol, r
        ref = vk.residual_units_plain(bp, y[sl])
        assert bool(torch.isfinite(wav[sl]).all())
        assert rel_rms(wav[sl], ref) <= tol, r


def test_k3_step_at_b32_graph_is_bit_for_bit_the_eager_step(tmp_path):
    need_gpu()
    d = tmp_path / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    cfg = tpipe.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                              use_cp_megakernel=False)
    pl = tpipe.Qwen3TTSPipeline(d, cfg, device="cuda", dtype=torch.float32)
    texts = [f"Stream {i} of the batch reads {'more words here' if i % 2 else 'this'}."
             for i in range(B)]
    statics = tgen.GenStatics(config=pl.config, capacity=64 + tgen.RING_SLACK, chunk_steps=6,
                              track_cp_penalty=False)
    pds = [pl._assemble(t, "aiden") for t in texts]
    e, tr, lengths, totals = tsrv._pad_prompts(pds, 64, 128)
    state = tsrv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                 tsrv._device_ints(range(B), e.device), statics)
    eager = tsrv._clone(state)
    frames, _, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0, statics)
    g = state.graph
    assert g is not None and B > qm.M0
    temps = torch.zeros(B, device="cuda")
    ref = []
    for _ in range(statics.chunk_steps):
        tsrv.lockstep_step(tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params),
                           eager, temps, statics, False)
        ref.append(eager["frame"].clone())
    torch.cuda.synchronize()
    assert torch.equal(frames, torch.stack(ref, dim=1))

    def same(a, b):
        for k, v in a.items():
            if isinstance(v, dict):
                same(v, b[k])
            else:
                assert torch.equal(v, b[k]), k

    same(state, eager)
    per_step = g.step_launches[0]
    assert per_step > 0
    for _ in range(5):  # a profiler window can lose records: take a short one again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "qt_qmm_" in e.name]
        if len(names) >= per_step:
            break
    assert len(names) == per_step and all("qt_qmm_tile_kernel<8" in k for k in names)
