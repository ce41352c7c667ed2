"""The 1.7B model's lockstep step at B = 32 on the card (marked `cuda`,
skipped where there is no GPU, since a CUDA kernel has no CPU mode), at
the 1.7B widths (Qwen3TTSConfig.standard_1_7b(): talker hidden 2048, the
1024-wide code predictor reached through small_to_mtp_projection; depth
cut to 2 talker and 2 code-predictor layers). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_serving_1_7b_b32.py -q --noconftest

- K3 and K7 (4 bits) at the projection's shape (K = 2,048, O = 1,024) at
  M = 32 and 64, the first pass's M at B = 32, both past M0 (the tile):
  one launch a call, against the plain version at rel RMS 1e-4 in fp32
  and 2e-2 in bf16, two calls bit-identical.
- The B = 32 lockstep graph on the megakernel configuration's weights (the
  `w8r` product, the projection on K3's tile: 15 launches a step, M = 64
  once, then 32) equals the eager step bit for bit over 6 replays, at
  temperature 0 and at 0.9."""

import dataclasses

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, write_model_dir

pytestmark = pytest.mark.cuda
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=2, text_vocab_size=4096, tts_bos_token_id=4000,
    tts_eos_token_id=4001, tts_pad_token_id=4002,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2))
TEXTS = ["Good morning.", "The train leaves at half past nine.",
         "Please water the plants tonight.", "A short one.",
         "The quick brown fox jumps over the dog.", "Numbers like twelve are read in full.",
         "The museum opens its new wing next week.", "Thank you, we will be with you."] * 4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


@pytest.mark.parametrize("bits", [8, 4], ids=["k3", "k7_4bit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_projection_tile_at_b32(dtype, bits):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    k, o = 2048, 1024
    s = torch.rand(o, k // 64, generator=g, device="cuda") * (1e-3 if bits == 8 else 2e-2 / 16)
    b = torch.randn(o, k // 64, generator=g, device="cuda") * 0.02
    if bits == 8:
        mod = qm
        w = torch.randint(0, 256, (o, k), generator=g, device="cuda", dtype=torch.uint8)

        def kernel(x):
            return qm.int8_matmul_kernel(x, w, s, b)

        def plain(x):
            return qm.int8_matmul_plain(x, w, s, b)
    else:
        mod = pm
        w = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=g, device="cuda",
                          dtype=torch.int64).to(torch.int32)

        def kernel(x):
            return pm.packed_matmul_kernel(x, w, s, b, bits, 64)

        def plain(x):
            return pm.packed_matmul_plain(x, w, s, b, bits, 64)
    for m in (32, 64):
        assert m > mod.M0  # the tile
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        before = mod.launches
        got = kernel(x)
        assert mod.launches == before + 1
        ref = plain(x)
        assert got.dtype == dtype and got.shape == (m, o)
        assert rel_rms(got.float(), ref.float()) <= TOL[dtype], m
        assert torch.equal(kernel(x), got), m


@pytest.fixture(scope="module")
def pl(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = tmp_path_factory.mktemp("cuda_serving_1_7b_b32") / "model"
    write_model_dir(d, CFG, tiny_decoder_config(), weight_dtype=torch.bfloat16)
    return tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        use_talker_megakernel=True, use_cp_megakernel=True), device="cuda", dtype=torch.bfloat16)


def test_b32_graph_replay_equals_eager_step(pl):
    assert "w8" in pl.cp_params["small_to_mtp_projection"]
    b = len(TEXTS)
    p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    for temperature in (0.0, 0.9):
        statics = tgen.GenStatics(config=pl.config, capacity=64 + tgen.RING_SLACK,
                                  chunk_steps=6, track_cp_penalty=False)
        pds = [pl._assemble(t, "aiden") for t in TEXTS]
        e, tr, lengths, totals = tsrv._pad_prompts(pds, 64, 64)
        state = tsrv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                     tsrv._device_ints(range(b), e.device), statics)
        eager = tsrv._clone(state)
        ms, fn = [], qm.int8_matmul_kernel

        def recording(x, *args):
            ms.append(x.shape[0])
            return fn(x, *args)

        qm.int8_matmul_kernel = recording
        try:
            frames, counts, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state,
                                                                 temperature, statics)
        finally:
            qm.int8_matmul_kernel = fn
        temps = torch.full((b,), temperature, device="cuda")
        ref = []
        for _ in range(6):
            tsrv.lockstep_step(p, cp, eager, temps, statics, temperature > 0)
            ref.append(eager["frame"].clone())
        torch.cuda.synchronize()
        assert torch.equal(frames, torch.stack(ref, dim=1)) and bool((counts == 6).all())
        for k, v in eager.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    assert torch.equal(state[k][kk], vv), (k, kk)
            else:
                assert torch.equal(state[k], v), k
        assert state.graph.step_launches[tsrv._COUNTED.index(qm)] == 15
        # each temperature's bind captures a graph (greedy, sampled): the
        # projection's calls in its warm-up and capture
        assert sorted(set(ms)) == [32, 64] and ms.count(64) == 2 and ms.count(32) == 28
