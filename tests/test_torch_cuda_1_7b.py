"""K1, K2 and K3's GEMV at the 1.7B widths (Qwen3TTSConfig.standard_1_7b():
talker hidden 2048, intermediate 6144, the code predictor reached through
small_to_mtp_projection) against their plain PyTorch versions on the card
(marked `cuda`; skipped where there is no GPU, since a CUDA kernel has no
CPU mode). Depth is cut to 4 talker and 2 code-predictor layers; every
width is the published one. Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_1_7b.py -q --noconftest

Tolerances: K1 and K2 at TOL_W8A8 = 5e-2, as chip_smoke.py holds them (both
sides do the same W8A8 arithmetic with exact integer dots, but fp32 sums in
another order can put an activation on the other side of an int8 rounding
step, which moves every later layer by ~1e-2); K2's codes agree except at
near ties (score gap within 1e-2 of the largest score) and its 2048-wide
embedding sum equals the plain version's; K3's GEMV at rel RMS 1e-4 in fp32
and 2e-2 in bf16 (sums in another order; bf16 output rounding)."""

import dataclasses

import pytest
import torch

from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk
from qwen3_tts_tpu_torch.ops.rope import inv_freq
from qwen3_tts_tpu_torch.testing import random_host_cp_params, random_host_talker_params

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=4, text_vocab_size=4096,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2))
TOL_W8A8 = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_talker_step_kernel_at_1_7b(dev, dtype):
    """A ring of 260 slots wrapped at position 300, with the window trimmed
    to 99 and to 297 (three valid slots)."""
    tkp = to_torch(tmk.build_talker_kernel_params(random_host_talker_params(CFG, 3), CFG), dev)
    c_len, position = 260, 300
    g = torch.Generator(device=dev).manual_seed(0)
    nl, kvw = CFG.num_hidden_layers, CFG.num_key_value_heads * CFG.head_dim
    slots = torch.arange(c_len, device=dev)
    pos = torch.where(slots < position % c_len, slots + c_len, slots)
    cache = {"k2": (torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3).to(dtype),
             "v2": (torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3).to(dtype),
             "pos": pos}
    embed = (torch.randn(1, 1, CFG.hidden_size, generator=g, device=dev) * 0.5).to(dtype)
    ang = position * torch.from_numpy(inv_freq(CFG.head_dim, CFG.rope_theta)).to(dev)
    cos, sin = torch.cat([ang.cos()] * 2), torch.cat([ang.sin()] * 2)
    slot = position % c_len
    for ws in (99, 297):
        args = (torch.tensor(position, device=dev), torch.tensor(ws, device=dev), cos, sin, CFG)
        ck = {k: v.clone() for k, v in cache.items()}
        cp = {k: v.clone() for k, v in cache.items()}
        before = tmk.launches
        hk, lk, ck = tmk.talker_step(tkp, embed, ck, *args)
        assert tmk.launches == before + 1
        hp, lp, cp = tmk.talker_step_plain(tkp, embed, cp, *args)
        torch.cuda.synchronize()
        assert rel_rms(hk, hp) <= TOL_W8A8 and rel_rms(lk, lp) <= TOL_W8A8, ws
        for name in ("k2", "v2"):
            assert rel_rms(ck[name][:, slot], cp[name][:, slot]) <= TOL_W8A8
            other = torch.ones(c_len, dtype=torch.bool, device=dev)
            other[slot] = False
            assert torch.equal(ck[name][:, other], cache[name][:, other])
        assert torch.equal(ck["pos"], cp["pos"]) and int(ck["pos"][slot]) == position


def test_cp_frame_kernel_through_the_projection(dev):
    """Temperature 0.85 with and without the penalty, and 0, from a
    2048-wide talker row."""
    cc = CFG.code_predictor_config
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    kp = to_torch(cpk.build_cp_kernel_params(random_host_cp_params(CFG, 4), cc), dev)
    assert kp["proj_w"].shape == (1024, 2048) and kp["embr_q"].shape[-1] == 2048
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = torch.randn(1, 1, CFG.hidden_size, generator=g, device=dev)
    code0 = torch.randn(1, 1, CFG.hidden_size, generator=g, device=dev) * 0.5
    seen = torch.rand(ng, v, generator=g, device=dev) < 0.3
    seed = torch.tensor([987654321], device=dev)
    for temperature, track in ((0.85, True), (0.85, False), (0.0, True)):
        lk = torch.empty(ng, v, device=dev)
        sk = seen.clone() if track else None
        before = (cpk.launches, gs.launches)
        codes, esum, sk = cpk.predict_frame(kp, hidden, code0, seed, temperature, sk, cc,
                                            logits_out=lk)
        assert (cpk.launches, gs.launches) == (before[0] + 1, before[1])
        lp = torch.empty(ng, v, device=dev)
        sp = seen.clone() if track else None
        _, pesum, sp = cpk.predict_frame_plain(kp, hidden, code0, seed, temperature, sp, cc,
                                               forced_codes=codes, logits_out=lp)
        torch.cuda.synchronize()
        assert rel_rms(lk, lp) <= TOL_W8A8
        noise = temperature * gs.gumbel_noise(seed, ng, v) if temperature > 0 else None
        for k in range(ng):
            score = lp[k] / torch.where(seen[k], 1.05, 1.0) if track else lp[k].clone()
            if noise is not None:
                score = score + noise[k]
            pick, want = int(torch.argmax(score)), int(codes[k])
            if pick != want:
                assert float(score[pick] - score[want]) <= 1e-2 * float(score.abs().max()), k
        assert esum.shape == (1, 1, 2048) and torch.equal(esum, pesum)
        assert not track or torch.equal(sk, sp)


def test_gemv_at_the_down_projection(dev):
    """K3 at K = 6144 (the down projection) at M <= M0: the GEMV, one
    launch a call, two calls bit-identical."""
    g = torch.Generator(device=dev).manual_seed(2)
    k, o = 6144, 2048
    w8 = torch.randint(0, 256, (o, k), generator=g, device=dev, dtype=torch.uint8)
    s = torch.rand(o, k // 64, generator=g, device=dev) * 1e-3
    b = torch.randn(o, k // 64, generator=g, device=dev) * 0.02
    for m in (1, 3, 9, qm.M0):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            before = qm.launches
            got = qm.int8_matmul_kernel(x, w8, s, b)
            assert qm.launches == before + 1
            assert rel_rms(got.float(), qm.int8_matmul_plain(x, w8, s, b).float()) <= tol, m
            assert torch.equal(qm.int8_matmul_kernel(x, w8, s, b), got)
