"""The port's CUDA kernels against their plain PyTorch versions on the card
(marked `cuda`; skipped where there is no GPU, since a CUDA kernel has no
CPU mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerance: rel RMS <= 1e-4 in fp32 (sums in another order). With bf16
weights K4, K5, K6 and the SEANet blocks' upsample run on the tensor cores
and their plain versions round the same operands to bf16: rel RMS <= 1e-3
(fp32 sums in another order, the card's sinf / cosf / expf / erff against
torch's, and the rare operand that lands on the other side of a bf16
rounding boundary)."""

import pytest
import torch

from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.ops.cuda import upsample_kernel as upk
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk
from qwen3_tts_tpu_torch.testing import random_vocoder_params, tiny_decoder_config

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

CFG = TokenizerDecoderConfig(
    latent_dim=96, hidden_size=128, intermediate_size=192, head_dim=64,
    num_attention_heads=2, num_hidden_layers=2, decoder_dim=160,
    upsample_rates=(4, 3), upsampling_ratios=(2, 2),
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


@pytest.mark.parametrize("m", [1, 2, 3, 8, 16, 37, 130])
def test_int8_matmul_kernel(dev, m):
    """The GEMV (M <= qm.M0: a block's 1, 2, 4 or 8 rows of x, and 16 rows
    over two row blocks where M0 reaches it) and the tensor-core tile (37
    and 130 rows: one and two row tiles, split K), at ragged O = 200
    columns, in fp32 (rel RMS 1e-4) and bf16 (2e-2); two calls give the
    same bits on either side of M0 (fixed-order sums, no atomics); a
    misaligned x is copied by the dispatch."""
    g = torch.Generator(device=dev).manual_seed(m)
    o, k = 200, 320
    w8 = torch.randint(0, 256, (o, k), generator=g, device=dev, dtype=torch.uint8)
    s = torch.rand(o, k // 64, generator=g, device=dev) * 1e-2
    b = torch.randn(o, k // 64, generator=g, device=dev) * 0.1
    params = {"w8": w8, "scales": s, "biases": b}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        before = qm.launches
        got = qm.int8_matmul(x, params)
        assert qm.launches == before + 1
        assert rel_rms(got.float(), qm.int8_matmul_plain(x, w8, s, b).float()) <= tol
        assert torch.equal(qm.int8_matmul(x, params), got)
        shifted = torch.empty(m * k + 1, dtype=dtype, device=dev)[1:].view(m, k)
        shifted.copy_(x)
        assert torch.equal(qm.int8_matmul(shifted, params), got)


def test_vocoder_kernels(dev):
    p = random_vocoder_params(CFG, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    kp = ptk.build_pretransformer_params(p["pre_transformer"], CFG, torch.float32)
    x = torch.randn(2, 19, CFG.latent_dim, generator=g, device=dev)
    kw = dict(nh=CFG.num_attention_heads, hd=CFG.head_dim, eps=CFG.rms_norm_eps)
    assert rel_rms(ptk.pre_transformer_packed(kp, x, **kw),
                   ptk.pre_transformer_plain(kp, x, **kw)) <= 1e-4

    sp = upk.build_upsample_stage_params(p["upsample"][1], torch.float32,
                                         initial_conv=p["decoder"]["initial_conv"])
    assert rel_rms(upk.upsample_stage_fused(sp, x), upk.upsample_stage_plain(sp, x)) <= 1e-4

    dec = p["decoder"]
    tail = {"snake": dec["out_snake"], "conv": dec["out_conv"]}
    for i, rate in enumerate(CFG.upsample_rates):
        bp = vk.build_seanet_block_params(dec["blocks"][i], rate, torch.float32,
                                          tail=tail if i == 1 else None)
        y = torch.randn(2, 90, bp["u_w2"].shape[-1], generator=g, device=dev) * 0.5
        assert rel_rms(vk.residual_units_fused(bp, y), vk.residual_units_plain(bp, y)) <= 1e-4


def test_bf16_tensor_core_kernels(dev):
    """K4 (one persistent cooperative launch, one device kernel a call) and
    K6 (the tensor-core conv) with bf16 weights, B = 2 and T = 19 (ragged
    64-row tiles), at CFG's widths (C = 80 and 40: ragged 64-column tiles)
    and the tiny config's (head_dim 8)."""
    for cfg in (CFG, tiny_decoder_config()):
        p = random_vocoder_params(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        kp = ptk.build_pretransformer_params(p["pre_transformer"], cfg, torch.bfloat16)
        kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(2, 19, cfg.latent_dim, generator=g, device=dev).to(dt)
            before = ptk.launches
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                got = ptk.pre_transformer_packed(kp, x, **kw)
                torch.cuda.synchronize()
            assert ptk.launches == before + 1
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(kernels) == 1 and "persistent" in kernels[0], kernels
            assert rel_rms(got, ptk.pre_transformer_plain(kp, x, **kw)) <= 1e-3

        dec = p["decoder"]
        tail = {"snake": dec["out_snake"], "conv": dec["out_conv"]}
        last = len(cfg.upsample_rates) - 1
        for i, rate in enumerate(cfg.upsample_rates):
            bp = vk.build_seanet_block_params(dec["blocks"][i], rate, torch.bfloat16,
                                              tail=tail if i == last else None)
            y = torch.randn(2, 90, bp["u_w2"].shape[-1], generator=g, device=dev) * 0.5
            before = vk.launches
            got = vk.residual_units_fused(bp, y)
            assert vk.launches == before + 1
            assert rel_rms(got, vk.residual_units_plain(bp, y)) <= 1e-3


def test_bf16_upsampling_kernels(dev):
    """K5 with bf16 weights (one persistent cooperative launch, one device
    kernel a call after the first) on both stages, from fp32 and bf16 input, at the 0.6B
    widths with T = 26 and 110 (the stream and generate windows) and at
    CFG's (C = 96, Cic = 160: ragged 64-column tiles) with B = 2, T = 19;
    the blocks' upsample (the 2-tap tensor-core conv with bf16 weights,
    the fp32 GEMM with fp32 weights) against its plain version at both."""
    for cfg, b, ts in ((TokenizerDecoderConfig(), 1, (26, 110)), (CFG, 2, (19,))):
        p = random_vocoder_params(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        stages = p["upsample"]
        sps = [upk.build_upsample_stage_params(
            st, torch.bfloat16,
            initial_conv=p["decoder"]["initial_conv"] if i == len(stages) - 1 else None)
            for i, st in enumerate(stages)]
        for t in ts:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(b, t, cfg.latent_dim, generator=g, device=dev).to(dt)
                for sp in sps:
                    upk.upsample_stage_fused(sp, x)  # the first call makes the split-K counters
                    before = upk.launches
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        got = upk.upsample_stage_fused(sp, x)
                        torch.cuda.synchronize()
                    assert upk.launches == before + 1
                    kernels = [e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA]
                    assert len(kernels) == 1 and "persistent" in kernels[0], kernels
                    assert got.dtype == dt
                    assert rel_rms(got, upk.upsample_stage_plain(sp, x)) <= 1e-3
                    x = got

        dec = p["decoder"]
        for i, rate in enumerate(cfg.upsample_rates):
            for wdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
                bp = vk.build_seanet_block_params(dec["blocks"][i], rate, wdt)
                cin = bp["up_w"].shape[0] // 2
                x = torch.randn(b, 4 * ts[-1], cin, generator=g, device=dev) * 0.5
                before = vk.upsample_launches
                got = vk.block_upsample(bp, x, rate=rate)
                assert vk.upsample_launches == before + 1
                assert rel_rms(got, vk.block_upsample_plain(bp, x, rate=rate)) <= tol
