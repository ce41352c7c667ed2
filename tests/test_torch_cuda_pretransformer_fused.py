"""K4a (the per-head pre-transformer, csrc/pretransformer.cu) against its
plain PyTorch version and against K4 on the same weights, on the card
(marked `cuda`; skipped where there is no GPU, since a CUDA kernel has no
CPU mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_pretransformer_fused.py -q

Shapes: head_dim 64 and 128; T = 1, 26, 110, and 300 (above the rows whose
q/k/v fit in shared memory, so the global-scratch store runs); fp32 and
bf16 weights. Tolerance: rel RMS <= 1e-4 in fp32 (sums in another order),
2e-2 with bf16 weights and a bf16 output."""

import pytest
import torch

from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
from qwen3_tts_tpu_torch.testing import random_vocoder_params

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def cfg(hd: int) -> TokenizerDecoderConfig:
    return TokenizerDecoderConfig(latent_dim=96, hidden_size=256, intermediate_size=192,
                                  head_dim=hd, num_attention_heads=256 // hd,
                                  num_hidden_layers=2)


@pytest.mark.parametrize("hd", [64, 128])
def test_fused_kernel_matches_plain_and_k4(dev, hd):
    c = cfg(hd)
    pt = random_vocoder_params(c, seed=hd, device=dev)["pre_transformer"]
    g = torch.Generator(device=dev).manual_seed(1)
    kw = dict(nh=c.num_attention_heads, hd=hd, eps=c.rms_norm_eps)
    for dt in (torch.float32, torch.bfloat16):
        kp = ptk.build_pretransformer_fused_params(pt, c, dt)
        packed = ptk.build_pretransformer_params(pt, c, dt)
        for b, t in ((1, 1), (2, 26), (1, 110), (2, 300)):
            x = torch.randn(b, t, c.latent_dim, generator=g, device=dev).to(dt)
            before = ptk.fused_launches
            got = ptk.pre_transformer_fused(kp, x, **kw)
            torch.cuda.synchronize()
            assert ptk.fused_launches == before + 1
            assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
            assert rel_rms(got, ptk.pre_transformer_fused_plain(kp, x, **kw)) <= TOL[dt], (dt, t)
            assert rel_rms(got, ptk.pre_transformer_plain(packed, x, **kw)) <= TOL[dt], (dt, t)


def test_fused_kernel_repeats_bit_for_bit(dev):
    c = cfg(64)
    kp = ptk.build_pretransformer_fused_params(
        random_vocoder_params(c, seed=3, device=dev)["pre_transformer"], c, torch.bfloat16)
    x = torch.randn(2, 110, c.latent_dim, device=dev)
    kw = dict(nh=c.num_attention_heads, hd=64, eps=c.rms_norm_eps)
    first = ptk.pre_transformer_fused(kp, x, **kw)
    assert torch.equal(first, ptk.pre_transformer_fused(kp, x, **kw))
