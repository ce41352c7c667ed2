"""K7 (packed-bit matmul) against its plain PyTorch version on the card, at
every width it takes (2, 3, 4, 6, 8 bits; group sizes 32, 64, 128; with and
without biases), at M up to and past pm.M0 (the GEMV and the
tensor-core tile), through the dispatch a linear uses (marked `cuda`; skipped
where there is no GPU, since a CUDA kernel has no CPU mode). Run on a GPU
host with:

    python -m pytest tests/test_torch_cuda_packed_matmul.py -q

Tolerance: rel RMS <= 1e-4 in fp32 (sums in another order), 2e-2 in bf16
(outputs rounded to bf16)."""

import pytest
import torch

from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

CASES = [(2, 64), (3, 64), (4, 64), (6, 64), (8, 64), (4, 32), (6, 128), (3, 32)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


@pytest.mark.parametrize("m", [1, 2, 37, 130])
def test_packed_matmul_kernel(dev, m):
    """The GEMV (M <= pm.M0) and the tensor-core tile (37 and 130
    rows, ragged O = 200 columns, split K, K = 352 at group 32) at every
    width; two calls give the same bits (the split-K sum is fixed-order)."""
    g = torch.Generator(device=dev).manual_seed(m)
    o = 200
    for bits, gs in CASES:
        k = 352 if gs == 32 else 384  # at 352, half of the last 64-column K step
        words = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
        s = torch.rand(o, k // gs, generator=g, device=dev) * 1e-2
        b = torch.randn(o, k // gs, generator=g, device=dev) * 0.1
        for biases in (b, None):
            entry = {"wq": words, "scales": s}
            if biases is not None:
                entry["biases"] = biases
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                before = pm.launches
                got = pm.quantized_matmul(x, entry)
                assert pm.launches == before + 1
                ref = pm.packed_matmul_plain(x, words, s, biases, bits, gs)
                err = rel_rms(got.float(), ref.float())
                assert err <= tol, (bits, gs, biases is None, dtype, err)
                assert torch.equal(pm.quantized_matmul(x, entry), got)
