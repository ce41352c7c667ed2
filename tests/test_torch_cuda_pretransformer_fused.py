"""K4a (the per-head pre-transformer, csrc/pretransformer.cu) against its
plain PyTorch version and against K4 on the same weights, on the card
(marked `cuda`; skipped where there is no GPU, since a CUDA kernel has no
CPU mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_pretransformer_fused.py -q

Shapes: head_dim 64 and 128; T = 1, 26, 110, and 300 (above the rows whose
q/k/v fit in shared memory, so the fp32 path's global-scratch store runs);
fp32 and bf16 weights. Tolerance: rel RMS <= 1e-4 in fp32 (sums in another
order), 2e-2 with bf16 weights and a bf16 output (the plain versions round
where the kernel does). With bf16 weights K4a is K4's persistent launch
reading the per-head arrays in place: one device kernel a call, and at
head_dim 64 its output equals K4's bit for bit."""

import ctypes

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


def test_persistent_fused_kernel_equals_k4_bit_for_bit(dev):
    c = cfg(64)
    pt = random_vocoder_params(c, seed=5, device=dev)["pre_transformer"]
    kp = ptk.build_pretransformer_fused_params(pt, c, torch.bfloat16)
    packed = ptk.build_pretransformer_params(pt, c, torch.bfloat16)
    kw = dict(nh=c.num_attention_heads, hd=64, eps=c.rms_norm_eps)
    g = torch.Generator(device=dev).manual_seed(2)
    for b, t in ((1, 1), (1, 26), (2, 110), (1, 300)):
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, t, c.latent_dim, generator=g, device=dev).to(xdt)
            got = ptk.pre_transformer_fused(kp, x, **kw)
            assert torch.equal(got, ptk.pre_transformer_kernel(packed, x, **kw)), (b, t, xdt)


def graph_nodes(call) -> list[int]:
    """The node types (0 = a kernel) of a CUDA graph captured from one call:
    the device work it launches, read from the driver rather than from
    torch.profiler, which may lose a kernel's record late in a process
    (chip_smoke.py's one_kernel_per_call)."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    drv = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def test_persistent_fused_kernel_is_one_device_kernel(dev):
    """bf16 weights: one kernel a call; fp32 weights: the launch sequence,
    3 + 8 nl kernels."""
    c = cfg(64)
    pt = random_vocoder_params(c, seed=6, device=dev)["pre_transformer"]
    x = torch.randn(1, 110, c.latent_dim, device=dev)
    kw = dict(nh=c.num_attention_heads, hd=64, eps=c.rms_norm_eps)
    for dt, kernels in ((torch.bfloat16, 1), (torch.float32, 3 + 8 * c.num_hidden_layers)):
        kp = ptk.build_pretransformer_fused_params(pt, c, dt)
        before = ptk.fused_launches
        assert graph_nodes(lambda: ptk.pre_transformer_fused(kp, x, **kw)) == [0] * kernels, dt
        assert ptk.fused_launches == before + 2  # the call before the capture, and the capture
