"""K7: packed-bit group-affine matmul (CUDA kernel csrc/packed_matmul.cu).

Counterpart of qwen3_tts_tpu/ops/pallas/quant_matmul.py::
quantized_matmul_pallas / quantized_matmul: y = x @ dequant(wq).T with wq
the MLX row-major little-endian bitstream (uint32 [O, K * bits / 32]),
fp32 scales / biases [O, K / gs] (missing biases count as zero), dequant as
s * q + b and accumulation in fp32, output in x's dtype. The kernel takes
bits 2, 3, 4, 6, 8 and group sizes 32, 64, 128 on the checkpoint's own rows:
no lane-permuted copy, no cap on M. One launch a call: the GEMV of
csrc/qmm_gemv.cuh (shared with K3) at M <= M0 rows, the tensor-core tile
of csrc/qmm_tile.cuh above.
"""

from __future__ import annotations

import torch

from ..quant import dequantize_torch
from . import _build, qmm_tile

BITS = (2, 3, 4, 6, 8)
GROUP_SIZES = (32, 64, 128)
# M <= M0 rows run the GEMV (csrc/qmm_gemv.cuh, shared with K3), more the
# tile: the largest M at which the GEMV at 4 bits, timed cold and summed
# over the serving step's and the text projection's shapes, is faster than
# the tile there and at every smaller M of the sweep (M = 1, 2, 3, 4, 8,
# 16: chip_smoke.py's m0_sweep, which logs its M0 beside this one; PERF.md)
M0 = 16
launches = 0  # kernel launches since the last reset


def packed_matmul_plain(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor | None,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """Plain PyTorch version: x [M, K] -> [M, O], fp32 dequant and matmul."""
    w = dequantize_torch(wq, scales, biases, bits, group_size)
    return (x.float() @ w.T).to(x.dtype)


def packed_matmul_kernel(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor | None,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on x [M, K] (fp32 or bf16) -> [M, O]."""
    global launches
    m, k = x.shape
    o = wq.shape[0]
    if bits not in BITS or group_size not in GROUP_SIZES or k % group_size:
        raise ValueError(f"packed kernel takes bits {BITS} and group sizes {GROUP_SIZES} "
                         f"with K % group == 0; got bits={bits} group={group_size} K={k}")
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    _build.require(wq, "wq", dtype=(torch.uint32, torch.int32), shape=(o, k * bits // 32))
    _build.require(scales, "scales", dtype=torch.float32, shape=(o, k // group_size))
    if biases is not None:
        _build.require(biases, "biases", dtype=torch.float32, shape=(o, k // group_size))
    if wq.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("x and wq must be 16-byte aligned")
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    m0, ks, part, cnt = qmm_tile.launch_args(x, o, group_size, bits, M0)
    rc = _build.lib().qt_packed_matmul(
        x.data_ptr(), _build.is_bf16(x), wq.data_ptr(), bits, group_size,
        scales.data_ptr(), _build.ptr(biases), y.data_ptr(), m, o, k, m0, ks,
        _build.ptr(part), _build.ptr(cnt), _build.stream(),
    )
    _build.check(rc, "qt_packed_matmul")
    with _build.COUNT_LOCK:
        launches += 1
    return y


def quantized_matmul(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Dispatch for a packed linear entry {"wq", "scales"[, "biases"]} over
    any leading dims of x. Bits and group size come from x's width (as the
    JAX package's `linear` derives them). A CUDA tensor runs the kernel at
    any M (or raises on a width it does not take); a CPU tensor runs the
    plain version."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wq, s, b = params["wq"], params["scales"], params.get("biases")
    k = x2.shape[-1]
    bits, gs = wq.shape[-1] * 32 // k, k // s.shape[-1]
    if x2.is_cuda:
        x2 = x2.contiguous()
        if x2.data_ptr() % 16:
            x2 = x2.clone()
        y = packed_matmul_kernel(x2, wq, s, b, bits, gs)
    else:
        y = packed_matmul_plain(x2, wq, s, b, bits, gs)
    return y.reshape(*lead, wq.shape[0])
