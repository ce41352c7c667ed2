"""K3: int8 group-affine matmul (CUDA kernel csrc/quant_matmul.cu).

Counterpart of qwen3_tts_tpu/ops/pallas/quant_matmul.py::
quantized_matmul_int8_pallas / int8_matmul: y = x @ (scales * w8 + biases).T
with uint8 weights [O, K], fp32 scales/biases [O, K/64], dequant and
accumulation in fp32, output in x's dtype. One launch a call: the GEMV of
csrc/qmm_gemv.cuh at M <= M0 rows, the tensor-core tile of
csrc/qmm_tile.cuh above.
"""

from __future__ import annotations

import torch

from . import _build, qmm_tile

GROUP = 64
# M <= M0 rows run the GEMV (csrc/qmm_gemv.cuh), more the tile: the
# largest M at which the GEMV, timed cold and summed over the serving
# step's shapes (qkv, o, gate/up, down, codec head, cp lm head) and the text
# projection's (fc1, fc2), is faster than the tile there and at every
# smaller M of the sweep (M = 1, 2, 3, 4, 8, 16: chip_smoke.py's m0_sweep,
# which logs its M0 beside this one; PERF.md). At 16 the GEMV still wins
# (its 8-row blocks read the weights twice); the sweep stops there.
M0 = 16
launches = 0  # kernel launches since the last reset


def int8_matmul_plain(
    x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: x [M, K] -> [M, O], fp32 dequant and matmul."""
    o, k = w8.shape
    g = scales.shape[-1]
    w = w8.float().reshape(o, g, k // g)
    w = w * scales.float()[..., None] + biases.float()[..., None]
    return (x.float() @ w.reshape(o, k).T).to(x.dtype)


def int8_matmul_kernel(
    x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel on x [M, K] (fp32 or bf16) -> [M, O]."""
    global launches
    m, k = x.shape
    o = w8.shape[0]
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    _build.require(w8, "w8", dtype=torch.uint8, shape=(o, k))
    _build.require(scales, "scales", dtype=torch.float32, shape=(o, k // GROUP))
    _build.require(biases, "biases", dtype=torch.float32, shape=(o, k // GROUP))
    if k % GROUP:
        raise ValueError(f"int8 kernel needs K % {GROUP} == 0, got K={k}")
    if w8.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("x and w8 must be 16-byte aligned")
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    m0, ks, part, cnt = qmm_tile.launch_args(x, o, GROUP, 8, M0)
    rc = _build.lib().qt_int8_matmul(
        x.data_ptr(), _build.is_bf16(x), w8.data_ptr(), scales.data_ptr(),
        biases.data_ptr(), y.data_ptr(), m, o, k, m0, ks, _build.ptr(part),
        _build.ptr(cnt), _build.stream(),
    )
    _build.check(rc, "qt_int8_matmul")
    with _build.COUNT_LOCK:
        launches += 1
    return y


def int8_matmul(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Dispatch for an int8 linear entry {"w8", "scales", "biases"} over any
    leading dims of x: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    w8, s, b = params["w8"], params["scales"], params["biases"]
    if x2.is_cuda:
        if s.shape[-1] * GROUP != x2.shape[-1]:
            raise ValueError(
                f"int8 kernel needs group size {GROUP}; scales {tuple(s.shape)} "
                f"for K={x2.shape[-1]}"
            )
        x2 = x2.contiguous()
        if x2.data_ptr() % 16:
            x2 = x2.clone()
        y = int8_matmul_kernel(x2, w8, s, b)
    else:
        y = int8_matmul_plain(x2, w8, s, b)
    return y.reshape(*lead, w8.shape[0])
