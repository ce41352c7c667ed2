"""Functional linear layer and table lookups over dense or quantized params.

Param dict conventions (as in qwen3_tts_tpu/ops/linear.py):
  dense:  {"w": [out, in], optional "b": [out]}
  int8:   {"w8": uint8 [out, in], "scales"/"biases": fp32 [out, in/64],
           optional "b": [out]}
  packed: {"wq": uint32 [out, in*bits/32], "scales": fp32 [out, in/G],
           optional "biases" [out, in/G], optional "b": [out]}: MLX's
           bitstream (ops/quant.py), bits and G derived from the shapes; an
           optional zero-size "g<N>" marker key records a group size N != 64
  w8r:    {"w8r": int8 [out, in], "s"/"m": fp32 [1, out]}, the megakernels'
           rowwise int8 weights (ops/quant.py), read here as views of the
           kernel trees so prefill holds no second copy
Stacked table sets carry a leading group axis. int8 linears and stacked
lm_heads go through the K3 kernel (ops/cuda/quant_matmul.py) on the card,
packed ones through K7 (ops/cuda/packed_matmul.py); `w8r` entries are plain
large products (fp32 GEMMs of bf16-valued operands, exact whether or not
TF32 is allowed, _w8r_linear, with the dequant folded into the output:
y*s + m*sum(x)). Table lookups gather the
requested rows and dequantize only those, in torch.
"""

from __future__ import annotations

import torch

from .cuda.packed_matmul import quantized_matmul
from .cuda.quant_matmul import int8_matmul
from .quant import dequantize_torch, derive_packed_dims


def _bf16_parts(x: torch.Tensor) -> torch.Tensor:
    """[3, ..., K] fp32 parts of fp32 x, each bf16-valued, that sum to x
    exactly: each takes the next 8 bits of the 24-bit significand, and
    each remainder is exact in fp32."""
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return torch.stack([hi, mid, r - mid])


def _w8r_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ (s * q + m).T without forming the dense weight. The product
    x @ q.T is exact fp32 arithmetic, as the JAX package asks for it
    (preferred_element_type=float32), whatever a process-wide precision
    flag says and without reading or writing one: every operand is
    bf16-valued (int8 weights; x as itself when bf16, else as three exact
    bf16 parts, _bf16_parts), so it is exact in TF32 too, and a GEMM
    multiplies exactly and sums in fp32 with TF32 allowed or not. The
    parts' products are summed in fp32, then the dequant y*s + m*sum(x);
    only the result is cast to x's dtype."""
    q = params["w8r"].float().transpose(-1, -2)
    if x.dtype == torch.bfloat16:
        y = x.float() @ q
    else:
        y = (_bf16_parts(x.float()) @ q).sum(0)
    s = params["s"][..., 0, :].float()
    m = params["m"][..., 0, :].float()
    xsum = x.float().sum(-1, keepdim=True)
    return (y * s + m * xsum).to(x.dtype)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W.T (+ b)."""
    if "w8r" in params:
        y = _w8r_linear(params, x)
    elif "w8" in params:
        y = int8_matmul(x, params)
    elif "wq" in params:
        y = quantized_matmul(x, params)
    else:
        y = x @ params["w"].to(x.dtype).T
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _dequant_rows(rows8, scales, biases) -> torch.Tensor:
    """uint8 rows [..., D] with per-group scales/biases [..., G] -> fp32."""
    d = rows8.shape[-1]
    g = scales.shape[-1]
    r = rows8.float().reshape(*rows8.shape[:-1], g, d // g)
    out = r * scales.float()[..., None] + biases.float()[..., None]
    return out.reshape(*rows8.shape[:-1], d)


def _rows(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """t[ids] through index_select: indexing with a 0-d device tensor would
    read it back to the host."""
    return t.index_select(0, ids.reshape(-1)).reshape(ids.shape + t.shape[1:])


def _packed_rows(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of a packed table, dequantized in fp32."""
    bits, gs, in_dim = derive_packed_dims(params)
    wq = params["wq"].view(torch.int32)  # index_select on 32-bit words
    rows = dequantize_torch(
        _rows(wq, ids).reshape(-1, wq.shape[-1]),
        _rows(params["scales"], ids).reshape(-1, params["scales"].shape[-1]),
        (_rows(params["biases"], ids).reshape(-1, params["biases"].shape[-1])
         if "biases" in params else None),
        bits, gs,
    )
    return rows.reshape(*ids.shape, in_dim)


def embedding_lookup(params: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows `ids` of a table; quantized tables dequantize only those rows."""
    if "w8r" in params:
        rows = _rows(params["w8r"], ids).float()
        out = (rows * _rows(params["s"][0], ids).float()[..., None]
               + _rows(params["m"][0], ids).float()[..., None])
    elif "w8" in params:
        out = _dequant_rows(*(_rows(params[k], ids) for k in ("w8", "scales", "biases")))
    elif "wq" in params:
        out = _packed_rows(params, ids)
    else:
        out = _rows(params["w"], ids)
    return out.to(dtype) if dtype is not None else out


def table_row(entry: dict, k_idx: int, code: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row(s) `code` of table `k_idx` in a stacked table set [ng, V, D]."""
    return embedding_lookup({k: v[k_idx] for k, v in entry.items()}, code, dtype)


def table_matmul(entry: dict, k_idx: int, x: torch.Tensor) -> torch.Tensor:
    """x @ table[k_idx].T for a stacked table set (the code predictor's
    per-group lm_heads); int8 tables run K3 and packed tables K7 on the
    group's rows."""
    group = {k: v[k_idx] for k, v in entry.items()}
    if "w8r" in entry:
        return _w8r_linear(group, x)
    if "w8" in entry:
        return int8_matmul(x, group)
    if "wq" in entry:
        return quantized_matmul(x, group)
    return x @ group["w"].to(x.dtype).T
