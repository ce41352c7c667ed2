"""Functional linear layer and table lookups over dense or int8 params.

Param dict conventions (as in qwen3_tts_tpu/ops/linear.py):
  dense: {"w": [out, in], optional "b": [out]}
  int8:  {"w8": uint8 [out, in], "scales"/"biases": fp32 [out, in/64],
          optional "b": [out]}
  w8r:   {"w8r": int8 [out, in], "s"/"m": fp32 [1, out]}, the megakernels'
         rowwise int8 weights (ops/quant.py), read here as views of the
         kernel trees so prefill holds no second copy
Stacked table sets carry a leading group axis. int8 linears and stacked
lm_heads go through the K3 kernel (ops/cuda/quant_matmul.py) on the card;
`w8r` entries are plain large products (torch.matmul on the int8 values cast
to x's dtype, with the dequant folded into the output: y*s + m*sum(x)).
Packed `wq` entries need the packed-bit kernel K7, which this port does not
have yet: they raise NotImplementedError.
"""

from __future__ import annotations

import torch

from .cuda.quant_matmul import int8_matmul


def _unported(params: dict) -> None:
    raise NotImplementedError(
        f"weight storage {sorted(params)} is not ported: packed `wq` weights "
        "need kernel K7 (ROADMAP)"
    )


def _w8r_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ (s * q + m).T without forming the dense weight."""
    y = torch.matmul(x, params["w8r"].to(x.dtype).transpose(-1, -2)).float()
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
    elif "w" in params:
        y = x @ params["w"].to(x.dtype).T
    else:
        _unported(params)
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
    return t.index_select(0, ids.reshape(-1)).reshape(*ids.shape, *t.shape[1:])


def embedding_lookup(params: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows `ids` of a table; int8 tables dequantize only those rows."""
    if "w8r" in params:
        rows = _rows(params["w8r"], ids).float()
        out = (rows * _rows(params["s"][0], ids).float()[..., None]
               + _rows(params["m"][0], ids).float()[..., None])
    elif "w8" in params:
        out = _dequant_rows(*(_rows(params[k], ids) for k in ("w8", "scales", "biases")))
    elif "w" in params:
        out = _rows(params["w"], ids)
    else:
        _unported(params)
    return out.to(dtype) if dtype is not None else out


def table_row(entry: dict, k_idx: int, code: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row(s) `code` of table `k_idx` in a stacked table set [ng, V, D]."""
    return embedding_lookup({k: v[k_idx] for k, v in entry.items()}, code, dtype)


def table_matmul(entry: dict, k_idx: int, x: torch.Tensor) -> torch.Tensor:
    """x @ table[k_idx].T for a stacked table set (the code predictor's
    per-group lm_heads); int8 tables run K3 on the group's rows."""
    if "w8r" in entry:
        return _w8r_linear({k: v[k_idx] for k, v in entry.items()}, x)
    if "w8" in entry:
        return int8_matmul(x, {
            "w8": entry["w8"][k_idx], "scales": entry["scales"][k_idx],
            "biases": entry["biases"][k_idx],
        })
    if "w" in entry:
        return x @ entry["w"][k_idx].to(x.dtype).T
    _unported(entry)
