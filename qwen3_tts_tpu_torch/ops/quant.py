"""Quantization for the PyTorch port.

Copies of the numpy quantizers in qwen3_tts_tpu/ops/quant.py (tests pin them
equal): the int8 group affine scheme of K3,

  w[o, i] ~= scales[o, i // G] * q[o, i] + biases[o, i // G],  q uint8,

the rowwise signed int8 scheme of the megakernels K1/K2 (W8A8),

  w[o, i] ~= s[o] * q[o, i] + m[o],  q int8 in [-127, 127],
  y[o] = sx * s[o] * (xq . q[o]) + m[o] * (sx * sum(xq)),

with x ~= sx * xq quantized symmetrically per row, and the packed-bit
unpack/dequant that dequantize-on-load checkpoints need. The TPU
kernel-layout repack (`w8_kl` lane permutation) is not copied: the CUDA
kernels read plain [out, in] rows.
"""

from __future__ import annotations

import numpy as np
import torch

_VALID_BITS = (2, 3, 4, 6, 8)


def _check(bits: int, group_size: int, in_dim: int) -> None:
    if bits not in _VALID_BITS:
        raise ValueError(f"unsupported bits: {bits}")
    if in_dim % group_size != 0:
        raise ValueError(f"in_dim {in_dim} not divisible by group_size {group_size}")
    if (in_dim * bits) % 32 != 0:
        raise ValueError(f"in_dim {in_dim} * bits {bits} must be a multiple of 32")


def unpack_bits_np(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Little-endian uint32 bitstream [..., W] -> uint32 values [..., n]."""
    packed = np.asarray(packed, dtype=np.uint32)
    if 32 % bits == 0:
        per = 32 // bits
        shifts = (np.arange(per, dtype=np.uint32) * bits)[None, :]
        mask = np.uint32((1 << bits) - 1)
        vals = (packed[..., None] >> shifts) & mask
        return vals.reshape(*packed.shape[:-1], packed.shape[-1] * per)[..., :n]
    shifts = np.arange(32, dtype=np.uint32)
    bit_arr = ((packed[..., None] >> shifts) & 1).astype(np.uint8)
    flat = bit_arr.reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    vals = flat[..., : n * bits].reshape(*packed.shape[:-1], n, bits)
    weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
    return (vals.astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)


def dequantize_np(
    packed: np.ndarray,
    scales: np.ndarray,
    biases: np.ndarray | None,
    bits: int = 4,
    group_size: int = 64,
    dtype=np.float32,
) -> np.ndarray:
    """Packed weights [out, in*bits/32] -> float [out, in]."""
    out_dim = packed.shape[0]
    in_dim = packed.shape[1] * 32 // bits
    _check(bits, group_size, in_dim)
    q = unpack_bits_np(packed, bits, in_dim).astype(np.float32)
    q = q.reshape(out_dim, in_dim // group_size, group_size)
    scales = np.asarray(scales, dtype=np.float32).reshape(out_dim, in_dim // group_size)
    if biases is None:
        biases = np.zeros_like(scales)
    else:
        biases = np.asarray(biases, dtype=np.float32).reshape(
            out_dim, in_dim // group_size
        )
    w = scales[..., None] * q + biases[..., None]
    return w.reshape(out_dim, in_dim).astype(dtype)


def derive_packed_dims(entry: dict) -> tuple[int, int, int]:
    """(bits, group_size, in_dim) of a packed {"wq", "scales"} entry, trying
    a "g<N>" group-size marker key first, then 64, 32, 128, 16, 256."""
    words = entry["wq"].shape[-1]
    groups = entry["scales"].shape[-1]
    hint = next(
        (
            int(k[1:])
            for k in entry
            if isinstance(k, str) and len(k) > 1 and k[0] == "g" and k[1:].isdigit()
        ),
        None,
    )
    for gs in ([hint] if hint else []) + [64, 32, 128, 16, 256]:
        in_dim = groups * gs
        if in_dim == 0 or (words * 32) % in_dim:
            continue
        bits = words * 32 // in_dim
        if bits in _VALID_BITS:
            return bits, gs, in_dim
    raise ValueError(f"cannot derive packed dims from words={words}, groups={groups}")


def quantize_int8_np(
    w: np.ndarray, group_size: int = 64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine int8 quantization with byte storage: w ~= scales * q + biases,
    q uint8 per group of `group_size` inputs."""
    w = np.asarray(w, np.float32)
    out_dim, in_dim = w.shape
    if in_dim % group_size != 0:
        raise ValueError(f"in_dim {in_dim} not divisible by group {group_size}")
    g = w.reshape(out_dim, in_dim // group_size, group_size)
    w_min = g.min(axis=-1)
    w_max = g.max(axis=-1)
    scales = np.maximum((w_max - w_min) / 255.0, 1e-12).astype(np.float32)
    biases = w_min.astype(np.float32)
    q = np.clip(np.round((g - biases[..., None]) / scales[..., None]), 0, 255)
    return q.reshape(out_dim, in_dim).astype(np.uint8), scales, biases


def _quantize_int8_entry(entry: dict, group_size: int) -> dict:
    w = np.asarray(entry["w"], np.float32)
    lead = w.shape[:-2]
    w2 = w.reshape(-1, w.shape[-2], w.shape[-1])
    q, scales, biases = zip(*(quantize_int8_np(wi, group_size) for wi in w2))
    out = {
        "w8": np.stack(q).reshape(*lead, w.shape[-2], w.shape[-1]),
        "scales": np.stack(scales).reshape(*lead, w.shape[-2], -1),
        "biases": np.stack(biases).reshape(*lead, w.shape[-2], -1),
    }
    if "b" in entry:
        out["b"] = entry["b"]
    return out


def apply_int8_quantization(params: dict, group_size: int = 64) -> dict:
    """Quantize every linear and table of a talker/code-predictor tree to
    int8 affine; entries whose input width is not a multiple of
    `group_size` stay dense (as in the JAX package)."""
    linear_paths = {
        "text_projection": ("fc1", "fc2"),
        "layers": ("qkv_proj", "o_proj", "gateup_proj", "down_proj"),
    }
    out = dict(params)
    for group, names in linear_paths.items():
        if group not in out:
            continue
        sub = dict(out[group])
        for name in names:
            if name not in sub or "w" not in sub[name]:
                continue
            if np.asarray(sub[name]["w"]).shape[-1] % group_size:
                continue
            sub[name] = _quantize_int8_entry(sub[name], group_size)
        out[group] = sub
    for name in (
        "codec_head", "small_to_mtp_projection",
        "text_embedding", "codec_embedding", "lm_head",
    ):
        if name in out and "w" in out[name]:
            if np.asarray(out[name]["w"]).shape[-1] % group_size:
                continue
            out[name] = _quantize_int8_entry(out[name], group_size)
    return out


def quantize_rowwise_int8_np(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-row signed int8 affine quantization, w ~= s[o] * q[o, :] +
    m[o] with q in [-127, 127] (rounding half to even, as numpy does);
    leading axes are kept (rows = last-but-one axis). The megakernels'
    weight format."""
    w = np.asarray(w, np.float32)
    mx = w.max(axis=-1)
    mn = w.min(axis=-1)
    scale = np.maximum((mx - mn) / 254.0, 1e-12).astype(np.float32)
    mid = ((mx + mn) / 2.0).astype(np.float32)
    q = np.clip(np.round((w - mid[..., None]) / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale, mid


# Talker / code-predictor layer linears whose entries are views of the
# megakernels' rowwise int8 buffers: (layer key, kernel prefix)
KERNEL_SHARED_LINS = (
    ("qkv_proj", "qkv"), ("o_proj", "o"),
    ("gateup_proj", "gu"), ("down_proj", "dn"),
)


def kernel_w8r_view(kernel_tree: dict, pre: str) -> dict:
    """A {"w8r", "s", "m"} linear / table entry holding the very tensors
    `pre`_q / _s / _m of a megakernel tree (no copy)."""
    return {
        "w8r": kernel_tree[f"{pre}_q"],
        "s": kernel_tree[f"{pre}_s"],
        "m": kernel_tree[f"{pre}_m"],
    }


def quantize_act_sym(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantization (the A8 of W8A8):
    x ~= sx * xq with sx = max(max|x| / 127, 1e-12), xq = clip(round(x / sx),
    -127, 127) rounded half to even. Returns (xq as fp32 integers, sx fp32
    [..., 1])."""
    x = x.float()
    sx = torch.clamp_min(x.abs().amax(-1, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(x / sx), -127, 127), sx


def w8a8_linear_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    """y = x @ (s * q + m).T with x quantized per row: the megakernels'
    W8A8 arithmetic in plain PyTorch. q int8 [O, K]; s, m fp32 [O]. The
    integer dot runs in float64, where it is exact, and is then rounded to
    fp32 as an int32 dot would be."""
    xq, sx = quantize_act_sym(x)
    acc = (xq.double() @ q.double().T).float()
    sum_xq = xq.sum(-1, keepdim=True)
    return sx * s.float() * acc + m.float() * (sx * sum_xq)


def dense_entry_np(entry: dict) -> np.ndarray:
    """A linear / table entry as a dense float32 numpy weight, from dense
    ("w"), int8 group affine ("w8") or bit-packed ("wq") storage."""
    if "w" in entry:
        return np.asarray(entry["w"], np.float32)
    if "w8" in entry:
        w8 = np.asarray(entry["w8"], np.float32)
        scales = np.asarray(entry["scales"], np.float32)
        biases = np.asarray(entry["biases"], np.float32)
        g = w8.shape[-1] // scales.shape[-1]
        r = w8.reshape(*w8.shape[:-1], scales.shape[-1], g)
        return (r * scales[..., None] + biases[..., None]).reshape(w8.shape)
    bits, gs, _ = derive_packed_dims(entry)
    wq = np.asarray(entry["wq"])
    scales = np.asarray(entry["scales"], np.float32)
    biases = np.asarray(entry["biases"], np.float32) if "biases" in entry else None
    lead = wq.shape[:-2]
    flat_wq = wq.reshape(-1, *wq.shape[-2:])
    flat_s = scales.reshape(-1, *scales.shape[-2:])
    flat_b = biases.reshape(-1, *biases.shape[-2:]) if biases is not None else None
    dense = np.stack([
        dequantize_np(flat_wq[i], flat_s[i], flat_b[i] if flat_b is not None else None,
                      bits=bits, group_size=gs)
        for i in range(flat_wq.shape[0])
    ])
    return dense.reshape(*lead, *dense.shape[-2:]).astype(np.float32)
