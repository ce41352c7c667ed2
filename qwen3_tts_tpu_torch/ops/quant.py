"""Group-affine quantization on the host (numpy), for the PyTorch port.

Copies of the numpy quantizers in qwen3_tts_tpu/ops/quant.py (tests pin them
equal): the int8 affine scheme the runtime uses,

  w[o, i] ~= scales[o, i // G] * q[o, i] + biases[o, i // G],  q uint8,

and the packed-bit unpack/dequant that dequantize-on-load checkpoints need.
The TPU kernel-layout repack (`w8_kl` lane permutation) is not copied: the
CUDA kernel reads the plain [out, in] uint8 rows.
"""

from __future__ import annotations

import numpy as np

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
