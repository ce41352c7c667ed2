"""Quantization for the PyTorch port.

Copies of the numpy quantizers in qwen3_tts_tpu/ops/quant.py (tests pin them
equal): the int8 group affine scheme of K3,

  w[o, i] ~= scales[o, i // G] * q[o, i] + biases[o, i // G],  q uint8,

the rowwise signed int8 scheme of the megakernels K1/K2 (W8A8),

  w[o, i] ~= s[o] * q[o, i] + m[o],  q int8 in [-127, 127],
  y[o] = sx * s[o] * (xq . q[o]) + m[o] * (sx * sum(xq)),

with x ~= sx * xq quantized symmetrically per row, and MLX's packed-bit
group-affine scheme of K7 (pre-quantized checkpoints and the mixed 4/6-bit
runtime mode),

  w[o, i] ~= scales[o, i // G] * q[o, i] + biases[o, i // G],
  q an unsigned `bits`-bit value, bits in {2, 3, 4, 6, 8},

stored per output row as a little-endian bitstream of uint32 words (3- and
6-bit values cross word boundaries). The TPU kernel-layout repacks (`w8_kl`,
`wq_kl` lane permutations) are not copied: the CUDA kernels read plain
[out, in] rows.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_VALID_BITS = (2, 3, 4, 6, 8)
# numpy frees the GIL in its array work, so the numpy quantizers below split
# a large weight's rows into blocks, a thread each (_row_blocks). Each row
# is quantized on its own, so the result is the same bits either way.
_THREADS = min(8, os.cpu_count() or 1)
_BLOCK_VALUES = 1 << 20  # the fewest values of the first array worth a thread


def _row_blocks(fn, *arrays):
    """fn(*arrays), where every array and every output of fn hold the same
    rows on axis 0: run on blocks of rows, one a thread, and concatenated."""
    n = min(_THREADS, arrays[0].size // _BLOCK_VALUES, arrays[0].shape[0])
    if n <= 1:
        return fn(*arrays)
    blocks = zip(*(np.array_split(a, n) for a in arrays))
    with ThreadPoolExecutor(n) as pool:
        parts = list(pool.map(lambda b: fn(*b), blocks))
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p) for p in zip(*parts))
    return np.concatenate(parts)


def _check(bits: int, group_size: int, in_dim: int) -> None:
    if bits not in _VALID_BITS:
        raise ValueError(f"unsupported bits: {bits}")
    if in_dim % group_size != 0:
        raise ValueError(f"in_dim {in_dim} not divisible by group_size {group_size}")
    if (in_dim * bits) % 32 != 0:
        raise ValueError(f"in_dim {in_dim} * bits {bits} must be a multiple of 32")


def _period(bits: int) -> tuple[int, int]:
    """(values, words) of the shortest run of whole words that holds whole
    values: 32 // bits values in one word where bits divides 32, else 32
    values in `bits` words (6 bits: 16 values in 3 words)."""
    per = 32 // math.gcd(32, bits)
    return per, per * bits // 32


def pack_bits_np(q: np.ndarray, bits: int) -> np.ndarray:
    """Unsigned values [..., N] -> little-endian bitstream of uint32 words
    [..., N * bits / 32], a run of _period's words at a time: value j of a
    run goes to bit j * bits of the run, its high bits into the next word
    where it crosses one (the uint32 shift drops them from this word)."""
    q = np.asarray(q, dtype=np.uint32)
    n = q.shape[-1]
    assert (n * bits) % 32 == 0
    per, nw = _period(bits)
    vals = q.reshape(*q.shape[:-1], n // per, per)
    out = np.zeros((*vals.shape[:-1], nw), np.uint32)
    for j in range(per):
        w, s = divmod(j * bits, 32)
        out[..., w] |= vals[..., j] << np.uint32(s)
        if s + bits > 32:
            out[..., w + 1] |= vals[..., j] >> np.uint32(32 - s)
    return out.reshape(*q.shape[:-1], n * bits // 32)


def unpack_bits_np(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Little-endian uint32 bitstream [..., W] -> uint32 values [..., n]."""
    packed = np.asarray(packed, dtype=np.uint32)
    mask = np.uint32((1 << bits) - 1)
    if 32 % bits == 0:
        per = 32 // bits
        shifts = (np.arange(per, dtype=np.uint32) * bits)[None, :]
        vals = (packed[..., None] >> shifts) & mask
        return vals.reshape(*packed.shape[:-1], packed.shape[-1] * per)[..., :n]
    # a run of _period's words at a time, as pack_bits_np writes them; the
    # stream is padded with zero words to whole runs
    per, nw = _period(bits)
    pad = -packed.shape[-1] % nw
    if pad:
        packed = np.concatenate([packed, np.zeros((*packed.shape[:-1], pad), np.uint32)], -1)
    words = packed.reshape(*packed.shape[:-1], -1, nw)
    out = np.empty((*words.shape[:-1], per), np.uint32)
    for j in range(per):
        w, s = divmod(j * bits, 32)
        v = words[..., w] >> np.uint32(s)
        if s + bits > 32:
            v |= words[..., w + 1] << np.uint32(32 - s)
        out[..., j] = v & mask
    return out.reshape(*packed.shape[:-1], -1)[..., :n]


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
    scales = np.asarray(scales, dtype=np.float32).reshape(out_dim, in_dim // group_size)
    if biases is None:
        biases = np.zeros_like(scales)
    else:
        biases = np.asarray(biases, dtype=np.float32).reshape(
            out_dim, in_dim // group_size
        )

    def rows(packed, scales, biases):
        q = unpack_bits_np(packed, bits, in_dim).astype(np.float32)
        q = q.reshape(len(q), in_dim // group_size, group_size)
        w = scales[..., None] * q + biases[..., None]
        return w.reshape(len(q), in_dim).astype(dtype)

    return _row_blocks(rows, np.asarray(packed), scales, biases)


def quantize_np(
    w: np.ndarray, bits: int = 4, group_size: int = 64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine-quantize a float weight [out, in] -> (packed uint32, scales,
    biases), scales / biases fp32 [out, in / group]; q = round((w - min) /
    scale)."""
    w = np.asarray(w, dtype=np.float32)
    _check(bits, group_size, w.shape[1])

    def rows(w):
        g = w.reshape(w.shape[0], w.shape[1] // group_size, group_size)
        w_min = g.min(axis=-1)
        w_max = g.max(axis=-1)
        denom = float(2**bits - 1)
        scales = (w_max - w_min) / denom
        scales = np.where(scales <= 1e-12, 1.0, scales).astype(np.float32)
        biases = w_min.astype(np.float32)
        q = np.clip(np.round((g - biases[..., None]) / scales[..., None]), 0, denom)
        return pack_bits_np(q.astype(np.uint32).reshape(w.shape), bits), scales, biases

    return _row_blocks(rows, w)


def unpack_bits_torch(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Little-endian 32-bit bitstream [..., W] (uint32 or int32 words) ->
    int32 values [..., n], on packed's device, a run of _period's words at
    a time. Values that cross a word boundary (3 and 6 bits) take their
    high bits from the next word. The words are read as int32: a right
    shift copies the sign bit down, so the bits a value takes from its own
    word are masked before the next word's are added."""
    words = packed.view(torch.int32)
    mask = (1 << bits) - 1
    per, nw = _period(bits)
    if nw == 1:
        shifts = torch.arange(per, device=packed.device, dtype=torch.int32) * bits
        vals = (words[..., None] >> shifts) & mask
        return vals.reshape(*packed.shape[:-1], packed.shape[-1] * per)[..., :n]
    runs = torch.nn.functional.pad(words, (0, -words.shape[-1] % nw))
    runs = runs.reshape(*runs.shape[:-1], -1, nw)
    vals = []
    for j in range(per):
        w, s = divmod(j * bits, 32)
        v = runs[..., w] >> s
        if s + bits > 32:
            v = (v & ((1 << (32 - s)) - 1)) | (runs[..., w + 1] << (32 - s))
        vals.append(v & mask)
    return torch.stack(vals, -1).reshape(*runs.shape[:-2], -1)[..., :n]


def dequantize_torch(
    packed: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor | None,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """Packed rows [out, in * bits / 32] -> fp32 [out, in], as s * q + b in
    fp32; missing biases count as zero."""
    out_dim = packed.shape[0]
    in_dim = packed.shape[1] * 32 // bits
    q = unpack_bits_torch(packed, bits, in_dim).float()
    q = q.reshape(out_dim, in_dim // group_size, group_size)
    w = scales.float()[..., None] * q
    if biases is not None:
        w = w + biases.float()[..., None]
    return w.reshape(out_dim, in_dim)


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
    if w.shape[1] % group_size != 0:
        raise ValueError(f"in_dim {w.shape[1]} not divisible by group {group_size}")

    def rows(w):
        g = w.reshape(w.shape[0], w.shape[1] // group_size, group_size)
        w_min = g.min(axis=-1)
        w_max = g.max(axis=-1)
        scales = np.maximum((w_max - w_min) / 255.0, 1e-12).astype(np.float32)
        biases = w_min.astype(np.float32)
        q = np.clip(np.round((g - biases[..., None]) / scales[..., None]), 0, 255)
        return q.reshape(w.shape).astype(np.uint8), scales, biases

    return _row_blocks(rows, w)


def _quantize_int8_entry(entry: dict, group_size: int) -> dict:
    """Dense {"w"[, "b"]} -> {"w8", "scales", "biases"[, "b"]}, leading
    (stacked) axes kept: their rows are quantized as one matrix."""
    w = np.asarray(entry["w"], np.float32)
    q, scales, biases = quantize_int8_np(w.reshape(-1, w.shape[-1]), group_size)
    out = {"w8": q.reshape(w.shape), "scales": scales.reshape(*w.shape[:-1], -1),
           "biases": biases.reshape(*w.shape[:-1], -1)}
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


# The mixed 4/6-bit scheme: these entries at 6 bits, every other quantizable
# one at 4, group 64
_SIX_BIT_NAMES = ("qkv_proj", "codec_head", "lm_head")


def _quantize_linear_entry(entry: dict, bits: int, group_size: int) -> dict:
    """Dense {"w"[, "b"]} -> packed {"wq", "scales", "biases"[, "b"]}, leading
    (stacked) axes kept: their rows are quantized as one matrix."""
    w = np.asarray(entry["w"], np.float32)
    packed, scales, biases = quantize_np(w.reshape(-1, w.shape[-1]), bits, group_size)
    out = {"wq": packed.reshape(*w.shape[:-1], -1),
           "scales": scales.reshape(*w.shape[:-1], -1),
           "biases": biases.reshape(*w.shape[:-1], -1)}
    if "b" in entry:
        out["b"] = entry["b"]
    return out


def apply_mixed_quantization(params: dict, group_size: int = 64) -> dict:
    """The reference's runtime mixed quantization of a talker / code-predictor
    tree: 6-bit qkv projections and heads, 4-bit everything else, the
    embedding tables and stacked cp tables included; entries whose input
    width does not pack stay dense (as in the JAX package)."""
    linear_paths = {
        "text_projection": ("fc1", "fc2"),
        "layers": ("qkv_proj", "o_proj", "gateup_proj", "down_proj"),
    }

    def quantized(entry: dict, name: str) -> dict:
        bits = 6 if name in _SIX_BIT_NAMES else 4
        in_dim = np.asarray(entry["w"]).shape[-1]
        if in_dim % group_size or (in_dim * bits) % 32:
            return entry
        return _quantize_linear_entry(entry, bits, group_size)

    out = dict(params)
    for group, names in linear_paths.items():
        if group not in out:
            continue
        sub = dict(out[group])
        for name in names:
            if name in sub and "w" in sub[name]:
                sub[name] = quantized(sub[name], name)
        out[group] = sub
    for name in ("codec_head", "small_to_mtp_projection",
                 "text_embedding", "codec_embedding", "lm_head"):
        if name in out and "w" in out[name]:
            out[name] = quantized(out[name], name)
    return out


def quantize_rowwise_int8_np(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-row signed int8 affine quantization, w ~= s[o] * q[o, :] +
    m[o] with q in [-127, 127] (rounding half to even, as numpy does);
    leading axes are kept (rows = last-but-one axis). The megakernels'
    weight format."""
    w = np.asarray(w, np.float32)

    def rows(w):
        mx = w.max(axis=-1)
        mn = w.min(axis=-1)
        scale = np.maximum((mx - mn) / 254.0, 1e-12).astype(np.float32)
        mid = ((mx + mn) / 2.0).astype(np.float32)
        q = np.clip(np.round((w - mid[..., None]) / scale[..., None]), -127, 127)
        return q.astype(np.int8), scale, mid

    q, scale, mid = _row_blocks(rows, w.reshape(-1, w.shape[-1]))
    return q.reshape(w.shape), scale.reshape(w.shape[:-1]), mid.reshape(w.shape[:-1])


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
