"""The GEMV behind K3 and K7 at M <= M0 rows (csrc/qmm_gemv.cuh; each
wrapper holds its own M0): its plan, in pure Python so that a CPU test can
check it, and a torch mirror of its arithmetic order.

A call cuts the O outputs into groups of R consecutive outputs (R = 2 where
a block holds <= 2 rows of x, 4 above) and K into C = K / 32 chunks of 32
values; L threads ("lanes", the plan's K split, which the C entries take
as `ks`) share a group, thread j taking chunks j, j + L, j + 2L, ... A
block of NT threads holds NT / L groups; blocks along y take MT rows of x
each. `thread_work` mirrors the kernel's mapping of a thread to its
outputs, rows and chunks; `gemv_mirror` its order of fp32 operations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

NT = 256  # threads a block (QG_NT)
MAX_ROWS = 8  # rows of x a block (QG_MAX_ROWS)
SMEM_BLOCK = 232_448  # shared memory an H100 block may opt into


def outputs(mt: int) -> int:
    """qg_outputs: outputs a thread owns at a block of mt rows."""
    return 4 if mt > 2 else 2


def staged_f32(mt: int, x_bf16: bool) -> bool:
    """qg_f32: x staged as fp32 (one row, or fp32 x), else as bf16."""
    return not x_bf16 or mt == 1


def smem_bytes(m: int, k: int, mt: int, x_bf16: bool) -> int:
    """qg_smem_bytes: the block's staged rows of x, then the warps' partial
    sums."""
    es = 4 if staged_f32(mt, x_bf16) else 2
    return min(m, mt) * k * es + NT // 32 * outputs(mt) * mt * 4


def row_tile(m: int, k: int, x_bf16: bool, smem: int = SMEM_BLOCK) -> int:
    """qg_row_tile: the rows of x a block takes (the kernel's MT)."""
    mt = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else MAX_ROWS
    while mt > 1 and smem_bytes(m, k, mt, x_bf16) > smem:
        mt //= 2
    return mt


@dataclass(frozen=True)
class Plan:
    lanes: int  # L: threads a group of R outputs (the K split, passed as ks)
    r: int  # R: outputs a thread
    mt: int  # rows of x a block
    chunks: int  # C: 32-value chunks of K
    bx: int  # blocks along the outputs
    by: int  # blocks along the rows

    @property
    def groups(self) -> int:  # groups a block
        return NT // self.lanes

    @property
    def blocks(self) -> int:
        return self.bx * self.by

    @property
    def ks(self) -> int:
        return self.lanes


def with_lanes(m: int, o: int, k: int, x_bf16: bool, lanes: int) -> Plan:
    """The call [m, k] x [o, k]^T with the K split L = lanes."""
    mt = row_tile(m, k, x_bf16)
    r = outputs(mt)
    return Plan(lanes, r, mt, k // 32, -(-o // (r * (NT // lanes))), -(-m // mt))


@functools.lru_cache(maxsize=None)
def plan(m: int, o: int, k: int, x_bf16: bool) -> Plan:
    """The GEMV plan of one call: L the row's chunks, as a power of two of
    at most NT, so that each thread takes one chunk a row and the call's
    loads all go out at once (the K split of scripts/torch_qmm_gemv_sweep.py:
    fewer lanes serialise a thread's loads, more leave lanes idle)."""
    c = k // 32
    return with_lanes(m, o, k, x_bf16, min(NT, 1 << max(0, (c - 1).bit_length())))


def thread_work(p: Plan, m: int, block_x: int, block_y: int, tid: np.ndarray):
    """Thread tid's work in block (block_x, block_y), as qt_qmm_gemv_kernel
    computes it, for an array of tids: (first output [T], first row, rows,
    chunks [T, n]: the chunk of each iteration, -1 where the thread has
    none). Its outputs are first .. first + R - 1 below O."""
    grp, j = tid // p.lanes, tid % p.lanes
    first = (block_x * p.groups + grp) * p.r
    m0 = block_y * p.mt
    its = -(-p.chunks // p.lanes)
    c = j[:, None] + p.lanes * np.arange(its)[None, :]
    return first, m0, min(p.mt, m - m0), np.where(c < p.chunks, c, -1)


def swizzle(c: int, f32: bool) -> int:
    """qg_swz: the slot of chunk c's 16-byte piece p is p ^ swizzle(c)."""
    return c & 7 if f32 else (c >> 1) & 3


def q_float(words: np.ndarray, bits: int, v: int) -> np.ndarray:
    """qg_q at 4 and 8 bits: value v of 32-value chunks of `bits` words
    [..., bits] as the kernel forms it, 2^23 + q by a byte permute, less
    2^23, in fp32."""
    if bits == 8:
        byte = (words[..., v >> 2] >> np.uint32(8 * (v & 3))) & np.uint32(0xFF)
    else:
        w = words[..., v >> 3]
        half = ((w >> np.uint32(4)) if v & 1 else w) & np.uint32(0x0F0F0F0F)
        byte = (half >> np.uint32(8 * ((v >> 1) & 3))) & np.uint32(0xFF)
    u = (np.uint32(0x4B000000) | byte.astype(np.uint32)).view(np.float32)
    return u - np.float32(8388608.0)


def gemv_mirror(x: torch.Tensor, w: torch.Tensor, p: Plan) -> torch.Tensor:
    """The GEMV's order of fp32 operations on x [M, K] and the dequantized
    weights w [O, K] (s * q + b in fp32): per thread j of a group the sum
    of its chunks' dot products in chunk order; the group's L sums by the
    butterfly over min(L, 32) lanes (offsets down to 1); where L > 32 the
    warps' sums in warp order. Returns [M, O] fp32 (before the store's cast
    to x's dtype)."""
    m, k = x.shape
    o = w.shape[0]
    c, lanes = p.chunks, p.lanes
    xc = x.float().reshape(m, c, 32)
    wc = w.float().reshape(o, c, 32)
    dots = torch.einsum("mcv,ocv->cmo", xc, wc)  # each chunk's dot product
    partial = torch.zeros(lanes, m, o)
    for it in range(-(-c // lanes)):  # a thread's chunks, in order
        n = min(lanes, c - it * lanes)
        partial[:n] = partial[:n] + dots[it * lanes:it * lanes + n]
    width = min(lanes, 32)
    warps = partial.reshape(lanes // width, width, m, o)
    lane = torch.arange(width)
    d = width // 2
    while d:
        warps = warps + warps[:, lane ^ d]
        d //= 2
    y = torch.zeros(m, o)
    for s in range(warps.shape[0]):
        y = y + warps[s, 0]
    return y
