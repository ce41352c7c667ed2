"""The tensor-core tile behind K3 and K7 at M > M0 rows (csrc/qmm_tile.cuh;
each wrapper holds its own M0):
its plan, in pure Python so that a CPU test can check it, and the launch
arguments the two wrappers hand their C entries (the GEMV's plan at M <=
M0 is ops/cuda/qmm_gemv.py's).

A call cuts the [M, N] output into tiles of BM = 64 rows by BN = 128
columns, and K into `ks` runs of whole units (a unit is one K step of 64
columns, two at group size 128, so a run never splits a quant group); tiles
x ks blocks run as one launch. `item` mirrors the kernel's mapping of a
block to its tile and K run.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import persistent, qmm_gemv
from ._build import is_bf16

BM, BN, BK, STAGES, LD = 64, 128, 64, 4, 72
SMEM_SM = 233_472  # an H100 SM's shared memory (228 KB); a block reserves 1 KB more
MAX_SPLIT = 16
# split_k's cost model, in K steps of a block (fitted to the K-split sweep of
# scripts/torch_qmm_compare.py on the H100, PERF.md): a block's fixed cost
# (launch, ring fill, staged store) and the fix-up's cost per partial
ITEM_STEPS = 5
FIX_STEPS = 0.5


@dataclass(frozen=True)
class Plan:
    mt: int  # row tiles
    nt: int  # column tiles
    ks: int  # K runs a tile
    unit_k: int  # K columns of a unit
    units: int  # units of K

    @property
    def tiles(self) -> int:
        return self.mt * self.nt

    @property
    def blocks(self) -> int:
        return self.tiles * self.ks


def smem_bytes(bits: int, x_bf16: bool) -> int:
    """QmLayout<BITS, x_bf16>::SMEM: per ring stage the x rows, the raw
    weights and the scales / biases of two groups, and the bf16 tile."""
    x = BM * LD * (2 if x_bf16 else 4)
    return STAGES * (x + BN * 8 * bits + 4 * BN * 4) + BN * LD * 2


def blocks_per_sm(bits: int, x_bf16: bool) -> int:
    """Resident blocks an SM holds: the launch bounds allow 2, shared
    memory may allow 1."""
    return max(1, min(2, SMEM_SM // (smem_bytes(bits, x_bf16) + 1024)))


def split_k(tiles: int, units: int, unit_steps: int, slots: int) -> int:
    """K runs a tile is cut into: the least of the blocks' waves over the
    card's block slots (at least one) times a block's steps plus
    ITEM_STEPS, plus FIX_STEPS a partial where K is split; ties to fewer
    runs."""
    def cost(ks):
        fix = ks * FIX_STEPS if ks > 1 else 0.0
        return max(1.0, tiles * ks / slots) * (-(-units // ks) * unit_steps + ITEM_STEPS) + fix

    return min(range(1, min(units, MAX_SPLIT) + 1), key=lambda ks: (cost(ks), ks))


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, gs: int, bits: int, x_bf16: bool, sms: int) -> Plan:
    """The tile plan of one call [m, k] x [n, k]^T on a card of `sms` SMs."""
    mt, nt = -(-m // BM), -(-n // BN)
    unit_k = max(gs, BK)
    units = -(-k // unit_k)
    ks = split_k(mt * nt, units, unit_k // BK, sms * blocks_per_sm(bits, x_bf16))
    return Plan(mt, nt, ks, unit_k, units)


def item(p: Plan, m: int, n: int, k: int, it: int) -> tuple[int, int, int, int, int, int]:
    """Block `it`'s (tile, K run, first row, first column, K begin, K end),
    as qt_qmm_tile_kernel computes them: the row tiles of one column slice
    are adjacent, the K run is the slow index."""
    tile, split = it % p.tiles, it // p.tiles
    m0, n0 = (tile % p.mt) * BM, (tile // p.mt) * BN
    u0, u1 = split * p.units // p.ks, (split + 1) * p.units // p.ks
    return tile, split, m0, n0, u0 * p.unit_k, min(u1 * p.unit_k, k)


@functools.lru_cache(maxsize=None)
def _sms(index: int | None) -> int:
    return persistent.sm_count(torch.device("cuda", index))


def launch_args(x: torch.Tensor, n: int, gs: int, bits: int, m0: int):
    """(m0, ks, part, cnt) for a C entry on x [M, K]: the GEMV's bound (the
    wrapper's M0); for M <= m0 the GEMV's K split (qmm_gemv.plan's lanes),
    for M > m0 the tile's with its split-K workspace and counters (None
    where ks == 1). The caller keeps `part` alive over the launch."""
    m, k = x.shape
    if m <= m0:
        return m0, qmm_gemv.plan(m, n, k, bool(is_bf16(x))).ks, None, None
    p = plan(m, n, k, gs, bits, bool(is_bf16(x)), _sms(x.device.index))
    if p.ks == 1:
        return m0, 1, None, None
    part = torch.empty(p.ks * m * n, dtype=torch.float32, device=x.device)
    return m0, p.ks, part, persistent.counters(x.device, p.tiles)
