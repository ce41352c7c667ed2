"""Launch plans of the persistent megakernels K1 (csrc/talker_step.cu) and K2
(csrc/cp_frame.cu), and the grid-barrier measurement.

Each call of K1 or K2 is one cooperative launch of one block of PK_NT
threads per SM (csrc/w8a8.cuh). Every GEMV phase gives block b the output
rows row_span(O, grid, b); the block streams its rows of the phases ahead
into two shared-memory buffers, so the dynamic shared memory is sized here
from the largest span (capped at BUF_CAP bytes a buffer: a larger span is
fetched in tiles). The attention phase splits each kv head's cache into
chunks (attention_split). The grid size is the SM count, once the
occupancy query on the kernel says one block fits on an SM with that much
shared memory, and that the plan fits the kernel's shared-memory limit
on the device; both are cached per device. A failed query raises.
`grid_barriers` times the barrier alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

PK_NT = 512  # threads per block (w8a8.cuh)
BUF_CAP = 64 * 1024  # bytes per weight buffer
MAX_SLOTS = 32  # cache slots a block stages per attention chunk
ALIGN = 128


class Plan(ctypes.Structure):
    """Mirror of QtPlan in csrc/w8a8.cuh."""

    _fields_ = _build.struct_fields(
        "grid:i smem:i buf:i xf:i lnf:i xq:i xrow:i att:i nch:i S:i")


def block_items(items: int, grid: int, block: int) -> range:
    """The items a block takes in a phase of K4's or K5's persistent
    kernel: round robin from its index."""
    return range(block, items, grid)


def row_span(rows: int, grid: int, block: int) -> tuple[int, int]:
    """Block `block`'s output rows [lo, hi) of a GEMV phase (qt_span)."""
    return block * rows // grid, (block + 1) * rows // grid


def att_floats(group: int, hd: int, slots: int) -> int:
    """fp32 words of the attention scratch, as qt_attention_phase
    (csrc/w8a8.cuh) carves it: cos | sin, q, k, v, their pre-RoPE rows,
    scores, per-head stats, the chunk's K and V, a flag."""
    return 2 * hd + (2 * group + 3) * hd + group * slots + 4 * group + 2 * slots * hd + 4


def attention_split(n_slots: int, nkv: int, grid: int) -> tuple[int, int]:
    """(chunks per kv head, slots per chunk) of the talker's ring cache:
    about 16 slots a chunk, at most one item per block where that fits,
    at most MAX_SLOTS slots a chunk."""
    nch = max(1, min(grid // nkv, -(-n_slots // 16)), -(-n_slots // MAX_SLOTS))
    return nch, max(1, -(-n_slots // nch))


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def layer_phases(hc: int, nq: int, nkv: int, hd: int, inter: int) -> list[tuple[int, int]]:
    """(K, O) of a decoder layer's four GEMVs: qkv, o, gate/up, down."""
    return [(hc, (nq + 2 * nkv) * hd), (nq * hd, hc), (hc, 2 * inter), (inter, hc)]


def make_plan(phases, grid: int, hc: int, group: int, hd: int, nch: int, slots: int) -> Plan:
    """Shared-memory layout for GEMV phases [(K, O)] over `grid` blocks."""
    for k, _ in phases:
        if k % 16:
            raise ValueError(f"GEMV width {k} is not a multiple of 16")
    if hd % 8 or hd > 256 or group * nch > slots * hd:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 up to 256, and the "
                         f"combine's {group} x {nch} chunk weights fit in {slots} x {hd}")
    kmax = max(k for k, _ in phases)
    span = max(-(-o // grid) * k for k, o in phases)
    buf = _align(max(min(span, BUF_CAP), kmax))
    xf = 2 * buf
    lnf = xf + _align(4 * kmax)
    xq = lnf + _align(4 * kmax)
    xrow = xq + _align(kmax)
    att = xrow + _align(4 * hc)
    smem = att + 4 * att_floats(group, hd, slots)
    return Plan(grid=grid, smem=smem, buf=buf, xf=xf, lnf=lnf, xq=xq, xrow=xrow, att=att, nch=nch,
                S=slots)


@functools.lru_cache(maxsize=None)
def _grid(entry: str, device: int, smem: int) -> int:
    """Blocks of a cooperative launch of `entry`'s kernel (qt_*_grid); raises
    where `smem` bytes exceed what a block of it may use on the device."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(getattr(_build.lib(), entry)(smem, ctypes.byref(blocks)), entry)
    return blocks.value


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def _talker_plan(device: int, sms: int, hc, nq, nkv, hd, inter, vocab, c_len) -> Plan:
    nch, slots = attention_split(c_len, nkv, sms)
    plan = make_plan(layer_phases(hc, nq, nkv, hd, inter) + [(hc, vocab)], sms, hc,
                     nq // nkv, hd, nch, slots)
    plan.grid = _grid("qt_talker_grid", device, plan.smem)
    return plan


def talker_plan(config, c_len: int, device: torch.device) -> Plan:
    """K1's plan for `config` and a ring of c_len slots."""
    c = config
    return _talker_plan(_index(device), sm_count(device), c.hidden_size,
                        c.num_attention_heads, c.num_key_value_heads, c.head_dim,
                        c.intermediate_size, c.vocab_size, c_len)


@functools.lru_cache(maxsize=None)
def _cp_plan(device: int, sms: int, hc, nq, nkv, hd, inter, vocab, groups) -> Plan:
    plan = make_plan(layer_phases(hc, nq, nkv, hd, inter) + [(hc, vocab)], sms, hc,
                     nq // nkv, hd, 1, groups)
    plan.grid = _grid("qt_cp_grid", device, plan.smem)
    return plan


def cp_plan(config, device: torch.device) -> Plan:
    """K2's plan for a code-predictor `config` (one chunk of num_code_groups
    slots per kv head)."""
    c = config
    return _cp_plan(_index(device), sm_count(device), c.hidden_size, c.num_attention_heads,
                    c.num_key_value_heads, c.head_dim, c.intermediate_size, c.vocab_size,
                    c.num_code_groups)


_COUNTERS: dict = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """[n] int32 zeros for the attention combine, one set per device and
    stream (launches on one stream run in order; each leaves them at 0)."""
    key = (_index(device), _build.stream())
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        t = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def require_aligned(kp: dict, names) -> None:
    """The int8 trees are read with bulk copies: 16-byte aligned bases."""
    for name in names:
        if kp[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def grid_barriers(n: int, device: torch.device | None = None) -> None:
    """One cooperative launch that runs n grid barriers of K1 / K2's kind
    (csrc/grid_barrier.cu) on the current stream: a measurement entry
    point, on no model path."""
    dev = torch.device("cuda") if device is None else device
    grid = _grid("qt_grid_barrier_grid", _index(dev), 0)
    _build.check(_build.lib().qt_grid_barriers(n, grid, 0, _build.stream()), "qt_grid_barriers")
