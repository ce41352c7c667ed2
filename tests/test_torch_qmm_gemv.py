"""The GEMV of K3 and K7 at M <= M0 (csrc/qmm_gemv.cuh), on the CPU: its
plan (ops/cuda/qmm_gemv.py) covers each (row, output, chunk) of a call once,
so each (row, output, group) once, at the 0.6B shapes and at ragged ones;
a torch mirror of its arithmetic order (w = s q + b in fp32, each thread's
chunks summed in order, the butterfly over a warp's lanes, the warps' sums
in warp order) against the Pallas K3 in interpret mode and against JAX's
K7 reference on the same seeded numpy inputs, at M = 1, 3 and 8 and at K
splits below, at and past one warp; the byte-permute unpack, every q at
every position exact; and the staged x's swizzle, which puts the 8 threads
of a shared-memory phase on 8 distinct bank groups.

Tolerance (rel max, as tests/test_torch_qmm_tile.py): 1e-5 for x whose
values are bf16, 1e-4 for fp32 x: the mirror and the references compute
the same dequantized weights and differ only in the order of fp32 sums."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops.pallas.quant_matmul import (
    quantized_matmul_int8_pallas,
    repack_int8_for_kernel,
)
from qwen3_tts_tpu.ops.quant import pack_bits_np, quantized_matmul_ref
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops.cuda import qmm_gemv

torch.set_num_threads(1)
HEADER = os.path.join(os.path.dirname(qmm_gemv.__file__), "..", "..", "csrc", "qmm_gemv.cuh")

# (K, O): the 0.6B linears: qkv, o, gate/up, down, codec head, cp lm head,
# text fc1, fc2
SHAPES_06B = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 3072),
              (1024, 2048), (2048, 2048), (2048, 1024)]
# (M, O, K, bf16 x): those at M = 1, 3 and 8 (gate/up also at 16), and
# ragged ones (O = 200; K = 320, 352 and 384; a K of 384 chunks, past 256
# lanes)
CASES = ([(m, o, k, True) for m in (1, 3, 8) for k, o in SHAPES_06B]
         + [(16, 6144, 1024, True), (1, 200, 320, False), (3, 200, 352, True),
            (8, 200, 384, False), (2, 200, 384, True), (5, 200, 320, False),
            (16, 200, 352, True), (1, 40, 12288, True)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_covers_each_row_output_and_group_once(case):
    m, o, k, xb = case
    c = k // 32
    p = qmm_gemv.plan(m, o, k, xb)
    assert p.lanes == min(qmm_gemv.NT, 1 << (c - 1).bit_length()) and p.chunks == c
    assert p.r == qmm_gemv.outputs(p.mt) and p.mt in (1, 2, 4, qmm_gemv.MAX_ROWS)
    assert qmm_gemv.smem_bytes(m, k, p.mt, xb) <= qmm_gemv.SMEM_BLOCK
    # at the K split the plan does not take, too (below, at and past a warp)
    for q in [p] + [qmm_gemv.with_lanes(m, o, k, xb, lanes) for lanes in (8, 32, 128)
                    if lanes != p.lanes]:
        seen = np.zeros((m, o, c), np.int64)
        tid = np.arange(qmm_gemv.NT)
        for by in range(q.by):
            for bx in range(q.bx):
                first, m0, mt, chunks = qmm_gemv.thread_work(q, m, bx, by, tid)
                for i in range(q.r):
                    out = first + i
                    for n in range(chunks.shape[1]):
                        ok = (out < o) & (chunks[:, n] >= 0)
                        for r in range(mt):
                            np.add.at(seen, (m0 + r, out[ok], chunks[ok, n]), 1)
        assert (seen == 1).all()
    # a chunk lies in one group at every group size, so each (row, output,
    # group) is covered once too
    for gs in (32, 64, 128):
        if k % gs == 0:
            groups = (np.arange(c) * 32) // gs
            assert ((np.arange(c) * 32 + 31) // gs == groups).all()


def close(got, ref, rel):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def x_cases(rng, m, k):
    """(x for the mirror, the same values in fp32 for JAX, rel tolerance)."""
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    xb = x.bfloat16()
    return [(xb, xb.float().numpy(), 1e-5), (x, x.numpy(), 1e-4)]


def mirrors(x, w, o):
    """The mirror at the plan's K split and at splits below, at and past
    one warp (8, 32, 128 lanes)."""
    m, k = x.shape
    xb = x.dtype == torch.bfloat16
    lanes = sorted({qmm_gemv.plan(m, o, k, xb).lanes, 8, 32, 128})
    return [qmm_gemv.gemv_mirror(x, w, qmm_gemv.with_lanes(m, o, k, xb, n)) for n in lanes]


@pytest.mark.parametrize("m", [1, 3, 8])
def test_mirror_matches_pallas_int8_and_jax_packed_reference(m):
    rng = np.random.default_rng(m)
    # K3: the uint8 rows are the 8-bit words the kernel reads; w = s q + b
    for o, k in ((256, 192), (64, 2048)):
        w = (rng.standard_normal((o, k)) * 0.05).astype(np.float32)
        w8, s, b = tquant.quantize_int8_np(w, 64)
        deq = (torch.from_numpy(w8.astype(np.float32)).reshape(o, k // 64, 64)
               * torch.from_numpy(s)[..., None] + torch.from_numpy(b)[..., None]).reshape(o, k)
        for xt, xref, rel in x_cases(rng, m, k):
            # waited for at once: an interpret-mode call returns before its
            # host callbacks finish, and no other JAX dispatch should race them
            ref = jax.block_until_ready(quantized_matmul_int8_pallas(
                jnp.asarray(xref), jnp.asarray(repack_int8_for_kernel(w8, 64)), jnp.asarray(s),
                jnp.asarray(b), group_size=64, tile_out=128, interpret=True,
            ))
            for got in mirrors(xt, deq, o):
                close(got, ref, rel)

    # K7 at 2, 3, 4 and 6 bits, groups 32 and 128, with biases and without
    o, k = 200, 512
    for bits, gs, biased in ((3, 32, True), (4, 128, True), (6, 32, False), (2, 128, True)):
        words = pack_bits_np(rng.integers(0, 2 ** bits, (o, k)), bits)
        s = (rng.random((o, k // gs)) * 1e-2).astype(np.float32)
        b = (rng.standard_normal((o, k // gs)) * 1e-2).astype(np.float32) if biased else None
        deq = tquant.dequantize_torch(torch.from_numpy(words.view(np.int32)), torch.from_numpy(s),
                                      None if b is None else torch.from_numpy(b), bits, gs)
        for xt, xref, rel in x_cases(rng, m, k):
            ref = quantized_matmul_ref(jnp.asarray(xref), jnp.asarray(words), jnp.asarray(s),
                                       jnp.zeros_like(jnp.asarray(s)) if b is None
                                       else jnp.asarray(b), bits=bits, group_size=gs)
            for got in mirrors(xt, deq.float(), o):
                close(got, ref, rel)


def test_header_constants_unpack_and_x_swizzle():
    src = open(HEADER).read()
    assert re.search(r"constexpr int QG_NT = (\d+);", src).group(1) == str(qmm_gemv.NT)
    assert re.search(r"constexpr int QG_MAX_ROWS = (\d+);", src).group(1) == str(
        qmm_gemv.MAX_ROWS)
    assert "return mt > 2 ? 4 : 2;" in src  # qmm_gemv.outputs
    assert "return !xb || mt == 1;" in src  # qmm_gemv.staged_f32
    assert "return F32 ? c & 7 : (c >> 1) & 3;" in src  # qmm_gemv.swizzle
    # the byte-permute unpack gives every q at every position of a chunk
    for bits in (4, 8):
        n_val = 2 ** bits
        q = np.array([[(v + j) % n_val for v in range(32)] for j in range(n_val)], np.uint32)
        words = pack_bits_np(q, bits)
        got = np.stack([qmm_gemv.q_float(words, bits, v) for v in range(32)], -1)
        assert np.array_equal(got, q.astype(np.float32))
    for f32, ppc in ((True, 8), (False, 4)):
        for start in range(0, 64, 8):
            for p in range(ppc):
                # piece p of 8 consecutive chunks: 16-byte slots within a
                # 128-byte bank row, all distinct
                slots = [(c * ppc + (p ^ qmm_gemv.swizzle(c, f32))) % 8
                         for c in range(start, start + 8)]
                assert sorted(slots) == list(range(8))
        for c in range(16):  # the swizzle permutes each chunk's pieces
            assert sorted(p ^ qmm_gemv.swizzle(c, f32) for p in range(ppc)) == list(range(ppc))
