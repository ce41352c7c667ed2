"""The tensor-core tile of K3 and K7 at M > M0 (csrc/qmm_tile.cuh), on the
CPU: its plan (ops/cuda/qmm_tile.py) covers each output tile and each
group-aligned K run once; a torch mirror of its arithmetic order (the
prologue's unpack of q into bf16, x_hi / x_lo for fp32 x, per group P and X
folded as s P + b X, the split-K partials added in the order 0..ks-1)
against the Pallas K3 in interpret mode and against JAX's K7 reference on
the same seeded numpy inputs; and the prologue's unpack giving every q at
every width exactly in bf16.

Tolerance (rel max, as tests/test_torch_quant_matmul.py): 1e-5 for x whose
values are bf16 (every product exact, fp32 sums in another order); 1e-4
for fp32 x (x_lo leaves ~2^-17 of x, ~1e-5 of the result)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops.pallas.quant_matmul import (
    quantized_matmul_int8_pallas,
    repack_int8_for_kernel,
)
from qwen3_tts_tpu.ops.quant import pack_bits_np, quantized_matmul_ref, unpack_bits_np
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops.cuda import qmm_tile

torch.set_num_threads(1)
SMS = 132  # an H100's SMs
SMEM_BLOCK = 232_448  # shared memory a block may opt into on an H100

# (M, N, K, group, bits, bf16 x): the 0.6B calls past M0 (text fc1 / fc2
# at 114 rows, gate/up and qkv at 300) and ragged ones
SHAPES = [(114, 2048, 2048, 64, 8, True), (114, 1024, 2048, 64, 8, True),
          (114, 2048, 2048, 64, 4, True), (300, 6144, 1024, 64, 8, True),
          (300, 6144, 1024, 64, 4, True), (300, 4096, 1024, 64, 6, False),
          (9, 200, 320, 64, 8, False), (37, 200, 352, 32, 3, True),
          (130, 200, 384, 128, 6, False), (300, 200, 384, 32, 2, True),
          (65, 3072, 3072, 128, 4, False), (16, 6144, 1024, 64, 8, True)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plan_covers_each_tile_and_k_run_once(shape):
    m, n, k, gs, bits, xb = shape
    for sms in (SMS, 1, 7):
        p = qmm_tile.plan(m, n, k, gs, bits, xb, sms)
        assert qmm_tile.smem_bytes(bits, xb) <= SMEM_BLOCK
        assert 1 <= p.ks <= min(p.units, qmm_tile.MAX_SPLIT)
        out = np.zeros((m, n), np.int64)
        runs = np.zeros((p.tiles, -(-k // 32)), np.int64)  # 32-column slices of K
        for it in range(p.blocks):
            tile, split, m0, n0, k0, k1 = qmm_tile.item(p, m, n, k, it)
            assert k0 < k1 and k0 % max(gs, 64) == 0 and (k1 % gs == 0)
            if split == 0:
                out[m0:m0 + qmm_tile.BM, n0:n0 + qmm_tile.BN] += 1
            runs[tile, k0 // 32:k1 // 32] += 1
        assert (out == 1).all() and (runs == 1).all()


def unpack_chunks(words: np.ndarray, bits: int) -> np.ndarray:
    """The prologue (qt_unpack_q, qm_q_f32, qm_pack_hi): words [..., C * bits] of
    32-value chunks -> the bf16 bit patterns [..., C * 32] of q."""
    w = words.astype(np.uint64).reshape(*words.shape[:-1], -1, bits)
    out = []
    for v in range(32):
        bit = v * bits
        wi, off = bit >> 5, bit & 31
        u = w[..., wi] >> np.uint64(off)
        if off + bits > 32:
            u |= w[..., min(wi + 1, bits - 1)] << np.uint64(32 - off)
        q = (u & np.uint64((1 << bits) - 1)).astype(np.uint32)
        f = (np.uint32(0x4B000000) | q).view(np.float32) - np.float32(8388608.0)
        out.append(f.view(np.uint32) >> 16)
    return np.stack(out, -1).reshape(*words.shape[:-1], -1).astype(np.uint16)


def bf16_value(bits16: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits16.view(np.int16)).view(torch.bfloat16)


def tile_mirror(x: torch.Tensor, words: np.ndarray, bits: int, s: np.ndarray,
                b: np.ndarray | None, gs: int) -> torch.Tensor:
    """The kernel's arithmetic order in fp32: q from the prologue exact in
    bf16; bf16 x as it is, fp32 x as bf16(x) + bf16(x - bf16(x)); per group
    P = x q^T and X = sum x, folded acc += s P + b X; with the plan's K runs
    each run's sum a partial, the partials added in the order 0..ks-1."""
    m, k = x.shape
    n = words.shape[0]
    q = bf16_value(unpack_chunks(words, bits)).float()  # [n, k]
    if x.dtype == torch.bfloat16:
        parts = [x.float()]
    else:
        hi = x.bfloat16().float()
        parts = [hi, (x - hi).bfloat16().float()]
    s, b = torch.from_numpy(s), None if b is None else torch.from_numpy(b)
    p = qmm_tile.plan(m, n, k, gs, bits, x.dtype == torch.bfloat16, SMS)
    y = torch.zeros(m, n)
    for split in range(p.ks):
        k0, k1 = qmm_tile.item(p, m, n, k, split * p.tiles)[4:]
        acc = torch.zeros(m, n)
        for g in range(k0 // gs, k1 // gs):
            sl = slice(g * gs, (g + 1) * gs)
            pg = sum(xp[:, sl] @ q[:, sl].T for xp in parts)
            xg = sum(xp[:, sl].sum(-1, keepdim=True) for xp in parts)
            acc = acc + (s[:, g] * pg + (0.0 if b is None else b[:, g] * xg))
        y = y + acc
    return y


def close(got, ref, rel):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def x_cases(rng, m, k):
    """(x for the mirror, the same values in fp32 for JAX, rel tolerance):
    bf16 x, and fp32 x."""
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    xb = x.bfloat16()
    return [(xb, xb.float().numpy(), 1e-5), (x, x.numpy(), 1e-4)]


@pytest.mark.parametrize("m", [9, 37])
def test_mirror_matches_pallas_int8_and_jax_packed_reference(m):
    rng = np.random.default_rng(m)
    # K3: the uint8 rows are the 8-bit words the kernel reads
    o, k = 256, 192
    w = (rng.standard_normal((o, k)) * 0.05).astype(np.float32)
    w8, s, b = tquant.quantize_int8_np(w, 64)
    for xt, xref, rel in x_cases(rng, m, k):
        # waited for at once: an interpret-mode call returns before its host
        # callbacks finish, and no other JAX dispatch should race them
        ref = jax.block_until_ready(quantized_matmul_int8_pallas(
            jnp.asarray(xref), jnp.asarray(repack_int8_for_kernel(w8, 64)), jnp.asarray(s),
            jnp.asarray(b), group_size=64, tile_out=128, interpret=True,
        ))
        close(tile_mirror(xt, w8.view(np.uint32), 8, s, b, 64), ref, rel)

    # K7 at 3 and 6 bits (the Pallas K7 takes 2 / 4 / 8 only), no biases
    o, k = 200, 256
    for bits in (3, 6):
        for gs in (32, 128):
            words = pack_bits_np(rng.integers(0, 2 ** bits, (o, k)), bits)
            s = (rng.random((o, k // gs)) * 1e-2).astype(np.float32)
            for xt, xref, rel in x_cases(rng, m, k):
                ref = quantized_matmul_ref(jnp.asarray(xref), jnp.asarray(words), jnp.asarray(s),
                                           jnp.zeros_like(jnp.asarray(s)), bits=bits, group_size=gs)
                close(tile_mirror(xt, words, bits, s, None, gs), ref, rel)


@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_prologue_unpacks_every_q_exactly_in_bf16(bits):
    # every value at every position of a 32-value chunk
    n_val = 2 ** bits
    q = np.array([(v + j) % n_val for j in range(n_val) for v in range(32)], np.uint32)
    words = pack_bits_np(q[None], bits)
    got = bf16_value(unpack_chunks(words, bits))[0]
    assert torch.equal(got.float(), torch.from_numpy(q.astype(np.float32)))
    assert np.array_equal(unpack_bits_np(words, bits, q.size)[0], q)
    # the port's packer writes the same words
    assert np.array_equal(tquant.pack_bits_np(q[None], bits), words)
