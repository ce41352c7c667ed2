"""The port's rowwise int8 (W8A8) quantization and its `w8r` linear / table
branches against the JAX package, on the CPU with seeded numpy inputs.

Tolerances: the quantizers and the kernel-view helpers are copies, so they
must agree exactly; W8A8 products agree to 1e-6 relative (the integer dot is
exact on both sides, the fp32 epilogue may round differently by an ulp);
the `w8r` products are fp32 matmuls summed in another order, 1e-5."""

import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import cp_megakernel as jcpk
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_rowwise_quantizer_and_dense_entries_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 64)).astype(np.float32)
    w[0, 5] = 0.25  # a constant row: the scale floor
    for a, b in zip(tquant.quantize_rowwise_int8_np(w), jquant.quantize_rowwise_int8_np(w)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wq, scales, biases = jquant.quantize_np(w[2], bits=4, group_size=32)
    entries = [
        {"w": w[0]},
        tquant._quantize_int8_entry({"w": w[1]}, 64),
        {"wq": wq, "scales": scales, "biases": biases, "g32": np.zeros((0,), np.float32)},
    ]
    for e in entries:
        np.testing.assert_array_equal(tquant.dense_entry_np(e), jcpk.dense_entry_np(e))


def test_w8a8_plain_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 256)) * 2.0).astype(np.float32)
    x[1] = 0.0  # a zero row quantizes to zeros
    q, s, m = jquant.quantize_rowwise_int8_np(rng.standard_normal((96, 256)).astype(np.float32))
    xq_t, sx_t = tquant.quantize_act_sym(torch.from_numpy(x))
    xq_j, sx_j = jquant.quantize_act_sym_jnp(jnp.asarray(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j, np.float32))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx_j))
    got = tquant.w8a8_linear_plain(torch.from_numpy(x), torch.from_numpy(q),
                                   torch.from_numpy(s), torch.from_numpy(m))
    ref = jquant.w8a8_linear_ref(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(m))
    assert rel(got.numpy(), ref) <= 1e-6


def test_w8r_linear_and_table_branches_match_jax():
    rng = np.random.default_rng(2)
    q, s, m = jquant.quantize_rowwise_int8_np(rng.standard_normal((3, 50, 64)).astype(np.float32))
    jent = {"w8r": jnp.asarray(q), "s": jnp.asarray(s[..., None, :]),
            "m": jnp.asarray(m[..., None, :])}
    tent = {"w8r": torch.from_numpy(q), "s": torch.from_numpy(s[..., None, :]),
            "m": torch.from_numpy(m[..., None, :])}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for k in range(3):
        lay_t = {kk: v[k] for kk, v in tent.items()}
        lay_j = {kk: v[k] for kk, v in jent.items()}
        assert rel(tlinear.linear(lay_t, torch.from_numpy(x)).numpy(),
                   jlinear.linear(lay_j, jnp.asarray(x))) <= 1e-5
        assert rel(tlinear.table_matmul(tent, k, torch.from_numpy(x[0])).numpy(),
                   jlinear.table_matmul(jent, jnp.int32(k), jnp.asarray(x[0]))) <= 1e-5
    codes = np.array([3, 49, 0])
    assert rel(tlinear.table_row(tent, 1, torch.from_numpy(codes)).numpy(),
               jlinear.table_row(jent, jnp.int32(1), jnp.asarray(codes))) <= 1e-6
    ids = np.array([[0, 7], [49, 1]])
    emb_t = {kk: v[2] for kk, v in tent.items()}
    emb_j = {kk: v[2] for kk, v in jent.items()}
    assert rel(tlinear.embedding_lookup(emb_t, torch.from_numpy(ids)).numpy(),
               jlinear.embedding_lookup(emb_j, jnp.asarray(ids))) <= 1e-6


def test_kernel_views_alias_the_kernel_tensors():
    assert tquant.KERNEL_SHARED_LINS == jquant.KERNEL_SHARED_LINS
    kt = {f"qkv_{k}": torch.zeros(2, 3) for k in "qsm"}
    view = tquant.kernel_w8r_view(kt, "qkv")
    assert view["w8r"] is kt["qkv_q"] and view["s"] is kt["qkv_s"] and view["m"] is kt["qkv_m"]
