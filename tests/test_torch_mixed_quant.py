"""The port's mixed 4/6-bit quantization and packed-bit helpers pinned to
the JAX package's: apply_mixed_quantization, quantize_np and pack_bits_np
equal to the originals; the torch unpack at 3 and 6 bits (values that cross
word boundaries) equal to numpy's and jnp's; packed embedding_lookup and
table_row against JAX's (rel max 1e-6: the same fp32 dequant, rounded
alike)."""

import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in b:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_mixed_quantization_and_packing_pinned_to_the_jax_package():
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {
        "text_embedding": {"w": w(40, 128)},
        "codec_embedding": {"w": w(3, 50, 64)},  # stacked cp tables
        "lm_head": {"w": w(3, 50, 64)},
        "text_projection": {"fc1": {"w": w(128, 128), "b": w(128)},
                            "fc2": {"w": w(64, 128), "b": w(64)}},
        "codec_head": {"w": w(96, 64)},
        "small_to_mtp_projection": {"w": w(64, 96), "b": w(64)},  # 96: stays dense
        "norm": {"w": w(64)},
        "layers": {"qkv_proj": {"w": w(2, 128, 64)}, "o_proj": {"w": w(2, 64, 64)},
                   "gateup_proj": {"w": w(2, 256, 64)}, "down_proj": {"w": w(2, 64, 128)},
                   "input_layernorm": {"w": w(2, 64)}},
    }
    mine = tquant.apply_mixed_quantization(tree)
    assert_trees_equal(mine, jquant.apply_mixed_quantization(tree, kernel_layout=False))
    assert mine["layers"]["qkv_proj"]["wq"].shape == (2, 128, 12)  # 6 bits
    assert mine["layers"]["o_proj"]["wq"].shape == (2, 64, 8)  # 4 bits
    assert "w" in mine["small_to_mtp_projection"]
    for bits in (2, 3, 4, 6, 8):
        q = rng.integers(0, 2 ** bits, (7, 192)).astype(np.uint32)
        np.testing.assert_array_equal(tquant.pack_bits_np(q, bits), jquant.pack_bits_np(q, bits))
        src = w(5, 192)
        for a, b in zip(tquant.quantize_np(src, bits, 64), jquant.quantize_np(src, bits, 64)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_torch_unpack_crosses_word_boundaries():
    rng = np.random.default_rng(1)
    for bits in (3, 6):
        q = rng.integers(0, 2 ** bits, (2, 4, 320)).astype(np.uint32)
        packed = jquant.pack_bits_np(q, bits)
        got = tquant.unpack_bits_torch(torch.from_numpy(packed), bits, 320).numpy()
        np.testing.assert_array_equal(got, q)
        np.testing.assert_array_equal(got, np.asarray(jquant.unpack_bits_jnp(
            jnp.asarray(packed), bits, 320)))
        np.testing.assert_array_equal(got, tquant.unpack_bits_np(packed, bits, 320))


def test_packed_lookups_match_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 50, 128)) * 0.05).astype(np.float32)
    for bits, gs in ((4, 64), (6, 64), (4, 32)):
        packed = [jquant.quantize_np(wi, bits, gs) for wi in w]
        stacked = {k: np.stack([p[i] for p in packed])
                   for i, k in enumerate(("wq", "scales", "biases"))}
        if gs != 64:
            stacked[f"g{gs}"] = np.zeros((3, 0), np.int8)
        tent = {k: torch.from_numpy(v) for k, v in stacked.items()}
        jent = {k: jnp.asarray(v) for k, v in stacked.items()}
        codes = np.array([3, 49, 0])
        assert rel(tlinear.table_row(tent, 1, torch.from_numpy(codes)).numpy(),
                   jlinear.table_row(jent, 1, jnp.asarray(codes))) <= 1e-6
        code = np.array(17)  # a 0-d code, as the frame loop passes it
        assert rel(tlinear.table_row(tent, 2, torch.from_numpy(code)).numpy(),
                   jlinear.table_row(jent, 2, jnp.asarray(code))) <= 1e-6
        ids = np.array([[0, 7], [49, 1]])
        tab_t = {k: v[0] for k, v in tent.items()}
        tab_j = {k: v[0] for k, v in jent.items()}
        got = tlinear.embedding_lookup(tab_t, torch.from_numpy(ids), torch.float32)
        assert got.shape == (2, 2, 128)
        assert rel(got.numpy(), jlinear.embedding_lookup(tab_j, jnp.asarray(ids),
                                                         jnp.float32)) <= 1e-6


def test_wide_rows_pinned_to_the_jax_package():
    """At the 1.7B widths (K = 2048, 6144) every width's words cross word
    boundaries the way they do in a checkpoint (3 and 6 bits: 32 and 16
    values in 3 words), and the numpy quantizers split a weight of 2 M
    values or more into row blocks on threads: pack_bits_np, unpack_bits_np,
    quantize_np, dequantize_np and the int8 quantizers equal the JAX
    package's, and the mixed tree of a stacked weight equals JAX's."""
    rng = np.random.default_rng(3)
    for bits in (2, 3, 4, 6, 8):
        for k in (2048, 6144):
            q = rng.integers(0, 2 ** bits, (3, k)).astype(np.uint32)
            packed = tquant.pack_bits_np(q, bits)
            np.testing.assert_array_equal(packed, jquant.pack_bits_np(q, bits))
            np.testing.assert_array_equal(tquant.unpack_bits_np(packed, bits, k), q)
            np.testing.assert_array_equal(tquant.unpack_bits_np(packed[:, :-1], bits, k // 2),
                                          jquant.unpack_bits_np(packed[:, :-1], bits, k // 2))
    w = (rng.standard_normal((1200, 2048)) * 0.05).astype(np.float32)  # 3 row blocks
    assert w.size // tquant._BLOCK_VALUES >= 2
    for bits in (4, 6):
        mine, ref = tquant.quantize_np(w, bits, 64), jquant.quantize_np(w, bits, 64)
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tquant.dequantize_np(*mine, bits, 64),
                                      jquant.dequantize_np(*ref, bits, 64))
    for a, b in zip(tquant.quantize_int8_np(w), jquant.quantize_int8_np(w)):
        np.testing.assert_array_equal(a, b)
    stacked = w.reshape(2, 600, 2048)
    for a, b in zip(tquant.quantize_rowwise_int8_np(stacked),
                    jquant.quantize_rowwise_int8_np(stacked)):
        np.testing.assert_array_equal(a, b)
    tree = {"layers": {"qkv_proj": {"w": stacked}, "o_proj": {"w": stacked[:, :300]}}}
    assert_trees_equal(tquant.apply_mixed_quantization(tree),
                       jquant.apply_mixed_quantization(tree, kernel_layout=False))
