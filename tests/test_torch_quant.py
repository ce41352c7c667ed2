"""The port's numpy int8 quantizers pinned equal to the JAX package's, and
the int8 linear's dispatch: group rows of a stacked table, the plain version
for a CPU tensor (the kernel refuses one); a packed `wq` linear (K7's plain
version on the CPU) gives the dense weight's answer."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

torch.set_num_threads(1)
REL = 1e-5  # fp32 dequant + fp32 accumulation on both sides


def close(got, ref, rel=REL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def make(seed, o, k):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, k)) * 0.05).astype(np.float32)
    w8, s, b = tquant.quantize_int8_np(w, 64)
    return rng, w, w8, s, b


def test_numpy_quantizers_pinned_to_the_jax_package():
    _, w, w8, s, b = make(7, 64, 128)
    for mine, theirs in zip((w8, s, b), jquant.quantize_int8_np(w, 64)):
        np.testing.assert_array_equal(mine, theirs)
    rng = np.random.default_rng(8)
    tree = {
        "text_projection": {"fc1": {"w": rng.standard_normal((128, 128)).astype(np.float32),
                                    "b": np.zeros(128, np.float32)}},
        "layers": {"o_proj": {"w": rng.standard_normal((2, 64, 96)).astype(np.float32)}},
        "lm_head": {"w": rng.standard_normal((3, 32, 64)).astype(np.float32)},
    }
    mine = tquant.apply_int8_quantization(tree)
    theirs = jquant.apply_int8_quantization(tree, kernel_layout=False)
    assert "w" in mine["layers"]["o_proj"]  # 96 inputs: not a multiple of 64
    for path in (("text_projection", "fc1"), ("lm_head",), ("layers", "o_proj")):
        a, b_ = mine, theirs
        for key in path:
            a, b_ = a[key], b_[key]
        assert a.keys() == b_.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b_[key])
    packed, ps, pb = jquant.quantize_np(tree["lm_head"]["w"][0], 4, 64)
    np.testing.assert_array_equal(
        tquant.dequantize_np(packed, ps, pb, 4, 64),
        jquant.dequantize_np(packed, ps, pb, 4, 64),
    )


def test_table_matmul_routes_the_group_rows():
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((3, 40, 128)) * 0.05).astype(np.float32)
    q = tquant.apply_int8_quantization({"lm_head": {"w": w}})["lm_head"]
    entry = {k: torch.from_numpy(v) for k, v in q.items()}
    x = torch.from_numpy(rng.standard_normal((1, 128)).astype(np.float32))
    deq = tlinear._dequant_rows(entry["w8"][2], entry["scales"][2], entry["biases"][2])
    close(tlinear.table_matmul(entry, 2, x), (x @ deq.T).numpy())


def test_cpu_tensor_takes_the_plain_version_and_kernel_refuses_it():
    _, _, w8, s, b = make(11, 64, 64)
    entry = {"w8": torch.from_numpy(w8), "scales": torch.from_numpy(s),
             "biases": torch.from_numpy(b)}
    before = qm.launches
    qm.int8_matmul(torch.ones(2, 64), entry)
    assert qm.launches == before  # no kernel launch for a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        qm.int8_matmul_kernel(torch.ones(2, 64), entry["w8"], entry["scales"],
                              entry["biases"])


def test_packed_weights_are_refused():
    """Packed weights were refused before K7; now a packed linear is held
    against its dense dequantized weight."""
    rng = np.random.default_rng(12)
    w = (rng.standard_normal((4, 64)) * 0.05).astype(np.float32)
    packed, s, b = jquant.quantize_np(w, 4, 64)
    x = rng.standard_normal((1, 64)).astype(np.float32)
    dense = jquant.dequantize_np(packed, s, b, 4, 64)
    got = tlinear.linear({"wq": torch.from_numpy(packed), "scales": torch.from_numpy(s),
                          "biases": torch.from_numpy(b)}, torch.from_numpy(x))
    close(got, x @ dense.T)
