"""The port's int8 linear (K3's plain version behind ops.linear, with a bias)
against the JAX package's int8_matmul path on the same seeded numpy inputs,
at M in {1, 7, 64} over a leading batch dim. Tolerance: max |port - jax|
<= 1e-5 * max |jax| (fp32 dequant and accumulation on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops.pallas.quant_matmul import int8_matmul as j_int8_matmul
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
REL = 1e-5


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


@pytest.mark.parametrize("m", [1, 7, 64])
def test_linear_matches_jax_int8_matmul(m):
    rng, _, w8, s, b = make(100 + m, 96, 128)
    x = rng.standard_normal((2, m, 128)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    entry = {"w8": w8, "scales": s, "biases": b}
    ref = np.asarray(j_int8_matmul(jnp.asarray(x), entry)) + bias
    got = tlinear.linear({**{k: torch.from_numpy(v) for k, v in entry.items()},
                          "b": torch.from_numpy(bias)}, torch.from_numpy(x))
    close(got, ref)
