"""The port's causal transposed conv against the JAX package's on the CPU in
fp32, channels-last with JAX's pre-flipped [k, Cin, Cout] kernels (a
layout slip shows as a time-reversed tap). Tolerance: max |port - jax| <=
1e-5 * max |jax|."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import conv as jconv
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops import conv as tconv

torch.set_num_threads(1)
REL = 1e-5


def close(got, ref, rel=REL):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"max err {err:.3e} > {rel:g} x {scale:.3e}"


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.asarray(a))


def conv(rng, k, cin, cout):
    return {"w": rnd(rng, k, cin, cout, scale=0.3), "b": rnd(rng, cout, scale=0.1)}


@pytest.mark.parametrize("k,stride", [(2, 2), (8, 4), (6, 3)])
def test_causal_transpose_conv(k, stride):
    rng = np.random.default_rng(5)
    p = conv(rng, k, 6, 5)
    x = rnd(rng, 2, 11, 6)
    close(tconv.causal_transpose_conv1d(to_torch(p), T(x), stride=stride),
          jconv.causal_transpose_conv1d(p, x, stride=stride))
