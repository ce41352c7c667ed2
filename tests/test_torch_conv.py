"""The PyTorch port's conv ops (qwen3_tts_tpu_torch.ops.conv) against the
JAX package's on the CPU in fp32, channels-last with JAX's [k, Cin, Cout]
kernels: causal and left-padded convs, SnakeBeta and the ConvNeXt block
(the transposed conv has its own file). Tolerance: max |port - jax| <= 1e-5
* max |jax| (fp32 sums in another order)."""

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


@pytest.mark.parametrize("dilation", [1, 3])
def test_causal_and_left_pad_conv(dilation):
    rng = np.random.default_rng(4)
    p = conv(rng, 7, 6, 5)
    x = rnd(rng, 2, 20, 6)
    close(tconv.causal_conv1d(to_torch(p), T(x), dilation=dilation),
          jconv.causal_conv1d(p, x, dilation=dilation))
    close(tconv.left_pad_conv1d(to_torch(p), T(x)), jconv.left_pad_conv1d(p, x))
    dw = conv(rng, 7, 1, 6)
    close(tconv.causal_conv1d(to_torch(dw), T(x), groups=6),
          jconv.causal_conv1d(dw, x, groups=6))


def test_snake_and_convnext():
    rng = np.random.default_rng(6)
    c = 16
    x = rnd(rng, 2, 13, c)
    snake = {"alpha": rnd(rng, c, scale=0.3), "beta": rnd(rng, c, scale=0.3)}
    close(tconv.snake_beta(to_torch(snake), T(x)), jconv.snake_beta(snake, x))
    block = {
        "dwconv": conv(rng, 7, 1, c),
        "norm": {"w": 1.0 + rnd(rng, c, scale=0.1), "b": rnd(rng, c, scale=0.1)},
        "pwconv1": {"w": rnd(rng, 4 * c, c, scale=0.2), "b": rnd(rng, 4 * c, scale=0.1)},
        "pwconv2": {"w": rnd(rng, c, 4 * c, scale=0.2), "b": rnd(rng, c, scale=0.1)},
        "gamma": np.full((c,), 0.5, np.float32),
    }
    close(tconv.convnext_block(to_torch(block), T(x)), jconv.convnext_block(block, x))
