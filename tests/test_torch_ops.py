"""The PyTorch port's ops (qwen3_tts_tpu_torch.ops) against the JAX
package's on the CPU in fp32: the same seeded numpy inputs go through both.
Tolerance: max |port - jax| <= 1e-5 * max |jax| (fp32 sums in another
order). Attention and sampling have files of their own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import norms as jnorms
from qwen3_tts_tpu.ops import rope as jrope
from qwen3_tts_tpu_torch.ops import norms as tnorms
from qwen3_tts_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
REL = 1e-5


def close(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"max err {err:.3e} > {rel:g} x {scale:.3e}"


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.asarray(a))


def test_norms():
    rng = np.random.default_rng(0)
    x, w, b = rnd(rng, 3, 5, 64), rnd(rng, 64), rnd(rng, 64)
    close(tnorms.rms_norm(T(x), T(w), 1e-6), jnorms.rms_norm(x, w, 1e-6))
    close(tnorms.layer_norm(T(x), T(w), T(b), 1e-6), jnorms.layer_norm(x, w, b, 1e-6))


@pytest.mark.parametrize("mrope", [None, (3, 3, 2)])
def test_rope_and_mrope(mrope):
    rng = np.random.default_rng(1)
    hd = 16
    inv = jrope.inv_freq(hd, 1e6)
    np.testing.assert_array_equal(trope.inv_freq(hd, 1e6), inv)
    pos = np.arange(37, dtype=np.int32)[None] + 5
    if mrope is None:
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv))
        tc, ts = trope.rope_cos_sin(T(pos).long(), T(inv))
    else:
        jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), jnp.asarray(inv), mrope)
        tc, ts = trope.mrope_cos_sin(T(pos).long(), T(inv), mrope)
    close(tc, jc)
    close(ts, js)
    x = rnd(rng, 1, 4, 37, hd)
    close(trope.apply_rope(T(x), tc[:, None], ts[:, None]),
          jrope.apply_rope(x, jc[:, None], js[:, None]))
