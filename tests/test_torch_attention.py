"""The port's attention (qwen3_tts_tpu_torch.ops.attention) against the JAX
package's on the CPU in fp32: causal prefill, and decode over a ring cache
that wrapped, with a nonzero window start (absolute-position masking).
Tolerance: max |port - jax| <= 1e-5 * max |jax| (fp32 sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tts_tpu.ops import attention as jatt
from qwen3_tts_tpu_torch.ops import attention as tatt

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


def test_attention_prefill_causal():
    rng = np.random.default_rng(2)
    q, k, v = rnd(rng, 1, 4, 9, 16), rnd(rng, 1, 2, 9, 16), rnd(rng, 1, 2, 9, 16)
    ref = jatt.gqa_attention_full(q, k, v, 0.25, jatt.causal_mask(9))
    got = tatt.gqa_attention_full(T(q), T(k), T(v), 0.25, tatt.causal_mask(9))
    close(got, ref)


def test_attention_decode_ring_wrap_window():
    """Ring of 16 slots after 26 writes (slot = pos % 16, so it wrapped) with
    the window start at 14: only positions 14..25 may be attended."""
    rng = np.random.default_rng(3)
    cap, n = 16, 26
    pos = np.full((cap,), -1, np.int32)
    for p in range(n):
        pos[p % cap] = p
    q = rnd(rng, 1, 4, 1, 16)
    kc, vc = rnd(rng, 1, 2, cap, 16), rnd(rng, 1, 2, cap, 16)
    ref = jatt.gqa_attention_decode(q, kc, vc, jnp.asarray(pos), jnp.int32(14), 0.25)
    got = tatt.gqa_attention_decode(T(q), T(kc), T(vc), T(pos).long(),
                                    torch.tensor(14), 0.25)
    close(got, ref)
