"""The port's sampling against the JAX package's on the CPU: greedy with the
repetition penalty and the valid-token mask gives the same ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import sampling as jsamp
from qwen3_tts_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampling_greedy_penalty_valid_mask(seed):
    rng = np.random.default_rng(seed)
    v = 3072
    logits = rnd(rng, v, scale=3.0)
    seen = rng.random(v) < 0.3
    jv = jsamp.talker_valid_mask(v)
    tv = tsamp.talker_valid_mask(v)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ref = jsamp.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.float32(0.0),
                             seen_mask=jnp.asarray(seen), repetition_penalty=1.05,
                             valid_mask=jv)
    got = tsamp.sample_token(T(logits), None, 0.0, seen_mask=T(seen),
                             repetition_penalty=1.05, valid_mask=tv)
    assert int(got) == int(ref)
