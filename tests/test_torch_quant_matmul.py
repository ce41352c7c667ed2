"""K3 (int8 group-affine matmul): the port's plain version against the
Pallas kernel in interpret mode (on its lane-permuted weights), on the same
seeded numpy inputs; the int8 linear against the JAX int8_matmul path is in
test_torch_linear.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops.pallas.quant_matmul import (
    quantized_matmul_int8_pallas,
    repack_int8_for_kernel,
)
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


@pytest.mark.parametrize("m", [1, 7, 64])
def test_plain_matches_pallas_interpret(m):
    rng, _, w8, s, b = make(m, 256, 192)
    x = rng.standard_normal((m, 192)).astype(np.float32)
    # waited for at once: an interpret-mode call returns before its host
    # callbacks finish, and no other JAX dispatch should race them
    ref = jax.block_until_ready(quantized_matmul_int8_pallas(
        jnp.asarray(x), jnp.asarray(repack_int8_for_kernel(w8, 64)), jnp.asarray(s),
        jnp.asarray(b), group_size=64, tile_out=128, interpret=True,
    ))
    got = qm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w8),
                               torch.from_numpy(s), torch.from_numpy(b))
    close(got, ref)
