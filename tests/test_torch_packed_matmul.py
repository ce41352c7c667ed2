"""K7 (packed-bit group-affine matmul): the port's plain version against the
Pallas kernel in interpret mode (on its lane-permuted weights) at 2, 4 and 8
bits, and against the JAX package's jnp reference at 3 and 6 bits (which
the Pallas kernel does not take), on the same seeded numpy inputs; the
dispatch for a CPU tensor; the `wq` routing of `linear` and `table_matmul`.

Tolerance: rel max 1e-5 (fp32 dequant and fp32 accumulation on both sides,
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.pallas.quant_matmul import quantized_matmul_pallas, repack_for_kernel
from qwen3_tts_tpu.ops.quant import quantize_np, quantized_matmul_ref
from qwen3_tts_tpu_torch.ops import linear as tlinear
from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm

torch.set_num_threads(1)
REL = 1e-5


def close(got, ref, rel=REL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def make(seed, o, k, bits, gs=64):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, k)) * 0.05).astype(np.float32)
    return rng, *quantize_np(w, bits, gs)


def plain(x, wq, s, b, bits, gs):
    return pm.packed_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                  torch.from_numpy(s), torch.from_numpy(b), bits, gs)


def test_plain_matches_pallas_interpret():
    cases, refs = [], []
    for bits, m, gs in ((2, 1, 64), (4, 7, 32), (8, 3, 128)):
        rng, wq, s, b = make(bits, 256, 256, bits, gs)
        x = rng.standard_normal((m, 256)).astype(np.float32)
        cases.append((x, wq, s, b, bits, gs))
        refs.append(quantized_matmul_pallas(
            jnp.asarray(x), jnp.asarray(repack_for_kernel(wq, bits, gs)), jnp.asarray(s),
            jnp.asarray(b), bits=bits, group_size=gs, tile_out=128, interpret=True,
        ))
    # waited for at once: an interpret-mode call returns before its host
    # callbacks finish, and no other JAX dispatch should race them
    refs = jax.block_until_ready(refs)
    for case, ref in zip(cases, refs):
        close(plain(*case), ref)


def test_plain_matches_jnp_reference_at_3_and_6_bits():
    for bits, gs in ((3, 64), (6, 64), (6, 32)):
        rng, wq, s, b = make(bits + gs, 96, 192, bits, gs)
        x = rng.standard_normal((5, 192)).astype(np.float32)
        ref = quantized_matmul_ref(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                                   jnp.asarray(b), bits=bits, group_size=gs)
        close(plain(x, wq, s, b, bits, gs), ref)


def test_cpu_tensor_takes_the_plain_version_and_kernel_refuses_it():
    _, wq, s, b = make(11, 64, 128, 4)
    entry = {"wq": torch.from_numpy(wq), "scales": torch.from_numpy(s),
             "biases": torch.from_numpy(b)}
    x = torch.ones(2, 3, 128)
    before = pm.launches
    y = pm.quantized_matmul(x, entry)
    assert pm.launches == before  # no kernel launch for a CPU tensor
    assert y.shape == (2, 3, 64)
    close(y.reshape(6, 64), np.asarray(plain(np.ones((6, 128), np.float32), wq, s, b, 4, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        pm.packed_matmul_kernel(x[0], entry["wq"], entry["scales"], entry["biases"], 4, 64)
    with pytest.raises(ValueError, match="bits"):
        pm.packed_matmul_kernel(x[0], entry["wq"], entry["scales"], entry["biases"], 5, 64)


def test_wq_routing_of_linear_and_table_matmul():
    """A packed `linear` (with a bias) and a packed stacked lm_head set
    against the JAX package's `linear` / `table_matmul`."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((3, 80, 128)) * 0.05).astype(np.float32)
    packed = [quantize_np(wi, 6, 64) for wi in w]
    stacked = {k: np.stack([p[i] for p in packed]) for i, k in enumerate(("wq", "scales",
                                                                           "biases"))}
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    bias = rng.standard_normal(80).astype(np.float32)
    lin = {"wq": stacked["wq"][1], "scales": stacked["scales"][1],
           "biases": stacked["biases"][1], "b": bias}
    close(tlinear.linear({k: torch.from_numpy(v) for k, v in lin.items()}, torch.from_numpy(x)),
          jlinear.linear({k: jnp.asarray(v) for k, v in lin.items()}, jnp.asarray(x)))
    tent = {k: torch.from_numpy(v) for k, v in stacked.items()}
    jent = {k: jnp.asarray(v) for k, v in stacked.items()}
    for k in range(3):
        close(tlinear.table_matmul(tent, k, torch.from_numpy(x[0])),
              jlinear.table_matmul(jent, k, jnp.asarray(x[0])))
