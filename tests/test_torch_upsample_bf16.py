"""The vocoder's upsampling with bf16 weights, on the CPU.

K5 (the ConvNeXt upsample stage): the port's plain version, which rounds
each product's operand to bf16 and sums in fp32 as the card's tensor-core
kernel does, against the Pallas kernel in interpret mode at
compute_dtype=bfloat16 on the same bf16 weights and seeded inputs, with and
without the folded initial conv. The SEANet block's upsample: the port's
block_upsample against the JAX package's own expression for it
(seanet_block_fused, restated here: bf16 operands, both products kept in
fp32). And the plan of K5's persistent kernel (csrc/upsample.cu,
qt_up_persistent_kernel) as the card runs it, at 1-132 blocks.

Tolerances. Both sides round the same operands at the same places, so they
differ only where fp32 sums in another order push an operand across a bf16
rounding boundary: rel RMS <= 1e-5 (observed 3.9e-8 and 7.8e-8 for K5,
5.7e-8 for the block upsample). Each test also shows that it sees the
rounding: K5 with the same weights widened to fp32, which rounds nothing,
lands >= 1e-3 away (observed 1.7e-3, 2.0e-3), and so does the block
upsample with each product rounded to bf16, as a bf16 matmul returns it
(observed 1.6e-3).

An interpret-mode call returns before its host callbacks finish; each one
is waited for at once, so no other JAX dispatch races those callbacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import TokenizerDecoderConfig
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops.pallas.upsample_kernel import (
    build_upsample_stage_params as j_build_stage,
    upsample_stage_fused as j_upsample_stage_fused,
)
from qwen3_tts_tpu.ops.pallas.vocoder_kernels import (
    _snake as j_snake,
    build_seanet_block_kernel_params as j_build_block,
)
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import persistent
from qwen3_tts_tpu_torch.ops.cuda import upsample_kernel as upk
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

torch.set_num_threads(1)
REL_RMS = 1e-5
UNROUNDED = 1e-3  # the least distance of the arithmetic that rounds elsewhere

CFG = TokenizerDecoderConfig(
    codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
    latent_dim=32, decoder_dim=48, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=48,
    upsample_rates=(4, 3), upsampling_ratios=(2, 2),
)


def params() -> dict:
    """JAX random init as numpy, with the ConvNeXt gamma raised to 0.5 so
    the block's branch shows in the output."""
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(CFG, jax.random.PRNGKey(0)))
    for st in p["upsample"]:
        st["convnext"]["gamma"] = np.full_like(st["convnext"]["gamma"], 0.5)
    return p


def rel_rms(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


@pytest.mark.parametrize("fold_ic", [False, True])
def test_upsample_stage_bf16_plain_matches_pallas(fold_ic):
    p = params()
    stage = p["upsample"][1]
    ic = p["decoder"]["initial_conv"] if fold_ic else None
    x = np.random.default_rng(3).standard_normal((2, 9, CFG.latent_dim)).astype(np.float32)
    ref = jax.block_until_ready(j_upsample_stage_fused(
        jax.tree.map(jnp.asarray, j_build_stage(stage, jnp.bfloat16, initial_conv=ic)),
        jnp.asarray(x), compute_dtype=jnp.bfloat16, interpret=True,
    ))
    kp = upk.build_upsample_stage_params(
        to_torch(stage), torch.bfloat16, initial_conv=to_torch(ic) if ic is not None else None)
    xt = torch.from_numpy(x)
    assert rel_rms(upk.upsample_stage_plain(kp, xt), ref) <= REL_RMS
    widened = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in kp.items()}
    assert rel_rms(upk.upsample_stage_plain(widened, xt), ref) >= UNROUNDED


def test_block_upsample_keeps_fp32_products():
    p = params()
    block, rate = p["decoder"]["blocks"][0], CFG.upsample_rates[0]
    cin, cout = block["up"]["w"].shape[1:]
    b, t = 2, 11
    x = (np.random.default_rng(5).standard_normal((b, t, cin)) * 0.5).astype(np.float32)
    # qwen3_tts_tpu/ops/pallas/vocoder_kernels.py::seanet_block_fused, its upsample
    kj = jax.tree.map(jnp.asarray, j_build_block(block, rate, jnp.bfloat16))
    xj = jnp.asarray(x)
    xs = j_snake(xj.astype(jnp.float32), kj["snake_a"], kj["snake_binv"]).astype(jnp.bfloat16)
    prev = jnp.concatenate([jnp.zeros_like(xs[:, :1]), xs[:, :-1]], axis=1)
    dn = (((2,), (0,)), ((), ()))
    acc = jax.lax.dot_general(
        xs, kj["w_lo"].astype(jnp.bfloat16), dn, preferred_element_type=jnp.float32
    ) + jax.lax.dot_general(
        prev, kj["w_hi"].astype(jnp.bfloat16), dn, preferred_element_type=jnp.float32)
    y = (acc.reshape(b, t * rate, -1) + kj["up_b"][0]).astype(xj.dtype)
    ref = np.asarray(jax.block_until_ready(y))[..., :cout]  # JAX pads channels to 128

    kp = vk.build_seanet_block_params(to_torch(block), rate, torch.bfloat16)
    xt = torch.from_numpy(x)
    assert rel_rms(vk.block_upsample(kp, xt, rate=rate), ref) <= REL_RMS
    # each product rounded to bf16 before the sum, as a bf16 matmul returns it
    xs_t = vk._snake(xt, kp["snake_a"], kp["snake_binv"]).bfloat16()
    prev_t = torch.nn.functional.pad(xs_t, (0, 0, 1, 0))[:, :t]
    rounded = (xs_t @ kp["up_w"][cin:]).float() + (prev_t @ kp["up_w"][:cin]).float()
    assert rel_rms((rounded + kp["up_b"]).reshape(b, t * rate, cout), ref) >= UNROUNDED


def test_persistent_plan_covers_every_output():
    """At the 0.6B widths, the tiny widths and the card test's, for the row
    counts the pipeline hands each stage (a 26-row stream window, 110-row
    generate windows, batches of them): every output element of every GEMM
    phase is owned by exactly one tile, every tile's K steps by exactly one
    of its K runs, every item and every LayerNorm row by exactly one block
    at 1-132 blocks; a block's first item of a phase is the one whose
    weight tiles it requests ahead; each phase is followed by one barrier
    every block reaches (the phases run in every block, items or none);
    the rings fit the shared memory."""
    widths = {"0.6B": (1024, 4096, 1536), "tiny": (32, 128, 48), "card-test": (96, 384, 160)}
    warps = persistent.PK_NT // 32
    for c, inter, cic in widths.values():
        for b, t0 in ((1, 26), (1, 110), (3, 110), (2, 19)):
            for t, fold in ((t0, False), (2 * t0, True)):  # stage 0, then stage 1
                gemms = upk.stage_gemms(b, t, c, inter, cic if fold else None)
                assert [len(upk.stage_phases(fold, x32)) for x32 in (False, True)] == (
                    [len(gemms) + 1, len(gemms) + 2])
                for grid in range(1, 133):
                    for (m, k, n), (bm, ks) in zip(gemms, upk.stage_plan(
                            b, t, c, inter, cic if fold else None, grid)):
                        assert 1 <= ks <= min(upk.k_steps(k), upk.MAX_SPLIT) and bm in (64, 128)
                        check_phase(m, k, n, bm, ks, grid)
                m = 2 * b * t
                for grid in range(1, 133):
                    rows = np.concatenate([np.asarray(upk.dwln_rows(m, grid, blk, w), np.int64)
                                           for blk in range(grid) for w in range(warps)])
                    assert np.array_equal(np.sort(rows), np.arange(m))
    assert upk.SMEM == 110592 and upk.SMEM <= 232448 - 1024
    # at the 0.6B widths a 26-row window's stages split K so that ~132 items stream weights
    assert upk.stage_plan(1, 26, 1024, 4096, None, 132) == [(64, 4), (64, 2), (64, 8)]
    assert upk.stage_plan(1, 52, 1024, 4096, 1536, 132) == [(64, 4), (128, 2), (128, 8), (128, 5)]


def check_cover(m, k, n, bm, ks):
    n_tiles = upk.tiles(m, n, bm)
    owned = np.zeros((m, n), np.int64)
    steps = np.zeros((n_tiles, upk.k_steps(k)), np.int64)
    for it in range(n_tiles * ks):
        tile, split, m0, n0, k0, nst = upk.gemm_item(m, k, n, bm, ks, it)
        assert split == it // n_tiles and nst >= 1
        steps[tile, k0:k0 + nst] += 1
        if split == 0:
            owned[m0:m0 + bm, n0:n0 + upk.UP_BN] += 1
    assert (owned == 1).all() and (steps == 1).all()


_COVERED = set()


def check_phase(m, k, n, bm, ks, grid):
    if (m, k, n, bm, ks) not in _COVERED:
        check_cover(m, k, n, bm, ks)
        _COVERED.add((m, k, n, bm, ks))
    items = upk.tiles(m, n, bm) * ks
    taken = np.concatenate([np.asarray(persistent.block_items(items, grid, blk), np.int64)
                            for blk in range(grid)])
    assert np.array_equal(np.sort(taken), np.arange(items))
    for blk in range(min(grid, items)):
        assert next(iter(persistent.block_items(items, grid, blk))) == blk
