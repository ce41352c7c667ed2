"""K5 / K6: the port's plain versions against the JAX package's Pallas
kernels in interpret mode at fp32 (fp32 weights, compute_dtype float32, the
exact-sin SnakeBeta), on the same weights and seeded inputs. Tolerance:
rel RMS <= 1e-4 (fp32 sums in another order through several layers).

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
    build_seanet_block_kernel_params as j_build_block,
    seanet_block_fused as j_seanet_block_fused,
)
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import upsample_kernel as upk
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

torch.set_num_threads(1)
REL_RMS = 1e-4

CFG = TokenizerDecoderConfig(
    codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
    latent_dim=32, decoder_dim=48, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=48,
    upsample_rates=(4, 3), upsampling_ratios=(2, 2),
)


def params() -> dict:
    """JAX random init as numpy, with LayerScale / ConvNeXt gamma raised to
    0.5 so every branch shows in the output."""
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(CFG, jax.random.PRNGKey(0)))
    L = p["pre_transformer"]["layers"]
    L["self_attn_layer_scale"]["w"] = np.full_like(L["self_attn_layer_scale"]["w"], 0.5)
    L["mlp_layer_scale"]["w"] = np.full_like(L["mlp_layer_scale"]["w"], 0.5)
    for st in p["upsample"]:
        st["convnext"]["gamma"] = np.full_like(st["convnext"]["gamma"], 0.5)
    return p


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def x_in(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fold_ic", [False, True])
def test_upsample_stage_plain_matches_pallas(fold_ic):
    p = params()
    stage = p["upsample"][1]
    ic = p["decoder"]["initial_conv"] if fold_ic else None
    x = x_in(3, 2, 9, CFG.latent_dim)
    ref = jax.block_until_ready(j_upsample_stage_fused(
        jax.tree.map(jnp.asarray, j_build_stage(stage, np.float32, initial_conv=ic)),
        jnp.asarray(x), compute_dtype=jnp.float32, interpret=True,
    ))
    kp = upk.build_upsample_stage_params(
        to_torch(stage), torch.float32,
        initial_conv=to_torch(ic) if ic is not None else None,
    )
    got = upk.upsample_stage_fused(kp, torch.from_numpy(x))
    assert got.shape == (2, 18, CFG.decoder_dim if fold_ic else CFG.latent_dim)
    assert rel_rms(got, ref) <= REL_RMS


@pytest.mark.parametrize("with_tail", [False, True])
def test_seanet_block_plain_matches_pallas(with_tail):
    p = params()
    dec = p["decoder"]
    i = len(dec["blocks"]) - 1 if with_tail else 0
    block, rate = dec["blocks"][i], CFG.upsample_rates[i]
    cin, cout = block["up"]["w"].shape[1:]
    tail = {"snake": dec["out_snake"], "conv": dec["out_conv"]} if with_tail else None
    x = x_in(5, 2, 11, cin) * 0.5
    ref = jax.block_until_ready(j_seanet_block_fused(
        jax.tree.map(jnp.asarray, j_build_block(block, rate, np.float32, tail=tail)),
        jnp.asarray(x), rate=rate, cout=cout, compute_dtype=jnp.float32, interpret=True,
    ))
    kp = vk.build_seanet_block_params(
        to_torch(block), rate, torch.float32,
        tail=to_torch(tail) if tail is not None else None,
    )
    got = vk.seanet_block_fused(kp, torch.from_numpy(x), rate=rate)
    assert got.shape == ((2, 11 * rate) if with_tail else (2, 11 * rate, cout))
    assert rel_rms(got, ref) <= REL_RMS
