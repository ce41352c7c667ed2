"""K4 / K6 with bf16 weights: the port's plain versions, which round each
product's operands to bf16 and sum in fp32 as the card's tensor-core
kernels do, against the JAX package's Pallas kernels in interpret mode at
compute_dtype=bfloat16 on the same bf16 weights and seeded inputs.

Tolerances. Both sides round the same operands at the same places, so K4
differs only where fp32 sums in another order push an operand across a bf16
rounding boundary: rel RMS <= 1e-5 (observed 4e-8; unrounded fp32 operands
land 2.4e-3 away). K6's JAX kernel also evaluates SnakeBeta with a
polynomial in bf16 (_snake_fast, ~3e-4 abs per application) where the port
keeps the exact sin: K6 is held at rel RMS <= 5e-4 on what the units add to
their input (the waveform on the tail block), where the polynomial moves
it by up to ~3.7e-4 at this input scale and by ~1e-7 once JAX's sin is made
exact, and unrounded operands land >= 1.4e-3 away. Each test also shows that
it sees the rounding: the same weights with fp32 operands, which round
nothing, land at least UNROUNDED away.

An interpret-mode call returns before its host callbacks finish; each one
is waited for at once, so no other JAX dispatch races those callbacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import TokenizerDecoderConfig
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops.pallas.pretransformer_kernel import (
    build_pretransformer_packed_params_device,
    pre_transformer_packed as j_pre_transformer_packed,
)
from qwen3_tts_tpu.ops.pallas.vocoder_kernels import (
    build_seanet_block_kernel_params as j_build_block,
    residual_units_fused as j_residual_units_fused,
)
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

torch.set_num_threads(1)
K4_REL_RMS, K6_REL_RMS = 1e-5, 5e-4
UNROUNDED = 1e-3  # the least distance of the unrounded arithmetic

CFG = TokenizerDecoderConfig(
    codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
    latent_dim=32, decoder_dim=48, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=48,
    upsample_rates=(4, 3), upsampling_ratios=(2, 2),
)


def params() -> dict:
    """JAX random init as numpy, with LayerScale raised to 0.5 so every
    branch shows in the output."""
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(CFG, jax.random.PRNGKey(0)))
    L = p["pre_transformer"]["layers"]
    L["self_attn_layer_scale"]["w"] = np.full_like(L["self_attn_layer_scale"]["w"], 0.5)
    L["mlp_layer_scale"]["w"] = np.full_like(L["mlp_layer_scale"]["w"], 0.5)
    return p


def rel_rms(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def widened(kp: dict) -> dict:
    """The same (bf16-valued) weights stored as fp32: the plain versions
    then round nothing."""
    return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in kp.items()}


@pytest.mark.parametrize("t,b", [(7, 1), (26, 2)])
def test_pre_transformer_bf16_plain_matches_pallas(t, b):
    p = params()
    x = np.random.default_rng(t).standard_normal((b, t, CFG.latent_dim)).astype(np.float32)
    kp_j = build_pretransformer_packed_params_device(
        jax.tree.map(jnp.asarray, p["pre_transformer"]), CFG, weight_dtype=jnp.bfloat16)
    ref = jax.block_until_ready(j_pre_transformer_packed(
        kp_j, jnp.asarray(x), nl=CFG.num_hidden_layers, nh=CFG.num_attention_heads,
        hd=CFG.head_dim, eps=CFG.rms_norm_eps, rope_theta=CFG.rope_theta,
        compute_dtype=jnp.bfloat16, interpret=True,
    ))
    kp = ptk.build_pretransformer_params(to_torch(p["pre_transformer"]), CFG, torch.bfloat16)
    kw = dict(nh=CFG.num_attention_heads, hd=CFG.head_dim, eps=CFG.rms_norm_eps)
    assert rel_rms(ptk.pre_transformer_plain(kp, torch.from_numpy(x), **kw), ref) <= K4_REL_RMS
    assert rel_rms(ptk.pre_transformer_plain(widened(kp), torch.from_numpy(x), **kw),
                   ref) >= UNROUNDED


@pytest.mark.parametrize("with_tail", [False, True])
def test_residual_units_bf16_plain_matches_pallas(with_tail):
    p = params()
    dec = p["decoder"]
    i = len(dec["blocks"]) - 1 if with_tail else 0
    block, rate = dec["blocks"][i], CFG.upsample_rates[i]
    cout = block["up"]["w"].shape[2]
    tail = {"snake": dec["out_snake"], "conv": dec["out_conv"]} if with_tail else None
    y = (np.random.default_rng(9).standard_normal((2, 37, cout)) * 0.5).astype(np.float32)
    kp_j = jax.tree.map(jnp.asarray, j_build_block(block, rate, jnp.bfloat16, tail=tail))
    cpad = kp_j["u_w2"].shape[-1]  # the JAX kernel works on 128-lane padded channels
    ref = np.asarray(jax.block_until_ready(j_residual_units_fused(
        kp_j, jnp.pad(jnp.asarray(y), ((0, 0), (0, 0), (0, cpad - cout))),
        compute_dtype=jnp.bfloat16, interpret=True,
    )), np.float32)
    ref = ref[..., 0] if with_tail else ref[..., :cout]
    kp = vk.build_seanet_block_params(to_torch(block), rate, torch.bfloat16,
                                      tail=to_torch(tail) if tail is not None else None)
    y0 = 0.0 if with_tail else y  # compare what the units add to y
    yt = torch.from_numpy(y)
    assert rel_rms(vk.residual_units_plain(kp, yt) - y0, ref - y0) <= K6_REL_RMS
    assert rel_rms(vk.residual_units_plain(widened(kp), yt) - y0, ref - y0) >= UNROUNDED
