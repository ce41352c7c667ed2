"""K4a: the port's per-head pre-transformer against the JAX package's
pre_transformer_fused Pallas kernel in interpret mode at fp32 (fp32
weights, compute_dtype float32), on the same weights and seeded inputs at
B = 2 and a T that is not a multiple of 8; its parameter builder pinned to
the JAX builder's arrays; and its plain version against K4's on the same
dense weights. Tolerance: rel RMS <= 1e-5 (fp32 sums in another order
through two layers).

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
    build_pretransformer_kernel_params_device,
    pre_transformer_fused as j_pre_transformer_fused,
)
from qwen3_tts_tpu_torch.convert import fused_pretransformer_params, to_torch
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk

torch.set_num_threads(1)
REL_RMS = 1e-5

CFG = TokenizerDecoderConfig(
    codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
    latent_dim=32, decoder_dim=48, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=48,
    upsample_rates=(4, 3), upsampling_ratios=(2, 2),
)
KW = dict(nh=CFG.num_attention_heads, hd=CFG.head_dim, eps=CFG.rms_norm_eps)


def dense_pt() -> dict:
    """JAX random init of the pre-transformer as numpy, with LayerScale
    raised to 0.5 so every branch shows in the output."""
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(CFG, jax.random.PRNGKey(0)))
    pt = p["pre_transformer"]
    L = pt["layers"]
    L["self_attn_layer_scale"]["w"] = np.full_like(L["self_attn_layer_scale"]["w"], 0.5)
    L["mlp_layer_scale"]["w"] = np.full_like(L["mlp_layer_scale"]["w"], 0.5)
    return pt


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def x_in(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_params_pinned_to_the_jax_builder():
    pt = dense_pt()
    for wdt in ("float32", "bfloat16"):
        ref = build_pretransformer_kernel_params_device(
            jax.tree.map(jnp.asarray, pt), CFG, weight_dtype=getattr(jnp, wdt))
        got = ptk.build_pretransformer_fused_params(to_torch(pt), CFG, getattr(torch, wdt))
        assert set(got) == set(ref) | {"inv_freq"}
        for name, want in ref.items():
            have = got[name]
            assert tuple(have.shape) == tuple(want.shape), name
            assert str(have.dtype).split(".")[-1] == str(want.dtype), name
            np.testing.assert_array_equal(have.float().numpy(), np.asarray(want, np.float32),
                                          name)
        # the JAX builder's tree carried across is the port's tree
        carried = fused_pretransformer_params(jax.tree.map(np.asarray, ref), CFG,
                                              dtype=getattr(torch, wdt))
        assert set(carried) == set(got)
        for name, have in carried.items():
            assert have.dtype == got[name].dtype and torch.equal(have, got[name]), name
    np.testing.assert_array_equal(
        got["inv_freq"].numpy(),
        1.0 / np.power(CFG.rope_theta, np.arange(0, CFG.head_dim, 2, dtype=np.float32)
                       / CFG.head_dim))


def test_plain_matches_the_pallas_kernel_in_interpret_mode():
    pt = dense_pt()
    b, t = 2, 13
    x = x_in(t, b, t, CFG.latent_dim)
    kp_j = build_pretransformer_kernel_params_device(
        jax.tree.map(jnp.asarray, pt), CFG, weight_dtype=jnp.float32)
    ref = jax.block_until_ready(j_pre_transformer_fused(
        kp_j, jnp.asarray(x), nl=CFG.num_hidden_layers, nh=CFG.num_attention_heads,
        hd=CFG.head_dim, eps=CFG.rms_norm_eps, rope_theta=CFG.rope_theta,
        compute_dtype=jnp.float32, interpret=True,
    ))
    kp = ptk.build_pretransformer_fused_params(to_torch(pt), CFG, torch.float32)
    got = ptk.pre_transformer_fused(kp, torch.from_numpy(x), **KW)
    assert rel_rms(got, ref) <= REL_RMS


def test_plain_equals_k4_plain_on_the_same_weights():
    pt = to_torch(dense_pt())
    fused = ptk.build_pretransformer_fused_params(pt, CFG, torch.float32)
    packed = ptk.build_pretransformer_params(pt, CFG, torch.float32)
    for b, t in ((1, 1), (2, 13), (1, 40)):
        x = torch.from_numpy(x_in(b * t, b, t, CFG.latent_dim))
        got = ptk.pre_transformer_fused_plain(fused, x, **KW)
        assert rel_rms(got, ptk.pre_transformer_plain(packed, x, **KW)) <= REL_RMS, (b, t)
    # the same bf16 weights in both: both plain versions round each
    # product's operands to bf16 at K4's points (which the persistent
    # kernel shares for both), and neither rounds them widened to fp32
    fused16 = ptk.build_pretransformer_fused_params(pt, CFG, torch.bfloat16)
    packed16 = ptk.build_pretransformer_params(pt, CFG, torch.bfloat16)
    x = torch.from_numpy(x_in(3, 2, 13, CFG.latent_dim))
    for fused_w, packed_w in ((fused16, packed16),
                              ({k: v.float() for k, v in fused16.items()},
                               {k: v.float() for k, v in packed16.items()})):
        assert rel_rms(ptk.pre_transformer_fused_plain(fused_w, x, **KW),
                       ptk.pre_transformer_plain(packed_w, x, **KW)) <= REL_RMS


def test_entry_point_takes_the_plain_version_on_the_cpu_only():
    kp = ptk.build_pretransformer_fused_params(to_torch(dense_pt()), CFG, torch.float32)
    x = torch.from_numpy(x_in(5, 1, 9, CFG.latent_dim))
    before = ptk.fused_launches
    np.testing.assert_array_equal(ptk.pre_transformer_fused(kp, x, **KW).numpy(),
                                  ptk.pre_transformer_fused_plain(kp, x, **KW).numpy())
    assert ptk.fused_launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ptk.pre_transformer_fused(kp, x.to("meta"), **KW)
