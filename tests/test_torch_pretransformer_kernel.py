"""K4: the port's plain pre-transformer against the JAX package's packed
Pallas kernel in interpret mode at fp32 (fp32 weights, compute_dtype
float32), on the same weights and seeded inputs. Tolerance: rel RMS <= 1e-4
(fp32 sums in another order through several layers).

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
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk

torch.set_num_threads(1)
REL_RMS = 1e-4

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
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def x_in(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,b", [(7, 1), (26, 2)])
def test_pre_transformer_plain_matches_pallas(t, b):
    p = params()
    x = x_in(t, b, t, CFG.latent_dim)
    kp_j = build_pretransformer_packed_params_device(
        jax.tree.map(jnp.asarray, p["pre_transformer"]), CFG, weight_dtype=jnp.float32
    )
    ref = jax.block_until_ready(j_pre_transformer_packed(
        kp_j, jnp.asarray(x), nl=CFG.num_hidden_layers, nh=CFG.num_attention_heads,
        hd=CFG.head_dim, eps=CFG.rms_norm_eps, rope_theta=CFG.rope_theta,
        compute_dtype=jnp.float32, interpret=True,
    ))
    kp = ptk.build_pretransformer_params(to_torch(p["pre_transformer"]), CFG, torch.float32)
    got = ptk.pre_transformer_packed(kp, torch.from_numpy(x), nh=CFG.num_attention_heads,
                                     hd=CFG.head_dim, eps=CFG.rms_norm_eps)
    assert rel_rms(got, ref) <= REL_RMS
