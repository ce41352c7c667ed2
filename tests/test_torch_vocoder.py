"""The port's vocoder decode_frames against the JAX package's on the CPU in
fp32, on identical weights (JAX random init), through the plain torch path
and through the K4/K5/K6 plain versions; and K6's plain version keeps every
output row causal. Tolerance: waveform rel RMS <= 1e-4 (fp32 through
several layers, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import TokenizerDecoderConfig as JDecConfig
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import vocoder_params
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk
from qwen3_tts_tpu_torch.testing import decoder_config_to_json_dict, random_vocoder_params

torch.set_num_threads(1)
REL = 1e-4


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


DEC = dict(latent_dim=32, codebook_dim=16, codebook_size=64, decoder_dim=48,
           hidden_size=32, intermediate_size=48, head_dim=16, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2, upsample_rates=(4, 3),
           upsampling_ratios=(2, 2))


@pytest.mark.parametrize("kernels", [False, True])
def test_decode_frames_waveform(kernels):
    jd = JDecConfig(**DEC)
    td = TokenizerDecoderConfig(**DEC)
    assert decoder_config_to_json_dict(td) == {
        k: (list(v) if isinstance(v, tuple) else v) for k, v in jd.__dict__.items()
    }
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(jd, jax.random.PRNGKey(2)))
    for st in p["upsample"]:
        st["convnext"]["gamma"] = np.full_like(st["convnext"]["gamma"], 0.5)
    codes = np.random.default_rng(3).integers(0, 64, (2, 16, 9))
    ref = jvoc.decode_frames(jax.tree.map(jnp.asarray, p), jnp.asarray(codes, jnp.int32), jd)
    tp = vocoder_params(p, td, kernel_dtype=torch.float32 if kernels else None)
    got = tvoc.decode_frames(tp, torch.from_numpy(codes).long(), td)
    assert got.shape == (2, 9 * td.total_upsample)
    assert rel_rms(got, ref) <= REL


def test_units_keep_rows_before_the_sequence_start_causal():
    """Changing a later row never changes an earlier output row, through the
    full 78-row reach of the d = 1, 3, 9 chain."""
    p = random_vocoder_params(TokenizerDecoderConfig(**DEC), seed=4)
    kp = vk.build_seanet_block_params(p["decoder"]["blocks"][0], 4, torch.float32)
    c = kp["u_w2"].shape[-1]
    y = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 120, c)).astype(np.float32))
    y2 = y.clone()
    y2[0, 100:] += 1.0
    a, b = vk.residual_units_fused(kp, y), vk.residual_units_fused(kp, y2)
    assert torch.equal(a[0, :100], b[0, :100])
    assert not torch.equal(a[0, 100:], b[0, 100:])
