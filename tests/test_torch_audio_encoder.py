"""The port's audio encoder (ICL reference codes) against the JAX package's
on the CPU in fp32, on the same checkpoint keys at tiny_encoder_config:
the hidden states the RVQ encodes (causal SEANet, non-causal transformer,
downsample) within rel max 1e-5, and equal codes; and the port's writer
read back by the JAX loader."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import SpeechTokenizerConfig as JSpeechConfig
from qwen3_tts_tpu.models import audio_encoder as jenc
from qwen3_tts_tpu.ops.conv import causal_conv1d as j_causal_conv1d
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.config import SpeechTokenizerConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import audio_encoder as tenc

torch.set_num_threads(1)
REL = 1e-5


def rel_max(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def speech_config_json(enc) -> dict:
    return {"encoder_config": jtesting.decoder_config_to_json_dict(enc),
            "encoder_valid_num_quantizers": enc.num_quantizers // 2}


def test_hidden_states_and_codes_match_jax():
    cfg = jtesting.tiny_encoder_config()
    weights = jtesting.export_audio_encoder_checkpoint(
        jenc.init_audio_encoder_params(cfg, jax.random.PRNGKey(4)), cfg)
    weights = {k: np.asarray(v) for k, v in weights.items()}
    raw = speech_config_json(cfg)
    jmodel = jenc.AudioEncoder.from_weights(weights, JSpeechConfig.from_json(raw))
    tmodel = tenc.AudioEncoder.from_weights(weights, SpeechTokenizerConfig.from_json(raw),
                                            device="cpu")
    rng = np.random.default_rng(0)
    for n in (24000, 9000):
        x = (0.3 * rng.standard_normal(n)).astype(np.float32)
        jh = jenc.seanet_encode(jmodel.params["seanet"], jnp.asarray(x)[None, :, None], cfg)
        jh = jenc.encoder_transformer(jmodel.params["transformer"], jh, cfg)
        jh = j_causal_conv1d(jmodel.params["downsample"], jh, stride=cfg.compress)
        th = tenc.encode_hidden(tmodel.params, torch.from_numpy(x)[None], tmodel.cfg)
        assert rel_max(th.numpy(), jh) <= REL, n
        ref, got = jmodel.encode(x), tmodel.encode(x)
        assert got.dtype == np.int32 and got.shape == ref.shape == (cfg.num_quantizers // 2,
                                                                    ref.shape[1])
        np.testing.assert_array_equal(got, ref)


def test_port_writer_round_trips_through_the_jax_loader():
    cfg = ttesting.tiny_encoder_config()
    params = ttesting.random_audio_encoder_params(cfg, seed=6)
    weights = ttesting.export_audio_encoder_checkpoint(params, cfg)
    jcfg = JSpeechConfig.from_json(speech_config_json(cfg)).encoder_config
    loaded = jenc.load_audio_encoder_params(weights, jcfg)
    flat_ref, flat_got = jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(loaded)
    # the JAX loader divides the EMA sums by the usage (1): equal values
    assert len(flat_ref) == len(flat_got)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tree = tenc.load_audio_encoder_params(weights, SpeechTokenizerConfig.from_json(
        speech_config_json(cfg)).encoder_config)
    for a, b in zip(jax.tree_util.tree_leaves(to_torch(tree)), flat_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
