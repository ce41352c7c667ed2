"""The port's speaker encoder against the JAX package's on the CPU in fp32:
the log-mel frontend (symmetric Hann, reflect padding, Slaney filterbank,
log clipped at 1e-5) and the ECAPA embedding at tiny_speaker_config, on the
same checkpoint keys, and the port's writer read back by the JAX loader.
Tolerance: rel max <= 1e-5 (fp32 FFT and convolutions, sums in another
order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.models import speaker_encoder as jspk
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.models import speaker_encoder as tspk

torch.set_num_threads(1)
REL = 1e-5


def rel_max(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def audio(n, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_mel_spectrogram_and_filterbank_match_jax():
    np.testing.assert_array_equal(tspk.mel_filterbank(), jspk.mel_filterbank())
    np.testing.assert_array_equal(tspk.hann_window(1024), jspk.hann_window(1024))
    for n, mels in ((24000, 128), (5001, 16)):
        x = audio(n)
        ref = jspk.mel_spectrogram(jnp.asarray(x), num_mels=mels)
        got = tspk.mel_spectrogram(x, num_mels=mels)
        assert got.shape == ref.shape
        assert rel_max(got.numpy(), ref) <= REL, n


def test_embedding_matches_jax_on_the_same_checkpoint():
    cfg = jtesting.tiny_speaker_config()
    weights = jtesting.export_speaker_encoder_checkpoint(
        jspk.init_speaker_encoder_params(cfg, jax.random.PRNGKey(3)))
    weights = {k: np.asarray(v) for k, v in weights.items()}
    assert (dataclasses.asdict(tspk.config_from_weights(weights))
            == dataclasses.asdict(jspk.config_from_weights(weights)))
    jenc = jspk.SpeakerEncoder.from_weights(weights)
    tenc = tspk.SpeakerEncoder.from_weights(weights, device="cpu")
    for n in (24000, 37000):
        x = audio(n, seed=n)
        ref = jenc.extract_embedding(x)
        got = tenc.extract_embedding(x)
        assert got.shape == ref.shape == (cfg.enc_dim,)
        assert rel_max(got, ref) <= REL, n


def test_port_writer_round_trips_through_the_jax_loader():
    cfg = ttesting.tiny_speaker_config()
    params = ttesting.random_speaker_encoder_params(cfg, seed=5)
    weights = ttesting.export_speaker_encoder_checkpoint(params)
    loaded = jspk.load_speaker_encoder_params(weights, jspk.config_from_weights(weights))
    flat_ref = jax.tree_util.tree_leaves(params)
    flat_got = jax.tree_util.tree_leaves(loaded)
    assert len(flat_ref) == len(flat_got)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert dataclasses.asdict(jspk.config_from_weights(weights)) == dataclasses.asdict(cfg)
