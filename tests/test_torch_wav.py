"""The port's copies of the WAV codec and the audio post-processing pinned to
their originals: the same samples give the same bytes and the same arrays
through both packages."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.io import wav as jwav
from qwen3_tts_tpu.utils import postprocess as jpost
from qwen3_tts_tpu_torch.io import wav as twav
from qwen3_tts_tpu_torch.utils import postprocess as tpost

torch.set_num_threads(1)


def signal(seed: int) -> np.ndarray:
    """1 s at 24 kHz: a tone, a near-silent stretch, a loud burst past 1.0,
    and a NaN and infinities for the sanitizer."""
    rng = np.random.default_rng(seed)
    t = np.arange(24000) / 24000.0
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.01 * rng.standard_normal(24000)
    x[6000:12000] *= 1e-4
    x[15000:15100] *= 5.0
    x[100], x[200], x[300] = np.nan, np.inf, -np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_wav_bytes_pinned(seed, tmp_path):
    x = np.clip(np.nan_to_num(signal(seed)), -1.5, 1.5)
    data = twav.wav_data(x, 24000)
    assert data == jwav.wav_data(x, 24000)
    assert twav.pcm16_bytes(x) == jwav.pcm16_bytes(x)
    assert twav.streaming_wav_header(22050) == jwav.streaming_wav_header(22050)
    for a, b in zip(twav.parse_wav(data), jwav.parse_wav(data)):
        np.testing.assert_array_equal(a, b)
    twav.write_wav(x, tmp_path / "x.wav", 24000)
    got, rate = jwav.read_wav(tmp_path / "x.wav")
    assert rate == 24000
    np.testing.assert_array_equal(got, twav.wav_to_float_samples(data))


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_pinned(seed):
    x = signal(seed)
    for name in ("sanitize_samples", "apply_noise_gate", "peak_normalize", "postprocess"):
        src = x if name == "sanitize_samples" else jpost.sanitize_samples(x)
        np.testing.assert_array_equal(getattr(tpost, name)(src.copy()),
                                      getattr(jpost, name)(src.copy()), err_msg=name)
