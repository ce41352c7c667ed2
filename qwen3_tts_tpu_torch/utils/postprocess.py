"""Audio postprocessing: noise gate + peak normalization, vectorized numpy.

Behavioral parity with the reference AudioPostprocessor (reference
Utilities/AudioPostprocessor.swift:14-121): 20 ms windowed-RMS noise gate with
120 ms hold and linear crossfade at window boundaries, then boost-only peak
normalization to -1 dBFS (skipped when peak < 0.01).
"""

from __future__ import annotations

import numpy as np

WINDOW_SIZE = 480  # 20 ms at 24 kHz
THRESHOLD = 0.008
HOLD_WINDOWS = 6  # ~120 ms hold
TARGET_PEAK = 0.891  # -1 dBFS


def sanitize_samples(samples: np.ndarray) -> np.ndarray:
    """NaN/Inf scrub + clamp to [-1, 1], float32 (reference consumer
    semantics, Qwen3TTSPipeline.swift:565-570). The ONE implementation
    behind pipeline._clean and serving.vocode_rows — every audio sample
    leaving this framework passes through here, so the NaN policy and
    clamp range can never drift between the pipeline and service paths."""
    out = np.asarray(samples, np.float32)
    out = np.where(np.isfinite(out), out, 0.0)
    return np.clip(out, -1.0, 1.0)


def apply_noise_gate(samples: np.ndarray) -> np.ndarray:
    """Windowed-RMS gate with hold + linear crossfade
    (reference AudioPostprocessor.swift:61-106)."""
    samples = np.asarray(samples, np.float32)
    n = len(samples)
    if n <= WINDOW_SIZE * 2:
        return samples.copy()

    num_windows = (n + WINDOW_SIZE - 1) // WINDOW_SIZE
    padded = np.pad(samples, (0, num_windows * WINDOW_SIZE - n))
    win = padded.reshape(num_windows, WINDOW_SIZE)
    counts = np.full(num_windows, WINDOW_SIZE, np.float32)
    if n % WINDOW_SIZE:
        counts[-1] = n % WINDOW_SIZE
    rms = np.sqrt((win * win).sum(axis=1) / counts)

    is_open = np.zeros(num_windows, bool)
    hold = 0
    for w in range(num_windows):
        if rms[w] >= THRESHOLD:
            is_open[w] = True
            hold = HOLD_WINDOWS
        elif hold > 0:
            is_open[w] = True
            hold -= 1

    open_f = is_open.astype(np.float32)
    half = WINDOW_SIZE // 2
    i = np.arange(n)
    w = i // WINDOW_SIZE
    pos = i % WINDOW_SIZE

    g = open_f[np.minimum(w, num_windows - 1)].copy()
    first_half = (pos < half) & (w > 0)
    t = (pos + half) / WINDOW_SIZE
    g = np.where(
        first_half,
        open_f[np.maximum(w - 1, 0)] * (1.0 - t) + open_f[w] * t,
        g,
    )
    second_half = (pos >= half) & (w + 1 < num_windows)
    t2 = (pos - half) / WINDOW_SIZE
    g = np.where(
        second_half,
        open_f[w] * (1.0 - t2) + open_f[np.minimum(w + 1, num_windows - 1)] * t2,
        g,
    )
    return samples * g.astype(np.float32)


def peak_normalize(samples: np.ndarray) -> np.ndarray:
    """Boost-only normalization to -1 dBFS
    (reference AudioPostprocessor.swift:113-120)."""
    samples = np.asarray(samples, np.float32)
    peak = float(np.abs(samples).max(initial=0.0))
    if peak <= 0.01 or peak >= TARGET_PEAK:
        return samples.copy()
    return samples * (TARGET_PEAK / peak)


def postprocess(samples: np.ndarray) -> np.ndarray:
    """Gate + normalize (the in-place WAV pipeline's sample transform)."""
    return peak_normalize(apply_noise_gate(samples))


def postprocess_wav_file_in_place(path: str) -> None:
    """Rewrite a 16-bit PCM WAV (44-byte header) with gated/normalized audio
    (reference AudioPostprocessor.swift:23-55)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) <= 44:
        return
    header = data[:44]
    pcm = np.frombuffer(data[44: 44 + (len(data) - 44) // 2 * 2], dtype="<i2")
    samples = pcm.astype(np.float32) / 32767.0
    out = postprocess(samples)
    pcm_out = np.clip(out * 32767.0, -32767, 32767).astype("<i2")
    with open(path, "wb") as f:
        f.write(header)
        f.write(pcm_out.tobytes())
