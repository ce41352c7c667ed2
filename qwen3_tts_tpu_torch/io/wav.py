"""16-bit PCM mono WAV writing/reading.

Parity with the reference AudioSampleWriter (reference
Utilities/AudioSampleWriter.swift:3-106): one-shot `wav_data`/`write_wav` and a
`StreamingWAVWriter` that writes a placeholder 44-byte header, appends int16
little-endian samples, and rewrites the header on finalize. Also the
`wav_to_float_samples` helper (reference Qwen3TTSPipeline.swift:1006-1020).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _pcm16(samples: np.ndarray) -> np.ndarray:
    clamped = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    return (clamped * 32767.0).astype(np.int16)


def _header(num_samples: int, sample_rate: int) -> bytes:
    num_channels = 1
    bits_per_sample = 16
    byte_rate = sample_rate * num_channels * bits_per_sample // 8
    block_align = num_channels * bits_per_sample // 8
    data_size = num_samples * 2
    file_size = 36 + data_size
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", file_size),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate,
                        block_align, bits_per_sample),
            b"data",
            struct.pack("<I", data_size),
        ]
    )


def wav_data(samples: np.ndarray, sample_rate: int = 24000) -> bytes:
    samples = np.asarray(samples).reshape(-1)
    return _header(len(samples), sample_rate) + _pcm16(samples).tobytes()


def streaming_wav_header(sample_rate: int = 24000) -> bytes:
    """WAV header for a stream of unknown length: the RIFF/data sizes carry
    the 0xFFFFFFFF sentinel players treat as 'read until EOF' (the common
    convention for live WAV streams; a finite rewrite needs seekability,
    which an HTTP chunked response does not have)."""
    h = bytearray(_header(0, sample_rate))
    h[4:8] = struct.pack("<I", 0xFFFFFFFF)
    h[40:44] = struct.pack("<I", 0xFFFFFFFF - 36)
    return bytes(h)


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """Raw 16-bit little-endian PCM for appending to a streamed WAV."""
    return _pcm16(np.asarray(samples).reshape(-1)).tobytes()


def write_wav(samples: np.ndarray, path: str | os.PathLike, sample_rate: int = 24000) -> None:
    with open(path, "wb") as f:
        f.write(wav_data(samples, sample_rate))


def wav_to_float_samples(data: bytes) -> np.ndarray:
    """16-bit PCM WAV bytes -> float32 samples in [-1, 1]
    (reference Qwen3TTSPipeline.swift:1006-1020: fixed 44-byte header assumed)."""
    if len(data) <= 44:
        return np.zeros(0, dtype=np.float32)
    pcm = np.frombuffer(data[44: 44 + (len(data) - 44) // 2 * 2], dtype="<i2")
    return pcm.astype(np.float32) / 32767.0


def parse_wav(data: bytes) -> tuple[np.ndarray, int, int]:
    """Strict RIFF/WAVE parse -> (float32 samples in [-1, 1] with channels
    interleaved, sample_rate, num_channels). Raises ValueError on anything
    that is not integer-PCM 16-bit WAV.

    `wav_to_float_samples` keeps the reference's blind 44-byte skip
    (Qwen3TTSPipeline.swift:1006-1020) for parity; this parser is for
    UNTRUSTED boundaries (the HTTP reference-audio input), where real-world
    files carry LIST/INFO/fact chunks after fmt and a blind skip would
    silently decode garbage into the voice-cloning encoders."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, pcm = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt " and len(body) >= 16:
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
            # a streaming header's 0xFFFFFFFF sentinel means read-to-EOF
            if size in (0xFFFFFFFF, 0xFFFFFFFF - 36):
                pcm = data[pos + 8:]
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or pcm is None:
        raise ValueError("WAV is missing its fmt or data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise ValueError(
            f"only 16-bit integer PCM is supported "
            f"(got format={audio_format}, bits={bits})"
        )
    if channels < 1:
        raise ValueError("WAV has no channels")
    pcm16 = np.frombuffer(pcm[: len(pcm) // 2 * 2], dtype="<i2")
    return pcm16.astype(np.float32) / 32767.0, int(rate), int(channels)


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM mono WAV produced by this module."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 44 or data[:4] != b"RIFF":
        raise ValueError("not a WAV file")
    sample_rate = struct.unpack("<I", data[24:28])[0]
    return wav_to_float_samples(data), sample_rate


class StreamingWAVWriter:
    """Incremental WAV writer (reference AudioSampleWriter.swift:44-106)."""

    def __init__(self, path: str | os.PathLike, sample_rate: int = 24000):
        self.path = os.fspath(path)
        self.sample_rate = sample_rate
        self.sample_count = 0
        self._f = open(self.path, "wb")
        self._f.write(b"\x00" * 44)

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples).reshape(-1)
        self._f.write(_pcm16(samples).tobytes())
        self.sample_count += len(samples)

    def finalize(self) -> int:
        self._f.seek(0)
        self._f.write(_header(self.sample_count, self.sample_rate))
        self._f.close()
        return self.sample_count

    def __enter__(self) -> "StreamingWAVWriter":
        return self

    def __exit__(self, *exc) -> None:
        if not self._f.closed:
            self.finalize()
