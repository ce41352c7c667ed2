"""Basic generation CLI for the PyTorch port.

Usage:
    python -m qwen3_tts_tpu_torch.cli <model-path> [out.wav] [speaker] [text...]

Runs on QWEN3TTS_DEVICE (default "cuda"; raises when CUDA is missing) and
prints load time, generation time, audio duration and the real-time factor
(generation time / audio duration), then writes a 24 kHz 16-bit PCM WAV.
"""

from __future__ import annotations

import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    model_path = argv[0]
    out_path = argv[1] if len(argv) > 1 else "output.wav"
    speaker = argv[2] if len(argv) > 2 else "aiden"
    text = (
        " ".join(argv[3:])
        if len(argv) > 3
        else "Hello! This is a test of the Qwen3 text to speech system on a GPU."
    )

    from .io.wav import write_wav
    from .pipeline import Qwen3TTSPipeline

    t0 = time.perf_counter()
    pipeline = Qwen3TTSPipeline(model_path)
    print(f"Model loaded in {time.perf_counter() - t0:.2f}s on {pipeline.device}")
    print(f"Available speakers: {', '.join(pipeline.available_speakers)}")

    max_tokens = int(os.environ.get("QWEN3TTS_MAX_TOKENS", "0")) or None
    t1 = time.perf_counter()
    samples = pipeline.generate(text, speaker, max_tokens=max_tokens)
    gen_time = time.perf_counter() - t1
    duration = len(samples) / pipeline.sample_rate
    print(f"Generated {duration:.2f}s of audio in {gen_time:.2f}s")
    if duration > 0:
        print(f"Real-time factor: {gen_time / duration:.3f}")
    write_wav(samples, out_path, pipeline.sample_rate)
    print(f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
