"""Single-stream first audio and RTF of the PyTorch port of one checkout on
one GPU, so that two commits can be compared on one card:

    python3 scripts/torch_first_audio.py --model DIR --write          # once
    python3 scripts/torch_first_audio.py --model DIR [--root ROOT]

`--write` writes a random-weight 0.6B model dir (seed 0, bf16) to DIR and
exits. Otherwise `--root` is the checkout whose `qwen3_tts_tpu_torch` is
imported (default: the one holding this script); its kernels build into
`ROOT/build/kernels`. To compare two commits, unpack one with `git archive`
into a directory that .gitignore lists and run both trees in one call, in
turns (parent, change, change, parent), on one model dir.

Loads the default (megakernel) configuration, runs one `generate` and one
`generate_stream` to warm up, then 5 rounds of a `generate_stream` (wall
time to the first non-empty chunk, stream RTF) and a `generate` (RTF), 96
frames of chip_smoke's sentence each. Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TEXT = ("The quick brown fox jumps over the lazy dog, and then it runs far "
        "away into the quiet green forest.")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--model", required=True)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.ops.cuda import _build
    from qwen3_tts_tpu_torch.testing import write_model_dir

    if not qt.__file__.startswith(root):
        raise SystemExit(f"imported {qt.__file__}, not the checkout at {root}")
    if args.write:
        write_model_dir(args.model, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(),
                        seed=0)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.lib()
    pl = qt.Qwen3TTSPipeline(args.model, device="cuda")
    pl.generate(TEXT, "aiden", max_tokens=96, seed=0)
    list(pl.generate_stream(TEXT, "aiden", max_tokens=96, seed=0))
    first, stream_rtf, rtf = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0, f, n = time.perf_counter(), None, 0
        for ch in pl.generate_stream(TEXT, "aiden", max_tokens=96, seed=0):
            if f is None and len(ch.samples):
                f = time.perf_counter() - t0
            n += len(ch.samples)
        first.append(f)
        stream_rtf.append((time.perf_counter() - t0) / (n / pl.sample_rate))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = pl.generate(TEXT, "aiden", max_tokens=96, seed=0)
        rtf.append((time.perf_counter() - t0) / (len(audio) / pl.sample_rate))
    print(json.dumps({"tree": root, "first_audio_s": first, "stream_rtf": stream_rtf,
                      "rtf": rtf, "median_first_audio_s": statistics.median(first),
                      "median_stream_rtf": statistics.median(stream_rtf),
                      "median_rtf": statistics.median(rtf)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
