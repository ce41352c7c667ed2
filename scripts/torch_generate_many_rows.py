"""generate_many of 32 streams on one checkout of the PyTorch port, with
enough frames a stream that chunked_decode stacks more than 39 rows of 110
frames into its one vocoder call (the rows K6's grid took before its row
tiles moved to gridDim.x), so that a checkout with and without the repair
can be run on one card:

    python3 scripts/torch_generate_many_rows.py [--root ROOT] [--frames N]

`--root` is the checkout whose `qwen3_tts_tpu_torch` is imported (default:
the one holding this script); its kernels build into `ROOT/build/kernels`.
Writes a random-weight 0.6B model dir (seed 0, bf16) to a temporary
directory, loads the default configuration and runs generate_many of 32
texts at temperature 0.85 and `--frames` frames (120: two 100-frame chunks
a stream, 64 rows). Prints the card, then one JSON line: the vocoder's rows
and whether the call returned finite audio, or the error it raised.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import vocoder as voc
    from qwen3_tts_tpu_torch.ops.cuda import _build
    from qwen3_tts_tpu_torch.testing import write_model_dir

    if not qt.__file__.startswith(root):
        raise SystemExit(f"imported {qt.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.lib()
    texts = [f"Stream {i} of thirty two reads a sentence of its own." for i in range(32)]
    rows, decode = [], voc.decode_frames

    def recording(params, codes, cfg):
        rows.append(int(codes.shape[0]))
        return decode(params, codes, cfg)

    voc.decode_frames = recording
    out = {"root": root, "frames": args.frames}
    with tempfile.TemporaryDirectory() as d:
        write_model_dir(d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0)
        pl = qt.Qwen3TTSPipeline(d, device="cuda")
        try:
            wavs = pl.generate_many(texts, "aiden", temperature=0.85, max_tokens=args.frames,
                                    seed=0)
            torch.cuda.synchronize()
            out.update(ok=True, finite=all(bool(np.isfinite(w).all()) for w in wavs),
                       samples=[len(w) for w in wavs])
        except Exception as e:  # noqa: BLE001 - the error is the result
            out.update(ok=False, error=f"{type(e).__name__}: {str(e)[:300]}")
    out["vocoder_rows"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
