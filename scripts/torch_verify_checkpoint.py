"""Verify a checkpoint directory against a golden parity file with the
PyTorch port (counterpart of scripts/verify_checkpoint.py):

    # 1) layout audit (key / shape manifests):
    python scripts/torch_audit_checkpoint.py <model_dir>
    # 2) golden parity (greedy frames + per-stage checksums), on the CPU:
    python scripts/torch_verify_checkpoint.py <model_dir> \
        --golden tests/golden/tiny_reference_format.json --device cpu

Writing a golden (the exact mode: fp32, no runtime quantization, the
megakernels and vocoder kernels off, TF32 off on CUDA):

    python scripts/torch_verify_checkpoint.py <model_dir> --write-golden out.json

`--production --tier tpu-bf16` checks the serving path instead (the
pipeline's default configuration in bf16, on the card: its kernels
included) against the same fp32 golden, by checksums only, the vocoder
waveform included (io/verify.py TOLERANCE_TIERS). `--device` is cuda (the
card) unless cpu is asked for. Exits 0 on PASS, 1 on FAIL.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qwen3_tts_tpu_torch.io import verify  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_dir")
    ap.add_argument("--golden", help="golden JSON to compare against")
    ap.add_argument("--write-golden", help="write the report as a new golden")
    ap.add_argument("--text", default=None)
    ap.add_argument("--speaker", default=None)
    ap.add_argument("--max-tokens", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--rtol", type=float, default=None,
                    help="override the tier's per-checksum tolerances")
    ap.add_argument("--tier", default="cpu-fp32", choices=tuple(verify.TOLERANCE_TIERS))
    ap.add_argument("--production", action="store_true",
                    help="the default configuration in bf16 (the serving path) instead "
                         "of the exact fp32 path")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()

    kwargs = dict(
        text=args.text if args.text is not None else verify.GOLDEN_TEXT,
        speaker=args.speaker if args.speaker is not None else verify.GOLDEN_SPEAKER,
        max_tokens=(args.max_tokens if args.max_tokens is not None
                    else verify.GOLDEN_MAX_TOKENS),
        seed=args.seed if args.seed is not None else verify.GOLDEN_SEED,
    )
    if args.golden:
        golden = verify.load_golden(args.golden)
        # the golden's settings win, so the reports compare; a hand-made
        # golden may omit some, which keep the values resolved above
        kwargs = {k: golden.get(k, kwargs[k]) for k in kwargs}
    report = verify.collect_report(args.model_dir, production=args.production,
                                   device=args.device, **kwargs)
    if args.write_golden:
        verify.save_golden(report, args.write_golden)
        print(f"golden written: {args.write_golden}")
        return 0
    if args.golden:
        errs = verify.compare_reports(report, golden, rtol=args.rtol, tier=args.tier)
        if errs:
            print(f"FAIL ({args.tier} tier)")
            for e in errs:
                print(f"  - {e}")
            return 1
        frames_note = (f"{len(report['frames'])} greedy frames and "
                       if verify.TOLERANCE_TIERS[args.tier]["compare_frames"] else "")
        print(f"PASS ({args.tier} tier): {frames_note}{len(report['checksums'])} checksums "
              f"match {args.golden}")
        return 0
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
