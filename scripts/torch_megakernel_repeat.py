"""Repeat chip_smoke's determinism and one-kernel-per-call checks of K1
(the talker step) and K2 (the code-predictor frame) on one GPU, at the 0.6B
widths on random weights, to tell a kernel fault from a profiler window that
lost records:

    python3 scripts/torch_megakernel_repeat.py [--runs 300] [--windows 40] [--checks 20]

Builds the kernels, runs chip_smoke's megakernels phase up to its persistent
checks on the same inputs, then prints for each kernel:
- how many of `--runs` runs differ from the first run, bit for bit, and in
  which outputs;
- the device-kernel records in each of `--windows` torch.profiler windows of
  4 calls (one window each, never taken again);
and runs chip_smoke's `persistent_checks` `--checks` times. Exits non-zero if
a run differs or a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Done(Exception):
    """Ends the megakernels phase after its persistent checks."""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--checks", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    checks = cs.persistent_checks
    differing = []

    def repeat(card, cfg, tkp, ckp, seed, k1_main, k2_main, lay_bytes, head_bytes):
        from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
        from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

        dev = torch.device("cuda")
        cc = cfg.code_predictor_config
        _, _, (embed, cache, pos_t, ws_t, cos, sin) = k1_main
        _, (hidden, code0, seen) = k2_main

        def k1():
            c = {k: v.clone() for k, v in cache.items()}
            h, lg, c = tmk.talker_step_kernel(tkp, embed, c, pos_t, ws_t, cos, sin, cfg)
            return h, lg, c["k2"], c["v2"], c["pos"]

        def k2():
            lg = torch.empty(cc.num_code_groups - 1, cc.vocab_size, device=dev)
            codes, esum, s = cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85,
                                                      seen.clone(), cc, logits_out=lg)
            return codes, esum, s, lg

        calls = (lambda: tmk.talker_step_kernel(tkp, embed, cache, pos_t, ws_t, cos, sin, cfg),
                 lambda: cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85, None, cc))
        for name, fn, call in (("talker_step", k1, calls[0]), ("cp_frame", k2, calls[1])):
            ref = fn()
            torch.cuda.synchronize()
            bad = {}
            for i in range(args.runs):
                got = fn()
                torch.cuda.synchronize()
                d = [j for j, (x, y) in enumerate(zip(ref, got)) if not torch.equal(x, y)]
                if d:
                    bad[i] = d
            differing.extend(bad)
            cs.log(f"[repeat] {name}: {len(bad)} of {args.runs} runs differ from the first "
                   f"(run: outputs) {dict(list(bad.items())[:10])} ({card})")
            records = []
            t0 = time.perf_counter()
            for _ in range(args.windows):
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(4):
                        call()
                    torch.cuda.synchronize()
                records.append(len(cs.device_kernels(prof)))
            cs.log(f"[repeat] {name}: records in {args.windows} windows of 4 calls: {records} "
                   f"({time.perf_counter() - t0:.1f} s)")
        for _ in range(args.checks):
            checks(card, cfg, tkp, ckp, seed, k1_main, k2_main, lay_bytes, head_bytes)
        cs.log(f"[repeat] persistent_checks passed {args.checks} times")
        raise _Done

    from qwen3_tts_tpu_torch.ops.cuda import _build

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.testing import write_model_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    _build.build(force=True)
    _build.lib()
    cs.persistent_checks = repeat
    with tempfile.TemporaryDirectory() as d:
        td, cd, _ = write_model_dir(d, qt.Qwen3TTSConfig.standard(),
                                    qt.TokenizerDecoderConfig(), seed=0)
        try:
            cs.phase_megakernels(cs.Record(), card, td, cd)
        except _Done:
            pass
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
