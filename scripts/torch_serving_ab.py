"""Batched streaming first audio, serving RTF and lockstep-graph capture
time of the PyTorch port of one checkout on one GPU, so that two commits
(or one commit with a part swapped back) can be compared on one card:

    python3 scripts/torch_serving_ab.py --model DIR --write          # once
    python3 scripts/torch_serving_ab.py --model DIR [--root ROOT] [--variant V]

`--write` writes a random-weight 0.6B model dir (seed 0, bf16) to DIR and
exits. Otherwise `--root` is the checkout whose `qwen3_tts_tpu_torch` is
imported (default: the one holding this script). Run the trees in one call,
in turns (parent, change, change, parent), on one model dir.

Loads the default (megakernel) configuration and, as chip_smoke's serving
phase does, runs `generate_many` on its 8 texts at T = 0 and 0.85 (96
frames), then `generate_many_stream` at B = 8 (T = 0.85) twice: the first
call captures its lockstep graph, the second replays it. Each call prints
its first audio per text, serving RTF, and the host seconds spent in each
part of the call (prompt assembly, prefills, admissions, graph warm-up and
capture split into the eager and the recorded step, gc.collect,
empty_cache, synchronize, capture_begin and capture_end; the vocoder).
Where the tree has `service.py`, it then times
`TTSService(batch_size=8).warmup()` with the same split for each graph it
captures.

`--phase service` instead runs chip_smoke's service phase of the same tree
(`phase_service`: HTTP on localhost, B = 8) once and prints its metrics
with a timeline of the service's host calls by thread (submit, prefill,
admission, bind, capture, decode chunk dispatch, vocoder dispatch), in
seconds from the start of the phase.

`--variant` swaps a part of the change back, to find which part moves a
number: `global` captures in torch's default (global) capture mode,
`old_w8r` takes the `w8r` product as one fp32 matmul of x (TF32 is off in
this script, as in chip_smoke, so that is the product before the change).
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import json
import os
import subprocess
import sys
import time

TEXT = ("The quick brown fox jumps over the lazy dog, and then it runs far "
        "away into the quiet green forest.")
SERVE_TEXTS = (
    "Good morning.",
    "The train leaves at half past nine from the second platform.",
    "Please remember to water the plants on the balcony before you go out tonight.",
    "A short one.",
    TEXT,
    "Numbers like twelve, forty and three hundred are read out in full by the voice.",
    "The museum opens its new wing to the public next week, with paintings from four "
    "centuries and a garden of sculptures behind the old library.",
    "Thank you for calling, we will be with you shortly.",
)

SPENT: collections.Counter = collections.Counter()
CAPTURES: list = []
EVENTS: list = []
T0 = [0.0]


def traced(name: str, fn, detail=None):
    """fn, appending (start s, end s, thread, name, detail) to EVENTS."""
    import threading

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            EVENTS.append((round(t0 - T0[0], 4), round(time.perf_counter() - T0[0], 4),
                           threading.current_thread().name, name,
                           detail(*args, **kwargs) if detail else None))
    return run


def service_phase(torch, srv, pl, root: str) -> dict:
    """chip_smoke.phase_service of the tree at `root`, traced."""
    import chip_smoke

    from qwen3_tts_tpu_torch import service

    if not chip_smoke.__file__.startswith(root):
        raise SystemExit(f"imported {chip_smoke.__file__}, not the checkout at {root}")
    svc = service.TTSService
    svc.submit = traced("submit", svc.submit, lambda self, text, *a, **k: text[:24])
    srv.prefill_batched = traced("prefill", srv.prefill_batched,
                                 lambda p, e, *a, **k: int(e.shape[0]))
    srv.admit_stream = traced("admit", srv.admit_stream, lambda st, slot, *a, **k: slot)
    srv.bind = traced("bind", srv.bind)
    srv.decode_chunk_serving = traced("decode_chunk", srv.decode_chunk_serving,
                                      lambda p, cp, st, *a, **k: int(st["logits"].shape[0]))
    srv.vocode_rows_dispatch = traced("vocode", srv.vocode_rows_dispatch,
                                      lambda rows, *a, **k: len(rows))
    srv.LockstepGraph.__init__ = traced("capture", srv.LockstepGraph.__init__,
                                        lambda self, *a, **k: None)
    T0[0] = time.perf_counter()
    _, m = chip_smoke.phase_service(pl, chip_smoke.card_line())
    return {"metrics": m, "events": sorted(EVENTS)}


def timed(name: str, fn):
    """fn, adding its host seconds to SPENT[name] (outermost call only)."""
    depth = [0]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[0] -= 1
            if not depth[0]:
                SPENT[name] += time.perf_counter() - t0
    return run


def instrument(torch, srv, pl) -> None:
    srv.prefill_batched = timed("prefill", srv.prefill_batched)
    srv.admit_stream = timed("admit", srv.admit_stream)
    srv.lockstep_step = timed("lockstep_step", srv.lockstep_step)
    srv.vocode_rows_dispatch = timed("vocode_dispatch", srv.vocode_rows_dispatch)
    srv.resolve_vocoded = timed("vocode_resolve", srv.resolve_vocoded)
    pl._assemble_many = timed("assemble", pl._assemble_many)
    gc.collect = timed("gc.collect", gc.collect)
    torch.cuda.empty_cache = timed("empty_cache", torch.cuda.empty_cache)
    torch.cuda.synchronize = timed("synchronize", torch.cuda.synchronize)
    g = torch.cuda.CUDAGraph
    g.capture_begin = timed("capture_begin", g.capture_begin)
    g.capture_end = timed("capture_end", g.capture_end)
    init = srv.LockstepGraph.__init__

    @functools.wraps(init)
    def graph_init(self, *args, **kwargs):
        before = dict(SPENT)
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        total = time.perf_counter() - t0
        parts = {k: round(v - before.get(k, 0.0), 6) for k, v in SPENT.items()
                 if v != before.get(k, 0.0)}
        CAPTURES.append({"key": [self.key[0], self.key[1], self.key[2], self.key[5]],
                         "init_s": total, "capture_s": self.capture_s, "parts": parts})
        SPENT["graph_init"] += total
    srv.LockstepGraph.__init__ = graph_init


def apply_variant(torch, lin, variant: str) -> None:
    if variant == "global":
        graph = torch.cuda.graph

        def global_mode(*args, **kwargs):
            kwargs.pop("capture_error_mode", None)
            return graph(*args, **kwargs)
        torch.cuda.graph = global_mode
    elif variant == "old_w8r":
        def old(params, x):
            y = torch.matmul(x.float(), params["w8r"].float().transpose(-1, -2))
            s = params["s"][..., 0, :].float()
            m = params["m"][..., 0, :].float()
            return (y * s + m * x.float().sum(-1, keepdim=True)).to(x.dtype)
        lin._w8r_linear = old
    elif variant != "as_is":
        raise SystemExit(f"unknown variant {variant}")


def stream_run(torch, pl) -> dict:
    SPENT.clear()
    del CAPTURES[:]
    first, n = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, ch in pl.generate_many_stream(list(SERVE_TEXTS), "aiden", temperature=0.85,
                                         max_tokens=96, batch_size=8, seed=0):
        if len(ch.samples) and i not in first:
            first[i] = time.perf_counter() - t0
        n += len(ch.samples)
    secs = time.perf_counter() - t0
    return {"first_audio_s": [first[i] for i in sorted(first)],
            "rtf": secs / (n / pl.sample_rate), "secs": secs,
            "spent": {k: round(v, 6) for k, v in SPENT.items()}, "captures": list(CAPTURES)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--model", required=True)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--variant", default="as_is")
    ap.add_argument("--phase", choices=("stream", "service"), default="stream")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.ops import linear as lin
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    apply_variant(torch, lin, args.variant)
    pl = qt.Qwen3TTSPipeline(args.model, device="cuda")
    pl.generate(TEXT, "aiden", max_tokens=96, seed=0)
    if args.phase == "service":
        print(json.dumps({"tree": root, "variant": args.variant,
                          **service_phase(torch, srv, pl, root)}), flush=True)
        return 0
    for temp in (0.0, 0.85):
        pl.generate_many(list(SERVE_TEXTS), "aiden", temperature=temp, max_tokens=96, seed=0)
    instrument(torch, srv, pl)
    out = {"tree": root, "variant": args.variant,
           "stream_capturing": stream_run(torch, pl), "stream_replaying": stream_run(torch, pl)}
    if os.path.exists(os.path.join(root, "qwen3_tts_tpu_torch", "service.py")):
        from qwen3_tts_tpu_torch.service import TTSService

        SPENT.clear()
        del CAPTURES[:]
        svc = TTSService(pl, batch_size=8)
        try:
            t0 = time.perf_counter()
            svc.warmup()
            out["service_warmup"] = {"secs": time.perf_counter() - t0,
                                     "spent": {k: round(v, 6) for k, v in SPENT.items()},
                                     "captures": list(CAPTURES)}
        except Exception as e:  # a variant may fail here; the stream runs still count
            out["service_warmup"] = {"error": repr(e)}
        finally:
            svc.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
