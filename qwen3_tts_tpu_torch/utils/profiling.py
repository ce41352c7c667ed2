"""Tracing, phase timing and debug logging (counterpart of
qwen3_tts_tpu/utils/profiling.py).

  - PhaseTimer: wall time per named phase; `sync=` takes tensors (or nested
    lists / tuples / dicts of them) and waits for the CUDA streams they were
    queued on before the clock stops, so a phase on the card is timed when
    its work is done, not when it was launched
  - trace(): a torch.profiler window (CPU and, on a CUDA host, CUDA
    activity) written as a Chrome / Perfetto trace into a directory; on
    globally through QWEN3TTS_PROFILE=<dir>, a no-op without it
  - debug(): stderr logging gated by QWEN3TTS_DEBUG_GENERATION=1

As in the JAX package, nothing in the pipeline calls these: callers wrap
what they want to see.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

import torch

DEBUG_ENV = "QWEN3TTS_DEBUG_GENERATION"
PROFILE_ENV = "QWEN3TTS_PROFILE"


def debug_enabled() -> bool:
    return os.environ.get(DEBUG_ENV) == "1"


def debug(*args) -> None:
    if debug_enabled():
        print("[qwen3-tts]", *args, file=sys.stderr, flush=True)


def _wait(tree) -> None:
    """Wait for the current CUDA stream of every CUDA device that holds a
    tensor of `tree`; CPU tensors and other leaves need no wait."""
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class PhaseTimer:
    """Accumulates wall time per named phase.

    with timer.phase("prefill", sync=state):   # sync: tensors to wait for
        ...
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name] * 1e3:.1f} ms"
                f" ({self.counts[name]} calls,"
                f" {self.totals[name] / max(self.counts[name], 1) * 1e3:.2f} ms/call)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A torch.profiler window written to `log_dir` as a Chrome trace
    (trace_<pid>_<n>.json). Uses QWEN3TTS_PROFILE when log_dir is None; a
    no-op when neither is set. Yields the profiler (None when off)."""
    log_dir = log_dir or os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
