"""Training checkpoint / resume for the joint TTS train state (counterpart
of qwen3_tts_tpu/parallel/checkpoint.py, which uses orbax).

- torch.distributed.checkpoint writes each step: every rank its shards of
  DTensor leaves, replicated leaves once. In one process without a process
  group it writes alone.
- Each step directory is written synchronously under a temporary name and
  renamed when complete, so a step directory that exists is whole; `keep`
  bounds how many are retained.
- Restore fills a fresh copy of a template (the live state, or any tree of
  the same structure): every leaf lands on the template leaf's device and
  dtype, and a DTensor leaf in its placement on its mesh, so a resumed
  (dp, tp) job keeps its layout. Read paths never create the directory.

The train state is a nested dict of tensors; the canonical one is
{"params": both, "opt_state": opt_state} with both = {"talker", "cp"} as
parallel.train.make_tts_train_step takes it. Directories written by the
JAX package (orbax) are not read.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

__all__ = ["save_train_state", "restore_train_state", "latest_step", "all_steps"]

_TMP = ".tmp-"


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _lead() -> bool:
    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def save_train_state(directory: str, step: int, state: Any, *, keep: int | None = 3) -> None:
    """Write `state` as checkpoint `step` under `directory`, keeping at most
    `keep` most recent steps (None = keep all). Synchronous and atomic: on
    return the step directory is complete. Collective under a process
    group: every rank calls it."""
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f"{_TMP}{step}")
    if _lead():
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists under {directory}")
        os.makedirs(directory, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    dcp.save(state, checkpoint_id=tmp, no_dist=not _distributed())
    _barrier()
    if _lead():
        os.replace(tmp, final)
        if keep is not None:
            for old in all_steps(directory)[:-keep]:
                shutil.rmtree(os.path.join(directory, str(old)))
    _barrier()


def all_steps(directory: str) -> list[int]:
    """All retained checkpoint steps, ascending ([] if none or no
    directory)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isdir(os.path.join(directory, name)))


def latest_step(directory: str) -> int | None:
    """Most recent checkpoint step under `directory`, or None if none."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _empty_like(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def restore_train_state(directory: str, template: Any, step: int | None = None
                        ) -> tuple[int, Any]:
    """Restore (step, state) from `directory` (default: the latest step)
    into a fresh copy of `template`, each leaf on the template leaf's
    device, dtype and placement. Raises FileNotFoundError if the directory
    holds no such checkpoint. Collective under a process group."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    path = os.path.join(directory, str(step))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint step {step} under {directory}")
    state = _empty_like(template)
    dcp.load(state, checkpoint_id=path, no_dist=not _distributed())
    return int(step), state
