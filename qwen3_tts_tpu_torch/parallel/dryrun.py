"""A multi-process dry run of the sharded train step on the CPU (gloo).

The counterpart of the training sections of the JAX package's
`dryrun_multichip`: `run_meshes(world_size, [(tp, sp, overrides), ...])`
starts `world_size` gloo processes (spawned, rendezvous through a file in a
temporary directory, no TCP port to pick) and, for each case, builds a
(dp, tp) or (dp, sp, tp) mesh, shards a tiny talker Megatron-style, places
the batch on dp (and its time axis on sp), and runs one
make_tts_train_step step. It returns rank 0's loss, parts, gradients and
updated params as full tensors, to hold against the single-process step on
the same inputs (`problem`); several meshes of one world size share one
group of processes (one start-up).

    python -m qwen3_tts_tpu_torch.parallel.dryrun 4 2 2   # world, tp, sp

Every process group and join times out (`timeout_s`), so a hang fails.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..convert import to_torch
from ..testing import random_host_cp_params, random_host_talker_params, tiny_talker_config
from . import sharding as sh
from . import train

B, T = 4, 8  # the batch splits over dp = 2 and its time axis over sp = 2


def problem(seed: int = 0, **overrides):
    """(config, talker, cp, batch): the tiny config with `overrides`, fp32
    CPU params from `seed` (fused layout) and a batch whose frames reach
    past the code predictor's vocabulary (clipped) and whose mask has
    zeros."""
    config = tiny_talker_config(**overrides)
    talker = to_torch(random_host_talker_params(config, seed))
    cp = to_torch(random_host_cp_params(config, seed + 1))
    rng = np.random.default_rng(seed + 2)
    mask = np.ones((B, T), np.float32)
    mask[1, -3:] = 0.0
    batch = {
        "embeds": torch.from_numpy(rng.standard_normal((B, T, config.hidden_size),
                                                       dtype=np.float32)),
        "frames": torch.from_numpy(rng.integers(
            0, config.vocab_size, (B, T, config.code_predictor_config.num_code_groups))),
        "mask": torch.from_numpy(mask),
    }
    return config, talker, cp, batch


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, sh.DTensor) else tree


def _worker(rank: int, world_size: int, cases: list, root: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    sh.init_process_group("cpu", rank, world_size, f"file://{root}/rendezvous", timeout_s)
    try:
        for i, (tp, sp, overrides) in enumerate(cases):
            mesh = sh.make_mesh(world_size, tp=tp, sp=sp)
            config, talker, cp, batch = problem(**overrides)
            sh.validate_tp_divisibility(config, tp)
            both = {"talker": sh.shard_params(talker, mesh, config=config), "cp": cp}
            batch = sh.shard_batch(batch, mesh, sp=sp > 1)
            _, _, grads = train.tts_value_and_grad(both, batch, config)
            optimizer, step = train.make_tts_train_step(config)
            opt_state = optimizer.init(both)
            both, opt_state, loss, parts = step(both, opt_state, batch)
            out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), "loss": loss,
                   "parts": parts, "grads": _full(grads), "params": _full(both)}
            if rank == 0:
                torch.save(out, os.path.join(root, f"result{i}.pt"))
    finally:
        dist.destroy_process_group()


def run_meshes(world_size: int, cases: list[tuple[int, int, dict]],
               timeout_s: float = 60.0) -> list[dict]:
    """One sharded train step for each (tp, sp, overrides) of `cases`, all in
    one group of `world_size` spawned gloo processes (one start-up for
    several meshes), each on problem(**overrides). Returns, per case,
    {"mesh": {axis: size}, "loss", "parts", "grads", "params"} from rank 0,
    every tensor full (gathered over tp), params after the step in the
    unfused layout. Raises TimeoutError after `timeout_s` seconds for the
    whole group, and a worker's own error if one fails."""
    with tempfile.TemporaryDirectory() as root:
        ctx = mp.start_processes(_worker, args=(world_size, cases, root, timeout_s),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"dry run (world {world_size}, cases {cases}) "
                                       f"did not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=5)
        return [torch.load(os.path.join(root, f"result{i}.pt"), weights_only=True)
                for i in range(len(cases))]


def main(argv: list[str]) -> int:
    world, tp, sp = (int(a) for a in (argv + ["2", "2", "1"][len(argv):]))
    overrides = {} if 2 % tp == 0 else {"num_attention_heads": 8, "num_key_value_heads": 4}
    out = run_meshes(world, [(tp, sp, overrides)])[0]
    print(f"dry run ok: mesh {out['mesh']}, loss {float(out['loss']):.6f} (code0 "
          f"{float(out['parts']['code0']):.6f}, cp {float(out['parts']['cp']):.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
