"""The port's sharded train step across gloo processes on the CPU
(parallel/sharding.py, parallel/dryrun.py): mesh shapes, the tp
divisibility guard, and tp = 2, dp = 2 x tp = 2, tp = 4 and dp = 1 x sp = 2
x tp = 2, each held against the single-process step on the same inputs:
the loss, the parts, every leaf's gradient and the updated params within
rel 1e-5 (fp32 sums in another order across ranks; leaves whose gradient
is zero must be zero on both sides)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.parallel import dryrun, train
from qwen3_tts_tpu_torch.parallel import sharding as sh
from qwen3_tts_tpu_torch.testing import tiny_talker_config

torch.set_num_threads(1)
REL = 1e-5


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def assert_trees_close(got: dict, ref: dict, label: str) -> None:
    _, gl = train._flatten(got)
    paths, rl = train._flatten(ref)
    assert len(gl) == len(rl)
    for path, g, r in zip(paths, gl, rl):
        if not bool(r.any()):
            assert not bool(g.any()), (label, path)
        else:
            assert rel_rms(g, r) <= REL, (label, path, rel_rms(g, r))


def test_mesh_shapes(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        sh.make_mesh()
    sh.init_process_group("cpu", 0, 1, f"file://{tmp_path}/rendezvous", timeout_s=30)
    try:
        mesh = sh.make_mesh()
        assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
        for bad in (dict(n_devices=2), dict(tp=2), dict(tp=1, sp=2)):
            with pytest.raises(ValueError):
                sh.make_mesh(**bad)
    finally:
        dist.destroy_process_group()


def test_tp_divisibility_guard():
    config = tiny_talker_config()
    sh.validate_tp_divisibility(config, 2)
    with pytest.raises(ValueError, match="num_key_value_heads"):
        sh.validate_tp_divisibility(config, 4)
    sh.validate_tp_divisibility(tiny_talker_config(num_attention_heads=8,
                                                   num_key_value_heads=4), 4)
    with pytest.raises(ValueError, match="intermediate_size"):
        sh.validate_tp_divisibility(tiny_talker_config(num_key_value_heads=4,
                                                       num_attention_heads=8,
                                                       intermediate_size=126), 4)


HEADS_8_4 = {"num_attention_heads": 8, "num_key_value_heads": 4}
# world size -> its meshes (tp, sp, overrides), each world size's run in one
# spawned group of processes
CASES = {
    "tp2": (2, (2, 1, {})),
    "dp2_tp2": (4, (2, 1, {})),
    "tp4": (4, (4, 1, HEADS_8_4)),
    "sp2_tp2": (4, (2, 2, {})),
}
MESHES = {"tp2": {"dp": 1, "tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2},
          "tp4": {"dp": 1, "tp": 4}, "sp2_tp2": {"dp": 1, "sp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def dry_runs():
    """case id -> dryrun output, each world size's meshes run once, in one
    group (two spawns for the four cases), when a case first asks."""
    done: dict = {}

    def get(case: str) -> dict:
        world = CASES[case][0]
        if case not in done:
            ids = [c for c, (w, _) in CASES.items() if w == world]
            outs = dryrun.run_meshes(world, [CASES[c][1] for c in ids], timeout_s=120.0)
            done.update(zip(ids, outs))
        return done[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_single_process(case, dry_runs):
    out = dry_runs(case)
    assert out["mesh"] == MESHES[case]
    overrides = CASES[case][1][2]

    config, talker, cp, batch = dryrun.problem(**overrides)
    both = {"talker": talker, "cp": cp}
    loss, parts, grads = train.tts_value_and_grad(both, batch, config)
    optimizer, step = train.make_tts_train_step(config)
    both, _, loss2, _ = step(both, optimizer.init(both), batch)
    np.testing.assert_allclose(float(loss2), float(loss), rtol=0)

    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=REL)
    for k in ("code0", "cp"):
        np.testing.assert_allclose(float(out["parts"][k]), float(parts[k]), rtol=REL)
    unfused = lambda t: dict(t, talker=sh.unfuse_qkv_gateup(t["talker"], config))  # noqa: E731
    assert_trees_close(out["grads"], unfused(grads), "grads")
    assert_trees_close(out["params"], unfused(both), "params")
