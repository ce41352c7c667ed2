"""Checkpoints of the port's train state (parallel/checkpoint.py) on the
CPU, one process: an exact round trip into a fresh template, a resumed step
equal to an uninterrupted one, retention of the newest `keep` steps, and
read paths that raise FileNotFoundError without creating anything."""

import os

import pytest
import torch

from qwen3_tts_tpu_torch.parallel import checkpoint as ck
from qwen3_tts_tpu_torch.parallel import dryrun, train

torch.set_num_threads(1)


def new_state():
    config, talker, cp, batch = dryrun.problem()
    both = {"talker": talker, "cp": cp}
    optimizer, step = train.make_tts_train_step(config)
    return {"params": both, "opt_state": optimizer.init(both)}, step, batch


def assert_equal_trees(got, ref) -> None:
    paths, gl = train._flatten(got)
    _, rl = train._flatten(ref)
    assert len(gl) == len(rl)
    for path, g, r in zip(paths, gl, rl):
        assert g.dtype == r.dtype and g.device == r.device and torch.equal(g, r), path


def test_round_trip_is_exact(tmp_path):
    state, step, batch = new_state()
    step(state["params"], state["opt_state"], batch)
    ck.save_train_state(str(tmp_path), 1, state)
    assert sorted(os.listdir(tmp_path)) == ["1"]  # no temporary left behind
    template, _, _ = new_state()
    restored_step, restored = ck.restore_train_state(str(tmp_path), template)
    assert restored_step == 1
    assert_equal_trees(restored, state)
    assert int(restored["opt_state"]["count"]) == 1
    # a fresh copy: the template is left as it was
    assert int(template["opt_state"]["count"]) == 0


def test_resume_equals_uninterrupted(tmp_path):
    state, step, batch = new_state()
    step(state["params"], state["opt_state"], batch)
    ck.save_train_state(str(tmp_path), 1, state)
    _, _, loss, parts = step(state["params"], state["opt_state"], batch)

    template, step2, _ = new_state()
    _, resumed = ck.restore_train_state(str(tmp_path), template)
    _, _, rloss, rparts = step2(resumed["params"], resumed["opt_state"], batch)
    assert torch.equal(rloss, loss) and all(torch.equal(rparts[k], parts[k]) for k in parts)
    assert_equal_trees(resumed, state)


def test_retention_keeps_the_newest(tmp_path):
    state = {"w": torch.arange(6.0), "count": torch.zeros((), dtype=torch.int64)}
    d = str(tmp_path / "run")
    for s in range(1, 6):
        state["count"].fill_(s)
        ck.save_train_state(d, s, state, keep=2)
    assert ck.all_steps(d) == [4, 5] and ck.latest_step(d) == 5
    assert int(ck.restore_train_state(d, state, step=4)[1]["count"]) == 4
    with pytest.raises(FileNotFoundError):
        ck.restore_train_state(d, state, step=1)
    with pytest.raises(FileExistsError):
        ck.save_train_state(d, 5, state)
    for s in (6, 7):
        ck.save_train_state(d, s, state, keep=None)
    assert ck.all_steps(d) == [4, 5, 6, 7]


def test_missing_directory_raises_and_is_not_created(tmp_path):
    d = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError):
        ck.restore_train_state(d, {"w": torch.zeros(2)})
    assert ck.latest_step(d) is None and ck.all_steps(d) == []
    assert not os.path.exists(d)
    os.makedirs(d)
    with pytest.raises(FileNotFoundError):
        ck.restore_train_state(d, {"w": torch.zeros(2)})
