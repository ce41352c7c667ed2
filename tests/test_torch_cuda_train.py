"""The train step and its checkpoints on the card (marked `cuda`; skipped
where there is no GPU), at the tiny widths of parallel/dryrun.problem in
fp32 (TF32 off). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_train.py -q --noconftest

The card's loss, parts and gradients against the CPU's (rel 1e-5; every
leaf's gradient rel RMS 1e-4: fp32 sums in another order), two steps
likewise; a one-process NCCL (dp = 1, tp = 1) mesh step against the plain
step on the card (the same tolerances); and a checkpoint of CUDA tensors
restored bit for bit onto a CUDA template, and onto a CPU one."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.parallel import checkpoint as ck
from qwen3_tts_tpu_torch.parallel import dryrun, train
from qwen3_tts_tpu_torch.parallel import sharding as sh

pytestmark = pytest.mark.cuda
REL, REL_GRAD = 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = flag


def to(tree, dev):
    return train._map(lambda x: x.to(dev), tree)


def rel_rms(got, ref) -> float:
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-300))


def assert_close(got: dict, ref: dict, tol: float) -> None:
    paths, gl = train._flatten(got)
    for path, g, r in zip(paths, gl, train._flatten(ref)[1]):
        assert (rel_rms(g, r) <= tol) if bool(r.any()) else not bool(g.any()), path


def test_card_step_matches_cpu(card):
    config, talker, cp, batch = dryrun.problem()
    both = {"talker": talker, "cp": cp}
    gboth, gbatch = to(both, card), to(batch, card)
    loss, parts, grads = train.tts_value_and_grad(both, batch, config)
    gloss, gparts, ggrads = train.tts_value_and_grad(gboth, gbatch, config)
    assert gloss.device.type == "cuda"
    np.testing.assert_allclose(float(gloss), float(loss), rtol=REL)
    for k in parts:
        np.testing.assert_allclose(float(gparts[k]), float(parts[k]), rtol=REL)
    assert_close(ggrads, grads, REL_GRAD)

    optimizer, step = train.make_tts_train_step(config)
    state, gstate = optimizer.init(both), optimizer.init(gboth)
    for _ in range(2):
        _, _, loss, _ = step(both, state, batch)
        _, _, gloss, _ = step(gboth, gstate, gbatch)
        np.testing.assert_allclose(float(gloss), float(loss), rtol=REL)
    assert_close(gboth, both, REL)


def test_one_process_nccl_mesh_matches_plain_step(card, tmp_path):
    config, talker, cp, batch = dryrun.problem()
    both, batch = to({"talker": talker, "cp": cp}, card), to(batch, card)
    sh.init_process_group("cuda", 0, 1, f"file://{tmp_path}/rendezvous", timeout_s=60)
    try:
        mesh = sh.make_mesh()
        assert mesh.device_type == "cuda" and dist.get_backend() == "nccl"
        sharded = {"talker": sh.shard_params(both["talker"], mesh, config=config),
                   "cp": train._map(torch.clone, both["cp"])}  # the plain step's stays
        sbatch = sh.shard_batch(batch, mesh)
        optimizer, step = train.make_tts_train_step(config)
        sharded, _, sloss, sparts = step(sharded, optimizer.init(sharded), sbatch)
    finally:
        dist.destroy_process_group()
    both, _, loss, parts = step(both, optimizer.init(both), batch)
    np.testing.assert_allclose(float(sloss), float(loss), rtol=REL)
    for k in parts:
        np.testing.assert_allclose(float(sparts[k]), float(parts[k]), rtol=REL)
    plain = dict(both, talker=sh.unfuse_qkv_gateup(both["talker"], config))
    assert_close(train._map(lambda x: x.full_tensor() if isinstance(x, sh.DTensor) else x,
                            sharded), plain, REL)


def test_checkpoint_of_cuda_tensors(card, tmp_path):
    config, talker, cp, batch = dryrun.problem()
    both = to({"talker": talker, "cp": cp}, card)
    optimizer, step = train.make_tts_train_step(config)
    state = {"params": both, "opt_state": optimizer.init(both)}
    step(state["params"], state["opt_state"], to(batch, card))
    ck.save_train_state(str(tmp_path), 1, state)
    for template in (train._map(torch.zeros_like, state), to(state, "cpu")):
        _, restored = ck.restore_train_state(str(tmp_path), template)
        paths, rl = train._flatten(restored)
        for path, r, t, s in zip(paths, rl, train._flatten(template)[1],
                                 train._flatten(state)[1]):
            assert r.device == t.device and r.dtype == t.dtype, path
            assert torch.equal(r.cpu(), s.cpu()), path
