"""The port's train step (parallel/train.py) against the JAX package's
jitted single-device functions on the CPU in fp32, from the same seeded
numpy params (the tiny config with a 48-wide code predictor, so its
small_to_mtp_projection runs) and batch (frames past the code predictor's
vocabulary, clipped; a mask with zeros).

Tolerances: loss and parts rel 1e-5; every leaf's gradient rel RMS 1e-4
(fp32 sums in another order through both stacks); after three AdamW steps
every param leaf rel RMS 1e-5 against optax.adamw and the moments 1e-4
(gradient-derived); the leaves the loss never reads get exactly zero
gradients on both sides, and still decay."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.parallel import train as jtrain
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.parallel import sharding as sh
from qwen3_tts_tpu_torch.parallel import train
from qwen3_tts_tpu_torch.testing import (
    config_to_json_dict,
    random_host_cp_params,
    random_host_talker_params,
    tiny_talker_config,
)

torch.set_num_threads(1)
REL_LOSS, REL_GRAD, REL_PARAM = 1e-5, 1e-4, 1e-5
UNREAD_TTS = {("talker", "text_embedding", "w"), ("talker", "text_projection", "fc1", "w"),
              ("talker", "text_projection", "fc1", "b"), ("talker", "text_projection", "fc2", "w"),
              ("talker", "text_projection", "fc2", "b")}


def rel_rms(got, ref) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got,
                                                                                       np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def close(got, ref, tol: float) -> bool:
    """rel RMS <= tol, or both exactly zero where the reference is."""
    if not np.asarray(ref).any():
        return not bool(got.any())
    return rel_rms(got, ref) <= tol


def leaves(tree) -> dict:
    paths, ls = train._flatten(tree)
    return dict(zip(paths, ls))


def jleaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): np.asarray(v) for path, v in flat}


@pytest.fixture(scope="module")
def setup():
    base = tiny_talker_config()
    tcfg = tiny_talker_config(
        code_predictor_config=dataclasses.replace(base.code_predictor_config, hidden_size=48))
    jcfg = JConfig.from_json(config_to_json_dict(tcfg))
    both_np = {"talker": random_host_talker_params(tcfg, 0), "cp": random_host_cp_params(tcfg, 1)}
    assert "small_to_mtp_projection" in both_np["cp"]
    rng = np.random.default_rng(2)
    b, t, ng = 2, 6, 16
    mask = np.ones((b, t), np.float32)
    mask[1, -2:] = 0.0
    batch_np = {
        "embeds": rng.standard_normal((b, t, tcfg.hidden_size), dtype=np.float32),
        "frames": rng.integers(0, tcfg.vocab_size, (b, t, ng)),  # past the cp vocab (2048)
        "targets": rng.integers(0, tcfg.vocab_size, (b, t)),
        "mask": mask,
    }
    assert (batch_np["frames"][..., 1:] >= tcfg.code_predictor_config.vocab_size).any()
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
              for k, v in batch_np.items()}
    jboth = jax.tree.map(jnp.asarray, both_np)

    def jtts(both, batch, remat=False):
        return jtrain.tts_loss(both["talker"], both["cp"], batch, jcfg, remat=remat)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(jtts, has_aux=True))(jboth, jbatch)
    jl_nf, jg_nf = jax.jit(jax.value_and_grad(
        lambda p, bt: jtrain.next_frame_loss(p, bt, jcfg)))(jboth["talker"], jbatch)
    jax.block_until_ready((jl, jg, jl_nf, jg_nf))
    ref = {"loss": float(jl), "parts": {k: float(v) for k, v in jparts.items()},
           "grads": jleaves(jg), "nf_loss": float(jl_nf), "nf_grads": jleaves(jg_nf)}
    return tcfg, jcfg, both_np, batch_np, jboth, jbatch, ref


def torch_inputs(both_np, batch_np):
    return to_torch(both_np), {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}


def check_tts(loss, parts, grads, ref) -> None:
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=REL_LOSS)
    for k in ("code0", "cp"):
        np.testing.assert_allclose(float(parts[k]), ref["parts"][k], rtol=REL_LOSS)
    got = leaves(grads)
    assert set(got) == set(ref["grads"])
    for path, g in got.items():
        r = ref["grads"][path]
        if path in UNREAD_TTS:
            assert not r.any() and not bool(g.any()), path
        else:
            assert rel_rms(g, r) <= REL_GRAD, (path, rel_rms(g, r))


def test_losses_and_gradients_match_jax(setup):
    tcfg, _, both_np, batch_np, _, _, ref = setup
    both, batch = torch_inputs(both_np, batch_np)
    loss, parts, grads = train.tts_value_and_grad(both, batch, tcfg)
    check_tts(loss, parts, grads, ref)
    assert not bool(grads["cp"]["codec_embedding"]["w"][-1].any())  # the 15th table: unread

    # next_frame_loss through the step's own gradient path, then make_train_step
    def nf(params, b, par):
        return train.next_frame_loss(params, b, tcfg, par=par), {}

    loss, _, _, grads = train._value_and_grad(nf, both["talker"], batch)
    np.testing.assert_allclose(float(loss), ref["nf_loss"], rtol=REL_LOSS)
    for path, g in zip(train._flatten(both["talker"])[0], grads):
        r = ref["nf_grads"][path]
        if path[0] in ("text_embedding", "text_projection", "codec_embedding"):
            assert not r.any() and not bool(g.any()), path  # never read
        else:
            assert rel_rms(g, r) <= REL_GRAD, (path, rel_rms(g, r))
    optimizer, step = train.make_train_step(tcfg)
    table = both["talker"]["text_embedding"]["w"].clone()
    _, state, loss = step(both["talker"], optimizer.init(both["talker"]), batch)
    np.testing.assert_allclose(float(loss), ref["nf_loss"], rtol=REL_LOSS)
    assert int(state["count"]) == 1
    np.testing.assert_allclose(both["talker"]["text_embedding"]["w"].numpy(),  # decayed
                               (table * (1 - optimizer.lr * optimizer.weight_decay)).numpy(),
                               rtol=1e-6)


def test_three_adamw_steps_match_optax(setup):
    tcfg, jcfg, both_np, batch_np, jboth, jbatch, _ = setup
    joptimizer, jstep = jtrain.make_tts_train_step(jcfg)
    jstate = joptimizer.init(jboth)
    both, batch = torch_inputs(both_np, batch_np)
    optimizer, step = train.make_tts_train_step(tcfg)
    state = optimizer.init(both)
    decayed = both["talker"]["text_embedding"]["w"].clone()
    for _ in range(3):
        jboth, jstate, jl, _ = jstep(jboth, jstate, jbatch)
        both, state, loss, _ = step(both, state, batch)
        np.testing.assert_allclose(float(loss), float(jl), rtol=REL_LOSS)
    assert int(state["count"]) == 3
    got, ref = leaves(both), jleaves(jboth)
    for path, r in ref.items():
        assert close(got[path], r, REL_PARAM), path
    # an unread leaf decays by lr * wd a step, as in optax
    lr_wd = optimizer.lr * optimizer.weight_decay
    np.testing.assert_allclose(got[("talker", "text_embedding", "w")].numpy(),
                               (decayed * (1 - lr_wd) ** 3).numpy(), rtol=1e-6)
    adam = jstate[0]
    for name, moments in (("mu", adam.mu), ("nu", adam.nu)):
        mine = leaves(state[name])
        for path, r in jleaves(moments).items():
            assert close(mine[path], r, REL_GRAD), (name, path)


def test_remat_gives_the_same_numbers(setup):
    tcfg, _, both_np, batch_np, _, _, ref = setup
    both, batch = torch_inputs(both_np, batch_np)
    plain = train.tts_value_and_grad(both, batch, tcfg)
    remat = train.tts_value_and_grad(both, batch, tcfg, remat=True)
    check_tts(*remat, ref)
    assert torch.equal(remat[0], plain[0])
    for path, g in leaves(remat[2]).items():
        assert torch.equal(g, leaves(plain[2])[path]), path


def test_unfused_layout_equals_fused(setup):
    tcfg, _, both_np, batch_np, _, _, ref = setup
    both, batch = torch_inputs(both_np, batch_np)
    loss, parts, grads = train.tts_value_and_grad(both, batch, tcfg)
    unfused = dict(both, talker=sh.unfuse_qkv_gateup(both["talker"], tcfg))
    assert "q" in unfused["talker"]["layers"]["qkv_proj"]
    uloss, uparts, ugrads = train.tts_value_and_grad(unfused, batch, tcfg)
    np.testing.assert_allclose(float(uloss), float(loss), rtol=REL_LOSS)
    want = leaves(dict(grads, talker=sh.unfuse_qkv_gateup(grads["talker"], tcfg)))
    for path, g in leaves(ugrads).items():
        assert close(g, want[path].numpy(), REL_LOSS), path
    check_tts(uloss, uparts, dict(ugrads, talker=grads["talker"]), ref)
    # the inference path takes the unfused layout too
    cache = lambda: ttalker.init_kv_cache(tcfg, 8, batch=2)  # noqa: E731
    fused_h, _ = ttalker.talker_prefill(both["talker"], batch["embeds"], cache(), tcfg)
    unfused_h, _ = ttalker.talker_prefill(unfused["talker"], batch["embeds"], cache(), tcfg)
    assert rel_rms(unfused_h, fused_h.detach().numpy()) <= REL_LOSS
