"""K1's builder, cache layouts and plain version against the JAX package's
talker megakernel module (its jnp mirror talker_step_w8a8_ref), on the CPU
in fp32 at a tiny width with seeded numpy weights and caches.

Tolerances: the builders are copies and must agree exactly; the step's
hidden state and logits agree to rel RMS 1e-5 (fp32, sums in another
order; the W8A8 integer dots are exact on both sides); the written cache
rows to 1e-5 of their largest value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops.pallas import talker_megakernel as jtk
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as ttk
from qwen3_tts_tpu_torch.testing import random_host_talker_params, tiny_talker_config

torch.set_num_threads(1)
CFG = tiny_talker_config(mrope_section=None)
JCFG = JConfig.from_json(jtesting.config_to_json_dict(CFG))
CAP = 64


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def trees():
    params = random_host_talker_params(CFG, seed=3)
    jtree = jtk.build_talker_kernel_params(params, JCFG)
    return params, jtree, to_torch(ttk.build_talker_kernel_params(params, CFG))


def ring(seed: int, pos: np.ndarray):
    rng = np.random.default_rng(seed)
    shape = (CFG.num_hidden_layers, 1, CFG.num_key_value_heads, CAP, CFG.head_dim)
    k = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    embed = (rng.standard_normal((1, 1, CFG.hidden_size)) * 0.5).astype(np.float32)
    return {"k": k, "v": v, "pos": pos}, embed


def jax_layout(cache2) -> np.ndarray:
    """Port kernel layout [nl, C, nkv*hd] -> the JAX kernel's [C, nl*nkv*hd]."""
    nl, c, w = cache2.shape
    return cache2.permute(1, 0, 2).reshape(c, nl * w).numpy()


def step_both(trees, cache, embed, position, ws):
    _, jtree, ttree = trees
    cos, sin = jtalker._rope_cos_sin(JCFG, jnp.full((1, 1), position, jnp.int32))
    jc2 = jtk.cache_to_kernel_layout({k: jnp.asarray(v) for k, v in cache.items()}, JCFG)
    jh, jlg, jnew = jtk.talker_step_w8a8_ref(
        jtree, jnp.asarray(embed), jc2, jnp.int32(position), jnp.int32(ws),
        cos[0], sin[0], JCFG,
    )
    tc2 = ttk.cache_to_kernel_layout({k: torch.from_numpy(np.array(v)) for k, v in cache.items()})
    th, tlg, tnew = ttk.talker_step(
        ttree, torch.from_numpy(embed), tc2, torch.tensor(position), torch.tensor(ws),
        torch.from_numpy(np.array(cos[0, 0])), torch.from_numpy(np.array(sin[0, 0])), CFG,
    )
    assert rel_rms(th.numpy(), jh) <= 1e-5
    assert rel_rms(tlg.numpy(), jlg) <= 1e-5
    for name in ("k2", "v2"):
        got, ref = jax_layout(tnew[name]), np.asarray(jnew[name])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), name
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    return tlg.numpy()


def test_builder_matches_jax_exactly(trees):
    _, jtree, ttree = trees
    assert sorted(jtree) == sorted(ttree)
    for k, v in jtree.items():
        ref = np.asarray(v)
        assert ttree[k].numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(ttree[k].numpy(), ref, err_msg=k)


def test_step_matches_the_jax_mirror(trees):
    pos = np.where(np.arange(CAP) < 20, np.arange(CAP), -1).astype(np.int64)
    cache, embed = ring(0, pos)
    step_both(trees, cache, embed, position=20, ws=0)


def test_window_masking_with_wraparound(trees):
    """Past the ring's capacity: slots 0..9 hold positions C..C+9, the
    token at C+10 goes to slot 10, and a raised window start masks old
    slots; both window starts agree with the mirror and differ from each
    other."""
    position = CAP + 10
    slots = np.arange(CAP)
    pos = np.where(slots < 10, slots + CAP, slots).astype(np.int64)
    cache, embed = ring(5, pos)
    full = step_both(trees, cache, embed, position=position, ws=0)
    trimmed = step_both(trees, cache, embed, position=position, ws=position - 40)
    assert rel_rms(full, trimmed) > 1e-3


def test_cache_layout_round_trip():
    pos = np.arange(CAP, dtype=np.int64)
    cache, _ = ring(7, pos)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    back = ttk.kernel_layout_to_cache(ttk.cache_to_kernel_layout(tc), CFG)
    for name in ("k", "v"):
        torch.testing.assert_close(back[name], tc[name], rtol=0, atol=0)
    jc2 = jtk.cache_to_kernel_layout({k: jnp.asarray(v) for k, v in cache.items()}, JCFG)
    np.testing.assert_array_equal(jax_layout(ttk.cache_to_kernel_layout(tc)["k2"]),
                                  np.asarray(jc2["k2"]))
