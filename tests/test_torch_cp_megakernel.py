"""K2's builder and plain version, and K2g's plain sampler, against the JAX
package's code-predictor megakernel module (its jnp mirror
predict_frame_w8a8_ref), on the CPU in fp32 at a tiny width with seeded
numpy weights.

Tolerances: the builders are copies and must agree exactly; greedy codes
and the seen set exactly; the embedding sum to rel RMS 1e-5 (fp32 sums).
The sampler is judged by distribution (chi-square p >= 1e-3 at fixed
seeds), since its Philox stream is not the TPU's; its bits are pinned to
Philox4x32-10's published answer for a zero key and counter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.ops.pallas import cp_megakernel as jcpk
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as tcpk
from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as tgs
from qwen3_tts_tpu_torch.testing import random_host_cp_params, tiny_talker_config

torch.set_num_threads(1)


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def configs(talker_hidden: int):
    cfg = tiny_talker_config(hidden_size=talker_hidden)
    return cfg, JConfig.from_json(jtesting.config_to_json_dict(cfg))


@pytest.mark.parametrize("talker_hidden", [64, 128], ids=["same_width", "projected"])
def test_builder_matches_jax_exactly(talker_hidden):
    cfg, jcfg = configs(talker_hidden)
    params = random_host_cp_params(cfg, seed=2)
    assert ("small_to_mtp_projection" in params) == (talker_hidden != 64)
    ref = jcpk.build_cp_kernel_params(params, jcfg.code_predictor_config)
    got = tcpk.build_cp_kernel_params(params, cfg.code_predictor_config)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_greedy_frame_matches_the_jax_mirror():
    cfg, jcfg = configs(128)
    cc, jcc = cfg.code_predictor_config, jcfg.code_predictor_config
    params = random_host_cp_params(cfg, seed=4)
    kp = tcpk.build_cp_kernel_params(params, cc)
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((1, 1, cfg.hidden_size)).astype(np.float32)
    code0 = (rng.standard_normal((1, 1, cfg.hidden_size)) * 0.5).astype(np.float32)
    seen = rng.random((cc.num_code_groups - 1, cc.vocab_size)) < 0.3
    jcodes, jsum, jseen = jcpk.predict_frame_w8a8_ref(
        jax.tree.map(jnp.asarray, kp), jnp.asarray(hidden), jnp.asarray(code0),
        jax.random.PRNGKey(0), jnp.float32(0.0), jnp.asarray(seen), jcc, 1.05,
    )
    tseen = torch.from_numpy(seen.copy())
    codes, esum, tseen = tcpk.predict_frame(
        to_torch(kp), torch.from_numpy(hidden), torch.from_numpy(code0),
        torch.zeros(1, dtype=torch.int64), 0.0, tseen, cc, 1.05,
    )
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    assert rel_rms(esum.numpy(), jsum) <= 1e-5


def test_plain_gumbel_pick_distribution_and_greedy():
    words = tgs.philox_words(torch.zeros((), dtype=torch.int64), 1, 4)[0]
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rng = np.random.default_rng(9)
    vocab, temp, n = 48, 0.85, 20_000
    logits = torch.from_numpy((rng.standard_normal(vocab) * 1.5).astype(np.float32))
    seed = torch.tensor([1234567890123], dtype=torch.int64)
    draws = tgs.gumbel_sample(logits, seed, temp, n).numpy()
    p = np.exp(logits.double().numpy() / temp)
    assert jtesting.chisq_gof_pvalue(np.bincount(draws, minlength=vocab), p / p.sum()) >= 1e-3
    greedy = tgs.gumbel_sample(logits, seed, 0.0, 64).numpy()
    assert (greedy == int(torch.argmax(logits))).all()
