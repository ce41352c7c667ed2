"""The port's models (talker, code predictor) against the JAX
package's on the CPU in fp32, on identical weights: JAX random init, int8
runtime quantization (every linear width a multiple of 64, so K3's plain
version carries every talker / code-predictor linear), then the same numpy
tree into both. Tolerances: rel <= 1e-4 on hidden states and logits (fp32
through several layers, sums in another order); greedy codes equal wherever
JAX's top-2 logit margin exceeds 1e-3. The vocoder is held in
test_torch_vocoder.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.testing import config_to_json_dict, tiny_talker_config

torch.set_num_threads(1)
REL = 1e-4


def rel_max(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def models():
    tcfg = tiny_talker_config()
    jcfg = JConfig.from_json(config_to_json_dict(tcfg))
    assert Qwen3TTSConfig.from_json(config_to_json_dict(tcfg)) == tcfg
    tp = jtalker.init_talker_params(jcfg, jax.random.PRNGKey(0))
    cp = jcp.init_cp_params(jcfg.code_predictor_config, jcfg.hidden_size,
                            jax.random.PRNGKey(1))
    tp = j_int8(jax.tree.map(np.asarray, tp), kernel_layout=False)
    cp = j_int8(jax.tree.map(np.asarray, cp), kernel_layout=False)
    assert "w8" in tp["text_projection"]["fc1"] and "w8" in cp["layers"]["qkv_proj"]
    jp = (jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp))
    return jcfg, tcfg, jp, (to_torch(tp), to_torch(cp))


def test_talker_prefill_and_decode_step(models):
    jcfg, tcfg, (jtp, _), (ttp, _) = models
    rng = np.random.default_rng(0)
    p, p_pad, cap = 13, 16, 40
    emb = (rng.standard_normal((1, p, jcfg.hidden_size)) * 0.5).astype(np.float32)
    emb_pad = np.zeros((1, p_pad, jcfg.hidden_size), np.float32)
    emb_pad[:, :p] = emb
    jh, jcache = jtalker.talker_prefill(
        jtp, jnp.asarray(emb_pad), jnp.int32(p), jtalker.init_kv_cache(jcfg, cap), jcfg
    )
    th, tcache = ttalker.talker_prefill(
        ttp, torch.from_numpy(emb), ttalker.init_kv_cache(tcfg, cap), tcfg
    )
    assert rel_max(th, jh) <= REL
    for name in ("k", "v"):
        assert rel_max(tcache[name][:, :, :, :p], np.asarray(jcache[name])[:, :, :, :p]) <= REL
    np.testing.assert_array_equal(tcache["pos"].numpy()[:p], np.arange(p))

    # one decode step from the same (JAX) cache, with a window start
    step = (rng.standard_normal((1, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    jh2, _ = jtalker.talker_decode_step(jtp, jnp.asarray(step), jcache, jnp.int32(p),
                                        jnp.int32(4), jcfg)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    cache["pos"] = cache["pos"].long()
    th2, cache = ttalker.talker_decode_step(ttp, torch.from_numpy(step), cache,
                                            torch.tensor(p), torch.tensor(4), tcfg)
    assert rel_max(th2, jh2) <= REL
    assert int(cache["pos"][p]) == p
    jl = jtalker.codec_head(jtp, jh2)
    assert rel_max(ttalker.codec_head(ttp, th2), jl) <= REL


def jax_group_logits(cp, cfg, code_hidden, code0_embed, codes):
    """JAX's per-group logits along a given code sequence (the jnp path of
    predict_frame, replayed)."""
    shape = (cfg.num_hidden_layers, 1, cfg.num_key_value_heads, jcp.CP_CACHE_LEN,
             cfg.head_dim)
    ck, cv = jnp.zeros(shape), jnp.zeros(shape)
    h, ck, cv = jcp._cp_forward(cp, jnp.concatenate([code_hidden, code0_embed], 1),
                                ck, cv, jnp.int32(0), cfg)
    out = [jlinear.table_matmul(cp["lm_head"], 0, h[:, 0])[0]]
    for k in range(1, cfg.num_code_groups - 1):
        x = jlinear.table_row(cp["codec_embedding"], k - 1, codes[k - 1])[None, None]
        h, ck, cv = jcp._cp_forward(cp, x, ck, cv, jnp.int32(k + 1), cfg)
        out.append(jlinear.table_matmul(cp["lm_head"], k, h[:, 0])[0])
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_frame_greedy(models, seed):
    jcfg, tcfg, (jtp, jcpp), (ttp, tcpp) = models
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((1, 1, jcfg.hidden_size)) * 2.0).astype(np.float32)
    code0 = int(rng.integers(0, 2048))
    c0 = jtalker.encode_audio(jtp, jnp.asarray([[code0]]))
    ccfg = jcfg.code_predictor_config
    ng = ccfg.num_code_groups - 1
    jcodes, jsum, _ = jcp.predict_frame(
        jcpp, jnp.asarray(hidden), c0, jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.zeros((ng, ccfg.vocab_size), bool), ccfg,
    )
    jcodes = np.asarray(jcodes)
    jlog = jax_group_logits(jcpp, ccfg, jnp.asarray(hidden), c0, jnp.asarray(jcodes))

    tc0 = ttalker.encode_audio(ttp, torch.tensor([[code0]]))
    assert rel_max(tc0, c0) <= 1e-6
    logits: list = []
    tcodes, tsum, seen = tcp.predict_frame(
        tcpp, torch.from_numpy(hidden), tc0, None, 0.0,
        torch.zeros(ng, ccfg.vocab_size, dtype=torch.bool), tcfg.code_predictor_config,
        logits_out=logits, forced_codes=torch.tensor(jcodes).long(),
    )
    tlog = torch.stack(logits)
    assert rel_max(tlog, jlog) <= REL
    assert rel_max(tsum, jsum) <= REL
    top2 = np.sort(jlog, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-3
    assert sure.sum() >= ng - 2
    np.testing.assert_array_equal(tlog.argmax(-1).numpy()[sure], jcodes[sure])
    assert seen.sum() == ng  # one code marked per group
