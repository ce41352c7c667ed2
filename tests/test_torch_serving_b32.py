"""Serving at B = 32, the JAX package's own serving batch (bench.py's
SERVE_BATCH), on the CPU in fp32.

- K6's launch grid (ops/cuda/vocoder_kernels.conv_grid, the mirror of
  qt_conv_mma_kernel's grid and block map): for 1-512 rows of 26, 48 and
  110 frames over every SEANet block's convs of the 0.6B vocoder, each
  grid dimension within CUDA's limits, and the blocks cover every (row,
  position, column) tile once. With the column tiles on x and the row
  tiles on y, as the kernel had them, y passes 65,535 at 40 rows of 110
  frames.
- chunked_decode of 48 rows (24 streams of two chunks) on a tiny vocoder
  through K4-K6's plain versions against JAX's chunked_decode: waveform
  rel RMS <= 1e-4.
- The lockstep step at B = 32 on the K3 (int8) and mixed 4/6-bit trees at
  tiny widths: the batched talker step, then the batched code predictor
  teacher-forced onto JAX's greedy codes, against JAX's
  talker_decode_step_batched / predict_frame_batched: rel RMS <= 1e-4.
- Greedy generate_many of 32 texts: each stream's frames equal its single
  stream's, and its audio that stream vocoded alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.config import TokenizerDecoderConfig as JDecConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu.ops.quant import apply_mixed_quantization as j_mixed
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import to_torch, vocoder_params
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk
from qwen3_tts_tpu_torch.testing import (
    config_to_json_dict,
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
)

torch.set_num_threads(1)
REL = 1e-4
B = 32
TEXTS = [f"Stream {i} reads {'a longer sentence with more words' if i % 3 else 'this'}."
         for i in range(B)]


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / max(np.mean(ref.astype(np.float64) ** 2), 1e-30)))


def _conv_launches(t: int):
    """(S, N) of every K6 launch that decode_frames makes for a row of t
    frames on the 0.6B vocoder: each block's upsample (2 taps, N = rate x
    Cout over its input rows) and its units' convs (N = Cout)."""
    cfg = TokenizerDecoderConfig()
    s, c = 4 * t, cfg.decoder_dim
    out = []
    for rate in cfg.upsample_rates:
        cout = c // 2
        out.append((s, rate * cout))
        s, c = s * rate, cout
        out.append((s, c))
    return out


def test_k6_grid_covers_every_tile_within_cuda_limits():
    sms = 132  # an H100 SXM's SMs; conv_tile picks the tile from them
    exhaustive = {1, 2, 8, 32, 39, 40, 41, 64, 512}
    for t in (26, 48, 110):
        for s, n in _conv_launches(t):
            for b in range(1, 513):
                bm, bn = vk.conv_tile(b, s, n, sms)
                (gx, gy), tile = vk.conv_grid(b, s, n, bm, bn)
                assert 0 < gx <= vk.GRID_X_MAX and 0 < gy <= vk.GRID_Y_MAX, (t, s, n, b)
                tiles = -(-s // bm)
                assert gx * gy == b * tiles * -(-n // bn)
                if b not in exhaustive:
                    continue
                order = np.arange(gx * gy, dtype=np.int64)  # launch order: x fastest
                seq, p0, n0 = tile(order % gx, order // gx)
                assert seq.min() == 0 and seq.max() == b - 1
                assert p0.min() == 0 and p0.max() == (tiles - 1) * bm and (p0 % bm == 0).all()
                assert n0.min() == 0 and n0.max() < n and (n0 % bn == 0).all()
                ids = (seq * tiles + p0 // bm) * gy + n0 // bn
                assert np.array_equal(np.sort(ids), np.arange(gx * gy)), (t, s, n, b)
                if gy > 1:  # a row tile's column tiles are adjacent in launch order
                    assert (seq[:gy] == 0).all() and (p0[:gy] == 0).all()
    # the parent's layout (row tiles on y) at block 3 of 110 frames
    s, n = _conv_launches(110)[-1]
    bm, _ = vk.conv_tile(40, s, n, sms)
    assert 40 * -(-s // bm) > vk.GRID_Y_MAX >= 39 * -(-s // bm)
    with pytest.raises(ValueError):
        vk.conv_grid(2 ** 31 // 1650 + 1, 211200, 96, 128, 96)


DEC = dict(latent_dim=32, codebook_dim=16, codebook_size=64, decoder_dim=48,
           hidden_size=32, intermediate_size=48, head_dim=16, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2, upsample_rates=(4, 3),
           upsampling_ratios=(2, 2))


def test_chunked_decode_of_48_rows_matches_jax():
    jd, td = JDecConfig(**DEC), TokenizerDecoderConfig(**DEC)
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(jd, jax.random.PRNGKey(2)))
    for st in p["upsample"]:
        st["convnext"]["gamma"] = np.full_like(st["convnext"]["gamma"], 0.5)
    streams, t, chunk = 24, 30, 16
    codes = np.random.default_rng(3).integers(0, 64, (streams, 16, t))
    lengths = [t if j % 5 else 17 for j in range(streams)]  # every stream reaches chunk 1
    ref = jvoc.chunked_decode(jax.tree.map(jnp.asarray, p), codes, jd, chunk_size=chunk,
                              left_context=4, lengths=lengths)
    tp = vocoder_params(p, td, kernel_dtype=torch.float32)
    assert "kernel" in tp
    rows = []
    real = tvoc.decode_frames

    def counting(params, c, cfg):
        rows.append(c.shape[0])
        return real(params, c, cfg)

    tvoc.decode_frames = counting
    try:
        got = tvoc.chunked_decode(tp, codes, td, device="cpu", chunk_size=chunk, left_context=4,
                                  lengths=lengths)
    finally:
        tvoc.decode_frames = real
    assert rows == [2 * streams]  # every row in one call, as on the card
    assert got.shape == ref.shape == (streams, t * td.total_upsample)
    assert rel_rms(got, ref) <= REL


@pytest.mark.parametrize("tree", ["int8", "mixed_4_6"])
def test_lockstep_step_at_b32_matches_jax(tree):
    tcfg = tiny_talker_config()
    jcfg = JConfig.from_json(config_to_json_dict(tcfg))
    quant = j_int8 if tree == "int8" else j_mixed
    tp = quant(jax.tree.map(np.asarray, jtalker.init_talker_params(jcfg, jax.random.PRNGKey(0))),
               kernel_layout=False)
    cp = quant(jax.tree.map(np.asarray, jcp.init_cp_params(
        jcfg.code_predictor_config, jcfg.hidden_size, jax.random.PRNGKey(1))), kernel_layout=False)
    key = "w8" if tree == "int8" else "wq"
    for t in (tp, cp):
        assert all(key in t["layers"][n] for n in ("qkv_proj", "o_proj", "gateup_proj",
                                                    "down_proj"))
    jtp, jcpp = jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp)
    ttp, tcpp = to_torch(tp), to_torch(cp)
    cc, jcc = tcfg.code_predictor_config, jcfg.code_predictor_config
    rng = np.random.default_rng(5)
    cap, h = 40, jcfg.hidden_size
    nl, nkv, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    lengths = rng.integers(9, 24, B)
    step, slot = 6, 30
    pos = np.full((B, cap), -1, np.int32)
    for i, n in enumerate(lengths):  # prompt slots, then `step` decode slots
        pos[i, :n] = np.arange(n)
        pos[i, 24:24 + step] = n + np.arange(step)
    positions = (lengths + step).astype(np.int32)
    window = rng.integers(0, 9, B).astype(np.int32)
    k = (rng.standard_normal((nl, B, nkv, cap, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((nl, B, nkv, cap, hd)) * 0.5).astype(np.float32)
    embed = (rng.standard_normal((B, 1, h)) * 0.5).astype(np.float32)
    jh, jcache = jsrv.talker_decode_step_batched(
        jtp, jnp.asarray(embed), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                  "pos": jnp.asarray(pos)},
        jnp.asarray(positions), jnp.int32(slot), jnp.asarray(window), jcfg)
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(pos.astype(np.int64))}
    th, tcache = ttalker.talker_decode_step(
        ttp, torch.from_numpy(embed), tcache, torch.from_numpy(positions).long(),
        torch.from_numpy(window).long(), tcfg, slot=torch.tensor(slot))
    assert rel_rms(th, jh) <= REL
    assert rel_rms(ttalker.codec_head(ttp, th), jtalker.codec_head(jtp, jh)) <= REL
    for name in ("k", "v"):
        assert rel_rms(tcache[name], jcache[name]) <= REL
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))

    hidden = (rng.standard_normal((B, 1, h)) * 0.5).astype(np.float32)
    code0_embed = (rng.standard_normal((B, 1, h)) * 0.5).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    jcodes, jsum = jsrv.predict_frame_batched(
        jcpp, jnp.asarray(hidden), jnp.asarray(code0_embed), keys, jnp.float32(0.0), jcc)
    jcodes = np.asarray(jcodes).astype(np.int64)
    # JAX's logits of every group over its own codes, a pass at a time
    shape = (cc.num_hidden_layers, B, cc.num_key_value_heads, tcp.CP_CACHE_LEN, cc.head_dim)
    jlg, ck, cv = [], jnp.zeros(shape), jnp.zeros(shape)
    x = jnp.asarray(np.concatenate([hidden, code0_embed], axis=1))
    for g in range(cc.num_code_groups - 1):
        hg, ck, cv = jcp._cp_forward(jcpp, x, ck, cv, jnp.int32(0 if g == 0 else g + 1), jcc)
        jlg.append(np.asarray(jlinear.table_matmul(jcpp["lm_head"], jnp.int32(g), hg[:, 0])))
        x = jlinear.table_row(jcpp["codec_embedding"], jnp.int32(g),
                              jnp.asarray(jcodes[:, g]), jnp.float32)[:, None]
    tlg = []
    tcodes, tsum = tcp.predict_frame_batched(
        tcpp, torch.from_numpy(hidden), torch.from_numpy(code0_embed), None, torch.zeros(B), cc,
        forced_codes=torch.from_numpy(jcodes), logits_out=tlg)
    assert len(tlg) == cc.num_code_groups - 1
    for g, (lg, ref) in enumerate(zip(tlg, jlg)):
        assert rel_rms(lg, ref) <= REL, g
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    assert rel_rms(tsum, jsum) <= REL


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_b32") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return tpipe.Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)


def test_greedy_generate_many_of_32_equals_single_streams(tpl):
    frames = 6
    pds = [tpl._assemble(t, "aiden") for t in TEXTS]
    batched = tsrv.generate_codes_batched(tpl.params, tpl.cp_params, tpl.config, pds,
                                          temperature=0.0, max_tokens=frames, chunk_steps=3)
    audio = tpl.generate_many(TEXTS, "aiden", temperature=0.0, max_tokens=frames)
    assert len(batched) == len(audio) == B
    for i, pd in enumerate(pds):
        single = tgen.filter_valid_frames(tgen.generate_codes(
            tpl.params, tpl.cp_params, tpl.config, pd, temperature=0.0, max_tokens=frames,
            chunk_steps=3, track_cp_penalty=False))
        assert len(single) > 0
        np.testing.assert_array_equal(tgen.filter_valid_frames(batched[i]), single,
                                      err_msg=f"stream {i}")
        np.testing.assert_allclose(audio[i], tpl._decode_to_audio(single), atol=1e-5)
