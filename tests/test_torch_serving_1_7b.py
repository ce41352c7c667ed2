"""The port's batched lockstep serving at the 1.7B widths on the CPU, in
fp32: talker hidden 2048, intermediate 6144, 16 / 8 heads of 128, codec
vocab 3072, and the 1024-wide code predictor, which every pass of the
batched code predictor reaches through small_to_mtp_projection
(Qwen3TTSConfig.standard_1_7b()). Depth is cut to 2 talker and 2
code-predictor layers and the text vocabulary to 4096 rows, as in
tests/test_torch_1_7b.py; every width is the published one.

First against the JAX package's serving on identical weights (JAX random
init, int8 runtime quantization, the same numpy tree into both; each JAX
call waited on at once): the batched talker step and the batched code
predictor teacher-forced, then prefill_batched and admit_stream.
Tolerances: rel RMS <= 1e-4 on hidden states, logits, caches and
embedding sums (fp32 sums in another order); greedy codes equal but where
the two codes' scores lie within 5e-3 of the largest score (a near tie).
Then the port against itself: greedy generate_many per stream equals the
single-stream decode, on the megakernel configuration's weights (`w8r`
views, the projection on K3's plain version) and on the K3
configuration; and the service's greedy burst equals generate_many."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, write_model_dir

torch.set_num_threads(1)
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=2, text_vocab_size=4096, tts_bos_token_id=4000,
    tts_eos_token_id=4001, tts_pad_token_id=4002,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2),
)
JCFG = JConfig.from_json(jtesting.config_to_json_dict(CFG))
REL = 1e-4
TIE = 5e-3  # a greedy pick may differ only where the scores are this close
TEXTS = [
    "First stream text for batched serving.",
    "A different and somewhat longer second stream.",
    "Short third one here.",
]


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / max(np.mean(ref.astype(np.float64) ** 2), 1e-30)))


def near_tie(scores: torch.Tensor, a: int, b: int) -> bool:
    return float((scores[a] - scores[b]).abs()) <= TIE * float(scores.abs().max())


@pytest.fixture(scope="module")
def models():
    tp = jtalker.init_talker_params(JCFG, jax.random.PRNGKey(0))
    cp = jcp.init_cp_params(JCFG.code_predictor_config, JCFG.hidden_size, jax.random.PRNGKey(1))
    tp = j_int8(jax.tree.map(np.asarray, tp), kernel_layout=False)
    cp = j_int8(jax.tree.map(np.asarray, cp), kernel_layout=False)
    assert "w8" in cp["small_to_mtp_projection"]  # the projection on K3
    jp = (jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp))
    return jp, (to_torch(tp), to_torch(cp))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_1_7b") / "model"
    write_model_dir(d, CFG, tiny_decoder_config(), weight_dtype=torch.float32)
    return d


def test_batched_step_and_frame_through_the_projection_match_jax(models):
    """B = 3 streams at different positions and window starts, one shared
    ring slot: the talker step's hidden state, logits and cache; then the
    batched code predictor at temperature 0. Its first pass projects the
    2048-wide [hidden, code-0 embedding] rows to 1024 (M = 2B) and each
    later pass the group's embedding (M = B): the first pass's hidden
    state and caches against JAX's _cp_forward, JAX's greedy codes, the
    port's logits of every group teacher-forced onto JAX's codes against
    JAX's own (its _cp_forward and lm heads driven over the same codes),
    and the 2048-wide embedding sum."""
    (jtp, jcpp), (ttp, tcpp) = models
    cc, jcc = CFG.code_predictor_config, JCFG.code_predictor_config
    rng = np.random.default_rng(0)
    b, cap, h = 3, 40, CFG.hidden_size
    nl, nkv, hd = CFG.num_hidden_layers, CFG.num_key_value_heads, CFG.head_dim
    lengths = np.array([9, 13, 21])
    step, slot = 6, 30
    pos = np.full((b, cap), -1, np.int32)
    for i, n in enumerate(lengths):  # prompt slots, then `step` decode slots
        pos[i, :n] = np.arange(n)
        pos[i, 24:24 + step] = n + np.arange(step)
    positions = (lengths + step).astype(np.int32)
    window = np.array([0, 5, 12], np.int32)
    k = (rng.standard_normal((nl, b, nkv, cap, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((nl, b, nkv, cap, hd)) * 0.5).astype(np.float32)
    embed = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)

    @jax.jit  # the weights as an argument: jitted, the JAX step is faster than eager
    def jstep(params, *args):
        h, cache = jsrv.talker_decode_step_batched(params, *args, JCFG)
        return h, jtalker.codec_head(params, h), cache

    jh, jlogits, jcache = jax.block_until_ready(jstep(
        jtp, jnp.asarray(embed), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                  "pos": jnp.asarray(pos)},
        jnp.asarray(positions), jnp.int32(slot), jnp.asarray(window)))
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(pos.astype(np.int64))}
    th, tcache = ttalker.talker_decode_step(
        ttp, torch.from_numpy(embed), tcache, torch.from_numpy(positions).long(),
        torch.from_numpy(window).long(), CFG, slot=torch.tensor(slot))
    assert rel_rms(th, jh) <= REL
    assert rel_rms(ttalker.codec_head(ttp, th), jlogits) <= REL
    for name in ("k", "v"):
        assert rel_rms(tcache[name], jcache[name]) <= REL
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))

    hidden = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    code0_embed = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    x0 = np.concatenate([hidden, code0_embed], axis=1)
    shape = (cc.num_hidden_layers, b, cc.num_key_value_heads, tcp.CP_CACHE_LEN, cc.head_dim)
    jh0, jck, jcv = jax.block_until_ready(jcp._cp_forward(
        jcpp, jnp.asarray(x0), jnp.zeros(shape), jnp.zeros(shape), jnp.int32(0), jcc))
    th0, tck, tcv = tcp.cp_forward(tcpp, torch.from_numpy(x0), torch.zeros(shape),
                                   torch.zeros(shape), 0, cc)
    assert th0.shape == (b, 1, cc.hidden_size) == jh0.shape
    assert rel_rms(th0, jh0) <= REL
    assert rel_rms(tck, jck) <= REL and rel_rms(tcv, jcv) <= REL

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    jframe = jax.jit(lambda params, *args: jsrv.predict_frame_batched(params, *args, jcc))
    jcodes, jsum = jax.block_until_ready(jframe(
        jcpp, jnp.asarray(hidden), jnp.asarray(code0_embed), keys, jnp.float32(0.0)))
    jcodes = np.asarray(jcodes).astype(np.int64)
    # JAX's logits of every group over its own codes (one jitted pass)
    @jax.jit
    def jpass(params, x, ck, cv, start, g):
        hg, ck, cv = jcp._cp_forward(params, x, ck, cv, start, jcc)
        return jlinear.table_matmul(params["lm_head"], g, hg[:, 0]), ck, cv

    jlg, ck, cv, x = [], jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(x0)
    for g in range(cc.num_code_groups - 1):
        lg, ck, cv = jax.block_until_ready(
            jpass(jcpp, x, ck, cv, jnp.int32(0 if g == 0 else g + 1), jnp.int32(g)))
        jlg.append(np.asarray(lg))
        x = jlinear.table_row(jcpp["codec_embedding"], jnp.int32(g),
                              jnp.asarray(jcodes[:, g]), jnp.float32)[:, None]
    tlg = []
    tcodes, tsum = tcp.predict_frame_batched(
        tcpp, torch.from_numpy(hidden), torch.from_numpy(code0_embed), None, torch.zeros(b), cc,
        forced_codes=torch.from_numpy(jcodes), logits_out=tlg)
    assert len(tlg) == cc.num_code_groups - 1
    ties = 0
    for g, (lg, ref) in enumerate(zip(tlg, jlg)):
        assert rel_rms(lg, ref) <= REL, g
        for r in range(b):
            pick = int(torch.argmax(lg[r]))
            if pick != jcodes[r, g]:
                ties += 1
                assert near_tie(lg[r], pick, int(jcodes[r, g])), (r, g)
    assert ties <= 2
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    assert tsum.shape == (b, 1, h)
    assert rel_rms(tsum, jsum) <= REL


def test_prefill_and_admission_match_jax(models):
    """prefill_batched of three prompts of different lengths at the 1.7B
    widths, then a mid-flight admission at step 44 (the ring has wrapped)
    of row 2 of a burst prefill into slot 1: every state array against
    JAX's (the samplers' keys aside: the port keeps each request's seed,
    JAX a PRNG key)."""
    (jtp, _), (ttp, _) = models
    rng = np.random.default_rng(1)
    b, p_pad, t_pad, h = 3, 16, 8, CFG.hidden_size
    cap = p_pad + 24
    lengths = np.array([9, 16, 12], np.int32)
    totals = np.array([3, 8, 5], np.int32)
    embeds = np.zeros((b, p_pad, h), np.float32)
    trailing = np.zeros((b, t_pad, h), np.float32)
    for i in range(b):
        embeds[i, :lengths[i]] = rng.standard_normal((lengths[i], h)) * 0.5
        trailing[i, :totals[i]] = rng.standard_normal((totals[i], h)) * 0.5
    pad = (rng.standard_normal((1, 1, h)) * 0.5).astype(np.float32)
    jstat = jgen.GenStatics(config=JCFG, capacity=cap, chunk_steps=0, track_cp_penalty=False)
    tstat = tgen.GenStatics(config=CFG, capacity=cap, chunk_steps=0, track_cp_penalty=False)

    def both(e, ln, tr, tot):
        j = jax.block_until_ready(jsrv._prefill_batched_jit.__wrapped__(
            jtp, jnp.asarray(e), jnp.asarray(ln), jnp.asarray(tr), jnp.asarray(tot),
            jnp.asarray(pad), jax.vmap(jax.random.PRNGKey)(jnp.arange(len(ln))), jstat))
        t = tsrv.prefill_batched(
            ttp, torch.from_numpy(e), torch.from_numpy(ln).long(), torch.from_numpy(tr),
            torch.from_numpy(tot).long(), torch.from_numpy(pad), torch.arange(len(ln)), tstat)
        return j, t

    def compare(j, t):
        for name in ("k", "v"):
            assert rel_rms(t["cache"][name], j["cache"][name]) <= REL, name
        np.testing.assert_array_equal(t["cache"]["pos"].numpy(), np.asarray(j["cache"]["pos"]))
        for name in ("h_last", "logits", "trailing", "tts_pad_embed"):
            assert rel_rms(t[name], j[name]) <= REL, name
        for name in ("lengths", "step", "window_start", "trailing_idx", "start_step",
                     "consecutive_pad", "eos", "seen_code0", "total_texts", "p_pad"):
            np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]), err_msg=name)

    jstate, tstate = both(embeds, lengths, trailing, totals)
    assert tstate["logits"].shape == (b, CFG.vocab_size)
    compare(jstate, tstate)
    jstate = {**jstate, "step": jnp.int32(44), "eos": jnp.asarray([False, True, False])}
    tstate["step"].fill_(44)
    tstate["eos"].copy_(torch.tensor([False, True, False]))
    jfresh, tfresh = both(embeds[::-1].copy(), lengths[::-1].copy(), trailing[::-1].copy(),
                          totals[::-1].copy())
    jadm = jax.block_until_ready(jsrv.admit_stream.__wrapped__(jstate, jnp.int32(1), jfresh,
                                                               jstat, 2))
    tadm = tsrv.admit_stream(tstate, 1, tfresh, tstat, src=2)
    compare(jadm, tadm)
    assert int(tadm["lengths"][1]) == int(lengths[0]) - 44


FRAMES = CHUNK = 3  # greedy frames a stream; lockstep steps a chunk


def _many(pl, monkeypatch) -> tuple[list, list]:
    """generate_many of TEXTS, greedy, FRAMES frames: (each stream's
    frames that it vocoded, its audio). Its lockstep chunks are cut from 48
    steps to CHUNK (greedy codes do not depend on the chunk), and its
    vocoder rows start at frame 0 with no zero-code left context, as a
    service's first row does (the vocoder is causal: the frames' audio
    does not depend on the rows' end padding)."""
    got = []
    real = tsrv.generate_codes_batched

    def recording(*args, **kwargs):
        got.extend(real(*args, **{**kwargs, "chunk_steps": CHUNK}))
        return got

    monkeypatch.setattr(tsrv, "generate_codes_batched", recording)
    monkeypatch.setenv("QWEN3TTS_DECODE_LEFT_CONTEXT", "0")
    audio = pl.generate_many(TEXTS, "aiden", temperature=0.0, max_tokens=FRAMES)
    monkeypatch.undo()
    return [tgen.filter_valid_frames(f) for f in got], audio


@pytest.fixture(scope="module")
def k3_pipeline(model_dir):
    """The K3 configuration (the CPU's default: every linear int8, K3's
    plain version) and its generate_many of TEXTS."""
    pl = tpipe.Qwen3TTSPipeline(model_dir, device="cpu", dtype=torch.float32)
    assert "w8" in pl.cp_params["small_to_mtp_projection"]
    with pytest.MonkeyPatch.context() as mp:
        return pl, _many(pl, mp)


@pytest.mark.parametrize("configuration", ["megakernel", "k3"])
def test_greedy_generate_many_equals_single_stream(configuration, model_dir, k3_pipeline,
                                                   monkeypatch):
    """Greedy: generate_many's frames per stream equal the single-stream
    decode of the same tree without the code predictor's repetition sets
    (serving keeps none), and its audio has one frame's samples a frame.
    megakernel: the batched path drops the kernel trees and runs the
    `w8r` views of their rowwise int8 weights with the projection on K3
    (int8 group 64: it is not a shared subtree), so the single stream is
    decoded on the same tree without the kernels; k3: every linear on K3."""
    if configuration == "k3":
        pl, (frames, audio) = k3_pipeline
    else:
        pl = tpipe.Qwen3TTSPipeline(model_dir, tpipe.Qwen3TTSPipelineConfiguration(
            use_talker_megakernel=True, use_cp_megakernel=True), device="cpu",
            dtype=torch.float32)
        assert "kernel" in pl.cp_params and "w8r" in pl.cp_params["layers"]["qkv_proj"]
        assert "w8" in pl.cp_params["small_to_mtp_projection"]
        frames, audio = _many(pl, monkeypatch)
    params, cp_params = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    for i, text in enumerate(TEXTS):
        single = tgen.filter_valid_frames(tgen.generate_codes(
            params, cp_params, pl.config, pl._assemble(text, "aiden"), temperature=0.0,
            max_tokens=FRAMES, chunk_steps=CHUNK, track_cp_penalty=False))
        assert len(single) > 0
        np.testing.assert_array_equal(frames[i], single, err_msg=f"stream {i}")
        assert len(audio[i]) == len(single) * pl._samples_per_frame
        assert np.isfinite(audio[i]).all()


def test_service_burst_equals_generate_many(k3_pipeline, monkeypatch):
    """A greedy burst of TEXTS into an idle 3-slot TTSService (one full-B
    prefill of prompts padded to its buckets; each submit assembles its
    prompt through the text projection on K3 at M = 3, 3, 1 and n - 9)
    against generate_many: the frames each request vocodes are equal, and
    its audio (one row holding all its frames, as generate_many's) within
    rel RMS 1e-4."""
    pl, (frames, audio) = k3_pipeline
    fed: dict = {}

    class Recording(tsrv._RowPacker):
        def feed(self, key, valid, done):
            fed.setdefault(key, []).append(valid)
            return super().feed(key, valid, done)

    monkeypatch.setattr(tsrv, "_RowPacker", Recording)
    svc = tservice.TTSService(pl, batch_size=3, chunk_steps=CHUNK, decode_chunk=8,
                              left_context=2, first_decode_chunk=8, trailing_bucket=128)
    try:
        burst: list = []
        for text in TEXTS:
            svc.submit(text, "aiden", temperature=0.0, max_tokens=FRAMES, _hold=burst)
        svc._enqueue(burst)
        got = [req.audio() for req in burst]
    finally:
        svc.close(drain=True)
    for i, req in enumerate(burst):
        np.testing.assert_array_equal(np.concatenate(fed[req]), frames[i], err_msg=f"request {i}")
        assert len(got[i]) == len(audio[i]) > 0, i
        assert rel_rms(got[i], audio[i]) <= REL, i
    s = svc.stats()
    assert s["requests_submitted"] == s["requests_completed"] == len(TEXTS)
