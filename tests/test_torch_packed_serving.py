"""The port's batched serving on packed sub-byte trees at the 1.7B widths on
the CPU, in fp32: talker hidden 2048, intermediate 6144, 16 / 8 heads of
128, codec vocab 3072, and the 1024-wide code predictor, which every pass
of the batched code predictor reaches through small_to_mtp_projection
(Qwen3TTSConfig.standard_1_7b()). Depth is cut to 2 talker and 2
code-predictor layers and the text vocabulary to 4096 rows, as in
tests/test_torch_serving_1_7b.py; every width is the published one. Two
trees run K7 (its plain version here): the mixed 4/6-bit runtime mode
(every talker and code-predictor linear packed, the projection at 4 bits)
and a 4-bit group-64 pre-quantized dir, MLX's layout, on the megakernel
configuration (its layers `w8r` views of the kernels' int8 rows; the
projection, the text projection and the tables packed).

Against the JAX package (each JAX call waited on at once): the batched
talker step and the batched code predictor teacher-forced on the same
mixed trees (JAX's apply_mixed_quantization, kernel_layout=False, into
both); the pre-quantized dir's prompt rows, prefill logits and
teacher-forced frames against the JAX pipeline on the same dir, the
megakernels on (JAX's jnp mirrors, the port's plain versions).
Tolerances, fp32 sums in another order: prompt rows 1e-5, hidden states,
logits, caches and embedding sums rel RMS 1e-4; greedy codes equal but
where the two codes' scores lie within 5e-3 of the largest score (a near
tie). Then the port against itself: greedy generate_many per stream equals
the single-stream decode on both trees, and the service's greedy burst on
the mixed tree equals generate_many."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.quant import apply_mixed_quantization as j_mixed
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.sampling import sample_token
from qwen3_tts_tpu_torch.testing import (
    tiny_decoder_config,
    write_model_dir,
    write_prequantized_model_dir,
)

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
TEXTS = ["First stream text for batched serving.", "Short second one here."]
LINEARS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / max(np.mean(ref.astype(np.float64) ** 2), 1e-30)))


def rel_max(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def near_tie(scores: torch.Tensor, a: int, b: int) -> bool:
    return float((scores[a] - scores[b]).abs()) <= TIE * float(scores.abs().max())


def test_batched_step_and_frame_on_mixed_trees_match_jax():
    """B = 3 streams at different positions and window starts on the mixed
    4/6-bit trees (6-bit qkv, codec head and lm heads, 4-bit the rest and
    small_to_mtp_projection): the talker step's hidden state, logits and
    cache; then the batched code predictor at temperature 0, whose first
    pass projects the 2048-wide rows to 1024 (M = 2B) and each later pass
    the group's embedding (M = B): JAX's greedy codes, the port's logits of
    every group teacher-forced onto them against JAX's own, and the
    2048-wide embedding sum."""
    tp = jtalker.init_talker_params(JCFG, jax.random.PRNGKey(0))
    cp = jcp.init_cp_params(JCFG.code_predictor_config, JCFG.hidden_size, jax.random.PRNGKey(1))
    tp = j_mixed(jax.tree.map(np.asarray, tp), kernel_layout=False)
    cp = j_mixed(jax.tree.map(np.asarray, cp), kernel_layout=False)
    for tree in (tp, cp):
        assert all("wq" in tree["layers"][n] for n in LINEARS)
    assert tp["layers"]["qkv_proj"]["wq"].shape[-1] == 2048 * 6 // 32
    assert cp["small_to_mtp_projection"]["wq"].shape == (1024, 2048 * 4 // 32)
    jtp, jcpp = jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp)
    ttp, tcpp = to_torch(tp), to_torch(cp)
    del tp, cp
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
    del jh, jlogits, jcache, th, tcache

    hidden = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    code0_embed = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    jframe = jax.jit(lambda params, *args: jsrv.predict_frame_batched(params, *args, jcc))
    jcodes, jsum = jax.block_until_ready(jframe(
        jcpp, jnp.asarray(hidden), jnp.asarray(code0_embed), keys, jnp.float32(0.0)))
    jcodes = np.asarray(jcodes).astype(np.int64)
    shape = (cc.num_hidden_layers, b, cc.num_key_value_heads, tcp.CP_CACHE_LEN, cc.head_dim)

    @jax.jit  # JAX's logits of every group over its own codes, one pass a call
    def jpass(params, x, ck, cv, start, g):
        hg, ck, cv = jcp._cp_forward(params, x, ck, cv, start, jcc)
        return jlinear.table_matmul(params["lm_head"], g, hg[:, 0]), ck, cv

    jlg, ck, cv = [], jnp.zeros(shape), jnp.zeros(shape)
    x = jnp.asarray(np.concatenate([hidden, code0_embed], axis=1))
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


# greedy frames a stream; lockstep steps a chunk (few: K7's plain version
# dequantizes every weight a call, seconds a frame at these widths)
FRAMES = CHUNK = 2


def _many(pl, monkeypatch) -> tuple[list, list]:
    """generate_many of TEXTS, greedy, FRAMES frames: (each stream's
    frames that it vocoded, its audio). Its lockstep chunks are cut from 48
    steps to CHUNK (greedy codes do not depend on the chunk), and its
    vocoder rows start at frame 0 with no zero-code left context, as a
    service's first row does."""
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
def mixed_pipeline(tmp_path_factory):
    """The mixed 4/6-bit configuration on a dense dir (megakernels off:
    every talker and code-predictor linear on K7's plain version) and its
    generate_many of TEXTS."""
    d = tmp_path_factory.mktemp("packed_serving_mixed") / "model"
    write_model_dir(d, CFG, tiny_decoder_config(), weight_dtype=torch.float32)
    pl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        runtime_quantization_mode="mixed_4_6", use_talker_megakernel=False,
        use_cp_megakernel=False), device="cpu", dtype=torch.float32)
    for tree in (pl.params, pl.cp_params):
        assert all("wq" in tree["layers"][n] for n in LINEARS)
    assert "wq" in pl.cp_params["small_to_mtp_projection"]
    assert "wq" in pl.params["codec_head"] and "wq" in pl.cp_params["lm_head"]
    with pytest.MonkeyPatch.context() as mp:
        return pl, _many(pl, mp)


@pytest.fixture(scope="module")
def prequant_dir(tmp_path_factory):
    """A 4-bit group-64 pre-quantized dir (MLX's layout: every eligible
    talker and code-predictor weight packed, config.json's quantization
    block)."""
    d = tmp_path_factory.mktemp("packed_serving_prequant") / "model"
    write_prequantized_model_dir(d, CFG, tiny_decoder_config(), widths=(4,), group_size=64)
    return d


def _prequant_pipeline(d):
    """The pre-quantized dir on the megakernel configuration: K1 / K2 built
    from the packed weights, the layers `w8r` views of their rows."""
    pl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        use_talker_megakernel=True, use_cp_megakernel=True), device="cpu", dtype=torch.float32)
    assert "kernel" in pl.params and "kernel" in pl.cp_params
    for tree in (pl.params, pl.cp_params):
        assert all("w8r" in tree["layers"][n] for n in LINEARS)
    assert pl.cp_params["small_to_mtp_projection"]["wq"].shape == (1024, 2048 * 4 // 32)
    assert "wq" in pl.params["text_projection"]["fc1"]
    assert "wq" in pl.params["text_embedding"]
    return pl


@pytest.mark.parametrize("tree", ["mixed", "prequant"])
def test_greedy_generate_many_equals_single_stream(tree, mixed_pipeline, prequant_dir,
                                                   monkeypatch):
    """Greedy: generate_many's frames per stream equal the single-stream
    decode of the same tree without the code predictor's repetition sets
    (serving keeps none), and its audio has one frame's samples a frame.
    mixed: every linear on K7 at M = B and 1; prequant: the batched path
    drops the kernel trees and runs the `w8r` views with the projection on
    K7, so the single stream is decoded on the same tree without the
    kernels."""
    if tree == "mixed":
        pl, (frames, audio) = mixed_pipeline
    else:
        pl = _prequant_pipeline(prequant_dir)
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


PREQUANT_FRAMES = 2
TEXT = "Hello there, this sentence checks the packed wide model."


def test_prequantized_dir_matches_jax_pipeline(prequant_dir):
    """Both pipelines load the pre-quantized dir with the megakernels on
    (JAX: GenStatics(kernel_mirror=True), its jnp mirrors of the kernels;
    the port: K1 / K2's plain versions on trees built from the packed
    weights, the projection dequantized into K2's tree): the prompt rows
    (the packed text table and text projection) to 1e-5, the prefill
    logits, and over PREQUANT_FRAMES greedy frames that JAX decodes, the
    port forced onto JAX's frames picks JAX's code 0 and its talker logits
    agree after every step."""
    jpl = jpipe.Qwen3TTSPipeline(
        str(prequant_dir), jpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=True, use_talker_megakernel=True, use_vocoder_kernels=False),
        dtype=jnp.float32)
    cfg = jpl.config
    jpd = jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, TEXT, speaker="aiden")
    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True, kernel_mirror=True)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jax.block_until_ready(jgen.prefill(jpl.params, emb, jnp.int32(p), trail,
                                               jnp.int32(t), jpd.tts_pad_embed,
                                               jax.random.PRNGKey(0), statics))
    rows = {n: np.asarray(getattr(jpd, n))
            for n in ("input_embeds", "trailing_hidden", "tts_pad_embed")}
    logits, frames = [np.asarray(state["logits"])], []
    for _ in range(PREQUANT_FRAMES):
        out, count, _, state = jax.block_until_ready(jgen.decode_chunk(
            jpl.params, jpl.cp_params, state, jnp.float32(0.0), statics))
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))
    del jpl, state, jpd

    tpl = _prequant_pipeline(prequant_dir)
    assert tpl.cp_params["kernel"]["proj_w"].shape == (1024, 2048)
    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    for name, ref in rows.items():
        assert rel_max(getattr(tpd, name), ref) <= 1e-5, name
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert rel_rms(ts["logits"], logits[0]) <= REL
    eos_pad, valid = ts["masks"]
    for i, frame in enumerate(frames):
        # the port's own greedy code 0 from this state, as decode_step draws it
        lg = ts["logits"] + torch.where(ts["trailing_idx"] < ts["total_text"], eos_pad, 0.0)
        pick = sample_token(lg, None, 0.0, seen_mask=ts["seen_code0"], valid_mask=valid)
        assert int(pick) == frame[0] or near_tie(lg.reshape(-1), int(pick), int(frame[0])), i
        out, emitted = tgen.decode_step(tpl.params, tpl.cp_params, ts, tpl.config,
                                        temperature=0.0, generator=None, track_cp_penalty=True,
                                        forced_frame=torch.from_numpy(frame).long())
        assert bool(emitted)
        np.testing.assert_array_equal(out.numpy(), frame)
        assert rel_rms(ts["logits"], logits[i + 1]) <= REL, i


def test_service_burst_on_the_mixed_tree_equals_generate_many(mixed_pipeline, monkeypatch):
    """A greedy burst of TEXTS into an idle 2-slot TTSService on the mixed
    tree (one full-B prefill of prompts padded to its buckets; each submit
    assembles its prompt through the packed text projection at M = 3, 3, 1
    and n - 9) against generate_many: the frames each request vocodes are
    equal, and its audio (one row holding all its frames, as
    generate_many's) within rel RMS 1e-4."""
    pl, (frames, audio) = mixed_pipeline
    fed: dict = {}

    class Recording(tsrv._RowPacker):
        def feed(self, key, valid, done):
            fed.setdefault(key, []).append(valid)
            return super().feed(key, valid, done)

    monkeypatch.setattr(tsrv, "_RowPacker", Recording)
    svc = tservice.TTSService(pl, batch_size=len(TEXTS), chunk_steps=CHUNK, decode_chunk=8,
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
