"""The 1.7B model's serving shapes at narrow widths, on the CPU in fp32: the
JAX package's serving batch (bench.py's SERVE_BATCH, B = 32) through
small_to_mtp_projection, and its service measure (bench.py's service_ttfa:
TTSService(batch_size=16, trailing_bucket=128), a burst into the idle
service, then arrivals into a batch kept busy by long streams, which are
then cancelled).

The model keeps the 1.7B model's projection at tiny widths: the talker 128
wide, the code predictor 64 (testing.tiny_talker_config's), so each
code-predictor pass projects its input through small_to_mtp_projection
(128 -> 64), and every linear input width stays a multiple of 64, so the
group-64 quantizers cover every linear; 2 + 2 layers.

- The B = 32 lockstep step on the int8 and mixed 4/6-bit trees against the
  JAX package's on the same numpy weights (carried over by convert.py):
  the batched talker step (hidden state, logits, cache), then the batched
  code predictor teacher-forced onto JAX's greedy codes, every group's
  logits against JAX's (its _cp_forward and lm heads over the same codes):
  rel RMS <= 1e-4 (fp32 sums in another order); a greedy pick of the
  port's logits may differ from JAX's code only where the two scores lie
  within 5e-3 of the largest score (a near tie). The projection runs at
  M = 2B = 64 on the first pass and M = B = 32 on the 14 others.
- The service at B = 16 on a model with both encoders: a burst of 16
  (testing.MODE_BURST and 8 built-in requests of bench.py's text) into
  the idle service; then 12 long streams (sampled) keep the batch busy,
  4 arrivals (two built-in, a clone by x-vector, an ICL clone, both of one
  reference clip) are admitted mid-flight, and the long streams are
  cancelled. Each arrival's padded prompt against JAX's
  assemble_prompt_padded (rel RMS <= 1e-5, the same lengths); each
  arrival's greedy frames against its B = 1 single (the service's own
  B = 1 prefill of it, stepped teacher-forced on those frames): every
  code the single's greedy pick, but at a near tie; every long stream
  ends with one final chunk and counts as cancelled, freeing its slot;
  the /stats identities after the drain."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import linear as jlinear
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu.ops.quant import apply_mixed_quantization as j_mixed
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.parallel.dryrun import greedy_scores

torch.set_num_threads(1)
CFG = ttesting.tiny_talker_config(hidden_size=128)
JCFG = JConfig.from_json(ttesting.config_to_json_dict(CFG))
REL = 1e-4
TIE = 5e-3  # a greedy pick may differ only where the scores are this close
B = 32
BENCH_TEXT = "Sixteen concurrent users each want their first chunk fast."  # bench.py's
# 103 characters, 119 trailing tokens with the test dir's character-level
# tokenizer (the bucket holds 128): the eos mask holds while text remains
LONG_TEXT = ("Twelve long streams keep the batch busy while arrivals come in; "
             "their text holds the stop back for now.")
LONG_STREAMS, LONG_FRAMES, FRAMES = 12, 400, 8


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / max(np.mean(ref.astype(np.float64) ** 2), 1e-30)))


def near_tie(scores: torch.Tensor, a: int, b: int) -> bool:
    finite = scores[torch.isfinite(scores)]
    return float((scores[a] - scores[b]).abs()) <= TIE * float(finite.abs().max())


@pytest.mark.parametrize("tree", ["int8", "mixed_4_6"])
def test_lockstep_step_at_b32_through_the_projection_matches_jax(tree, monkeypatch):
    assert CFG.code_predictor_config.hidden_size != CFG.hidden_size
    quant = j_int8 if tree == "int8" else j_mixed
    tp = quant(jax.tree.map(np.asarray, jtalker.init_talker_params(JCFG, jax.random.PRNGKey(0))),
               kernel_layout=False)
    cp = quant(jax.tree.map(np.asarray, jcp.init_cp_params(
        JCFG.code_predictor_config, JCFG.hidden_size, jax.random.PRNGKey(1))), kernel_layout=False)
    key = "w8" if tree == "int8" else "wq"
    for t in (tp, cp):
        assert all(key in t["layers"][n] for n in ("qkv_proj", "o_proj", "gateup_proj",
                                                    "down_proj"))
    assert key in cp["small_to_mtp_projection"]  # the projection on K3 / K7
    jtp, jcpp = jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp)
    ttp, tcpp = to_torch(tp), to_torch(cp)
    cc, jcc = CFG.code_predictor_config, JCFG.code_predictor_config
    rng = np.random.default_rng(5)
    cap, h = 40, CFG.hidden_size
    nl, nkv, hd = CFG.num_hidden_layers, CFG.num_key_value_heads, CFG.head_dim
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

    hidden = (rng.standard_normal((B, 1, h)) * 0.5).astype(np.float32)
    code0_embed = (rng.standard_normal((B, 1, h)) * 0.5).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    jframe = jax.jit(lambda params, *args: jsrv.predict_frame_batched(params, *args, jcc))
    jcodes, jsum = jax.block_until_ready(jframe(
        jcpp, jnp.asarray(hidden), jnp.asarray(code0_embed), keys, jnp.float32(0.0)))
    jcodes = np.asarray(jcodes).astype(np.int64)

    # JAX's logits of every group over its own codes, a pass at a time: the
    # first pass's 128-wide rows and each later pass's group embedding
    # through the projection (one jitted pass for each input width)
    @jax.jit
    def jpass(params, x, ck, cv, start, g):
        hg, ck, cv = jcp._cp_forward(params, x, ck, cv, start, jcc)
        return jlinear.table_matmul(params["lm_head"], g, hg[:, 0]), ck, cv

    shape = (cc.num_hidden_layers, B, cc.num_key_value_heads, tcp.CP_CACHE_LEN, cc.head_dim)
    jlg, ck, cv = [], jnp.zeros(shape), jnp.zeros(shape)
    x = jnp.asarray(np.concatenate([hidden, code0_embed], axis=1))
    for g in range(cc.num_code_groups - 1):
        lg, ck, cv = jax.block_until_ready(
            jpass(jcpp, x, ck, cv, jnp.int32(0 if g == 0 else g + 1), jnp.int32(g)))
        jlg.append(np.asarray(lg))
        x = jlinear.table_row(jcpp["codec_embedding"], jnp.int32(g),
                              jnp.asarray(jcodes[:, g]), jnp.float32)[:, None]
    # the M of each call on the projection's weight (the wrappers' plain
    # versions on the CPU)
    weight = tcpp["small_to_mtp_projection"][key]
    ms: list = []
    mod, fn = (qm, "int8_matmul_plain") if tree == "int8" else (pm, "packed_matmul_plain")
    real = getattr(mod, fn)

    def recording(x2, w, *args):
        if w is weight:
            ms.append(x2.shape[0])
        return real(x2, w, *args)

    monkeypatch.setattr(mod, fn, recording)
    tlg = []
    tcodes, tsum = tcp.predict_frame_batched(
        tcpp, torch.from_numpy(hidden), torch.from_numpy(code0_embed), None, torch.zeros(B), cc,
        forced_codes=torch.from_numpy(jcodes), logits_out=tlg)
    monkeypatch.undo()
    ng = cc.num_code_groups - 1
    assert ms == [2 * B] + [B] * (ng - 1)
    assert len(tlg) == ng
    ties = 0
    for g, (lg, ref) in enumerate(zip(tlg, jlg)):
        assert rel_rms(lg, ref) <= REL, g
        for r in range(B):
            pick = int(torch.argmax(lg[r]))
            if pick != jcodes[r, g]:
                ties += 1
                assert near_tie(lg[r], pick, int(jcodes[r, g])), (r, g)
    assert ties <= 2
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    assert rel_rms(tsum, jsum) <= REL


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serving_1_7b_b32") / "model")
    enc = ttesting.tiny_encoder_config()
    # the x-vector joins the codec stream unprojected: the talker's width
    ttesting.write_model_dir(
        d, CFG, ttesting.tiny_decoder_config(), seed=0, weight_dtype=torch.float32,
        with_encoders=True, speaker_config=ttesting.tiny_speaker_config(enc_dim=CFG.hidden_size),
        encoder_config=enc, tts_model_type="base")
    tpl = tpipe.Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)
    jpl = jpipe.Qwen3TTSPipeline(d, jpipe.Qwen3TTSPipelineConfiguration(
        use_cp_megakernel=False, use_talker_megakernel=False, use_vocoder_kernels=False),
        dtype=jnp.float32)
    assert "small_to_mtp_projection" in tpl.cp_params
    ref = ttesting.reference_clip(63, enc)  # a 5 s clip's codes at 12.5 Hz
    return tpl, jpl, tpl.extract_speaker_embedding(ref), tpl.encode_reference_audio(ref)


def test_service_at_b16_serves_arrivals_behind_long_streams(models, monkeypatch):
    tpl, jpl, emb, codes = models
    fed: dict = {}

    class Recording(tsrv._RowPacker):
        def feed(self, key, valid, done):
            fed.setdefault(key, []).append(valid)
            return super().feed(key, valid, done)

    monkeypatch.setattr(tsrv, "_RowPacker", Recording)
    spf = tpl._samples_per_frame
    burst = ttesting.mode_burst(emb, codes) + [(BENCH_TEXT, "aiden", {})] * 8
    arrivals = [(BENCH_TEXT, "aiden", {}), (BENCH_TEXT, "aiden", {}),
                (BENCH_TEXT, "", {"speaker_embedding": emb}),
                (BENCH_TEXT, "", {"reference_transcript": ttesting.REFERENCE_TRANSCRIPT,
                                  "reference_audio_codes": codes})]
    svc = tservice.TTSService(tpl, batch_size=16, trailing_bucket=128)
    try:
        # the burst of 16 into the idle service, every request at once
        held: list = []
        for i, (text, spk, kw) in enumerate(burst):
            svc.submit(text, spk, temperature=0.0, max_tokens=FRAMES, seed=100 + i,
                       _hold=held, **kw)
        svc._enqueue(held)
        for req in held:
            audio = req.audio()
            assert len(audio) == FRAMES * spf and np.isfinite(audio).all()
        # long streams keep the batch busy; their text holds their stop back
        longs = [svc.submit(LONG_TEXT, "aiden", temperature=0.9, max_tokens=LONG_FRAMES,
                            seed=500 + i) for i in range(LONG_STREAMS)]
        got = {i: [] for i in range(LONG_STREAMS)}

        def drain(i):
            for c in longs[i].chunks():
                got[i].append(c)

        drains = [threading.Thread(target=drain, args=(i,)) for i in range(LONG_STREAMS)]
        for th in drains:
            th.start()
        deadline = time.monotonic() + 120
        while not all(got.values()) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert all(got.values())  # every long stream has audio: the batch is mid-flight
        # the arrivals: the two built-in ones together, each clone alone
        late: list = []
        for i, (text, spk, kw) in enumerate(arrivals):
            svc.submit(text, spk, temperature=0.0, max_tokens=FRAMES, seed=600 + i, _hold=late,
                       **kw)
        for part in (late[:2], late[2:3], late[3:]):
            svc._enqueue(part)
        heard = [req.audio() for req in late]
        assert not any(c.is_final for cs in got.values() for c in cs)  # still decoding
        for req in longs:
            req.cancel()
        for th in drains:
            th.join(timeout=60)
        statics = svc.statics
        singles = [svc._prefill(req) for req in late]
        deadline = time.monotonic() + 60
        while svc.stats()["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = svc.stats()
    finally:
        svc.close(drain=True)
    for cs in got.values():  # one final chunk each, after the cancel
        assert sum(c.is_final for c in cs) == 1 and cs[-1].is_final
        assert sum(c.token_range[1] - c.token_range[0] for c in cs) < LONG_FRAMES
    assert stats["requests_cancelled"] == LONG_STREAMS and stats["active_slots"] == 0
    assert stats["requests_submitted"] == len(burst) + LONG_STREAMS + len(arrivals)
    assert stats["requests_submitted"] == (stats["requests_completed"]
                                           + stats["requests_cancelled"])
    assert not stats["requests_failed"] and not stats["worker_restarts"]
    # each arrival's prompt rows against JAX's
    for req, (text, spk, kw) in zip(late, arrivals):
        jpd = jprompt.assemble_prompt_padded(jpl.params, jpl.config, jpl.tokenizer, text,
                                             speaker=spk, prompt_bucket=128,
                                             trailing_bucket=128, **kw)
        assert tprompt.pd_lengths(req.pd) == jprompt.pd_lengths(jpd)
        for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
            assert rel_rms(getattr(req.pd, name), getattr(jpd, name)) <= 1e-5, name
    # each arrival's frames against its B = 1 single's greedy picks
    params, cp = tsrv._drop_kernel(tpl.params), tsrv._drop_kernel(tpl.cp_params)
    cc, ties = tpl.config.code_predictor_config, 0
    for j, (req, single) in enumerate(zip(late, singles)):
        frames = np.concatenate(fed[req]).astype(np.int64)
        assert len(frames) == FRAMES and len(heard[j]) == FRAMES * spf, j
        assert np.isfinite(heard[j]).all()
        for i, frame in enumerate(torch.from_numpy(frames)):
            lg = [greedy_scores(single, tpl.config, "total_texts", statics.repetition_penalty)]
            tcp.predict_frame_batched(cp, single["h_last"], ttalker.encode_audio(
                params, frame[None, :1]), None, torch.zeros(1), cc, forced_codes=frame[None, 1:],
                logits_out=lg)
            for g, scores in enumerate(lg):  # code 0, then the code predictor's 15
                pick = int(torch.argmax(scores[0]))
                if pick != int(frame[g]):
                    ties += 1
                    assert near_tie(scores[0], pick, int(frame[g])), (j, i, g)
            tsrv.lockstep_step(params, cp, single, torch.zeros(1), statics, False,
                               forced=frame[None])
    assert ties <= 2
