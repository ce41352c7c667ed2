"""The port's batched lockstep serving (qwen3_tts_tpu_torch/models/serving.py)
against the JAX package's, on the CPU in fp32 at tiny widths, on identical
weights (JAX random init, int8 runtime quantization, the same numpy tree into
both; the JAX side called eagerly). Tolerances: rel RMS <= 1e-4 on hidden
states, logits, caches and embedding sums (fp32 sums in another order), codes equal
at temperature 0. Then the port against itself: greedy generate_many per
stream equals the single-stream decode with no code-predictor repetition
sets (as tests/test_serving.py holds the JAX package), and a sampled
stream's codes depend neither on its slot nor on when it was admitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
from qwen3_tts_tpu_torch.testing import (
    config_to_json_dict,
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
)

torch.set_num_threads(1)
REL = 1e-4
TEXTS = [
    "First stream text for batched serving.",
    "A different and somewhat longer second stream with extra words at the end.",
    "Short third one here.",
]


def rel_rms(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


@pytest.fixture(scope="module")
def models():
    tcfg = tiny_talker_config()
    jcfg = JConfig.from_json(config_to_json_dict(tcfg))
    tp = jtalker.init_talker_params(jcfg, jax.random.PRNGKey(0))
    cp = jcp.init_cp_params(jcfg.code_predictor_config, jcfg.hidden_size, jax.random.PRNGKey(1))
    tp = j_int8(jax.tree.map(np.asarray, tp), kernel_layout=False)
    cp = j_int8(jax.tree.map(np.asarray, cp), kernel_layout=False)
    jp = (jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp))
    return jcfg, tcfg, jp, (to_torch(tp), to_torch(cp))


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_dir") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return tpipe.Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)


def test_batched_talker_step_and_frame_match_jax(models):
    """B = 3 streams at different positions and window starts, one shared
    ring slot: the talker step's hidden state, logits and cache, then the
    greedy code-predictor frame's codes and embedding sum."""
    jcfg, tcfg, (jtp, jcpp), (ttp, tcpp) = models
    rng = np.random.default_rng(0)
    b, cap, h = 3, 40, jcfg.hidden_size
    nl, nkv, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
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

    hidden = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    code0_embed = (rng.standard_normal((b, 1, h)) * 0.5).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    jcodes, jsum = jsrv.predict_frame_batched(
        jcpp, jnp.asarray(hidden), jnp.asarray(code0_embed), keys, jnp.float32(0.0),
        jcfg.code_predictor_config)
    tcodes, tsum = tcp.predict_frame_batched(
        tcpp, torch.from_numpy(hidden), torch.from_numpy(code0_embed), None,
        torch.zeros(b), tcfg.code_predictor_config)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert rel_rms(tsum, jsum) <= REL


def test_prefill_and_admission_match_jax(models):
    """prefill_batched of three prompts of different lengths, then a
    mid-flight admission at step 44 of row 2 of a burst prefill into slot 1,
    then two greedy chunks of decode_chunk_serving of 3 steps (JAX's jitted:
    under jax.disable_jit its fori_loop hands the code predictor's body a
    Python int, which it calls .astype on): every state array against JAX's
    (the samplers' keys aside: the port keeps each request's seed, JAX a
    PRNG key), and the frames, counts and eos flags. Inside the chunks:
    the eos / pad mask while text remains (row 1), a consecutive-pad stop
    (row 2) and an EOS stop (row 0, second chunk), frozen rows after their
    stop, and row 0's window trim at its 45th step, the chunks' first (its
    position base raised past KV_WINDOW)."""
    jcfg, tcfg, (jtp, jcpp), (ttp, tcpp) = models
    rng = np.random.default_rng(1)
    b, p_pad, t_pad, h = 3, 16, 8, jcfg.hidden_size
    cap = p_pad + 24
    lengths = np.array([9, 16, 12], np.int32)
    totals = np.array([3, 8, 5], np.int32)
    embeds = np.zeros((b, p_pad, h), np.float32)
    trailing = np.zeros((b, t_pad, h), np.float32)
    for i in range(b):
        embeds[i, :lengths[i]] = rng.standard_normal((lengths[i], h)) * 0.5
        trailing[i, :totals[i]] = rng.standard_normal((totals[i], h)) * 0.5
    pad = (rng.standard_normal((1, 1, h)) * 0.5).astype(np.float32)
    jstat = jgen.GenStatics(config=jcfg, capacity=cap, chunk_steps=0, track_cp_penalty=False)
    tstat = tgen.GenStatics(config=tcfg, capacity=cap, chunk_steps=0, track_cp_penalty=False)

    def both(e, ln, tr, tot):
        j = jsrv._prefill_batched_jit.__wrapped__(
            jtp, jnp.asarray(e), jnp.asarray(ln), jnp.asarray(tr), jnp.asarray(tot),
            jnp.asarray(pad), jax.vmap(jax.random.PRNGKey)(jnp.arange(len(ln))), jstat)
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
    compare(jstate, tstate)
    # a running state at step 44 (the ring has wrapped), and a burst of
    # three fresh prompts, the same ones reversed
    jstate = {**jstate, "step": jnp.int32(44),
              "eos": jnp.asarray([False, True, False])}
    tstate["step"].fill_(44)
    tstate["eos"].copy_(torch.tensor([False, True, False]))
    jfresh, tfresh = both(embeds[::-1].copy(), lengths[::-1].copy(), trailing[::-1].copy(),
                          totals[::-1].copy())
    jadm = jsrv.admit_stream.__wrapped__(jstate, jnp.int32(1), jfresh, jstat, 2)
    tadm = tsrv.admit_stream(tstate, 1, tfresh, tstat, src=2)
    compare(jadm, tadm)
    assert int(tadm["lengths"][1]) == int(lengths[0]) - 44

    pad_id, eos_id = tcfg.codec_pad_id, tcfg.codec_eos_token_id

    def edit(j, t, row, **fields):
        for name, (col, value) in fields.items():
            at = (row,) if col is None else (row, col)
            j = {**j, name: j[name].at[at].set(value)}
            t[name][at] = value
        return j

    # row 0: text through the first chunk, positions past the window; row 1
    # (admitted, text left): EOS on top, masked; row 2: no text left, pad on
    # top after MAX_CONSECUTIVE_PAD pads
    jadm = edit(jadm, tadm, 0, lengths=(None, int(lengths[0]) + 200), total_texts=(None, t_pad))
    jadm = edit(jadm, tadm, 1, logits=(eos_id, 1e4))
    jadm = edit(jadm, tadm, 2, trailing_idx=(None, int(totals[2])), logits=(pad_id, 1e4),
                consecutive_pad=(None, jgen.MAX_CONSECUTIVE_PAD))
    jst = jgen.GenStatics(config=jcfg, capacity=cap, chunk_steps=3, track_cp_penalty=False)
    tst = tgen.GenStatics(config=tcfg, capacity=cap, chunk_steps=3, track_cp_penalty=False)
    for first, want_eos in ((True, [False, False, True]), (False, [True, False, True])):
        jf, jn, je, jadm = jsrv.decode_chunk_serving(jtp, jcpp, jadm, jnp.float32(0.0), jst)
        tf, tn, te, tadm = tsrv.decode_chunk_serving(ttp, tcpp, tadm, 0.0, tst)
        compare(jadm, tadm)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(te.numpy(), want_eos)
        np.testing.assert_array_equal(np.asarray(je), want_eos)
        if first:
            assert (tf[2] == -1).all() and int(tf[1, 0, 0]) != eos_id
            assert int(tadm["window_start"][0]) > 0 == int(tadm["window_start"][1])
            jadm = edit(jadm, tadm, 0, trailing_idx=(None, t_pad), logits=(eos_id, 1e4))
    assert (tf[0] == -1).all() and (tf[1, :, 0] >= 0).all()


def test_greedy_generate_many_equals_single_stream(tpl):
    """Greedy: generate_codes_batched's codes per stream equal the
    single-stream decode without the code predictor's repetition sets (the
    sets serving keeps none of), and generate_many's audio per stream equals
    that decode vocoded alone. The megakernel configuration (plain versions
    on the CPU) serves through the layer path on the kernels' `w8r` views."""
    pds = [tpl._assemble(t, "aiden") for t in TEXTS]
    batched = tsrv.generate_codes_batched(tpl.params, tpl.cp_params, tpl.config, pds,
                                          temperature=0.0, max_tokens=12, chunk_steps=5)
    audio = tpl.generate_many(TEXTS, "aiden", temperature=0.0, max_tokens=12)
    for i, pd in enumerate(pds):
        single = tgen.filter_valid_frames(tgen.generate_codes(
            tpl.params, tpl.cp_params, tpl.config, pd, temperature=0.0, max_tokens=12,
            chunk_steps=5, track_cp_penalty=False))
        got = tgen.filter_valid_frames(batched[i])
        assert len(single) > 0
        np.testing.assert_array_equal(got, single, err_msg=f"stream {i}")
        np.testing.assert_allclose(audio[i], tpl._decode_to_audio(single), atol=1e-5)

    mk = tpipe.Qwen3TTSPipeline(tpl.model_path, tpipe.Qwen3TTSPipelineConfiguration(
        use_talker_megakernel=True, use_cp_megakernel=True), device="cpu", dtype=torch.float32)
    assert "kernel" in mk.params and "w8r" in mk.params["layers"]["qkv_proj"]
    outs = mk.generate_many(TEXTS[:2], "aiden", temperature=0.0, max_tokens=6)
    assert all(len(o) == 6 * mk._samples_per_frame and np.isfinite(o).all() for o in outs)


def test_sampled_stream_does_not_depend_on_slot_or_admission(tpl):
    """Temperature 0.9: request r draws with seed + r keyed by its own
    step, so its codes are the same whether all three requests start
    together (B = 3, generate_codes_batched and a 3-slot server), two slots
    serve them (the third admitted mid-flight), or one slot serves them in
    turn. The words are K2g's: at step 0 a stream's are philox_words of its
    seed."""
    seeds = torch.tensor([3, 2 ** 40 + 7])
    words = gs.philox_words_streams(seeds, torch.tensor([0, 5]), 16, 3071)
    assert torch.equal(words[0], gs.philox_words(seeds[:1], 16, 3071))
    assert not torch.equal(words[1], gs.philox_words(seeds[1:], 16, 3071))
    pds = [tpl._assemble(t, "aiden") for t in TEXTS]
    kw = dict(temperature=0.9, max_tokens=8)
    runs = [tsrv.generate_codes_batched(tpl.params, tpl.cp_params, tpl.config, pds,
                                        chunk_steps=4, seed=3, **kw)]
    for slots in (3, 2, 1):
        server = tsrv.ContinuousServer(tpl.params, tpl.cp_params, tpl.config,
                                       batch_size=slots, prompt_bucket=64, trailing_bucket=128,
                                       chunk_steps=4, seed=3)
        runs.append(server.run(pds, **kw))
    for r in range(len(pds)):
        ref = runs[0][r]
        assert len(ref) == 8 and (ref[:, 0] < 2048).any()
        for run in runs[1:]:
            np.testing.assert_array_equal(run[r], ref, err_msg=f"request {r}")
    # another seed draws other codes
    other = tsrv.generate_codes_batched(tpl.params, tpl.cp_params, tpl.config, pds,
                                        chunk_steps=4, seed=4, **kw)
    assert any(not np.array_equal(a, b) for a, b in zip(other, runs[0]))
