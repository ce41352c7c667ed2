"""The port's tp-sharded inference (parallel/sharding.py local_params,
models/talker.py decoder_layers, serving, service, vocoder) across two gloo
processes on the CPU, held against the JAX package's sharded functions on
conftest's CPU devices (a (dp = 1, tp = 2) and a (dp = 2, tp = 1) mesh of
two), on the same tiny fp32 weights (the JAX package's host trees of its
tiny config and a random vocoder tree; numpy trees into both), as the
inference sections of `dryrun_multichip`:

- single-stream prefill + decode_chunk (greedy, 8 frames), and two of the
  stream stacked (stack_states / decode_chunk_batched, 2 frames);
- prefill_batched + decode_chunk_serving at B = 2 (8 steps in chunks of 4);
- the park / admit cycle (a chunk, park_slot(0), a B = 1 prefill admitted
  into slot 0, a chunk);
- the dp-sharded vocode at B = 2;
- TTSService (batch_size 2, chunk_steps 4, decode_chunk 6, left_context 3)
  on 3 requests, the third admitted mid-flight: rank 0 serves, rank 1
  follows.

Tolerances: frames, counts and EOS equal to JAX's, a departure allowed
only where the port's greedy code 0, teacher-forced on JAX's frames, picks
another code whose score is within 5e-3 of the top score (at most twice, as
tests/test_torch_batched_decode.py allows); talker logits teacher-forced
on JAX's frames at rel RMS <= 1e-4 a step (fp32 sums in another order
across the ranks); waveforms at rel RMS <= 1e-4; the service's chunk token
ranges and audio lengths equal to JAX's service and its audio at rel RMS
<= 1e-4 (as tests/test_torch_service.py), and byte-identical to the port's
unsharded service. Guards: a quantized tree is refused by shard_params,
each rank's KV cache has its local KV heads, no placed tree reaches
serving.bind (whose capture refuses it), and a one-process tp = 1 mesh runs
the same code bit for bit as the plain tree. Every JAX call is waited on
before the next dispatch. One spawn of the two processes serves every
case."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from qwen3_tts_tpu import service as jservice
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.parallel import sharding as jsh
from qwen3_tts_tpu.testing import (
    FakeByteTokenizer,
    config_to_json_dict,
    tiny_decoder_config,
)
from qwen3_tts_tpu.testing import random_host_cp_params as jrandom_cp
from qwen3_tts_tpu.testing import random_host_talker_params as jrandom_talker
from qwen3_tts_tpu.testing import tiny_talker_config as jtiny_talker_config
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig, TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import to_torch, vocoder_params
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.ops.quant import apply_int8_quantization
from qwen3_tts_tpu_torch.parallel import dryrun
from qwen3_tts_tpu_torch.parallel import sharding as sh
from qwen3_tts_tpu_torch.testing import FakeByteTokenizer as TFakeByteTokenizer
from qwen3_tts_tpu_torch.testing import random_vocoder_params

torch.set_num_threads(1)
REL = 1e-4
NEAR_TIE = 5e-3
CASES = list(dryrun.INFERENCE_CASES)


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


def ready(tree):
    """Wait for every array of a JAX result before the next dispatch."""
    return jax.block_until_ready(tree)


def padded(pd, pb: int, tb: int, h: int):
    p, t = int(pd.input_embeds.shape[1]), int(pd.trailing_hidden.shape[1])
    e = jnp.zeros((1, pb, h)).at[:, :p].set(pd.input_embeds)
    tr = jnp.zeros((1, tb, h)).at[:, :t].set(pd.trailing_hidden)
    return e, tr, p, t


def jax_runs(cfg, params, cp, vparams, dec, codes) -> dict:
    """JAX's sharded runs of the five cases (greedy, one step a chunk for
    per-step logits where the port is teacher-forced)."""
    tok = FakeByteTokenizer()
    h = cfg.hidden_size
    tp_mesh = jsh.make_mesh(2, tp=2)
    sp = ready(jsh.shard_params(params, tp_mesh, config=cfg))
    out = {}

    # single stream
    pd = jprompt.assemble_prompt(params, cfg, tok, dryrun.SENTENCE, speaker="aiden")
    pb = jgen.pick_bucket(int(pd.input_embeds.shape[1]))
    tb = jgen.pick_bucket(int(pd.trailing_hidden.shape[1]), jgen.TRAILING_BUCKETS)
    one = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                          track_cp_penalty=False)
    e, tr, p, t = padded(pd, pb, tb, h)
    with tp_mesh:
        st = ready(jgen.prefill(sp, e, jnp.int32(p), tr, jnp.int32(t), pd.tts_pad_embed,
                                jax.random.PRNGKey(0), one))
        logits, frames, count, eos = [np.asarray(st["logits"])], [], 0, False
        for _ in range(dryrun.STEPS):
            f, c, e_, st = ready(jgen.decode_chunk(sp, cp, st, jnp.float32(0.0), one))
            frames.append(np.asarray(f[0]))
            count += int(c)
            eos = bool(e_)
            logits.append(np.asarray(st["logits"]))
    out["single"] = {"frames": np.stack(frames), "count": count, "eos": eos,
                     "logits": np.stack(logits)}

    # serving at B = 2, and the park / admit cycle
    pds = [jprompt.assemble_prompt(params, cfg, tok, x, speaker="aiden")
           for x in (*dryrun.SERVE_TEXTS, dryrun.FRESH_TEXT)]
    pb = jgen.pick_bucket(max(int(d.input_embeds.shape[1]) for d in pds))
    tb = jgen.pick_bucket(max(int(d.trailing_hidden.shape[1]) for d in pds),
                          jgen.TRAILING_BUCKETS)

    def rows(ds, seeds):
        parts = [padded(d, pb, tb, h) for d in ds]
        return (jnp.concatenate([x[0] for x in parts]),
                jnp.asarray([x[2] for x in parts], jnp.int32),
                jnp.concatenate([x[1] for x in parts]),
                jnp.asarray([x[3] for x in parts], jnp.int32), pds[0].tts_pad_embed,
                jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))

    def statics(chunk):
        return jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=chunk,
                               track_cp_penalty=False)

    with tp_mesh:
        st = ready(jsrv.prefill_batched(sp, *rows(pds[:2], [0, 1]), statics(1)))
        logits, frames = [np.asarray(st["logits"])], []
        for _ in range(dryrun.STEPS):
            f, _, eos, st = ready(jsrv.decode_chunk_serving(sp, cp, st, jnp.float32(0.0),
                                                            statics(1)))
            frames.append(np.asarray(f[:, 0]))
            logits.append(np.asarray(st["logits"]))
        frames = np.stack(frames, 1)
        out["serving"] = {"frames": frames, "counts": (frames[..., 0] >= 0).sum(1),
                          "eos": np.asarray(eos), "logits": np.stack(logits, 1)}

        c4 = statics(dryrun.CHUNK)
        st = ready(jsrv.prefill_batched(sp, *rows(pds[:2], [0, 1]), c4))
        fa, _, _, st = ready(jsrv.decode_chunk_serving(sp, cp, st, jnp.float32(0.0), c4))
        st = ready(jsrv.park_slot(st, jnp.int32(0)))
        fresh = ready(jsrv.prefill_batched(sp, *rows(pds[2:], [99]), c4))
        st = ready(jsrv.admit_stream(st, jnp.int32(0), fresh, c4))
        fb, counts, eos, st = ready(jsrv.decode_chunk_serving(sp, cp, st, jnp.float32(0.0),
                                                              c4))
        out["cycle"] = {"fa": np.asarray(fa), "fb": np.asarray(fb), "counts": np.asarray(counts),
                        "eos": np.asarray(eos), "logits": np.asarray(st["logits"])}

    # the dp-sharded vocode
    dp_mesh = jsh.make_mesh(2, tp=1)
    with dp_mesh:
        placed = ready(jax.device_put(jnp.asarray(codes), NamedSharding(dp_mesh, P("dp"))))
        out["vocode"] = {"wav": np.asarray(ready(jvoc.decode_frames_jit(vparams, placed, dec)))}

    # the service on the tp-sharded tree
    pl = SimpleNamespace(
        config=cfg, params=sp, cp_params=cp, tokenizer=tok,
        speech_config=SimpleNamespace(decoder_config=dec), vocoder_params=vparams,
        pipeline_config=SimpleNamespace(default_temperature=0.0, default_max_tokens=10))
    svc = jservice.TTSService(pl, **dryrun.SERVICE)
    try:
        reqs = [svc.submit(x, "aiden", temperature=0.0, max_tokens=dryrun.SERVICE_MAX_TOKENS,
                           seed=i) for i, x in enumerate(dryrun.SERVICE_TEXTS)]
        audio, ranges = [], []
        for r in reqs:
            chunks = list(r.chunks())
            parts = [c.samples for c in chunks if len(c.samples)]
            audio.append(np.concatenate(parts) if parts else np.zeros(0, np.float32))
            ranges.append([c.token_range for c in chunks])
    finally:
        svc.close()
    out["service"] = {"audio": audio, "ranges": ranges}
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX's sharded runs, the port's two-process run teacher-forced on
    JAX's frames, the port's unsharded service, the port's problem). The
    weights are the JAX package's tiny host trees (random_host_*_params,
    numpy, as tiny_models lays them out) and a random vocoder tree. JAX's
    runs end before the port's processes start: nothing else runs beside a
    JAX call but the JAX service's own threads."""
    jcfg = jtiny_talker_config()
    params = jrandom_talker(jcfg, 0)
    cp = jrandom_cp(jcfg, 1)
    jdec = tiny_decoder_config(codebook_size=jcfg.code_predictor_config.vocab_size)
    tcfg = Qwen3TTSConfig.from_json(config_to_json_dict(jcfg))
    tdec = TokenizerDecoderConfig(**jdec.__dict__)
    vp = {k: v for k, v in dryrun._numpy(random_vocoder_params(tdec, 7)).items()}
    codes = np.random.default_rng(11).integers(0, jdec.codebook_size,
                                               (2, jdec.num_quantizers, 12))
    problem = {"config": tcfg, "decoder": tdec, "codes": codes, "talker": params, "cp": cp,
               "vocoder": vp}
    jtree = lambda t: ready(jax.tree.map(jnp.asarray, t))  # noqa: E731
    ref = jax_runs(jcfg, jtree(params), jtree(cp), jtree(vp), jdec, codes)
    s = ref["single"]  # the port teacher-forced on JAX's frames
    forced = {"single": s["frames"][:s["count"]].astype(np.int64),
              "serving": ref["serving"]["frames"].astype(np.int64)}
    port = dryrun.run_inference(problem, forced=forced, timeout_s=180.0)
    pl = SimpleNamespace(
        config=tcfg, params=to_torch(params), cp_params=to_torch(cp),
        tokenizer=TFakeByteTokenizer(), speech_config=SimpleNamespace(decoder_config=tdec),
        vocoder_params=vocoder_params(vp, tdec),
        pipeline_config=SimpleNamespace(default_temperature=0.0, default_max_tokens=10))
    plain_service = dryrun.serve_texts(pl, dryrun.SERVICE_TEXTS)
    return ref, port, plain_service, problem


def check_stream(label: str, tf: dict, jframes, jlogits, ties: list) -> int:
    """The port's teacher-forced pass on JAX's frames [n, 16]: the talker
    logits after each step (and the prefill's) against JAX's, and the
    port's own greedy frame from each state equal to JAX's, or code 0 off
    at a near tie of its scores (counted in `ties`). Returns the first
    step where the port's pick departs (n if none)."""
    n = len(jframes)
    assert len(tf["logits"]) == n + 1, label
    for i in range(n + 1):
        err = rel_rms(tf["logits"][i].numpy(), jlogits[i])
        assert err <= REL, (label, i, err)
    for i in range(n):
        pick, want = tf["picks"][i].numpy(), jframes[i]
        if np.array_equal(pick, want):
            continue
        scores = tf["scores"][i]
        a, w = int(pick[0]), int(want[0])
        top = float(scores[torch.isfinite(scores)].abs().max())
        assert a != w and abs(float(scores[a] - scores[w])) <= NEAR_TIE * top, (label, i)
        ties.append((label, i))
        return i
    return n


def serving_ties(port: dict, ref: dict, ties: list) -> list:
    """The serving case's streams checked teacher-forced on JAX's frames
    (check_stream) and free-running up to a departure; returns `ties`."""
    g, want = port["serving"]["sharded"], ref["serving"]
    n = g["tf"]["logits"].shape[0] - 1
    assert n >= 4, n  # both streams emitted through the first chunk at least
    for s in range(2):
        tf = {k: v[:, s] for k, v in g["tf"].items()}
        stop = check_stream(f"serving[{s}]", tf, want["frames"][s, :n],
                            want["logits"][s, :n + 1], ties)
        np.testing.assert_array_equal(g["frames"][s, :stop].numpy(), want["frames"][s, :stop])
    return ties


@pytest.mark.parametrize("case", CASES)
def test_sharded_case_matches_jax(case, runs):
    ref, port, plain_service, problem = runs
    assert port["backend"] == "gloo"
    assert port["mesh"] == {"tp": {"dp": 1, "tp": 2}, "dp": {"dp": 2, "tp": 1}}
    got, want = port[case], ref[case]
    ties: list = []
    if case == "single":
        g = got["sharded"]
        n = check_stream("single", g["tf"], want["frames"][:want["count"]], want["logits"], ties)
        if not ties:
            assert (g["count"], g["eos"]) == (want["count"], want["eos"])
        np.testing.assert_array_equal(g["frames"][:n].numpy(), want["frames"][:n])
        assert got["reduces"] > 0  # two a layer and step: the tp split ran
        batched = g["batched"]  # two of the stream stacked on the local caches
        if n >= 2:
            for row in batched["frames"]:
                np.testing.assert_array_equal(row.numpy(), want["frames"][:2])
    elif case == "serving":
        g = got["sharded"]
        serving_ties(port, ref, ties)
        if not ties:
            np.testing.assert_array_equal(g["frames"].numpy(), want["frames"])
            assert g["counts"].tolist() == want["counts"].tolist()
            assert g["eos"].tolist() == want["eos"].tolist()
    elif case == "cycle":
        # the cycle's first chunk is serving's: its frames are JAX's unless
        # serving departed at a near tie
        if not serving_ties(port, ref, ties):
            np.testing.assert_array_equal(got["fa"].numpy(), want["fa"])
            np.testing.assert_array_equal(got["fb"].numpy(), want["fb"])
            assert got["counts"].tolist() == want["counts"].tolist()
            assert got["eos"].tolist() == want["eos"].tolist()
            assert rel_rms(got["logits"].numpy(), want["logits"]) <= REL
        cfg = problem["config"]
        assert got["cache_shape"][2] == cfg.num_key_value_heads // 2  # the local KV heads
    elif case == "vocode":
        assert got["local_rows"] == 1 and got["placements"] == ["S(0)", "R"]
        assert rel_rms(got["wav"].numpy(), want["wav"]) <= REL
    else:
        for i, (a, ja, pa) in enumerate(zip(got["audio"], want["audio"], plain_service["audio"])):
            assert [tuple(r) for r in got["ranges"][i]] == [tuple(r) for r in want["ranges"][i]]
            assert len(a) == len(ja) > 0, i
            assert rel_rms(a, ja) <= REL, i
            assert a.tobytes() == pa.tobytes(), i  # the port's unsharded service
        assert got["stats"]["requests_completed"] == len(dryrun.SERVICE_TEXTS)
    assert len(ties) <= 2


def test_placement_guards(runs, tmp_path):
    """A quantized tree is refused; each rank kept its local KV heads; no
    placed tree reached bind, which refuses one; a one-process (dp = 1, tp
    = 1) mesh runs the placed-tree code bit for bit as the plain tree."""
    _, port, _, problem = runs
    cfg = problem["config"]
    with pytest.raises(ValueError, match="dense"):
        sh.shard_params(to_torch(apply_int8_quantization(problem["talker"])), None, config=cfg)
    local = cfg.num_key_value_heads // 2
    assert port["single"]["sharded"]["kv_heads"] == local
    assert port["single"]["sharded"]["batched"]["cache_shape"][1:3] == (2, local)
    assert port["serving"]["sharded"]["kv_heads"] == local
    assert port["sharded_binds"] == 0 and port["bind_refuses_placed"]

    sh.init_process_group("cpu", 0, 1, f"file://{tmp_path}/rendezvous", timeout_s=30)
    try:
        mesh = sh.make_mesh(1, tp=1)
        plain = to_torch(problem["talker"])
        placed = sh.shard_params(plain, mesh, config=cfg)
        assert sh.is_placed(placed) and not sh.is_placed(plain)
        par, tree = sh.local_params(placed)
        assert par.tp_size == 1 and par.tp is not None
        assert sh.local_params(placed)[1] is tree  # cached per tree
        pd = tprompt.assemble_prompt(plain, cfg, TFakeByteTokenizer(), dryrun.SENTENCE,
                                     speaker="aiden")
        unfused = sh.unfuse_qkv_gateup(plain, cfg)
        runs_ = []
        for t in (unfused, placed):
            st = tgen.prefill(t, pd, cfg)
            frames, count, _ = tgen.decode_chunk(t, to_torch(problem["cp"]), st, cfg, steps=4,
                                                 temperature=0.0, generator=None,
                                                 track_cp_penalty=False)
            runs_.append((frames, count, st["logits"]))
        assert torch.equal(runs_[0][0], runs_[1][0]) and int(runs_[0][1]) == int(runs_[1][1])
        assert torch.equal(runs_[0][2], runs_[1][2])
    finally:
        dist.destroy_process_group()
