"""The port's always-on service (qwen3_tts_tpu_torch/service.py) on the CPU
in fp32 at tiny widths. First against the JAX package's TTSService on
identical weights (JAX random init, int8 runtime quantization, the same
numpy trees into both, one tokenizer): B = 2, decode chunk 6, left context
3; two requests decode, then a burst of three arrives (the port's first two
reach the worker together, so its burst takes one full-B admission and
leaves one request in the backlog); greedy. Per request: the same chunk
token ranges and audio length, audio rel RMS <= 1e-4 (fp32 sums in another
order through talker, code predictor and vocoder). Then the port against
itself: cancel, backpressure, max_queue validation, close(drain=True) with
the /stats identity, warmup, and worker restarts after a crash in the
decode and in the PCM puller."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import service as jservice
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops.quant import apply_int8_quantization as j_int8
from qwen3_tts_tpu.testing import (
    FakeByteTokenizer,
    config_to_json_dict,
    tiny_decoder_config,
    tiny_models,
)
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig, TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import to_torch, vocoder_params
from qwen3_tts_tpu_torch.models import serving as tsrv

torch.set_num_threads(1)
TEXTS = [
    "Independent request number one arrives first.",
    "A second request shows up while the first is decoding.",
    "Third request lands after a pause, batch already running.",
    "Fourth request fills the last open slot in the batch.",
    "Fifth request has to wait for a slot to free up.",
]
DC, CTX = 6, 3
REL = 1e-4


def rel_rms(got, ref) -> float:
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline): the attributes a service reads."""
    jcfg, tp, cp = tiny_models()
    tp = j_int8(jax.tree.map(np.asarray, tp), kernel_layout=False)
    cp = j_int8(jax.tree.map(np.asarray, cp), kernel_layout=False)
    jdec = tiny_decoder_config(codebook_size=jcfg.code_predictor_config.vocab_size)
    vp = jax.tree.map(np.asarray, jvoc.init_vocoder_params(jdec, jax.random.PRNGKey(7)))
    tdec = TokenizerDecoderConfig(**jdec.__dict__)
    defaults = SimpleNamespace(default_temperature=0.0, default_max_tokens=12)
    tok = FakeByteTokenizer()
    jpl = SimpleNamespace(
        config=jcfg, params=jax.tree.map(jnp.asarray, tp), cp_params=jax.tree.map(jnp.asarray, cp),
        tokenizer=tok, speech_config=SimpleNamespace(decoder_config=jdec),
        vocoder_params=jax.tree.map(jnp.asarray, vp), pipeline_config=defaults)
    tpl = SimpleNamespace(
        config=Qwen3TTSConfig.from_json(config_to_json_dict(jcfg)), params=to_torch(tp),
        cp_params=to_torch(cp), tokenizer=tok, speech_config=SimpleNamespace(decoder_config=tdec),
        vocoder_params=vocoder_params(vp, tdec), pipeline_config=defaults)
    return jpl, tpl


def make(mod, pl, **kw):
    return mod.TTSService(pl, batch_size=2, chunk_steps=5, decode_chunk=DC, left_context=CTX,
                          trailing_bucket=128, **kw)


def collect(req, head=()):
    chunks = list(head) + list(req.chunks())
    assert sum(c.is_final for c in chunks) == 1 and chunks[-1].is_final
    parts = [c.samples for c in chunks if len(c.samples)]
    ranges = [c.token_range for c in chunks if c.token_range[1] > c.token_range[0]]
    assert [a for a, _ in ranges] == [0] + [b for _, b in ranges][:-1]  # they tile [0, n)
    return np.concatenate(parts) if parts else np.zeros(0, np.float32), ranges


def serve_five(svc, port: bool):
    """Two requests decode (the port's reach the worker in one list), then
    a burst of three arrives; returns (audio, token ranges) per request."""
    kw = dict(temperature=0.0, max_tokens=12)
    if port:
        first: list = []
        for text in TEXTS[:2]:
            svc.submit(text, "aiden", _hold=first, **kw)
        svc._enqueue(first)
    else:
        first = [svc.submit(text, "aiden", **kw) for text in TEXTS[:2]]
    streams = [r.chunks() for r in first]
    heads = [next(s) for s in streams]  # both decoding
    burst = [svc.submit(text, "aiden", **kw) for text in TEXTS[2:]]
    out = [collect(r, [h]) for r, h in zip(first, heads)]
    return out + [collect(r) for r in burst]


def test_service_matches_jax_service(pipelines):
    jpl, tpl = pipelines
    jsvc, tsvc = make(jservice, jpl), make(tservice, tpl)
    admits = []
    real = tsrv.admit_stream

    def counting(state, idx, fresh, statics, src=0):
        admits.append((idx, fresh["logits"].shape[0]))
        return real(state, idx, fresh, statics, src=src)

    tsrv.admit_stream = counting
    try:
        got = serve_five(tsvc, port=True)
        ref = serve_five(jsvc, port=False)
    finally:
        tsrv.admit_stream = real
        jsvc.close()
        tsvc.close()
    # the two first requests bootstrapped together, so their slots free at
    # one boundary: two requests admitted from one full-B prefill, then one
    assert len(admits) == 3 and [b for _, b in admits[:2]] == [2, 2], admits
    for i, ((audio, ranges), (jaudio, jranges)) in enumerate(zip(got, ref)):
        assert ranges == jranges, i
        assert len(audio) == len(jaudio) > 0, i
        assert rel_rms(audio, jaudio) <= REL, i
    s = tsvc.stats()
    assert s["requests_submitted"] == s["requests_completed"] == 5


def test_cancel_backpressure_drain_and_validation(pipelines):
    _, tpl = pipelines
    with pytest.raises(ValueError, match="max_queue"):
        make(tservice, tpl, max_queue=-2)
    busy = make(tservice, tpl, max_queue=0)
    try:
        assert busy.busy and busy.try_reject_busy()
        with pytest.raises(tservice.ServiceBusy):
            busy.submit(TEXTS[0], "aiden")
        assert busy.stats()["requests_rejected_busy"] == 2
        assert busy.stats()["requests_submitted"] == 0
    finally:
        busy.close()

    svc = make(tservice, tpl, max_queue=None)
    try:
        svc.warmup(max_tokens=12)  # bootstrap, one arrival, parks
        s = svc.stats()
        assert s["requests_submitted"] == s["requests_completed"] == 3  # burst of min(2, B-1)
        req = svc.submit(TEXTS[0], "aiden", temperature=0.0, max_tokens=400)
        req.cancel()
        chunks = list(req.chunks())  # ends at the next boundary, with a final chunk
        assert chunks[-1].is_final
        assert svc.submit(TEXTS[1], "aiden", max_tokens=0).audio().size == 0  # no slot
        with pytest.raises(ValueError, match="max_tokens"):
            svc.submit(TEXTS[1], "aiden", max_tokens=-1)
        with pytest.raises(ValueError, match="exceeds service buckets"):
            svc.submit("word " * 40, "aiden")
        pending = [svc.submit(t, "aiden", temperature=t0, max_tokens=8, seed=3)
                   for t, t0 in zip(TEXTS[2:], (0.0, 0.9, 0.0))]
        svc.close(drain=True)
        s = svc.stats()
        assert s["closed"] and s["active_slots"] == 0 and s["queued"] == 0
        assert s["requests_cancelled"] == 1 and s["requests_failed"] == 0
        assert s["requests_submitted"] == 3 + 1 + 1 + 3
        assert s["requests_submitted"] == (s["requests_completed"] + s["requests_failed"]
                                           + s["requests_cancelled"])
        spf = tpl.speech_config.decoder_config.total_upsample
        for r in pending:  # up to 8 frames each, past the filter of special codes
            audio = r.audio()
            assert len(audio) % spf == 0 and len(audio) <= 8 * spf
            assert np.isfinite(audio).all()
        with pytest.raises(tservice.ServiceClosed):
            svc.submit(TEXTS[0], "aiden")
    finally:
        svc.close()


def test_worker_restarts_after_a_crash(pipelines, monkeypatch):
    """A crash in the decode, then one in the PCM puller: each fails the
    request in flight and the worker restarts with a fresh batch, whose
    next request is served as by a new service; past max_worker_restarts
    the service closes for good."""
    _, tpl = pipelines
    ref = make(tservice, tpl)
    try:
        want = ref.submit(TEXTS[1], "aiden", max_tokens=8).audio()
    finally:
        ref.close()
    crash = {"decode": threading.Event(), "pull": threading.Event()}
    decode, resolve = tsrv.decode_chunk_serving, tsrv.resolve_vocoded

    def flaky_decode(*args, **kwargs):
        if crash["decode"].is_set():
            crash["decode"].clear()
            raise RuntimeError("injected device failure")
        return decode(*args, **kwargs)

    def flaky_resolve(*args, **kwargs):
        if crash["pull"].is_set():
            crash["pull"].clear()
            raise RuntimeError("injected copy failure")
        yield from resolve(*args, **kwargs)

    monkeypatch.setattr(tsrv, "decode_chunk_serving", flaky_decode)
    monkeypatch.setattr(tsrv, "resolve_vocoded", flaky_resolve)
    svc = make(tservice, tpl)
    try:
        for n, kind in enumerate(("decode", "pull"), 1):
            crash[kind].set()
            with pytest.raises(tservice.ServiceClosed):
                svc.submit(TEXTS[0], "aiden", max_tokens=8).audio()
            deadline = time.monotonic() + 30  # the puller's error reaches the worker later
            while svc.worker_restarts < n and time.monotonic() < deadline:
                time.sleep(0.01)
            np.testing.assert_array_equal(svc.submit(TEXTS[1], "aiden", max_tokens=8).audio(),
                                          want)
            assert svc.worker_restarts == n
        crash["decode"].set()  # the budget (2) is spent: closed for good
        with pytest.raises(tservice.ServiceClosed):
            svc.submit(TEXTS[2], "aiden", max_tokens=8).audio()
        svc._worker.join(timeout=30)
        assert not svc._worker.is_alive()
        with pytest.raises(tservice.ServiceClosed):
            svc.submit(TEXTS[3], "aiden")
        s = svc.stats()
        assert s["requests_failed"] == 3 and s["requests_completed"] == 2
    finally:
        svc.close()
