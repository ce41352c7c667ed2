"""The voice modes through the always-on service, the port's against the JAX
package's, on the CPU in fp32 at tiny widths. Both pipelines load one tiny
model directory with both encoders (testing.write_model_dir, int8 runtime
quantization, the kernels off: K3's plain version in the port), so both
services read the same weights.

The traffic is one mixed burst of 8 requests at temperature 0
(testing.MODE_BURST), every prompt layout a voice-design or cloning
service sees in one lockstep batch: two
VoiceDesign descriptions of different token lengths, two CustomVoice
requests (built-in speaker + instruct), a speaker-embedding clone and an
ICL request from one reference clip, the request the OpenAI route makes of
`voice` + `instructions` (a CustomVoice prompt), and a built-in speaker.
The reference clip gives REF_CODES codes, a 5 s clip's at 12.5 Hz (the
tiny audio encoder downsamples 24x, not 1,920x): its ICL prompt fits the
service's default 128-row prompt bucket. A long reference (LONG_CODES, a
9 s clip's) does not: the default service refuses it, and a service built
with the first PROMPT_BUCKETS entry that holds its rows (as JAX's
assemble_prompt_padded counts them) serves it.

Checks, at the tolerances the port's other service tests use:
- every padded prompt against JAX's (rel RMS <= 1e-5, the same real
  lengths), then the service's full-B bootstrap prefill of the burst and
  8 lockstep steps teacher-forced on JAX's greedy frames: talker logits
  rel RMS <= 1e-4 after the prefill and every step;
- both services serve the burst: each request's chunk token ranges and
  audio length equal JAX's, audio rel RMS <= 1e-4; the long-reference
  refusal's exception and message equal JAX's; the larger-bucket services
  (ring capacity bucket + RING_SLACK) serve it alike;
- over HTTP through the real services: /tts with `instruct`, speaker +
  `instruct`, `reference_audio_b64` alone and with `reference_transcript`,
  /tts?stream=1 with `instruct`, /v1/audio/speech with `instructions`, the
  long reference (past the bucket the server serves it one at a time, as
  JAX's does), and the mode fields' error cases: statuses, error bodies and
  audio lengths equal JAX's."""

import base64
import dataclasses
import http.client
import json
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu import server as jserver
from qwen3_tts_tpu import service as jservice
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import server as tserver
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.io.wav import parse_wav, wav_data
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.models import serving as tsrv

torch.set_num_threads(1)
REF_CODES, LONG_CODES = 63, 113  # 5 s and 9 s of reference at 12.5 Hz
TRANSCRIPT = ttesting.REFERENCE_TRANSCRIPT
FRAMES = 12  # greedy frames a burst request
TF_STEPS = 8
LONG_TEXT = "A long reference clip to clone."


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("service_modes") / "model")
    enc = ttesting.tiny_encoder_config()
    ttesting.write_model_dir(
        d, ttesting.tiny_talker_config(), ttesting.tiny_decoder_config(), seed=0,
        weight_dtype=torch.float32, with_encoders=True,
        speaker_config=ttesting.tiny_speaker_config(), encoder_config=enc,
        tts_model_type="base")
    jpl = jpipe.Qwen3TTSPipeline(d, jpipe.Qwen3TTSPipelineConfiguration(
        use_cp_megakernel=False, use_talker_megakernel=False, use_vocoder_kernels=False,
        default_temperature=0.0, default_max_tokens=FRAMES), dtype=jnp.float32)
    tpl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        default_temperature=0.0, default_max_tokens=FRAMES), device="cpu",
        dtype=torch.float32)
    ref = ttesting.reference_clip(REF_CODES, enc)
    long_ref = ttesting.reference_clip(LONG_CODES, enc)
    codes = tpl.encode_reference_audio(ref)
    assert len(codes[0]) == REF_CODES
    long_codes = tpl.encode_reference_audio(long_ref)
    assert len(long_codes[0]) == LONG_CODES
    burst = ttesting.mode_burst(tpl.extract_speaker_embedding(ref), codes)
    long_kw = {"reference_transcript": TRANSCRIPT, "reference_audio_codes": long_codes}
    return SimpleNamespace(jpl=jpl, tpl=tpl, burst=burst, long_kw=long_kw, ref=ref,
                           long_ref=long_ref)


def long_bucket(pipes) -> int:
    """The first PROMPT_BUCKETS entry that holds the long-reference ICL
    prompt's rows, as JAX's assemble_prompt_padded counts them."""
    jpl = pipes.jpl
    pd = jprompt.assemble_prompt_padded(jpl.params, jpl.config, jpl.tokenizer, LONG_TEXT,
                                        prompt_bucket=128, trailing_bucket=64, **pipes.long_kw)
    p, _ = jprompt.pd_lengths(pd)
    assert p > 128
    return jgen.pick_bucket(p)


def test_mixed_burst_prompts_and_teacher_forced_logits_match_jax(pipes):
    jpl, tpl = pipes.jpl, pipes.tpl
    jsvc = jservice.TTSService(jpl, batch_size=8)
    tsvc = tservice.TTSService(tpl, batch_size=8)
    try:
        placed_j, placed_t = {}, {}
        for slot, (text, spk, kw) in enumerate(pipes.burst):
            jpd = jprompt.assemble_prompt_padded(
                jpl.params, jpl.config, jpl.tokenizer, text, speaker=spk,
                prompt_bucket=jsvc.prompt_bucket, trailing_bucket=jsvc.trailing_bucket, **kw)
            held: list = []
            tsvc.submit(text, spk, seed=slot, _hold=held, **kw)
            tpd = held[0].pd
            assert tprompt.pd_lengths(tpd) == jprompt.pd_lengths(jpd), slot
            assert tpd.input_embeds.shape == jpd.input_embeds.shape == (
                1, 128, jpl.config.hidden_size)
            for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
                assert rel_rms(getattr(tpd, name), getattr(jpd, name)) <= 1e-5, (slot, name)
            placed_j[slot] = SimpleNamespace(pd=jpd, seed=slot)
            placed_t[slot] = held[0]
        lengths = [jprompt.pd_lengths(r.pd)[0] for r in placed_j.values()]
        assert len(set(lengths)) >= 6, lengths  # the layouts' lengths differ
        jstate = jsvc._prefill_bootstrap(placed_j)
        tstate = tsvc._prefill_bootstrap(placed_t)
        assert rel_rms(tstate["logits"], jstate["logits"]) <= 1e-4
        one = dataclasses.replace(jsvc.statics, chunk_steps=1)
        params, cp = tsrv._drop_kernel(tpl.params), tsrv._drop_kernel(tpl.cp_params)
        temps = torch.zeros(8)
        for i in range(TF_STEPS):
            frames, _, _, jstate = jsrv.decode_chunk_serving(
                jpl.params, jpl.cp_params, jstate, jnp.float32(0.0), one)
            frame = np.asarray(jax.block_until_ready(frames))[:, 0]
            assert (frame[:, 0] >= 0).all(), i  # every stream emits
            tsrv.lockstep_step(params, cp, tstate, temps, tsvc.statics, False,
                               forced=torch.from_numpy(frame.astype(np.int64)))
            for j in range(8):
                assert rel_rms(tstate["logits"][j], jstate["logits"][j]) <= 1e-4, (i, j)
    finally:
        jsvc.close()
        tsvc.close()


def collect(req):
    chunks = list(req.chunks())
    assert sum(c.is_final for c in chunks) == 1 and chunks[-1].is_final
    parts = [c.samples for c in chunks if len(c.samples)]
    ranges = [c.token_range for c in chunks if c.token_range[1] > c.token_range[0]]
    return np.concatenate(parts) if parts else np.zeros(0, np.float32), ranges


def serve(svc, reqs, port: bool):
    """Submit every (text, speaker, kwargs) at temperature 0 (the port's in
    one list, so they reach its worker together), then collect each."""
    kw = dict(temperature=0.0, max_tokens=FRAMES)
    if port:
        held: list = []
        for i, (text, spk, extra) in enumerate(reqs):
            svc.submit(text, spk, seed=i, _hold=held, **kw, **extra)
        svc._enqueue(held)
    else:
        held = [svc.submit(text, spk, seed=i, **kw, **extra)
                for i, (text, spk, extra) in enumerate(reqs)]
    return [collect(r) for r in held]


def test_mixed_burst_and_long_reference_served_like_jax(pipes):
    jpl, tpl = pipes.jpl, pipes.tpl
    bucket = long_bucket(pipes)
    spf = tpl._samples_per_frame
    long_req = [(LONG_TEXT, "", pipes.long_kw), pipes.burst[7]]
    for mod, pl, port in ((jservice, jpl, False), (tservice, tpl, True)):
        svc = mod.TTSService(pl, batch_size=8)
        try:
            if port:
                svc.warmup(max_tokens=6)  # the CPU captures nothing; every path runs once
            out = serve(svc, pipes.burst, port)
            with pytest.raises(ValueError) as refused:
                svc.submit(LONG_TEXT, **pipes.long_kw)
        finally:
            svc.close()
        wide = mod.TTSService(pl, batch_size=2, prompt_bucket=bucket)
        try:
            assert wide.statics.capacity == bucket + jgen.RING_SLACK
            out += serve(wide, long_req, port)
        finally:
            wide.close()
        if port:
            got, got_msg = out, str(refused.value)
        else:
            ref, ref_msg = out, str(refused.value)
    assert got_msg == ref_msg and "exceeds service buckets" in got_msg, (got_msg, ref_msg)
    for i, ((audio, ranges), (jaudio, jranges)) in enumerate(zip(got, ref)):
        assert ranges == jranges, i
        assert len(audio) == len(jaudio) > 0 and len(audio) % spf == 0, i
        assert np.isfinite(audio).all(), i
        assert rel_rms(audio, jaudio) <= 1e-4, i


def post(port: int, path: str, body: dict) -> tuple[int, bytes, str]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    out = (r.status, r.read(), r.getheader("Content-Type"))
    conn.close()
    return out


def test_http_mode_routes_through_the_service_match_jax(pipes):
    """The mode fields over HTTP, each request on its own thread at once,
    through the real services (B = 8, as the burst's: the JAX service reuses
    its compiled steps): statuses, error bodies and audio
    lengths equal JAX's."""
    ref_b64 = base64.b64encode(wav_data(pipes.ref, 24000)).decode()
    long_b64 = base64.b64encode(wav_data(pipes.long_ref, 24000)).decode()
    bad_rate = base64.b64encode(wav_data(pipes.ref, 16000)).decode()
    gen = {"temperature": 0.0, "max_tokens": 8, "seed": 5}
    text = "The mode routes over HTTP."
    reqs = {
        "design": ("/tts", {"text": text, "instruct": "Calm and low.", **gen}),
        "design_stream": ("/tts?stream=1", {"text": text, "instruct": "A cheerful host.", **gen}),
        "custom": ("/tts", {"text": text, "speaker": "aiden", "instruct": "Slowly.", **gen}),
        "clone": ("/tts", {"text": text, "reference_audio_b64": ref_b64, **gen}),
        "icl": ("/tts", {"text": text, "reference_audio_b64": ref_b64,
                         "reference_transcript": TRANSCRIPT, **gen}),
        "openai": ("/v1/audio/speech", {"input": text, "voice": "aiden",
                                        "instructions": "Read it like the news.",
                                        "response_format": "pcm", **gen}),
        "long_icl": ("/tts", {"text": LONG_TEXT, "reference_audio_b64": long_b64,
                              "reference_transcript": TRANSCRIPT, **gen}),
        "both": ("/tts", {"text": text, "instruct": "Calm.", "reference_audio_b64": ref_b64}),
        "orphan": ("/tts", {"text": text, "reference_transcript": TRANSCRIPT}),
        "empty_instruct": ("/tts", {"text": text, "instruct": "  "}),
        "bad_b64": ("/tts", {"text": text, "reference_audio_b64": "not base64!"}),
        "rate": ("/tts", {"text": text, "reference_audio_b64": bad_rate}),
        "empty_transcript": ("/tts", {"text": text, "reference_audio_b64": ref_b64,
                                      "reference_transcript": ""}),
    }
    got = {}
    for mod, pl in ((jserver, pipes.jpl), (tserver, pipes.tpl)):
        httpd = mod.serve(pl, port=0, batch_size=8)
        out: dict = {}
        try:
            port = httpd.server_address[1]

            def go(name, path, body):
                out[name] = post(port, path, body)

            threads = [threading.Thread(target=go, args=(n, p, b)) for n, (p, b) in reqs.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            stats = httpd.tts_service.stats()
        finally:
            httpd.shutdown()
        got[mod is tserver] = out, stats
    (ref, jstats), (out, tstats) = got[False], got[True]
    spf = pipes.tpl._samples_per_frame
    for name in reqs:
        status, body, ctype = out[name]
        jstatus, jbody, jctype = ref[name]
        assert (status, ctype) == (jstatus, jctype), (name, status, body[:200], jbody[:200])
        if status != 200:
            assert status == 400 and json.loads(body) == json.loads(jbody), name
            continue
        if ctype == "audio/pcm":
            n, jn = len(body) // 2, len(jbody) // 2
        elif name == "design_stream":  # chunked: the streaming header, then PCM
            n, jn = (len(body) - 44) // 2, (len(jbody) - 44) // 2
        else:
            samples, rate, _ = parse_wav(body)
            n, jn = len(samples), len(parse_wav(jbody)[0])
            assert rate == 24000 and np.isfinite(samples).all(), name
        assert n == jn and n > 0 and n % spf == 0, (name, n, jn)
    assert sorted(n for n, r in out.items() if r[0] == 400) == [
        "bad_b64", "both", "empty_instruct", "empty_transcript", "orphan", "rate"]
    # the service took the six mode requests; the long reference went past it
    for s in (jstats, tstats):
        assert s["requests_submitted"] == s["requests_completed"] == 6, s
