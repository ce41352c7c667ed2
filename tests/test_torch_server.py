"""The port's HTTP server (qwen3_tts_tpu_torch/server.py) against the JAX
package's, on the CPU. A table of requests goes to both packages'
make_handler over one duck-typed fake pipeline (no model params: the lock
path) and over a fake service: every response must be the same bytes
(status line, headers but the Date line, body; chunked framing included)
for /health, /v1/models, /stats, /tts (one-shot, streamed, voice modes),
/v1/audio/speech (wav, pcm, streamed), /tts_many, and the 400, 404, 413,
500, 503 and OpenAI-envelope errors, before and after the first audio.
Then one real round trip on a tiny port pipeline: /tts and /tts?stream=1
carry the audio of the port's TTSService for the same request."""

import base64
import json
import socket
import threading
import zlib
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import server as jserver
from qwen3_tts_tpu import service as jservice
from qwen3_tts_tpu_torch import server as tserver
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch.io.wav import pcm16_bytes, streaming_wav_header, wav_data
from qwen3_tts_tpu_torch.pipeline import Qwen3TTSPipeline
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

torch.set_num_threads(1)


def _samples(text: str, kw: dict) -> np.ndarray:
    key = text + "|" + ",".join(sorted(kw))
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    return (rng.standard_normal(480 * (1 + len(text) % 3)) * 0.3).astype(np.float32)


class FakePipeline:
    """The surface make_handler reads, with audio made from the text. Text
    "bad" raises ValueError (400), "boom" RuntimeError (500), and a stream of
    "late boom" fails after its first chunk."""

    sample_rate = 24000
    available_speakers = ["fake", "other"]
    model_path = "/models/fake-tts-model/"

    def generate(self, text, speaker="", **kw):
        if text in ("bad", "boom"):
            raise (ValueError if text == "bad" else RuntimeError)(f"cannot say {text!r}")
        return _samples(text + speaker, kw)

    def generate_stream(self, text, speaker="", **kw):
        audio = self.generate(text.replace("late ", ""), speaker, **kw)
        for i in range(0, len(audio), 480):
            yield SimpleNamespace(samples=audio[i:i + 480], token_range=(i, i + 480),
                                  is_final=False)
            if text == "late boom":
                raise RuntimeError("failed mid-stream")
        yield SimpleNamespace(samples=np.zeros(0, np.float32), token_range=(0, 0),
                              is_final=True)

    def generate_many_stream(self, texts, speakers, batch_size=8, **kw):
        for i, text in enumerate(texts):
            yield i, SimpleNamespace(samples=_samples(text + f"{speakers}{batch_size}", kw),
                                     is_final=True)

    def extract_speaker_embedding(self, samples):
        return np.full(8, float(np.mean(samples)), np.float32)

    def encode_reference_audio(self, samples):
        return [list(range(3))]


class FakeService:
    """A service stand-in: busy or not, its submit's handle serves the fake
    pipeline's audio, or raises the package's ServiceBusy."""

    def __init__(self, busy_exc, busy: bool = False, raise_busy: bool = False):
        self.busy_exc, self.busy, self.raise_busy = busy_exc, busy, raise_busy

    def stats(self):
        return {"requests_submitted": 3, "batch_size": 8, "closed": False}

    def try_reject_busy(self):
        return self.busy

    def submit(self, text, speaker="", **kw):
        if self.raise_busy:
            raise self.busy_exc("waiting queue is full (0); retry later")
        chunks = list(FakePipeline().generate_stream(text, speaker, **kw))
        return SimpleNamespace(chunks=lambda: iter(chunks),
                               audio=lambda: np.concatenate([c.samples for c in chunks]))


def start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def raw(port: int, method: str, path: str, body: bytes = b"", headers: str = "") -> bytes:
    """The whole response of one request (Connection: close), Date line out."""
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n{headers}"
    if method == "POST" and "Content-Length" not in headers:
        head += f"Content-Length: {len(body)}\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(head.encode() + b"\r\n" + body)
        out = b""
        while True:
            try:
                data = s.recv(65536)
            except ConnectionResetError:
                break
            if not data:
                break
            out += data
    return b"\r\n".join(ln for ln in out.split(b"\r\n") if not ln.startswith(b"Date: "))


def _wav_b64() -> str:
    tone = (np.sin(np.arange(2400) * 0.05) * 0.5).astype(np.float32)
    return base64.b64encode(wav_data(tone, 24000)).decode()


def post(path, obj) -> tuple:
    return ("POST", path, obj if isinstance(obj, bytes) else json.dumps(obj).encode(), "")


LOCK_TABLE = [
    ("GET", "/health", b"", ""),
    ("GET", "/v1/models", b"", ""),
    ("GET", "/stats", b"", ""),
    ("GET", "/nope", b"", ""),
    post("/nope", {}),
    post("/tts", {"text": "Hello there.", "speaker": "fake", "max_tokens": 8, "seed": 1}),
    post("/tts?stream=1", {"text": "Streamed hello.", "speaker": "fake", "temperature": 0.5}),
    post("/tts", {"text": "Streamed by body.", "stream": True}),
    post("/tts", {"text": "Designed voice.", "instruct": "A calm voice."}),
    post("/tts", {"text": "Cloned voice.", "reference_audio_b64": _wav_b64()}),
    post("/tts", {"text": "ICL voice.", "reference_audio_b64": _wav_b64(),
                  "reference_transcript": "The reference words."}),
    post("/v1/audio/speech", {"model": "x", "input": "OpenAI drop-in.", "voice": "fake"}),
    post("/v1/audio/speech", {"input": "Raw PCM.", "voice": "fake", "response_format": "pcm"}),
    post("/v1/audio/speech", {"input": "Streamed PCM.", "voice": "other",
                              "response_format": "pcm", "stream_format": "audio",
                              "instructions": "Slowly.", "seed": 4}),
    post("/tts_many", {"texts": ["One.", "Two texts."], "speaker": "fake", "batch_size": 2,
                       "max_tokens": 6}),
    # errors
    post("/tts", {"text": "   "}),
    post("/tts", {"text": "hi there", "max_tokens": -1}),
    post("/tts", b"[]"),
    post("/tts", b"{not json"),
    post("/tts", {"text": "bad"}),
    post("/tts", {"text": "boom"}),
    post("/tts?stream=1", {"text": "bad"}),
    post("/tts?stream=1", {"text": "boom"}),
    post("/tts?stream=1", {"text": "late boom"}),
    post("/tts", {"text": "x", "reference_transcript": "no audio"}),
    post("/tts", {"text": "x", "reference_audio_b64": "%%%"}),
    post("/tts", {"text": "x", "reference_audio_b64": _wav_b64(), "instruct": "both"}),
    post("/tts_many", {"texts": []}),
    post("/v1/audio/speech", {"voice": "fake"}),
    post("/v1/audio/speech", {"input": "x", "speed": 1.5}),
    post("/v1/audio/speech", {"input": "x", "response_format": "mp3"}),
    post("/v1/audio/speech", {"input": "x", "stream_format": "sse"}),
    post("/v1/audio/speech", {"input": "boom"}),
    ("POST", "/tts", b"", "Content-Length: -1\r\n"),
    ("POST", "/tts", b"", f"Content-Length: {9 << 20}\r\n"),
]
SERVICE_TABLE = [
    ("GET", "/stats", b"", ""),
    post("/tts", {"text": "Through the service.", "speaker": "fake"}),
    post("/tts?stream=1", {"text": "Streamed through the service."}),
    post("/v1/audio/speech", {"input": "Service PCM.", "response_format": "pcm"}),
]


@pytest.mark.parametrize("case", ["lock", "service", "busy"])
def test_responses_equal_jax_servers_bytes(case):
    """The same bytes from both packages' handlers: the lock path's table;
    the service path's (stats, one-shot, streamed, pcm); and a busy service
    (503 + Retry-After from the advisory check and from submit's
    ServiceBusy)."""
    table = LOCK_TABLE
    if case == "lock":
        services = (None, None)
    elif case == "service":
        services = (FakeService(jservice.ServiceBusy), FakeService(tservice.ServiceBusy))
        table = SERVICE_TABLE
    else:
        services = [(FakeService(jservice.ServiceBusy, busy=True),
                     FakeService(tservice.ServiceBusy, busy=True)),
                    (FakeService(jservice.ServiceBusy, raise_busy=True),
                     FakeService(tservice.ServiceBusy, raise_busy=True))]
        table = [post("/tts", {"text": "Too busy."}),
                 post("/v1/audio/speech", {"input": "Too busy."})]
    pairs = services if case == "busy" else [services]
    for jsvc, tsvc in pairs:
        js = start(jserver.make_handler(FakePipeline(), jsvc))
        ts = start(tserver.make_handler(FakePipeline(), tsvc))
        try:
            for method, path, body, headers in table:
                want = raw(js.server_address[1], method, path, body, headers)
                got = raw(ts.server_address[1], method, path, body, headers)
                assert got == want, (case, method, path, body[:80], got[:300], want[:300])
                assert want.startswith(b"HTTP/1.")
        finally:
            js.shutdown()
            ts.shutdown()


@pytest.fixture(scope="module")
def tiny_pipeline(tmp_path_factory):
    d = tmp_path_factory.mktemp("server_dir") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)


def test_round_trip_carries_the_service_audio(tiny_pipeline):
    """serve() on the tiny port pipeline: /tts gives wav_data of what a
    TTSService of the same settings gives for the same request (both a
    first request into an idle batch: the same computation), and
    /tts?stream=1 the streaming header and the same PCM in chunks; /health
    and /stats answer; shutdown() stops the service."""
    pl = tiny_pipeline
    kw = dict(batch_size=2, trailing_bucket=128)
    req = {"text": "Hello there, this is a test.", "speaker": "aiden", "temperature": 0.0,
           "max_tokens": 8, "seed": 1}
    ref = tservice.TTSService(pl, **kw)
    try:
        audio = ref.submit(req["text"], "aiden", temperature=0.0, max_tokens=8, seed=1).audio()
    finally:
        ref.close()
    assert len(audio) > 0
    httpd = tserver.serve(pl, port=0, **kw)
    port = httpd.server_address[1]
    try:
        body = json.dumps(req).encode()
        one_shot = raw(port, "POST", "/tts", body)
        head, _, payload = one_shot.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200") and b"Content-Type: audio/wav" in head
        assert payload == wav_data(audio, pl.sample_rate)
        streamed = raw(port, "POST", "/tts?stream=1", body)
        head, _, chunked = streamed.partition(b"\r\n\r\n")
        assert b"Transfer-Encoding: chunked" in head
        data, rest = b"", chunked
        while True:  # undo the chunked framing
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            data, rest = data + rest[:n], rest[n + 2:]
        assert data == streaming_wav_header(pl.sample_rate) + pcm16_bytes(audio)
        health = json.loads(raw(port, "GET", "/health").partition(b"\r\n\r\n")[2])
        assert health == {"status": "ok", "speakers": pl.available_speakers}
        stats = json.loads(raw(port, "GET", "/stats").partition(b"\r\n\r\n")[2])
        assert stats["mode"] == "service" and stats["requests_completed"] == 2
        assert stats["batch_size"] == 2 and stats["worker_restarts"] == 0
    finally:
        httpd.shutdown()
    assert httpd.tts_service.stats()["closed"]
