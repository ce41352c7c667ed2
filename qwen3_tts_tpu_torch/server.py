"""HTTP TTS server on the port's Qwen3TTSPipeline (counterpart of
qwen3_tts_tpu/server.py; stdlib http.server only).

With a real pipeline, `serve()` starts one always-on TTSService worker
(service.py) that owns a single lockstep continuous batch: `/tts` requests
from separate connections are admitted into free batch slots mid-flight,
and each response streams its own audio while the others keep decoding. An
object without model params (a test fake) takes the one-at-a-time lock
path instead. Run one server process per card.

Endpoints:
  GET  /health            -> {"status": "ok", "speakers": [...]}
  GET  /stats             -> the service's counters and gauges (requests
        submitted / completed / failed / cancelled, audio chunks, frames
        decoded, active slots, backlog, uptime, worker restarts, batch
        configuration)
  POST /tts               -> audio/wav (one-shot, through the shared batch)
        body JSON: {"text": str, "speaker": str (optional),
                    "temperature": float, "max_tokens": int, "seed": int,
                    "instruct": str (VoiceDesign without a speaker,
                                     CustomVoice with one),
                    "reference_audio_b64": str (base64 16-bit 24 kHz WAV;
                        with "reference_transcript": ICL cloning, alone:
                        speaker-embedding cloning),
                    "reference_transcript": str}   (all but text optional)
  POST /tts?stream=1      -> chunked audio/wav: a streaming WAV header, then
        16-bit PCM as each chunk leaves the vocoder (also {"stream": true})
  POST /tts_many          -> {"wavs": [base64 WAV, ...], "sample_rate": N}
        body JSON: {"texts": [str, ...], "speaker": str | "speakers": [str],
                    "temperature" / "max_tokens" / "seed" as above,
                    "batch_size": int (default 8)}: one generate_many_stream
        call for bulk jobs (clients should rather POST /tts concurrently)
  POST /v1/audio/speech   -> OpenAI-compatible `audio.speech`: {"input",
        "voice", "instructions" (optional), "response_format": "wav" | "pcm",
        "stream_format": "audio" (optional, chunked)}; "model" is ignored,
        "speed" other than 1.0 and compressed formats are rejected; the
        extensions temperature / max_tokens / seed pass through. Errors on
        /v1 paths use the OpenAI envelope {"error": {"message", "type"}}.
  GET  /v1/models         -> OpenAI-compatible model listing.

Run: python -m qwen3_tts_tpu_torch.server <model-dir> [port]  (the device is
the pipeline's: QWEN3TTS_DEVICE, default cuda)
"""

from __future__ import annotations

import base64
import json
import os
import queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .io.wav import parse_wav, pcm16_bytes, streaming_wav_header, wav_data
from .pipeline import Qwen3TTSError, Qwen3TTSPipeline

# 8 MiB: bounds memory per request while leaving room for ~2 min of base64
# reference audio (24 kHz 16-bit WAV is ~48 KB/s raw, ~64 KB/s base64)
MAX_BODY_BYTES = 8 << 20


def _gen_kwargs(req: dict) -> dict:
    kwargs = {}
    if "temperature" in req:
        kwargs["temperature"] = float(req["temperature"])
    if "max_tokens" in req:
        kwargs["max_tokens"] = int(req["max_tokens"])
        if kwargs["max_tokens"] < 0:
            # a negative budget would slice frames as valid[:negative] and
            # EMIT audio downstream — reject at the edge (ValueError -> 400)
            raise ValueError("max_tokens must be >= 0")
    if "seed" in req:
        kwargs["seed"] = int(req["seed"])
    return kwargs


def _prompt_kwargs(req: dict, pipeline) -> dict:
    """Voice-mode parameters, completing the reference's generation-mode
    surface over HTTP: `instruct` selects VoiceDesign (no speaker) or
    CustomVoice (with speaker) (reference Qwen3TTSPipeline.swift:355-480);
    `reference_audio_b64` (base64 16-bit 24 kHz WAV) with a
    `reference_transcript` is encoded to codec codes for ICL cloning
    (swift:924-945), without one it becomes a 1024-d speaker x-vector
    (swift:906-918). ValueError -> 400 at the edge."""
    kwargs: dict = {}
    instruct = req.get("instruct")
    if instruct is not None:
        if not isinstance(instruct, str) or not instruct.strip():
            raise ValueError("'instruct' must be a non-empty string")
        kwargs["instruct"] = instruct
    ref_b64 = req.get("reference_audio_b64")
    transcript = req.get("reference_transcript")
    if ref_b64 is None:
        if transcript is not None:
            raise ValueError(
                "'reference_transcript' requires 'reference_audio_b64'"
            )
        return kwargs
    if instruct is not None:
        # the prompt layout has exactly one instruct/ICL section
        # (Qwen3Talker.swift:388-414) — accepting both and silently
        # dropping the reference would return un-cloned audio with a 200
        raise ValueError(
            "'instruct' cannot be combined with 'reference_audio_b64'; "
            "pick VoiceDesign/CustomVoice or voice cloning"
        )
    if not isinstance(ref_b64, str):
        raise ValueError("'reference_audio_b64' must be a base64 string")
    try:
        wav_bytes = base64.b64decode(ref_b64, validate=True)
    except Exception:
        raise ValueError("'reference_audio_b64' is not valid base64") from None
    try:
        samples, rate, channels = parse_wav(wav_bytes)
    except ValueError as e:
        raise ValueError(f"reference audio: {e}") from None
    if not len(samples):
        raise ValueError("reference audio is empty")
    if channels > 1:
        # exact downmix beats rejecting every stereo recording; trim a
        # truncated tail frame rather than failing the reshape
        samples = samples[: len(samples) // channels * channels]
        samples = samples.reshape(-1, channels).mean(axis=1)
    if rate != pipeline.sample_rate:
        raise ValueError(
            f"reference audio must be {pipeline.sample_rate} Hz (got "
            f"{rate}); resample it client-side"
        )
    if transcript is not None:
        if not isinstance(transcript, str) or not transcript.strip():
            raise ValueError(
                "'reference_transcript' must be a non-empty string"
            )
        codes = pipeline.encode_reference_audio(samples)
        if codes is None:
            raise ValueError(
                "this checkpoint has no audio encoder; ICL cloning "
                "is unavailable"
            )
        kwargs["reference_transcript"] = transcript
        kwargs["reference_audio_codes"] = codes
    else:
        emb = pipeline.extract_speaker_embedding(samples)
        if emb is None:
            raise ValueError(
                "this checkpoint has no speaker encoder; voice cloning "
                "is unavailable"
            )
        kwargs["speaker_embedding"] = emb
    return kwargs


def make_handler(pipeline: Qwen3TTSPipeline, service=None):
    """HTTP handler class. With a TTSService, /tts requests (streaming and
    one-shot) are admitted into its shared continuous batch; without one,
    they serialize through the legacy global lock."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer needs HTTP/1.1; every non-chunked response sets
        # Content-Length so keep-alive stays correct
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _send_busy(self) -> None:
            body = json.dumps(
                {"error": "service is at capacity; retry later"}
            ).encode()
            self.send_response(503)
            self.send_header("Retry-After", "1")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _write_chunk(self, data: bytes) -> None:
            if data:
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

        def do_GET(self):  # noqa: N802 (http.server API)
            path = urlparse(self.path).path
            if path == "/health":
                self._send_json(
                    200,
                    {"status": "ok", "speakers": pipeline.available_speakers},
                )
            elif path == "/v1/models":
                # OpenAI-compatible listing: one model per server process
                mid = (
                    os.path.basename(
                        os.path.normpath(getattr(pipeline, "model_path", ""))
                    )
                    or "qwen3-tts"
                )
                self._send_json(200, {
                    "object": "list",
                    "data": [{"id": mid, "object": "model", "created": 0,
                              "owned_by": "qwen3-tts-tpu"}],
                })
            elif path == "/stats":
                # service observability (counters + gauges); without a
                # continuous-batching service only the serving mode is known
                body = (
                    {"mode": "service", **service.stats()}
                    if service is not None
                    else {"mode": "serialized"}
                )
                self._send_json(200, body)
            else:
                self._send_json(404, {"error": "unknown path"})

        def _read_body(self) -> dict | None:
            n = int(self.headers.get("Content-Length", "0"))
            if n > MAX_BODY_BYTES:
                self._send_json(413, {"error": "body too large"})
                return None
            if n < 0:
                # rfile.read(-1) would read until EOF: unbounded memory and
                # a pinned thread at the client's pleasure
                self._send_json(400, {"error": "invalid Content-Length"})
                return None
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                # '[]' / '"hi"' are valid JSON but malformed requests — a
                # 400, not an AttributeError-turned-500
                self._send_json(400, {"error": "body must be a JSON object"})
                return None
            return req

        def _audio_body(self, samples, fmt: str) -> tuple[bytes, str]:
            """One-shot audio bytes + content type for a response format."""
            if fmt == "pcm":
                return pcm16_bytes(np.asarray(samples)), "audio/pcm"
            return wav_data(np.asarray(samples), pipeline.sample_rate), "audio/wav"

        def _tts_service(self, text: str, speaker: str, kwargs: dict,
                         stream: bool, fmt: str = "wav") -> None:
            """Serve one request through the shared continuous batch: submit
            returns immediately; the worker decodes this utterance in
            lockstep with every other in-flight request."""
            handle = service.submit(text, speaker, **kwargs)
            if not stream:
                samples = handle.audio()  # raises on failure -> do_POST maps
                self._send(200, *self._audio_body(samples, fmt))
                return
            it = handle.chunks()
            first = next(it)  # raises pre-audio failures -> clean JSON error
            self.send_response(200)
            self.send_header(
                "Content-Type", "audio/pcm" if fmt == "pcm" else "audio/wav"
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                if fmt != "pcm":
                    self._write_chunk(
                        streaming_wav_header(pipeline.sample_rate)
                    )
                chunk = first
                while True:
                    if len(chunk.samples):
                        self._write_chunk(pcm16_bytes(chunk.samples))
                    if chunk.is_final:
                        break
                    chunk = next(it)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                handle.cancel()  # free the batch slot; stop decoding
                self.close_connection = True
            except Exception:
                # mid-stream service failure: legally terminate the chunked
                # body early (truncated audio) — never a second status line
                handle.cancel()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    pass
                self.close_connection = True

        def _tts(self, req: dict, stream: bool, fmt: str = "wav") -> None:
            text = req.get("text", "")
            if not isinstance(text, str) or not text.strip():
                self._send_json(400, {"error": "missing 'text'"})
                return
            if service is not None and service.try_reject_busy():
                # saturated: 503 BEFORE base64 decode + reference-audio
                # encoding — a rejected cloning request must not add
                # encoder work to an already-overloaded chip (submit's
                # atomic reserve below stays authoritative)
                self._send_busy()
                return
            kwargs = _gen_kwargs(req)
            kwargs.update(_prompt_kwargs(req, pipeline))
            speaker = req.get("speaker", "")
            if service is not None:
                from .service import ServiceBusy, ServiceClosed

                try:
                    self._tts_service(text, speaker, kwargs, stream, fmt)
                    return
                except ServiceBusy:
                    # backpressure, not failure: tell the client to retry
                    # instead of queueing without bound or absorbing the
                    # request into the serialized lock path (which would
                    # defeat the limit)
                    self._send_busy()
                    return
                except ServiceClosed:
                    # the worker exhausted its restarts (or a shutdown raced
                    # this submit): the continuous batch is gone for good,
                    # but the legacy one-at-a-time lock path still works —
                    # degrade to it instead of 500ing every future request
                    if not getattr(Handler, "_svc_degraded", False):
                        Handler._svc_degraded = True
                        print(
                            "tts service unavailable; degrading to the "
                            "serialized lock path",
                            file=sys.stderr, flush=True,
                        )
                except ValueError as e:
                    if "exceeds service buckets" not in str(e):
                        raise
                    # prompt too long for the shared batch's fixed buckets:
                    # fall through to the single-stream path (dynamic
                    # buckets) rather than rejecting the request
            if not stream:
                with lock:
                    samples = pipeline.generate(text, speaker, **kwargs)
                self._send(200, *self._audio_body(samples, fmt))
                return
            # Chunked streaming, decoupled from client pace: a producer
            # thread generates under the (global) lock into an unbounded
            # queue while THIS thread writes to the socket outside the lock
            # — a slow-reading client must not stall every other request
            # (PCM is ~48 KB/s of buffered audio worst case). The 200 is
            # committed only after the first queue item, so a failure before
            # any audio (bad speaker, prefill OOM) still gets a clean JSON
            # error; a failure after that legally terminates the chunked
            # body (truncated audio) instead of writing a second status
            # line into it.
            q: queue.Queue = queue.Queue()
            stop = threading.Event()

            def produce() -> None:
                try:
                    with lock:
                        for chunk in pipeline.generate_stream(
                            text, speaker, **kwargs
                        ):
                            if stop.is_set():
                                break
                            if len(chunk.samples):
                                q.put(pcm16_bytes(chunk.samples))
                    q.put(None)
                except Exception as e:  # classified by the consumer
                    q.put(e)

            threading.Thread(target=produce, daemon=True).start()
            first = q.get()
            if isinstance(first, Exception):
                raise first  # do_POST maps it to a 400/500 JSON response
            self.send_response(200)
            self.send_header(
                "Content-Type", "audio/pcm" if fmt == "pcm" else "audio/wav"
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                if fmt != "pcm":
                    self._write_chunk(
                        streaming_wav_header(pipeline.sample_rate)
                    )
                item = first
                while item is not None:
                    if isinstance(item, Exception):
                        break  # truncate the stream; audio ends early
                    self._write_chunk(item)
                    item = q.get()
                self.wfile.write(b"0\r\n\r\n")
                if item is not None:
                    self.close_connection = True
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
            except Exception:
                # any other mid-stream failure: the 200 is committed, so a
                # second status line (do_POST's 500 JSON) would corrupt the
                # chunked framing — legally terminate the body instead
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    pass
                self.close_connection = True
            finally:
                stop.set()  # abort generation if the client went away

        def _openai_speech(self, req: dict) -> None:
            """OpenAI `audio.speech` drop-in: translate the request onto the
            internal /tts machinery (same continuous-batching service, same
            voice-mode plumbing). Unsupported knobs are rejected with a clear
            message rather than silently approximated: "speed" != 1.0 would
            need time-stretching, non-PCM "response_format"s an encoder, and
            "stream_format": "sse" a base64-JSON event framing this server
            does not produce."""
            text = req.get("input", "")
            if not isinstance(text, str) or not text.strip():
                raise ValueError("missing 'input'")
            fmt = req.get("response_format", "wav")
            if fmt not in ("wav", "pcm"):
                raise ValueError(
                    f"unsupported response_format {fmt!r}; this server "
                    "produces uncompressed audio only: 'wav' or 'pcm'"
                )
            speed = req.get("speed", 1.0)
            if not isinstance(speed, (int, float)) or float(speed) != 1.0:
                raise ValueError("'speed' is not supported (only 1.0)")
            stream_format = req.get("stream_format")
            if stream_format not in (None, "audio"):
                raise ValueError(
                    f"unsupported stream_format {stream_format!r}; use "
                    "'audio' for chunked audio streaming"
                )
            voice = req.get("voice", "")
            if not isinstance(voice, str):
                raise ValueError("'voice' must be a string")
            inner = {"text": text, "speaker": voice}
            instructions = req.get("instructions")
            if instructions is not None:
                inner["instruct"] = instructions
            for k in ("temperature", "max_tokens", "seed"):  # extensions
                if k in req:
                    inner[k] = req[k]
            self._tts(inner, stream=stream_format == "audio", fmt=fmt)

        def _tts_many(self, req: dict) -> None:
            texts = req.get("texts")
            if (
                not isinstance(texts, list)
                or not texts
                or not all(isinstance(t, str) and t.strip() for t in texts)
            ):
                self._send_json(400, {"error": "missing 'texts'"})
                return
            speakers = req.get("speakers", req.get("speaker", ""))
            kwargs = _gen_kwargs(req)
            batch_size = int(req.get("batch_size", 8))
            buckets: list[list[np.ndarray]] = [[] for _ in texts]
            with lock:
                for idx, chunk in pipeline.generate_many_stream(
                    texts, speakers, batch_size=batch_size, **kwargs
                ):
                    if len(chunk.samples):
                        buckets[idx].append(chunk.samples)
            wavs = []
            for parts in buckets:
                samples = (
                    np.concatenate(parts) if parts else np.zeros(0, np.float32)
                )
                wavs.append(
                    base64.b64encode(
                        wav_data(samples, pipeline.sample_rate)
                    ).decode()
                )
            self._send_json(
                200, {"wavs": wavs, "sample_rate": pipeline.sample_rate}
            )

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            try:
                req = self._read_body()
                if req is None:
                    return
                if url.path == "/tts":
                    q = parse_qs(url.query)
                    stream = bool(req.get("stream")) or (
                        q.get("stream", ["0"])[0].lower()
                        in ("1", "true", "yes")
                    )
                    self._tts(req, stream)
                elif url.path == "/tts_many":
                    self._tts_many(req)
                elif url.path == "/v1/audio/speech":
                    self._openai_speech(req)
                else:
                    self._send_json(404, {"error": "unknown path"})
            except (Qwen3TTSError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send_error(400, f"{type(e).__name__}: {e}",
                                 "invalid_request_error")
            except BrokenPipeError:
                pass  # client hung up mid-stream
            except Exception as e:  # CUDA RuntimeError / OOM: answer, don't drop
                try:
                    self._send_error(500, f"{type(e).__name__}: {e}",
                                     "server_error")
                except Exception:
                    pass  # headers already sent on a streaming response

        def _send_error(self, code: int, message: str, etype: str) -> None:
            """Error JSON; /v1 paths use the OpenAI envelope so official
            SDK clients surface `error.message` instead of a parse failure."""
            if urlparse(self.path).path.startswith("/v1/"):
                self._send_json(
                    code, {"error": {"message": message, "type": etype}}
                )
            else:
                self._send_json(code, {"error": message})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def _maybe_service(pipeline, batch_size: int, **service_kwargs):
    """A TTSService when the pipeline carries raw model params (any real
    Qwen3TTSPipeline); None for objects without them (test fakes), which
    keeps the legacy lock path."""
    needed = (
        "params", "cp_params", "config", "tokenizer", "vocoder_params",
        # TTSService also reads these (submit() defaults, _serve_once's
        # decoder config) — a duck-typed object missing them must take the
        # legacy path, not crash the worker through its restart budget
        "speech_config", "pipeline_config",
    )
    if not all(hasattr(pipeline, a) for a in needed):
        return None
    from .service import TTSService

    return TTSService(pipeline, batch_size=batch_size, **service_kwargs)


def serve(pipeline: Qwen3TTSPipeline, port: int = 8080,
          host: str = "127.0.0.1", *, batch_size: int = 8,
          warmup: bool = False, **service_kwargs) -> ThreadingHTTPServer:
    """Start serving in a background thread; returns the server (call
    .shutdown() to stop — it also stops the continuous-batching worker).
    Binds localhost by default — front it with a real ingress for anything
    public. warmup=True blocks until every serving path has run once and
    every lockstep graph the service can reach is captured
    (TTSService.warmup), so no request waits for a capture or a kernel
    build."""
    service = _maybe_service(pipeline, batch_size, **service_kwargs)
    if warmup and service is not None:
        service.warmup()
    if warmup:
        # the cloning encoders run outside the service (on the handler
        # thread, _prompt_kwargs): run them once too
        tone = np.zeros(24000, np.float32)
        if getattr(pipeline, "speaker_encoder", None) is not None:
            pipeline.extract_speaker_embedding(tone)
        if getattr(pipeline, "audio_encoder", None) is not None:
            pipeline.encode_reference_audio(tone)
    httpd = ThreadingHTTPServer((host, port), make_handler(pipeline, service))
    httpd.tts_service = service
    _shutdown = httpd.shutdown

    def shutdown():
        _shutdown()
        if service is not None:
            service.close()

    httpd.shutdown = shutdown
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Qwen3-TTS HTTP server (continuous-batching service)"
    )
    ap.add_argument("model_dir")
    ap.add_argument("port", nargs="?", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default localhost; front anything "
                         "public with a real ingress)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="lockstep serving batch slots")
    ap.add_argument("--prompt-bucket", type=int, default=None,
                    help="fixed prompt bucket (longer prompts fall back to "
                         "the serialized path)")
    ap.add_argument("--trailing-bucket", type=int, default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="run every serving path and capture every lockstep "
                         "graph before accepting traffic")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="waiting-queue bound; beyond it /tts answers 503 + "
                         "Retry-After instead of queueing without bound")
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="decode chunk cadence in frames (default 6); "
                         "smaller = lower per-request TTFA, more vocoder "
                         "dispatches")
    ap.add_argument("--first-decode-chunk", type=int, default=None,
                    help="ship each stream's first audio after this many "
                         "frames instead of a full 18-frame window (pair "
                         "with --chunk-steps <= this for effect)")
    args = ap.parse_args()

    pipeline = Qwen3TTSPipeline(args.model_dir)
    kw = {}
    if args.prompt_bucket is not None:
        kw["prompt_bucket"] = args.prompt_bucket
    if args.trailing_bucket is not None:
        kw["trailing_bucket"] = args.trailing_bucket
    if args.max_queue is not None:
        kw["max_queue"] = args.max_queue
    if args.chunk_steps is not None:
        kw["chunk_steps"] = args.chunk_steps
    if args.first_decode_chunk is not None:
        kw["first_decode_chunk"] = args.first_decode_chunk
    if args.warmup:
        print("warming up the serving paths ...", flush=True)
    # one wiring for embedded and CLI use: serve() owns the service
    # lifecycle, and its wrapped shutdown() also stops the batch worker
    httpd = serve(
        pipeline, port=args.port, host=args.host,
        batch_size=args.batch_size, warmup=args.warmup, **kw,
    )
    print(
        f"loaded {args.model_dir}; serving on http://{args.host}:{args.port}",
        flush=True,
    )
    try:
        threading.Event().wait()  # serve() runs in its own thread
    except KeyboardInterrupt:
        print("shutting down ...", flush=True)
        httpd.shutdown()


if __name__ == "__main__":
    main()
