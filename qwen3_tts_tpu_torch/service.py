"""Always-on continuous-batching TTS service for independently arriving
requests (counterpart of qwen3_tts_tpu/service.py).

One background worker owns one running lockstep batch
(models/serving.py). Requests submitted from any thread at any time are
assembled on the submitter's thread (the padded prompt, prompt.
assemble_prompt_padded), prefilled behind the decode chunk in flight, and
admitted into free slots mid-flight (serving.admit_stream); each request
streams its own audio chunks through its own queue while the others keep
decoding.

Per worker iteration (chunk `it` in flight):
  1. drain arrivals and place them into free slots: a burst into an idle
     batch is ONE full-B prefill (the batch's first state); one arrival into
     a running batch a B = 1 prefill, several a full-B prefill whose rows
     are admitted by `src`; admissions and parks are deferred to the next
     boundary
  2. when chunk `it`'s state is back: apply the deferred ops and queue chunk
     `it + 1` (depth-1 prefetch) before the host waits on anything
  3. wait for chunk `it`'s frames (pinned memory behind an event, so only
     that chunk is waited for), route them to their requests, and queue the
     vocoder on the ready rows of all streams in fixed [B, 16, left + chunk]
     calls
  4. a finished request (EOS, max_tokens, cancel) frees its slot; a non-EOS
     finish parks the row so an idle batch stops costing decode work

All audio and final pushes of slot-served requests go through one FIFO that
a puller thread drains: it waits for the PCM's copy and pushes the chunks, so
the copy overlaps the next decode chunk and each request's chunks stay in
order. A puller error fails the requests queued behind it and restarts the
worker.

Greedy, a request's audio does not depend on when it arrived or which slot
it took: hold a service's output against another service run.

On CUDA every lockstep step replays a CUDA graph; warmup() captures the
graph of every key the service can reach, so traffic never captures. An
unexpected worker crash fails the requests in flight (their streams raise
ServiceClosed) and the worker restarts with a fresh batch, up to
`max_worker_restarts` times (the budget resets after 600 s without a crash).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .models import generate as gen_mod
from .models import prompt as prompt_mod
from .models import serving as srv
from .pipeline import AudioChunk


class ServiceClosed(RuntimeError):
    """The service was shut down before or while serving this request."""


class ServiceBusy(RuntimeError):
    """Backpressure: the waiting queue is at max_queue; retry later (the
    HTTP layer answers 503 + Retry-After)."""


class _Stats:
    """Thread-safe counters and gauges (GET /stats). Counters only grow;
    gauges are the worker loop's last writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + by

    def add_get(self, name: str, by: int = 1) -> int:
        """Increment and read in one step: the admission reserve must be one
        operation, or concurrent submits all pass a stale check."""
        with self._lock:
            v = self._c.get(name, 0) + by
            self._c[name] = v
            return v

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._c[name] = int(value)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


@dataclass
class _SlotView:
    """Host-side bookkeeping of one batch slot."""

    req: "TTSRequest | None" = None
    active_from: int = 0


def _empty_final(t0: int = 0) -> AudioChunk:
    return AudioChunk(samples=np.zeros(0, np.float32), token_range=(t0, t0), is_final=True)


class TTSRequest:
    """Handle of one submitted utterance: a thread-safe stream of
    AudioChunks (exactly one has is_final=True; an Exception in the stream
    aborts it)."""

    def __init__(self, pd, temperature: float, max_tokens: int, seed: int, stats=None):
        self.pd = pd
        self.temperature = float(temperature)
        self.max_tokens = int(max_tokens)
        self.seed = int(seed)
        self._q: queue.Queue = queue.Queue()
        self._cancel = threading.Event()
        self._stats = stats
        self._done = False  # the first terminal push takes the stats count
        self._done_lock = threading.Lock()
        self.emitted = 0  # the worker's (one thread): frames taken so far

    def cancel(self) -> None:
        """Stop generating; the stream ends with an empty final chunk at the
        next chunk boundary."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def chunks(self):
        """Iterate the audio chunks as they are synthesized (blocking).
        Raises if the service failed this request."""
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item
            if item.is_final:
                return

    def audio(self) -> np.ndarray:
        """Block until completion; the whole waveform."""
        parts = [c.samples for c in self.chunks() if len(c.samples)]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def _first_terminal(self) -> bool:
        """Claim the one terminal stats count (close() can race the worker's
        shutdown drain, both failing the same request)."""
        with self._done_lock:
            if self._done:
                return False
            self._done = True
            return True

    def _push(self, item) -> None:
        if self._stats is not None:
            if isinstance(item, Exception):
                if self._first_terminal():
                    self._stats.inc("requests_cancelled" if self.cancelled
                                    else "requests_failed")
            else:
                if len(item.samples):
                    self._stats.inc("audio_chunks_emitted")
                if item.is_final and self._first_terminal():
                    self._stats.inc("requests_cancelled" if self.cancelled
                                    else "requests_completed")
        self._q.put(item)


class TTSService:
    """A running continuous-batching TTS worker on a loaded Qwen3TTSPipeline.
    Submit from any number of threads; close() to stop.

    batch_size, prompt_bucket, trailing_bucket and chunk_steps are fixed at
    construction (they key the lockstep graphs); a request whose prompt
    exceeds the buckets is rejected at submit(). max_queue bounds the
    requests waiting for a slot: -1 (default) is 4 batches, None unbounded;
    a full queue raises ServiceBusy."""

    def __init__(self, pipeline, *, batch_size: int = 8, chunk_steps: int = 6,
                 decode_chunk: int = 18, left_context: int = 8,
                 first_decode_chunk: int | None = None, prompt_bucket: int | None = None,
                 trailing_bucket: int | None = None, max_worker_restarts: int = 2,
                 max_queue: int | None = -1):
        if first_decode_chunk is None:
            # each stream's first audio after 6 frames (with chunk_steps 6)
            first_decode_chunk = min(6, decode_chunk)
        if max_queue == -1:
            # bounded by default: each waiting request holds bucket-padded
            # prompt tensors on the device
            max_queue = 4 * batch_size
        elif max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, -1 (4 x batch_size) or None "
                             f"(unbounded), got {max_queue}")
        if not 1 <= first_decode_chunk <= decode_chunk:
            # checked here: the packer is built on the worker thread, where a
            # bad value would kill the worker instead of raising to the caller
            raise ValueError(f"first_decode_chunk must be in [1, decode_chunk], got "
                             f"{first_decode_chunk}")
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.chunk_steps = chunk_steps
        self.decode_chunk = decode_chunk
        self.left_context = left_context
        self.first_decode_chunk = first_decode_chunk
        self.prompt_bucket = prompt_bucket or gen_mod.PROMPT_BUCKETS[2]
        self.trailing_bucket = trailing_bucket or gen_mod.TRAILING_BUCKETS[1]
        self.statics = gen_mod.GenStatics(
            config=pipeline.config, capacity=self.prompt_bucket + gen_mod.RING_SLACK,
            chunk_steps=chunk_steps, track_cp_penalty=False)
        # items are lists of requests: a list reaches the worker in one drain
        self._inbox: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._stats = _Stats()
        self._t0 = time.monotonic()
        self.max_queue = max_queue
        self._seq = itertools.count()
        self.max_worker_restarts = max_worker_restarts
        self.worker_restarts = 0
        self._worker = threading.Thread(target=self._run, name="tts-service", daemon=True)
        self._worker.start()

    # -- public API --------------------------------------------------------

    def submit(self, text: str, speaker: str = "", *, temperature: float | None = None,
               max_tokens: int | None = None, seed: int | None = None,
               _bypass_queue_bound: bool = False, _hold: list | None = None,
               **prompt_kwargs) -> TTSRequest:
        """Queue one utterance; returns at once with its chunk stream.
        prompt_kwargs go to the prompt assembly (instruct, speaker_embedding,
        reference_transcript, reference_audio_codes). Internal:
        _bypass_queue_bound lets warmup run under max_queue=0, and _hold
        collects the request for the caller to enqueue with others."""
        if self._stop.is_set():
            raise ServiceClosed("service is shut down")
        # The reserve is atomic and made before assembly, so a burst of
        # submits cannot all pass a stale count and a rejected request costs
        # no device work. Every exit that does not enqueue releases it (the
        # finally); the worker releases it for enqueued requests.
        waiting = self._stats.add_get("waiting")
        if not _bypass_queue_bound and self.max_queue is not None and waiting > self.max_queue:
            self._stats.inc("waiting", -1)
            self._stats.inc("requests_rejected_busy")
            raise ServiceBusy(f"waiting queue is full ({self.max_queue}); retry later")
        enqueued = False
        try:
            if max_tokens is not None and max_tokens < 0:
                raise ValueError("max_tokens must be >= 0")
            pl = self.pipeline
            pd = None
            if max_tokens != 0:
                pd = prompt_mod.assemble_prompt_padded(
                    pl.params, pl.config, pl.tokenizer, text, speaker=speaker,
                    prompt_bucket=self.prompt_bucket, trailing_bucket=self.trailing_bucket,
                    **prompt_kwargs)
            if pd is None:
                # max_tokens=0, or text too short to prompt: an empty stream,
                # served without a slot
                req = TTSRequest(None, temperature=0.0, max_tokens=0, seed=0, stats=self._stats)
                self._stats.inc("requests_submitted")
                req._push(_empty_final())
                return req
            p, t = prompt_mod.pd_lengths(pd)
            if p > self.prompt_bucket or t > self.trailing_bucket:
                raise ValueError(
                    f"prompt ({p} embeds / {t} trailing) exceeds service buckets "
                    f"({self.prompt_bucket}/{self.trailing_bucket}); shorten the text or run "
                    "a service with larger buckets")
            n = next(self._seq)
            pc = pl.pipeline_config
            req = TTSRequest(
                pd, stats=self._stats,
                temperature=temperature if temperature is not None else pc.default_temperature,
                max_tokens=max_tokens if max_tokens is not None else pc.default_max_tokens,
                seed=seed if seed is not None else n)
            # counted once valid: close(drain=True) relies on submitted ==
            # completed + failed + cancelled
            self._stats.inc("requests_submitted")
            enqueued = True
            if _hold is not None:
                _hold.append(req)
                return req
            self._enqueue([req])
            return req
        finally:
            if not enqueued:
                self._stats.inc("waiting", -1)

    def _enqueue(self, reqs: list) -> None:
        self._inbox.put(reqs)
        if self._stop.is_set():
            # close() raced the put: the worker may have made its last drain,
            # so fail them here (a second push is harmless: the stream stops
            # at the first, and the terminal count is taken once)
            for req in reqs:
                req._push(ServiceClosed("service is shut down"))

    def close(self, timeout: float = 30.0, drain: bool = False) -> None:
        """Stop the worker; requests in flight and queued get ServiceClosed.
        drain=True first waits, up to `timeout`, for every submitted request
        to finish (callers stop submitting first)."""
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                s = self.stats()
                # a counter identity, not gauges: each submitted request ends
                # in exactly one terminal count
                if s["requests_submitted"] == (s["requests_completed"] + s["requests_failed"]
                                               + s["requests_cancelled"]):
                    break
                time.sleep(0.05)
        self._stop.set()
        self._worker.join(timeout=timeout)

    @property
    def busy(self) -> bool:
        """True when a submit would now be rejected by the queue bound
        (advisory: the reserve inside submit decides). Lets the HTTP layer
        answer 503 before it encodes reference audio."""
        return (self.max_queue is not None
                and self._stats.snapshot().get("waiting", 0) >= self.max_queue)

    def try_reject_busy(self) -> bool:
        """busy, counted in requests_rejected_busy when True."""
        if self.busy:
            self._stats.inc("requests_rejected_busy")
            return True
        return False

    def warmup(self, max_tokens: int = 24) -> None:
        """Run every serving path once before real traffic, then capture
        the lockstep graph of every key the service can reach, so no
        request waits for a capture: a request into the idle batch (the
        bootstrap prefill, decode chunks, the batched vocoder), then, while
        it decodes, a burst of arrivals that reach the worker together (a
        full-B prefill admitted by row, with batch_size >= 3) and one more
        (a B = 1 prefill and its admission), and the parks of their
        max_tokens finishes; then one graph per key, greedy and sampled, at
        the service's batch width, capacity and trailing bucket
        (serving.capture; on CUDA). Warmup requests count in stats()."""
        first = self.submit("Warm up the serving path.", temperature=0.0,
                            max_tokens=max_tokens, seed=0, _bypass_queue_bound=True)
        it = first.chunks()
        next(it)  # the batch is running
        burst: list = []
        for i in range(min(2, self.batch_size - 1)):
            self.submit(f"Warmup burst request {i}.", temperature=0.0,
                        max_tokens=max(1, max_tokens // 2), seed=1 + i,
                        _bypass_queue_bound=True, _hold=burst)
        self._enqueue(burst)
        streams = [it] + [req.chunks() for req in burst]
        if burst:
            next(streams[1])  # the burst is admitted, so the next arrival comes alone
        single = self.submit("One more warmup request.", temperature=0.0,
                             max_tokens=max(1, max_tokens // 3), seed=3,
                             _bypass_queue_bound=True)
        for stream in streams + [single.chunks()]:
            for _ in stream:
                pass
        params = self.pipeline.params
        if params["norm"]["w"].is_cuda:
            template = self._prefill_bootstrap({0: first})
            for sampled in (False, True):
                srv.capture(params, self.pipeline.cp_params, template, self.statics, sampled)

    def stats(self) -> dict:
        """Counters (requests submitted / completed / failed / cancelled /
        rejected busy, audio chunks emitted, frames decoded, decode chunks),
        gauges (active slots, backlog, queued) and the configuration. Safe
        from any thread; backs GET /stats."""
        out = self._stats.snapshot()
        for k in ("requests_submitted", "requests_completed", "requests_failed",
                  "requests_cancelled", "active_slots", "backlog"):
            out.setdefault(k, 0)
        out["queued"] = max(0, out.pop("waiting", 0))
        out["uptime_s"] = round(time.monotonic() - self._t0, 1)
        out["worker_restarts"] = self.worker_restarts
        out["closed"] = self._stop.is_set()
        out["batch_size"] = self.batch_size
        out["prompt_bucket"] = self.prompt_bucket
        out["trailing_bucket"] = self.trailing_bucket
        return out

    # -- worker ------------------------------------------------------------

    def _padded_rows(self, pd) -> tuple[torch.Tensor, torch.Tensor]:
        """(embeds [1, pb, H], trailing [1, tb, H]) of one request: submit
        pads every prompt it accepts to the service's buckets."""
        return pd.input_embeds, pd.trailing_hidden

    def _prefill(self, req: TTSRequest) -> srv.ServingState:
        """A B = 1 prefill of one request."""
        p, t = prompt_mod.pd_lengths(req.pd)
        e, tr = self._padded_rows(req.pd)
        dev = e.device
        return srv.prefill_batched(
            self.pipeline.params, e, srv._device_ints([p], dev), tr,
            srv._device_ints([t], dev), req.pd.tts_pad_embed,
            srv._device_ints([req.seed], dev), self.statics)

    def _prefill_bootstrap(self, placed: dict) -> srv.ServingState:
        """ONE full-B prefill of the requests in `placed` (slot -> request):
        the batch's first state for a burst into an idle service, or the
        fresh state whose rows a burst into a running batch admits. One
        batched call reads the talker weights once instead of once a
        request; rows are independent through prefill_batched, so greedy
        outputs are unchanged. Unoccupied rows repeat the first placed
        request's prompt with seed 0: shape-valid rows never emitted, which
        admission overwrites."""
        ref = next(iter(placed.values()))
        rows, lengths, totals, seeds = [], [], [], []
        for slot in range(self.batch_size):
            req = placed.get(slot, ref)
            p, t = prompt_mod.pd_lengths(req.pd)
            rows.append(self._padded_rows(req.pd))
            lengths.append(p)
            totals.append(t)
            seeds.append(req.seed if slot in placed else 0)
        e = torch.cat([r[0] for r in rows])
        tr = torch.cat([r[1] for r in rows])
        dev = e.device
        return srv.prefill_batched(
            self.pipeline.params, e, srv._device_ints(lengths, dev), tr,
            srv._device_ints(totals, dev), ref.pd.tts_pad_embed,
            srv._device_ints(seeds, dev), self.statics)

    def _fail_inbox(self, err: Exception) -> None:
        while True:
            try:
                reqs = self._inbox.get_nowait()
            except queue.Empty:
                return
            for req in reqs:
                req._push(err)
                self._stats.inc("waiting", -1)

    def _run(self) -> None:
        """Worker thread: serve until shutdown, restarting after an
        unexpected crash up to max_worker_restarts times (the budget guards
        against crash loops: it resets after 600 s without a crash). A crash
        fails the requests in flight; the next ones get a fresh batch."""
        last_crash = None
        while True:
            try:
                self._serve_once()
                return  # clean shutdown
            except Exception:
                now = time.monotonic()
                if last_crash is not None and now - last_crash > 600.0:
                    self.worker_restarts = 0
                last_crash = now
                if self._stop.is_set() or self.worker_restarts >= self.max_worker_restarts:
                    # give up: stop accepting and fail everything queued
                    self._stop.set()
                    self._fail_inbox(ServiceClosed("service is shut down"))
                    return
                self.worker_restarts += 1

    def _serve_once(self) -> None:
        pl = self.pipeline
        b = self.batch_size
        dec_cfg = pl.speech_config.decoder_config
        ng = pl.config.code_predictor_config.num_code_groups
        spf = dec_cfg.total_upsample
        packer = srv._RowPacker(ng, self.decode_chunk, self.left_context,
                                self.first_decode_chunk)
        self._packer = packer  # lives as long as this worker generation

        # the PCM puller: every audio and final push of slot-served requests
        # goes through this FIFO, so each request's chunks stay in order
        pq: queue.Queue = queue.Queue()
        pull_err: list = [None]

        def fail(items, err) -> None:
            for dispatched, final_pushes in items:
                for _pull, group in dispatched:
                    for key, *_ in group:
                        key._push(err)
                for req, _ in final_pushes:
                    req._push(err)

        def pull_loop() -> None:
            while True:
                item = pq.get()
                if item is None:
                    return
                dispatched, final_pushes = item
                try:
                    for key, samples, t_range, final in srv.resolve_vocoded(dispatched, spf):
                        key._push(AudioChunk(samples=samples, token_range=t_range,
                                             is_final=final))
                    for req, t0 in final_pushes:
                        req._push(_empty_final(t0))
                except Exception as e:  # a device error surfaces at the wait
                    err = ServiceClosed(f"audio delivery failed: {type(e).__name__}: {e}")
                    rest = [item]
                    while True:  # fail what is queued, then hand the error on
                        try:
                            nxt = pq.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is None:
                            break
                        rest.append(nxt)
                    fail(rest, err)
                    pull_err[0] = e
                    return

        puller = threading.Thread(target=pull_loop, name="tts-service-pull", daemon=True)
        puller.start()

        slots = [_SlotView() for _ in range(b)]
        backlog: deque[TTSRequest] = deque()
        # released from their slot, final chunk not yet handed to the puller:
        # the crash handler fails these too
        finishing: list[TTSRequest] = []
        temps = np.full((b,), 1.0, np.float32)
        state = None
        pending = None  # (pull of chunk `it`'s frames and eos, its state)
        ops: list[tuple] = []  # deferred boundary ops: ("admit", slot, fresh, src) | ("park", slot)
        it = 0

        def apply_ops(state):
            for op in ops:
                if op[0] == "admit":
                    srv.admit_stream(state, op[1], op[2], self.statics, src=op[3])
                else:
                    srv.park_slot(state, op[1])
            ops.clear()
            return state

        def dispatch(state):
            frames, _counts, eos, state = srv.decode_chunk_serving(
                pl.params, pl.cp_params, state, temps, self.statics)
            return srv._to_host(torch.cat([frames.reshape(-1), eos.long()])), state

        def occupied() -> bool:
            return any(s.req is not None for s in slots)

        def finish(req: TTSRequest) -> None:
            t0 = packer.sent(req)
            packer.release(req)
            req._push(_empty_final(t0))

        try:
            while True:
                if pull_err[0] is not None:
                    raise pull_err[0]  # restart with a fresh batch and puller
                if self._stop.is_set():
                    raise ServiceClosed("service is shut down")

                # 1. arrivals -> backlog -> free slots
                idle = pending is None and not occupied() and not backlog
                try:
                    backlog.extend(self._inbox.get(timeout=0.2) if idle
                                   else self._inbox.get_nowait())
                except queue.Empty:
                    if idle:
                        continue
                while True:
                    try:
                        backlog.extend(self._inbox.get_nowait())
                    except queue.Empty:
                        break

                bootstrap: dict[int, TTSRequest] = {}
                midflight: dict[int, TTSRequest] = {}
                for slot in range(b):
                    if not backlog:
                        break
                    if slots[slot].req is not None:
                        continue
                    req = backlog.popleft()
                    self._stats.inc("waiting", -1)
                    if req.cancelled:
                        finish(req)
                        continue
                    # the slot is claimed before the prefill: if it raises,
                    # the crash handler finds the request and fails it
                    temps[slot] = req.temperature
                    slots[slot].req = req
                    if state is None:
                        bootstrap[slot] = req
                        slots[slot].active_from = 0
                        continue
                    midflight[slot] = req
                    slots[slot].active_from = it if pending is None else it + 1
                if bootstrap:
                    state = self._prefill_bootstrap(bootstrap)
                if len(midflight) == 1:  # one arrival: a B = 1 prefill
                    ((slot, req),) = midflight.items()
                    ops.append(("admit", slot, self._prefill(req), 0))
                elif midflight:  # a burst: one full-B prefill, rows admitted by slot
                    fresh = self._prefill_bootstrap(midflight)
                    for slot in midflight:
                        ops.append(("admit", slot, fresh, slot))

                if state is None:
                    continue

                # 2. no chunk in flight: apply the ops, dispatch, loop
                if pending is None:
                    state = apply_ops(state)
                    if occupied():
                        pending = dispatch(state)
                        state = pending[1]
                    continue

                # 3. boundary: chunk `it`'s state is back; apply the ops and
                # queue chunk `it + 1` before waiting on chunk `it`
                pull, state = pending
                state = apply_ops(state)
                pending = dispatch(state) if occupied() else None
                if pending is not None:
                    state = pending[1]
                host = pull()
                frames_np = host[:-b].reshape(b, self.chunk_steps, ng).astype(np.int32)
                eos_np = host[-b:].astype(bool)

                # 4. route chunk `it`'s frames; vocode; emit
                rows = []
                empty_finals: list[TTSRequest] = []
                for slot in range(b):
                    sv = slots[slot]
                    req = sv.req
                    if req is None or it < sv.active_from:
                        continue
                    if req.cancelled:
                        packer.drop(req)  # its buffered frames die with it
                        finish(req)
                        sv.req = None
                        ops.append(("park", slot))
                        continue
                    valid = frames_np[slot][frames_np[slot][:, 0] >= 0]
                    take = max(0, min(len(valid), req.max_tokens - req.emitted))
                    valid = gen_mod.filter_valid_frames(valid[:take])
                    req.emitted += take
                    self._stats.inc("frames_decoded", take)
                    done = bool(eos_np[slot]) or req.emitted >= req.max_tokens
                    r, empty_final = packer.feed(req, valid, done)
                    rows.extend(r)
                    if done:
                        if empty_final:
                            empty_finals.append(req)
                        finishing.append(req)
                        sv.req = None
                        if not eos_np[slot]:
                            ops.append(("park", slot))

                # only queued here: the puller waits for the PCM and pushes
                # the chunks while the next decode chunk runs
                dispatched = srv.vocode_rows_dispatch(rows, b, pl.vocoder_params, dec_cfg, ng,
                                                      packer.width)
                final_pushes = [(req, packer.sent(req)) for req in empty_finals]
                if dispatched or final_pushes:
                    pq.put((dispatched, final_pushes))
                # after the puller owns delivery: a crash from here on must
                # not fail these requests a second time
                for req in finishing:
                    packer.release(req)
                finishing.clear()
                it += 1
                self._stats.inc("decode_chunks")
                self._stats.set("active_slots", sum(1 for s in slots if s.req is not None))
                self._stats.set("backlog", len(backlog))
        except Exception as e:  # every waiting consumer gets the error
            # drop the batch's state now, so its graph is free for the next
            # generation's batch (a replay in flight is ordered before any
            # later use of the graph on this stream)
            state = pending = None
            ops.clear()
            # stop this generation's puller, letting queued audio flush
            # (close(drain=True) counts the terminal pushes it makes)
            pq.put(None)
            puller.join(timeout=30.0 if isinstance(e, ServiceClosed) else 5.0)
            err = e if isinstance(e, ServiceClosed) else ServiceClosed(
                f"service worker died: {type(e).__name__}: {e}")
            if not isinstance(e, ServiceClosed):
                traceback.print_exc()
            for sv in slots:
                if sv.req is not None:
                    sv.req._push(err)
                    sv.req = None
            for req in finishing:
                req._push(err)
            finishing.clear()
            for req in backlog:
                self._stats.inc("waiting", -1)
                req._push(err)
            self._stats.set("active_slots", 0)
            self._stats.set("backlog", 0)
            if isinstance(e, ServiceClosed):
                self._fail_inbox(err)  # shutdown: nothing queued may hang
                return
            raise  # _run restarts with a fresh batch, or gives up
