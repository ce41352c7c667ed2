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

Under a tp mesh (pipeline.params placed by parallel.sharding.shard_params)
the service runs on tp rank 0 and TTSService.follow on every other rank.
Admission depends on when requests reach rank 0, so only rank 0 decides:
before each device call of a boundary its worker broadcasts the call over
the tp group (_Channel): a prefill with its padded prompt rows, lengths
and seeds, the deferred admit / park ops, each decode chunk with its
temperatures. The followers repeat those calls on their shards; each
lockstep step is eager (its all-reduces are not captured), and warmup
captures nothing. Followers never vocode. An idle rank 0 sends a
keep-alive every few seconds, so a follower waiting in the broadcast never
reaches the process group's timeout; close() ends the followers. A worker
crash under a mesh ends the service (a fresh batch cannot resynchronize
the ranks).
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
import torch.distributed as dist

from .models import generate as gen_mod
from .models import prompt as prompt_mod
from .models import serving as srv
from .parallel import sharding as sh
from .pipeline import AudioChunk


# the commands of the tp group's channel
_KEEPALIVE, _PREFILL, _OPS, _DECODE, _CLOSE = range(5)
_PARK, _ADMIT = 0, 1
_KEEPALIVE_S = 5.0


class _Channel:
    """Rank 0's command stream to the other ranks of a tp group: a fixed
    int64 header (the command, its integer count, its integers) broadcast
    from the group's first rank, then the command's tensors. Every call of
    it is made on one thread (the worker's on rank 0, the follower's
    elsewhere), in the same order on every rank."""

    def __init__(self, group, batch_size: int):
        self.group = group
        self.src = dist.get_global_rank(group, 0)
        # the longest command: a boundary's ops, a park and an admission of
        # each slot at most, 4 integers each
        self.size = 2 + 8 * batch_size
        self.last = time.monotonic()

    @classmethod
    def of(cls, params: dict, batch_size: int) -> "_Channel | None":
        par, _ = sh.local_params(params)
        return None if par.tp is None else cls(par.tp, batch_size)

    @property
    def leader(self) -> bool:
        return dist.get_rank() == self.src

    def _bcast(self, t: torch.Tensor) -> None:
        # as bytes, bit for bit: gloo carries no 16-bit type of a CUDA tensor
        dist.broadcast(t.view(torch.uint8), self.src, group=self.group)

    def send(self, op: int, ints=(), tensors=()) -> None:
        ints = [int(x) for x in ints]
        hdr = torch.zeros(self.size, dtype=torch.int64)
        hdr[0], hdr[1] = op, len(ints)
        hdr[2:2 + len(ints)] = torch.tensor(ints, dtype=torch.int64)
        self._bcast(hdr)
        for t in tensors:
            self._bcast(t.contiguous())
        self.last = time.monotonic()

    def keepalive(self) -> None:
        if time.monotonic() - self.last > _KEEPALIVE_S:
            self.send(_KEEPALIVE)

    def recv(self) -> tuple[int, list[int]]:
        hdr = torch.zeros(self.size, dtype=torch.int64)
        self._bcast(hdr)
        n = int(hdr[1])
        return int(hdr[0]), hdr[2:2 + n].tolist()

    def recv_tensor(self, shape, like: torch.Tensor) -> torch.Tensor:
        t = torch.empty(shape, dtype=like.dtype, device=like.device)
        self._bcast(t)
        return t


def _temps_ints(temps: np.ndarray) -> list[int]:
    """float32 temperatures as their bit patterns (the channel's header is
    int64)."""
    return np.asarray(temps, np.float32).view(np.int32).astype(np.int64).tolist()


def _ints_temps(ints: list[int]) -> np.ndarray:
    return np.asarray(ints, np.int64).astype(np.int32).view(np.float32)


def _prefill_rows(params: dict, e, tr, lengths, totals, seeds, pad, statics):
    """prefill_batched of padded prompt rows e [n, pb, H], tr [n, tb, H] and
    their integers (lists)."""
    dev = e.device
    return srv.prefill_batched(params, e, srv._device_ints(lengths, dev), tr,
                               srv._device_ints(totals, dev), pad, srv._device_ints(seeds, dev),
                               statics)


def _apply_ops(state, ops: list, fresh: dict, statics) -> None:
    """The deferred boundary ops, (_PARK, slot, 0, 0) or (_ADMIT, slot,
    fresh id, src), applied to `state` in place; fresh id -> a fresh
    prefilled state."""
    for op in ops:
        if op[0] == _ADMIT:
            srv.admit_stream(state, op[1], fresh[op[2]], statics, src=op[3])
        else:
            srv.park_slot(state, op[1])


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
        self._channel = _Channel.of(pipeline.params, batch_size)
        if self._channel is not None:
            if not self._channel.leader:
                raise ValueError("under a tp mesh the service runs on the tp group's first "
                                 "rank; the other ranks call TTSService.follow")
            self.max_worker_restarts = 0
        self._fresh_ids = itertools.count()
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
        (serving.capture; on CUDA, and not under a tp mesh, whose steps run
        eagerly). Warmup requests count in stats()."""
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
        if params["norm"]["w"].is_cuda and self._channel is None:
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

    def _prefill_rows(self, e, tr, lengths, totals, seeds, pad, target: int) -> srv.ServingState:
        """prefill_batched of padded rows e [n, pb, H], tr [n, tb, H], under
        a tp mesh broadcast to the followers first. target: -1 for the
        batch's state, else the id of a fresh state that admissions read."""
        if self._channel is not None:
            self._channel.send(_PREFILL, [target, *lengths, *totals, *seeds], (e, tr, pad))
        return _prefill_rows(self.pipeline.params, e, tr, lengths, totals, seeds, pad,
                             self.statics)

    def _prefill(self, req: TTSRequest, target: int = -1) -> srv.ServingState:
        """A B = 1 prefill of one request."""
        p, t = prompt_mod.pd_lengths(req.pd)
        e, tr = self._padded_rows(req.pd)
        return self._prefill_rows(e, tr, [p], [t], [req.seed], req.pd.tts_pad_embed, target)

    def _prefill_bootstrap(self, placed: dict, target: int = -1) -> srv.ServingState:
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
        return self._prefill_rows(torch.cat([r[0] for r in rows]),
                                  torch.cat([r[1] for r in rows]), lengths, totals, seeds,
                                  ref.pd.tts_pad_embed, target)

    @classmethod
    def follow(cls, pipeline, *, batch_size: int = 8, chunk_steps: int = 6,
               prompt_bucket: int | None = None, trailing_bucket: int | None = None,
               **_audio_kwargs) -> None:
        """The service's part on a tp rank other than the first: repeat, on
        this rank's shards, each device call that rank 0's worker
        broadcasts (prefills, admit / park ops, decode chunks) until rank
        0's service closes. Takes the kwargs rank 0's TTSService took; the
        audio ones are unused, since followers never vocode."""
        channel = _Channel.of(pipeline.params, batch_size)
        if channel is None or channel.leader:
            raise ValueError("TTSService.follow runs on a tp rank other than the first, "
                             "with the talker placed on the mesh")
        pb = prompt_bucket or gen_mod.PROMPT_BUCKETS[2]
        tb = trailing_bucket or gen_mod.TRAILING_BUCKETS[1]
        statics = gen_mod.GenStatics(config=pipeline.config, capacity=pb + gen_mod.RING_SLACK,
                                     chunk_steps=chunk_steps, track_cp_penalty=False)
        like = sh.local_params(pipeline.params)[1]["norm"]["w"]
        h = pipeline.config.hidden_size
        state, fresh = None, {}
        while True:
            op, ints = channel.recv()
            if op == _CLOSE:
                return
            if op == _PREFILL:
                target, rest = ints[0], ints[1:]
                n = len(rest) // 3
                e = channel.recv_tensor((n, pb, h), like)
                tr = channel.recv_tensor((n, tb, h), like)
                pad = channel.recv_tensor((1, 1, h), like)
                out = _prefill_rows(pipeline.params, e, tr, rest[:n], rest[n:2 * n],
                                    rest[2 * n:], pad, statics)
                if target < 0:
                    state = out
                else:
                    fresh[target] = out
            elif op == _OPS:
                _apply_ops(state, [ints[i:i + 4] for i in range(0, len(ints), 4)], fresh,
                           statics)
                fresh.clear()
            elif op == _DECODE:
                *_, state = srv.decode_chunk_serving(pipeline.params, pipeline.cp_params, state,
                                                     _ints_temps(ints), statics)

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
        try:
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
        finally:
            if self._channel is not None:
                self._channel.send(_CLOSE)  # the followers return

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
        # deferred boundary ops: (_ADMIT, slot, fresh id, src) | (_PARK, slot,
        # 0, 0); fresh id -> the fresh prefilled state they admit from
        ops: list[tuple] = []
        fresh: dict = {}
        it = 0

        def apply_ops(state):
            if self._channel is not None and ops:
                self._channel.send(_OPS, [x for op in ops for x in op])
            _apply_ops(state, ops, fresh, self.statics)
            ops.clear()
            fresh.clear()
            return state

        def dispatch(state):
            if self._channel is not None:
                self._channel.send(_DECODE, _temps_ints(temps))
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
                        if self._channel is not None:
                            self._channel.keepalive()
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
                    fid = next(self._fresh_ids)
                    fresh[fid] = self._prefill(req, fid)
                    ops.append((_ADMIT, slot, fid, 0))
                elif midflight:  # a burst: one full-B prefill, rows admitted by slot
                    fid = next(self._fresh_ids)
                    fresh[fid] = self._prefill_bootstrap(midflight, fid)
                    for slot in midflight:
                        ops.append((_ADMIT, slot, fid, slot))

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
                        ops.append((_PARK, slot, 0, 0))
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
                            ops.append((_PARK, slot, 0, 0))

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
            fresh.clear()
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
