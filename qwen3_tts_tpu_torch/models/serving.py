"""Batched lockstep serving: B utterances decode concurrently, one frame each
per lockstep step (counterpart of qwen3_tts_tpu/models/serving.py).

Every stream's prompt is padded to one bucket, so the ring slot is shared by
all streams (one cache write a layer for the whole batch) while RoPE
positions, window starts, trailing-text schedules, stop flags and sampling
state are per-stream vectors. A stream that finished keeps computing with
its outputs and state frozen by masks, so a greedy stream decodes as it
would alone.

A step updates the state's tensors in place and never reaches the host: no
`.item()`, no branch on a device value, no size that depends on data. On
CUDA every step is the replay of one CUDA graph (LockstepGraph), captured
at the first use of its key (batch width, ring capacity, trailing bucket,
GenStatics, greedy or sampled) over static state buffers; `bind` copies a
state into a graph's buffers, and admission and parking then write those
buffers in place. A failed capture raises. `bind` leases a graph to one
state at a time under one lock, so callers on several threads (a service
worker and a request thread) never share buffers, and captures outside it,
one capture at a time; `capture` captures a key ahead of traffic. The CPU
runs the same step eagerly. The megakernels are B = 1 launches, so the
batched path drops params["kernel"] (as the JAX package does) and runs the
layer-by-layer linears at M = B: K3 on int8 entries, K7 on packed ones,
the `w8r` product on the megakernels' shared rowwise weights.

Draws: a stream's Gumbel noise is K2g's Philox formula keyed by the
request's seed, with counter (v // 4, group, the stream's own step)
(gumbel_sampler.gumbel_noise_streams), so a stream's codes depend neither
on its slot nor on when it was admitted.

Host side: ContinuousServer keeps B slots busy (admitting queued prompts
into finished slots mid-flight) and serve_audio vocodes ready 18-frame rows
of all streams in one fixed-shape call, pulling PCM through pinned memory
behind CUDA events.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import torch

from ..config import Qwen3TTSConfig
from ..ops.attention import gqa_attention_full
from ..ops.cuda import gumbel_sampler, packed_matmul, quant_matmul
from ..ops.linear import linear, table_matmul, table_row
from ..ops.norms import rms_norm
from ..ops.sampling import NEG_INF, sample_token
from ..utils.postprocess import sanitize_samples
from . import code_predictor as cp_mod
from . import generate as gen_mod
from . import talker as talker_mod
from . import vocoder as voc

# the kernel wrappers a lockstep step can reach (LockstepGraph.step_launches)
_COUNTED = (quant_matmul, packed_matmul)


class ServingState(dict):
    """A serving state: a dict of device tensors (the cache a dict of its
    own). `graph` is the LockstepGraph whose static buffers these tensors
    are, or None. Update it only in place: a bound graph reads and writes
    these very tensors."""

    __slots__ = ("graph", "__weakref__")

    def __init__(self, *args, graph=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.graph = graph


def _drop_kernel(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "kernel"}


def _device_ints(vals, device) -> torch.Tensor:
    """int64 [len(vals)] on `device` without a blocking host copy."""
    t = torch.tensor(np.asarray(vals, np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _host_temps(temperature, b: int) -> np.ndarray:
    """A shared or per-stream temperature as float32 [B] on the host."""
    return np.broadcast_to(np.asarray(temperature, np.float32).reshape(-1), (b,)).copy()


def _to_host(t: torch.Tensor):
    """Queue a copy of `t` to host memory; returns a function that waits
    for it and gives the numpy array. On CUDA a non-blocking copy into
    pinned memory behind an event, so only this copy is waited for."""
    if not t.is_cuda:
        return lambda: t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def pull() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return pull


# ---------------------------------------------------------------------------
# Batched model steps (shared slot, per-stream positions)
# ---------------------------------------------------------------------------


def _attention_decode_batched(q, k_cache, v_cache, cache_pos, window_start, scale):
    """GQA decode with per-stream validity. q [B, Hq, 1, D]; caches [B, Hkv,
    C, D]; cache_pos [B, C]; window_start [B]."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bkcd->bkgc", qg, k_cache.float()) * scale
    valid = (cache_pos >= 0) & (cache_pos >= window_start[:, None])
    scores = torch.where(valid[:, None, None, :], scores, float(NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgc,bkcd->bkgd", probs, v_cache).reshape(b, hq, 1, d)


def talker_decode_step_batched(params: dict, embed: torch.Tensor, cache: dict,
                               positions: torch.Tensor, slot: torch.Tensor,
                               window_start: torch.Tensor,
                               config: Qwen3TTSConfig) -> tuple[torch.Tensor, dict]:
    """One lockstep decode step for B streams. embed [B, 1, H]; positions
    [B] absolute per stream; slot: the ring slot all streams share (0-d);
    window_start [B]. cache {"k", "v": [L, B, Hkv, C, D], "pos": [B, C]} is
    written in place at the slot; returns (h [B, 1, H], cache)."""
    b = embed.shape[0]
    nq, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    eps = config.rms_norm_eps
    scale = 1.0 / float(hd) ** 0.5
    cos, sin = talker_mod.rope_cos_sin(config, positions[:, None])
    slot = slot.reshape(1)
    cache["pos"].index_copy_(1, slot, positions[:, None].to(cache["pos"].dtype))
    h = embed
    for i in range(config.num_hidden_layers):
        lp = talker_mod._layer(params["layers"], i)
        x = rms_norm(h, lp["input_layernorm"]["w"], eps)
        q, k, v = talker_mod.layer_qkv(lp, x, cos, sin, nq, nkv, hd, eps)
        cache["k"][i].index_copy_(2, slot, k)
        cache["v"][i].index_copy_(2, slot, v)
        attn = _attention_decode_batched(q, cache["k"][i], cache["v"][i], cache["pos"],
                                         window_start, scale)
        h = h + linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, 1, -1))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], eps)
        h = h + linear(lp["down_proj"], talker_mod.swiglu(lp, x2, config.intermediate_size))
    return rms_norm(h, params["norm"]["w"], eps), cache


def predict_frame_batched(cp_params: dict, code_hidden: torch.Tensor,
                          code0_embed: torch.Tensor, noise: torch.Tensor | None,
                          temps: torch.Tensor, config,
                          forced_codes: torch.Tensor | None = None):
    """Codes 1..15 of B streams' frames (the cp positions are shared, so
    cp_forward's batch dim applies directly). code_hidden / code0_embed
    [B, 1, H]; noise [B, 15, V] Gumbel noise of the groups (None: greedy);
    temps [B]. No repetition penalty, as in the JAX serving path and the
    streaming paths. `forced_codes` [B, 15] feeds given codes on (teacher
    forcing). Returns (codes [B, 15] int64, embed_sum [B, 1, H])."""
    ng = config.num_code_groups - 1
    b = code_hidden.shape[0]
    dtype, dev = code_hidden.dtype, code_hidden.device
    shape = (config.num_hidden_layers, b, config.num_key_value_heads, cp_mod.CP_CACHE_LEN,
             config.head_dim)
    ck = torch.zeros(shape, dtype=dtype, device=dev)
    cv = torch.zeros(shape, dtype=dtype, device=dev)
    emb, heads = cp_params["codec_embedding"], cp_params["lm_head"]

    def emb_rows(k, codes):
        return table_row(emb, k, codes, dtype)[:, None, :]

    def sample_group(k, h_last):
        if forced_codes is not None:
            return forced_codes[:, k]
        lg = table_matmul(heads, k, h_last[:, 0].float())
        return sample_token(lg, None, 0.0 if noise is None else temps,
                            noise=None if noise is None else noise[:, k])

    x0 = torch.cat([code_hidden, code0_embed], dim=1)
    h_last, ck, cv = cp_mod.cp_forward(cp_params, x0, ck, cv, 0, config)
    codes = [sample_group(0, h_last)]
    embed_sum = code0_embed + emb_rows(0, codes[0])
    for k in range(1, ng):
        h_last, ck, cv = cp_mod.cp_forward(cp_params, emb_rows(k - 1, codes[-1]), ck, cv,
                                           k + 1, config)
        codes.append(sample_group(k, h_last))
        embed_sum = embed_sum + emb_rows(k, codes[-1])
    return torch.stack(codes, dim=1), embed_sum


# ---------------------------------------------------------------------------
# Batched prefill and the lockstep step
# ---------------------------------------------------------------------------


def prefill_batched(params: dict, embeds_padded: torch.Tensor, lengths: torch.Tensor,
                    trailing_padded: torch.Tensor, total_texts: torch.Tensor,
                    tts_pad_embed: torch.Tensor, seeds: torch.Tensor,
                    statics: gen_mod.GenStatics) -> ServingState:
    """Prefill B prompts, all padded to one bucket, in one pass, and build
    the serving state. embeds_padded [B, P, H]; lengths [B]; trailing_padded
    [B, T, H]; total_texts [B]; seeds [B] the requests' sampler seeds.
    Slots [0, P) are shared; a stream's padding slots carry pos = -1. The
    cache is handed over in the plain k / v layout."""
    params = _drop_kernel(params)
    cfg = statics.config
    b, p_pad, _ = embeds_padded.shape
    dev, dtype = embeds_padded.device, embeds_padded.dtype
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    scale = 1.0 / float(hd) ** 0.5
    idx = torch.arange(p_pad, device=dev)
    cos, sin = talker_mod.rope_cos_sin(cfg, idx[None].expand(b, p_pad))
    ok = (idx[None, :] <= idx[:, None])[None] & (idx[None, None, :] < lengths[:, None, None])
    mask = torch.where(ok, 0.0, float(NEG_INF))[:, None, None]  # [B, 1, 1, P, P]
    shape = (cfg.num_hidden_layers, b, nkv, statics.capacity, hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev),
             "pos": torch.full((b, statics.capacity), -1, dtype=torch.int64, device=dev)}
    h = embeds_padded
    for i in range(cfg.num_hidden_layers):
        lp = talker_mod._layer(params["layers"], i)
        x = rms_norm(h, lp["input_layernorm"]["w"], eps)
        q, k, v = talker_mod.layer_qkv(lp, x, cos, sin, nq, nkv, hd, eps)
        cache["k"][i, :, :, :p_pad] = k
        cache["v"][i, :, :, :p_pad] = v
        attn = gqa_attention_full(q, k, v, scale, mask)
        h = h + linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, p_pad, -1))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], eps)
        h = h + linear(lp["down_proj"], talker_mod.swiglu(lp, x2, cfg.intermediate_size))
    h = rms_norm(h, params["norm"]["w"], eps)
    cache["pos"][:, :p_pad] = torch.where(idx[None] < lengths[:, None], idx[None], -1)
    h_last = h.gather(1, (lengths - 1)[:, None, None].expand(b, 1, h.shape[2]))

    def zeros(dt=torch.int64):
        return torch.zeros(b, dtype=dt, device=dev)

    return ServingState(
        cache=cache,
        h_last=h_last,
        logits=talker_mod.codec_head(params, h_last)[:, 0],
        lengths=lengths.long(),
        step=torch.zeros((), dtype=torch.int64, device=dev),
        window_start=zeros(),
        trailing_idx=zeros(),
        start_step=zeros(),
        consecutive_pad=zeros(),
        eos=zeros(torch.bool),
        seen_code0=torch.zeros(b, cfg.vocab_size, dtype=torch.bool, device=dev),
        trailing=trailing_padded,
        total_texts=total_texts.long(),
        tts_pad_embed=tts_pad_embed,
        seeds=seeds.long(),
        p_pad=torch.full((), p_pad, dtype=torch.int64, device=dev),
        frame=torch.full((b, cfg.code_predictor_config.num_code_groups), -1,
                         dtype=torch.int64, device=dev),
    )


def lockstep_step(params: dict, cp_params: dict, state: dict, temps: torch.Tensor,
                  statics: gen_mod.GenStatics, sampled: bool,
                  forced: torch.Tensor | None = None) -> None:
    """One frame for every stream, written into `state` in place:
    state["frame"] [B, 16] gets each stream's frame (-1 where it emitted
    nothing). Code-0 sampling with the eos / pad mask while text remains
    and the validity mask, the code predictor, the trailing-text schedule,
    the EOS / consecutive-pad stop, the talker step and the window trim,
    each per stream. temps [B]; `sampled` (static): draw Gumbel noise for
    streams with temperature > 0, else every stream is greedy. `forced`
    [B, 16] replaces the sampled codes (teacher forcing)."""
    cfg = statics.config
    cc = cfg.code_predictor_config
    dev = state["logits"].device
    b, hdim = state["h_last"].shape[0], state["h_last"].shape[2]
    eos_pad_mask, valid_mask = gen_mod.step_masks(cfg, dev)
    active = ~state["eos"]
    noise = None
    if sampled:
        own = state["step"] - state["start_step"]
        noise = gumbel_sampler.gumbel_noise_streams(
            state["seeds"], own, cc.num_code_groups, max(cfg.vocab_size, cc.vocab_size))

    has_text = state["trailing_idx"] < state["total_texts"]
    lg = state["logits"] + torch.where(has_text[:, None], eos_pad_mask, 0.0)
    code0 = sample_token(lg, None, 0.0 if noise is None else temps,
                         seen_mask=state["seen_code0"],
                         repetition_penalty=statics.repetition_penalty, valid_mask=valid_mask,
                         noise=None if noise is None else noise[:, 0, :cfg.vocab_size])
    if forced is not None:
        code0 = forced[:, 0]
    is_pad = code0 == cfg.codec_pad_id
    consec = torch.where(is_pad, state["consecutive_pad"] + 1, 0)
    stop = active & ((code0 == cfg.codec_eos_token_id)
                     | (is_pad & (consec > gen_mod.MAX_CONSECUTIVE_PAD)))
    emit = active & ~stop

    code0_embed = talker_mod.encode_audio(params, code0[:, None])
    codes15, embed_sum = predict_frame_batched(
        cp_params, state["h_last"], code0_embed,
        None if noise is None else noise[:, 1:, :cc.vocab_size], temps, cc,
        forced_codes=None if forced is None else forced[:, 1:])
    frame = torch.where(emit[:, None], torch.cat([code0[:, None], codes15], dim=1), -1)

    trailing = state["trailing"]
    t_idx = torch.clamp(state["trailing_idx"], max=trailing.shape[1] - 1)
    trailing_embed = trailing.gather(1, t_idx[:, None, None].expand(b, 1, hdim))
    text_embed = torch.where(has_text[:, None, None], trailing_embed, state["tts_pad_embed"])
    input_embed = (text_embed + embed_sum).to(state["h_last"].dtype)
    positions = state["lengths"] + state["step"]
    # the shared ring slot wraps as the single-stream path's does; the window
    # mask on absolute positions keeps stale slots out
    slot = (state["p_pad"] + state["step"]) % statics.capacity
    h, _ = talker_decode_step_batched(params, input_embed, state["cache"], positions, slot,
                                      state["window_start"], cfg)
    logits = talker_mod.codec_head(params, h)[:, 0]

    step = state["step"] + 1
    total_len = state["lengths"] + step
    # each stream trims every TRIM_INTERVAL of its OWN steps (start_step
    # offsets an admitted stream)
    trim = ((step - state["start_step"]) % gen_mod.TRIM_INTERVAL == 0) & emit
    window = torch.where(trim, torch.maximum(state["window_start"], total_len - gen_mod.KV_WINDOW),
                         state["window_start"])
    seen = state["seen_code0"]
    seen.scatter_(1, code0[:, None], seen.gather(1, code0[:, None]) | emit[:, None])
    state["logits"].copy_(torch.where(emit[:, None], logits, state["logits"]))
    state["h_last"].copy_(torch.where(emit[:, None, None], h, state["h_last"]))
    state["window_start"].copy_(window)
    state["trailing_idx"].copy_(torch.where(emit & has_text, state["trailing_idx"] + 1,
                                            state["trailing_idx"]))
    state["consecutive_pad"].copy_(torch.where(emit, consec, state["consecutive_pad"]))
    state["eos"].copy_(state["eos"] | stop)
    state["step"].copy_(step)
    state["frame"].copy_(frame)


# ---------------------------------------------------------------------------
# One CUDA graph per lockstep step
# ---------------------------------------------------------------------------


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


def _counts() -> list[int]:
    return [m.launches for m in _COUNTED]


class LockstepGraph:
    """One CUDA graph of lockstep_step over static state buffers shaped as
    `template`, and a static temperature buffer. Warm-up (one eager step on
    the capture stream: plans, counters and constants made outside the
    capture), then capture; capture_s, pool_bytes (the graph pool's
    reserved bytes) and step_launches (the launches of each _COUNTED wrapper
    the capture recorded, so those a replay makes) are kept. The wrappers
    count their calls in the warm-up and the capture; a replay launches the
    recorded kernels without them and counts nothing."""

    def __init__(self, params, cp_params, template: dict, statics, sampled: bool, key):
        self.key, self.free = key, True
        self.buffers = _clone(template)
        self.temps = torch.zeros(template["logits"].shape[0], device=template["logits"].device)
        self._temps_host = None

        def step():
            lockstep_step(params, cp_params, self.buffers, self.temps, statics, sampled)

        # The capture runs on a stream of its own, in thread-local error
        # mode: CUDA then forbids unsafe calls (a sync, an allocation) only
        # on this thread while it captures, and other threads' work (a
        # puller's event waits and pinned copies, a submitter's prompt
        # assembly, another batch's replays) goes on beside it on their own
        # streams and is not recorded. The default (global) mode would fail
        # the capture, or those threads' calls, whenever they overlap.
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        gc.collect()  # as the capture does first, so the pool's growth is all it adds
        torch.cuda.empty_cache()
        before, reserved = _counts(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            step()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.step_launches = [a - b for a, b in zip(_counts(), before)]

    def set_temps(self, temps: np.ndarray) -> None:
        """Fill the temperature buffer (device fills, no host copy) when the
        values change."""
        key = tuple(temps.tolist())
        if key != self._temps_host:
            for i, t in enumerate(key):
                self.temps[i].fill_(t)
            self._temps_host = key

    def replay(self) -> None:
        self.graph.replay()


# id(talker final-norm weight) -> (weak reference to it, {key: [LockstepGraph]});
# an entry goes when its weight does
_GRAPHS: dict = {}


def graphs(params: dict) -> dict:
    """{key: [LockstepGraph]} of the talker tree `params` (a graph bakes in
    its weights' addresses, so graphs are kept per tree)."""
    w = params["norm"]["w"]
    entry = _GRAPHS.get(id(w))
    if entry is None or entry[0]() is not w:
        entry = (weakref.ref(w, lambda _ref, k=id(w), d=_GRAPHS: d.pop(k, None)), {})
        _GRAPHS[id(w)] = entry
    return entry[1]


def graph_key(cp_params: dict, state: dict, statics, sampled: bool) -> tuple:
    """(B, capacity, trailing bucket, dtype, statics, sampled, cp tree)."""
    b, t = state["trailing"].shape[:2]
    return (b, statics.capacity, t, state["h_last"].dtype, statics, sampled,
            id(cp_params["norm"]["w"]))


# _LOCK guards every pool's lookup, lease and growth: a graph is leased to
# one state at a time. It is never held during a capture, so a bind of a
# captured key (a service worker's, switching between its greedy and
# sampled graphs) never waits for another thread's capture. _CAPTURE_LOCK
# lets one capture run at a time, and a key is captured only when, with
# it held, none of the key's graphs is free. The release (a finalizer,
# which may run inside either lock on the thread holding it) is one
# attribute store and takes no lock. Lock order: _CAPTURE_LOCK, then _LOCK.
_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()


def _lease(pool: list):
    """A free graph of `pool`, leased; None if none is free. Under _LOCK."""
    g = next((x for x in pool if x.free), None)
    if g is not None:
        g.free = False
    return g


def capture(params: dict, cp_params: dict, template: dict, statics, sampled: bool):
    """Capture a graph of `template`'s key unless the pool already holds
    one, ahead of traffic (a service's warmup captures every key it can
    reach, so its traffic never captures). Returns the pool's first graph
    of the key. CUDA only."""
    params, cp_params = _drop_kernel(params), _drop_kernel(cp_params)
    key = graph_key(cp_params, template, statics, sampled)
    with _CAPTURE_LOCK:
        with _LOCK:
            pool = graphs(params).setdefault(key, [])
            if pool:
                return pool[0]
        g = LockstepGraph(params, cp_params, template, statics, sampled, key)
        with _LOCK:
            pool.append(g)
        return g


def bind(params: dict, cp_params: dict, state: dict, statics, sampled: bool) -> ServingState:
    """On CUDA, `state` as a ServingState over the static buffers of a
    graph of its key (its values copied in), captured now if no free graph
    of that key exists. The graph is leased to the returned state until
    that state is dropped. Use the returned state from here on. On the CPU
    `state` comes back unchanged. The copy is queued on the caller's
    current stream, behind the work that made `state`; a state's replays
    and in-place edits must stay on that stream."""
    if not state["logits"].is_cuda:
        return state if isinstance(state, ServingState) else ServingState(state)
    params, cp_params = _drop_kernel(params), _drop_kernel(cp_params)
    key = graph_key(cp_params, state, statics, sampled)
    g = getattr(state, "graph", None)
    if g is not None and g.key == key:
        return state
    with _LOCK:
        pool = graphs(params).setdefault(key, [])
        g = _lease(pool)
    if g is None:
        with _CAPTURE_LOCK:
            with _LOCK:  # freed while this thread waited for the capture lock?
                g = _lease(pool)
            if g is None:
                g = LockstepGraph(params, cp_params, state, statics, sampled, key)
                g.free = False
                with _LOCK:
                    pool.append(g)
    _copy_into(g.buffers, state)
    out = ServingState(g.buffers, graph=g)
    weakref.finalize(out, setattr, g, "free", True)
    return out


def decode_chunk_serving(params: dict, cp_params: dict, state: dict, temperature,
                         statics: gen_mod.GenStatics):
    """statics.chunk_steps lockstep steps for B streams, queued with no host
    sync. `temperature`: a shared float or one per stream. On CUDA each step
    replays the state's bound graph (bind); on the CPU it runs eagerly.
    Returns (frames [B, chunk, 16] int64 (-1 where a stream emitted
    nothing), counts [B], eos [B], state) as device tensors; use the
    returned state from here on."""
    b = state["logits"].shape[0]
    temps = _host_temps(temperature, b)
    sampled = bool((temps > 0).any())
    state = bind(params, cp_params, state, statics, sampled)
    out = torch.empty(b, statics.chunk_steps, state["frame"].shape[1], dtype=torch.int64,
                      device=state["frame"].device)
    if state.graph is not None:
        state.graph.set_temps(temps)
        step = state.graph.replay
    else:
        p, cp, t = _drop_kernel(params), _drop_kernel(cp_params), torch.from_numpy(temps)

        def step():
            lockstep_step(p, cp, state, t, statics, sampled)

    for i in range(statics.chunk_steps):
        step()
        out[:, i].copy_(state["frame"])
    return out, (out[..., 0] >= 0).sum(1), state["eos"].clone(), state


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _pad_prompts(prompt_datas: list, p_bucket: int, t_bucket: int):
    """(embeds [B, P, H], trailing [B, T, H], lengths, totals) of prompts
    padded with zeros to the buckets, on the prompts' device."""
    e0 = prompt_datas[0].input_embeds
    b, hdim = len(prompt_datas), e0.shape[2]
    embeds = torch.zeros(b, p_bucket, hdim, dtype=e0.dtype, device=e0.device)
    trailing = torch.zeros(b, t_bucket, hdim, dtype=e0.dtype, device=e0.device)
    lengths, totals = [], []
    for i, pd in enumerate(prompt_datas):
        p, t = pd.input_embeds.shape[1], pd.trailing_hidden.shape[1]
        embeds[i, :p] = pd.input_embeds[0]
        trailing[i, :t] = pd.trailing_hidden[0]
        lengths.append(p)
        totals.append(t)
    return (embeds, trailing, _device_ints(lengths, e0.device),
            _device_ints(totals, e0.device))


def generate_codes_batched(params: dict, cp_params: dict, config: Qwen3TTSConfig,
                           prompt_datas: list, *, temperature: float = 0.9,
                           max_tokens: int = 1200, chunk_steps: int = 48,
                           seed: int = 0) -> list[np.ndarray]:
    """Serve B prompts concurrently (all padded to one bucket); returns each
    stream's raw frames [T_i, 16] int32. Stream i draws with seed + i."""
    b = len(prompt_datas)
    p_bucket = gen_mod.pick_bucket(max(pd.input_embeds.shape[1] for pd in prompt_datas))
    t_bucket = gen_mod.pick_bucket(max(pd.trailing_hidden.shape[1] for pd in prompt_datas),
                                   gen_mod.TRAILING_BUCKETS)
    embeds, trailing, lengths, totals = _pad_prompts(prompt_datas, p_bucket, t_bucket)
    statics = gen_mod.GenStatics(config=config, capacity=p_bucket + gen_mod.RING_SLACK,
                                 chunk_steps=chunk_steps, track_cp_penalty=False)
    state = prefill_batched(params, embeds, lengths, trailing, totals,
                            prompt_datas[0].tts_pad_embed,
                            _device_ints(range(seed, seed + b), embeds.device), statics)
    results: list[list[np.ndarray]] = [[] for _ in range(b)]
    emitted = 0
    ng = config.code_predictor_config.num_code_groups
    while emitted < max_tokens:
        frames, _counts, eos, state = decode_chunk_serving(params, cp_params, state,
                                                           temperature, statics)
        host = _to_host(torch.cat([frames.reshape(-1), eos.long()]))()
        frames_np = host[:-b].reshape(b, chunk_steps, ng)
        for i in range(b):
            valid = frames_np[i][frames_np[i][:, 0] >= 0]
            if len(valid):
                results[i].append(valid.astype(np.int32))
        emitted += chunk_steps
        if host[-b:].all():
            break
    return [np.concatenate(r)[:max_tokens] if r else np.zeros((0, ng), np.int32)
            for r in results]


# ---------------------------------------------------------------------------
# Continuous batching: admit a fresh utterance into a finished stream slot
# ---------------------------------------------------------------------------


def admit_stream(state: dict, idx: int, fresh: dict, statics: gen_mod.GenStatics,
                 src: int = 0) -> dict:
    """Replace row `idx` of a running state, in place, with row `src` of a
    freshly prefilled state (a burst's full-B prefill admits each of its
    rows by `src`). The shared ring cursor sits at (p_pad + step) %
    capacity while the fresh prefill wrote its prompt at slots [0, p_pad);
    attention masks on absolute positions, so rolling the fresh row by
    step % capacity makes its prompt end one slot before the cursor. The
    row's position base becomes fresh length - step, so positions = lengths
    + step give its own absolute positions, and start_step = step keeps its
    trim schedule and draws its own. Returns `state`."""
    cap = statics.capacity
    step = state["step"]
    dev = step.device
    order = (torch.arange(cap, device=dev) - step % cap) % cap  # jnp.roll by step % cap
    c, fc = state["cache"], fresh["cache"]
    c["k"][:, idx].copy_(fc["k"][:, src].index_select(2, order))
    c["v"][:, idx].copy_(fc["v"][:, src].index_select(2, order))
    c["pos"][idx].copy_(fc["pos"][src].index_select(0, order))
    for key in ("h_last", "logits", "seen_code0", "trailing", "total_texts", "seeds"):
        state[key][idx].copy_(fresh[key][src])
    state["lengths"][idx].copy_(fresh["lengths"][src] - step)
    state["start_step"][idx].copy_(step)
    for key in ("window_start", "trailing_idx", "consecutive_pad"):
        state[key][idx].fill_(0)
    state["eos"][idx].fill_(False)
    state["frame"][idx].fill_(-1)
    return state


def concat_states(states: list[dict]) -> ServingState:
    """One B = len(states) state from B = 1 states of prefill_batched.
    step and p_pad must match and stay shared (a mixed step would corrupt
    the shared ring cursor); the cache's batch axis is 1 for k / v."""
    first = states[0]
    for i, s in enumerate(states[1:], 1):
        for field in ("step", "p_pad"):
            if int(s[field]) != int(first[field]):
                raise ValueError(
                    f"concat_states: states[{i}][{field!r}]={int(s[field])} != "
                    f"states[0][{field!r}]={int(first[field])}; mixed-step concatenation "
                    "would corrupt the shared ring cursor")
    out = ServingState(first)
    out["cache"] = {
        "k": torch.cat([s["cache"]["k"] for s in states], dim=1),
        "v": torch.cat([s["cache"]["v"] for s in states], dim=1),
        "pos": torch.cat([s["cache"]["pos"] for s in states], dim=0),
    }
    for key in ("h_last", "logits", "lengths", "window_start", "trailing_idx", "start_step",
                "consecutive_pad", "eos", "seen_code0", "trailing", "total_texts", "seeds",
                "frame"):
        out[key] = torch.cat([s[key] for s in states], dim=0)
    for key in ("step", "p_pad"):
        out[key] = first[key].clone()
    return out


def park_slot(state: dict, idx: int) -> dict:
    """Force row `idx` to EOS and blank its cache validity, in place: a
    request that ended on the host side (max_tokens) without codec EOS must
    not keep costing emit-path work."""
    state["eos"][idx].fill_(True)
    state["cache"]["pos"][idx].fill_(-1)
    return state


def parked_state(reference: dict) -> ServingState:
    """A single-slot state already at EOS, for padding slots: its cache is
    all masked (pos = -1), so its attention is finite garbage never read.
    Shares step, p_pad and tts_pad_embed with `reference`."""
    z = ServingState({k: torch.zeros_like(v) for k, v in reference.items() if k != "cache"})
    z["cache"] = {k: torch.zeros_like(v) for k, v in reference["cache"].items()}
    z["cache"]["pos"].fill_(-1)
    z["eos"].fill_(True)
    z["frame"].fill_(-1)
    for key in ("step", "p_pad", "tts_pad_embed"):
        z[key] = reference[key]
    return z


@dataclasses.dataclass
class ServedChunk:
    """One streamed audio chunk from serve_audio (the continuous-batching
    counterpart of pipeline.AudioChunk)."""

    request: int  # index into prompt_datas
    samples: np.ndarray  # float32 in [-1, 1]
    token_range: tuple[int, int]
    is_final: bool


class _RowPacker:
    """Buffer-and-batch of vocoder rows: fixed-width [left_context +
    decode_chunk] rows with carried left context, zero END padding
    (transparent by the vocoder's causality), and per-key sent-frame
    accounting. `first_chunk` (< decode_chunk) ships a stream's FIRST row as
    soon as that many frames are buffered; later rows keep the decode_chunk
    cadence, the second one carrying only the frames shipped before as
    context."""

    def __init__(self, ng: int, decode_chunk: int, left_context: int,
                 first_chunk: int | None = None):
        if first_chunk is not None and not 1 <= first_chunk <= decode_chunk:
            raise ValueError(f"first_chunk must be in [1, decode_chunk], got {first_chunk}")
        self.ng = ng
        self.decode_chunk = decode_chunk
        self.left = left_context
        self.first_chunk = first_chunk
        self.width = left_context + decode_chunk
        self._buf: dict = {}
        self._ctx: dict = {}
        self._sent: dict = {}

    def sent(self, key) -> int:
        """Frames whose audio has been packed into rows for `key`."""
        return self._sent.get(key, 0)

    def drop(self, key) -> None:
        """Forget a request's buffered frames, keeping its sent count."""
        self._buf.pop(key, None)
        self._ctx.pop(key, None)

    def release(self, key) -> None:
        """Forget a request entirely, once no more chunks will be emitted."""
        self.drop(key)
        self._sent.pop(key, None)

    def _mk_row(self, key, frames: np.ndarray, final: bool):
        ctx = self._ctx.get(key)
        drop = 0 if ctx is None else len(ctx)
        row = np.zeros((self.width, self.ng), np.int32)
        if drop:
            row[:drop] = ctx
        row[drop: drop + len(frames)] = frames
        joined = np.concatenate([ctx, frames]) if ctx is not None else frames
        self._ctx[key] = joined[-self.left:]
        start = self._sent.get(key, 0)
        self._sent[key] = start + len(frames)
        return (key, row, drop, len(frames), (start, start + len(frames)), final)

    def feed(self, key, valid: np.ndarray, done: bool):
        """Append `valid` (already filtered) frames and pop every ready row
        (and a short final row when `done` leaves a remainder). Returns
        (rows, empty_final): empty_final means the stream ended with nothing
        buffered and the caller owes an empty is_final chunk at
        self.sent(key)."""
        rows = []
        buf = self._buf.get(key)
        buf = np.concatenate([buf, valid]) if buf is not None and len(buf) else valid
        while len(buf) >= self.decode_chunk:
            rows.append(self._mk_row(key, buf[: self.decode_chunk], False))
            buf = buf[self.decode_chunk:]
        if (not done and self.first_chunk is not None and self._sent.get(key, 0) == 0
                and len(buf) >= self.first_chunk):
            rows.append(self._mk_row(key, buf, False))
            buf = buf[len(buf):]
        empty_final = False
        if done:
            if len(buf):
                rows.append(self._mk_row(key, buf, True))
            else:
                empty_final = True
            self.drop(key)
        else:
            self._buf[key] = buf
        return rows, empty_final


def vocode_rows_dispatch(rows, batch_size: int, vocoder_params: dict, decoder_cfg, ng: int,
                         width: int):
    """Queue the batched fixed-shape vocoder calls of _RowPacker rows
    ([batch_size, nq, width] each) and the PCM's copy to the host, without
    waiting: returns [(pull, group), ...]. Each output is trimmed on the
    device to the frames its rows hold before the copy."""
    spf = decoder_cfg.total_upsample
    dev = vocoder_params["quantizer"]["semantic"]["codebooks"].device
    out = []
    for g0 in range(0, len(rows), batch_size):
        group = rows[g0: g0 + batch_size]
        batch = np.zeros((batch_size, ng, width), np.int64)
        need = 1
        for i, (_key, row, drop, m, _tr, _f) in enumerate(group):
            batch[i] = row.T
            need = max(need, drop + m)
        codes = torch.from_numpy(batch)
        if dev.type == "cuda":
            codes = codes.pin_memory().to(dev, non_blocking=True)
        wav = voc.decode_frames(vocoder_params, codes, decoder_cfg)
        out.append((_to_host(wav[:, : need * spf].contiguous()), group))
    return out


def resolve_vocoded(dispatched, spf: int):
    """Wait for dispatched vocoder batches and yield (key, samples float32
    in [-1, 1], token_range, is_final) per row, the context frames' samples
    dropped and NaN / Inf scrubbed."""
    for pull, group in dispatched:
        wav = pull()
        for i, (key, _row, drop, m, t_range, final) in enumerate(group):
            yield key, sanitize_samples(wav[i, drop * spf: (drop + m) * spf]), t_range, final


def vocode_rows(rows, batch_size: int, vocoder_params: dict, decoder_cfg, ng: int,
                width: int):
    """Synchronous vocode_rows_dispatch + resolve_vocoded."""
    yield from resolve_vocoded(
        vocode_rows_dispatch(rows, batch_size, vocoder_params, decoder_cfg, ng, width),
        decoder_cfg.total_upsample)


class ContinuousServer:
    """Continuous batching: B slots decode in lockstep, finished utterances
    drain and queued prompts are admitted into freed slots mid-flight, with
    no batch restart. Request r draws with seed + r.

    Each decode chunk is queued before the host waits on the previous one's
    frames (depth-1 prefetch), and an admission's prefill is queued behind
    the chunk in flight and applied one chunk later.

        server = ContinuousServer(params, cp_params, config, batch_size=8)
        frames = server.run(prompt_datas, temperature=0.9, max_tokens=600)
        for chunk in server.serve_audio(prompt_datas, vocoder_params, dec_cfg):
            play(chunk.request, chunk.samples)
    """

    def __init__(self, params: dict, cp_params: dict, config: Qwen3TTSConfig, *,
                 batch_size: int = 8, prompt_bucket: int | None = None,
                 trailing_bucket: int | None = None, chunk_steps: int = 48, seed: int = 0):
        self.params = _drop_kernel(params)
        self.cp_params = _drop_kernel(cp_params)
        self.config = config
        self.batch_size = batch_size
        self.prompt_bucket = prompt_bucket or gen_mod.PROMPT_BUCKETS[2]
        self.trailing_bucket = trailing_bucket or gen_mod.TRAILING_BUCKETS[1]
        self.statics = gen_mod.GenStatics(
            config=config, capacity=self.prompt_bucket + gen_mod.RING_SLACK,
            chunk_steps=chunk_steps, track_cp_penalty=False)
        self._seed = seed

    def _prefill_one(self, pd, seed: int) -> ServingState:
        p, t = pd.input_embeds.shape[1], pd.trailing_hidden.shape[1]
        if p > self.prompt_bucket or t > self.trailing_bucket:
            raise ValueError(f"prompt ({p}/{t}) exceeds server buckets "
                             f"({self.prompt_bucket}/{self.trailing_bucket})")
        e, tr, _, _ = _pad_prompts([pd], self.prompt_bucket, self.trailing_bucket)
        dev = e.device

        def one(v):
            return torch.full((1,), v, dtype=torch.int64, device=dev)

        return prefill_batched(self.params, e, one(p), tr, one(t), pd.tts_pad_embed, one(seed),
                               self.statics)

    def _event_stream(self, prompt_datas: list, *, temperature: float, max_tokens: int):
        """The continuous-batching loop: yields, once per decode chunk, a list
        of events (request index, valid frames [m, 16] int32, done).

        Per iteration i (handling chunk i): apply the parks and admissions
        decided at i - 1 to the state chunk i left; queue chunk i + 1; wait
        for chunk i's frames and eos; emit events; for each finished slot
        queue the replacement's prefill (behind chunk i + 1) and defer its
        admission. A slot admitted at i emits from chunk i + 2 on, so its
        eos flag is ignored until active_from[slot]."""
        n = len(prompt_datas)
        if n == 0:
            return
        b = self.batch_size
        ng = self.config.code_predictor_config.num_code_groups
        queue = list(range(n))
        emitted = [0] * n
        slot_req: list[int | None] = []
        active_from = [0] * b
        states = []
        for _slot in range(b):
            if queue:
                req = queue.pop(0)
                slot_req.append(req)
                states.append(self._prefill_one(prompt_datas[req], self._seed + req))
            else:
                slot_req.append(None)
                states.append(parked_state(states[0]))
        state = concat_states(states)
        del states

        def dispatch(state):
            frames, _counts, eos, state = decode_chunk_serving(
                self.params, self.cp_params, state, temperature, self.statics)
            return _to_host(torch.cat([frames.reshape(-1), eos.long()])), state

        pending_admits: list[tuple[int, dict]] = []
        pending_parks: list[int] = []
        pending, state = dispatch(state)
        it = 0
        while True:
            pull = pending
            for slot in pending_parks:
                park_slot(state, slot)
            pending_parks = []
            for slot, fresh in pending_admits:
                admit_stream(state, slot, fresh, self.statics)
            pending_admits = []
            pending = None
            if any(r is not None for r in slot_req):
                pending, state = dispatch(state)
            host = pull()  # waits for chunk `it` only
            frames_np = host[:-b].reshape(b, -1, ng)
            eos_np = host[-b:].astype(bool)

            events: list[tuple[int, np.ndarray, bool]] = []
            for slot in range(b):
                req = slot_req[slot]
                if req is None or it < active_from[slot]:
                    continue  # parked, or admitted and not decoding yet
                valid = frames_np[slot][frames_np[slot][:, 0] >= 0].astype(np.int32)
                take = max(0, min(len(valid), max_tokens - emitted[req]))
                valid = valid[:take]
                emitted[req] += take
                done = bool(eos_np[slot]) or emitted[req] >= max_tokens
                events.append((req, valid, done))
                if done:
                    slot_req[slot] = None
                    if queue:
                        new_req = queue.pop(0)
                        slot_req[slot] = new_req
                        active_from[slot] = it + 2
                        pending_admits.append(
                            (slot, self._prefill_one(prompt_datas[new_req],
                                                     self._seed + new_req)))
                    elif not bool(eos_np[slot]):
                        # ended by max_tokens with no stream to replace it:
                        # park the row, or it keeps costing decode work
                        pending_parks.append(slot)
            yield events
            it += 1
            if pending is None:
                return

    def run(self, prompt_datas: list, *, temperature: float = 0.9,
            max_tokens: int = 1200) -> list[np.ndarray]:
        """Serve every prompt; returns each one's raw frames [T_i, 16]."""
        results: list[list[np.ndarray]] = [[] for _ in prompt_datas]
        for events in self._event_stream(prompt_datas, temperature=temperature,
                                         max_tokens=max_tokens):
            for req, valid, _done in events:
                if len(valid):
                    results[req].append(valid)
        ng = self.config.code_predictor_config.num_code_groups
        return [np.concatenate(r) if r else np.zeros((0, ng), np.int32) for r in results]

    def serve_audio(self, prompt_datas: list, vocoder_params: dict, decoder_cfg, *,
                    temperature: float = 0.9, max_tokens: int = 1200, decode_chunk: int = 18,
                    left_context: int = 8, first_decode_chunk: int | None = None):
        """Continuous batching that yields audio while decoding goes on:
        ServedChunks per stream, the vocoder batched across streams on ready
        rows of decode_chunk frames with left_context frames of context.
        Every vocoder call is [batch_size, nq, left_context + decode_chunk]:
        the vocoder is causal, so rows shorter than the window are
        zero-padded at the END and the extra samples dropped.

        A boundary's PCM is pulled at the next boundary, so its copy runs
        under the next decode chunk; a boundary that carries a stream's
        first audio ships at once. A boundary with no rows still ships the
        one deferred before it (the JAX package's serve_audio holds it until
        the next boundary with rows). first_decode_chunk ships each stream's
        first audio after that many frames (with chunk_steps below
        decode_chunk)."""
        ng = self.config.code_predictor_config.num_code_groups
        packer = _RowPacker(ng, decode_chunk, left_context, first_decode_chunk)
        spf = decoder_cfg.total_upsample

        def emit(boundary):
            dispatched, finals_empty = boundary
            for req, samples, t_range, final in resolve_vocoded(dispatched, spf):
                yield ServedChunk(request=req, samples=samples, token_range=t_range,
                                  is_final=final)
                if final:
                    packer.release(req)
            for req, t in finals_empty:
                yield ServedChunk(request=req, samples=np.zeros(0, np.float32),
                                  token_range=(t, t), is_final=True)

        pending_boundary = None
        for events in self._event_stream(prompt_datas, temperature=temperature,
                                         max_tokens=max_tokens):
            rows = []
            finals_empty: list[tuple[int, int]] = []
            for req, valid, done in events:
                r, empty_final = packer.feed(req, gen_mod.filter_valid_frames(valid), done)
                rows.extend(r)
                if empty_final:
                    finals_empty.append((req, packer.sent(req)))
                    packer.release(req)
            if not rows and not finals_empty:
                if pending_boundary is not None:
                    yield from emit(pending_boundary)
                    pending_boundary = None
                continue
            dispatched = vocode_rows_dispatch(rows, self.batch_size, vocoder_params,
                                              decoder_cfg, ng, packer.width)
            if pending_boundary is not None:
                yield from emit(pending_boundary)
                pending_boundary = None
            boundary = (dispatched, finals_empty)
            if any(row[4][0] == 0 for _pull, group in dispatched for row in group):
                yield from emit(boundary)
            else:
                pending_boundary = boundary
        if pending_boundary is not None:
            yield from emit(pending_boundary)
