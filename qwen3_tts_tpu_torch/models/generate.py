"""Autoregressive generation for the talker (counterpart of
qwen3_tts_tpu/models/generate.py).

Prefill runs the prompt once; decoding runs in chunks of `chunk_steps`
frames, each frame being the talker step, code-0 sampling, the 15-group
code-predictor loop, the trailing-text schedule, EOS / consecutive-pad
stopping and the 192-token window trimmed every 15 steps. All of it is
queued on the device with no host sync inside a chunk: the stop condition
is a device flag that freezes the frame count, so frames computed after a
stop within the chunk are dropped. Codes cross to the host once per chunk.

The KV cache is a ring of capacity prompt + RING_SLACK slots whose decode
attention masks keys by absolute position against the window start (the
reference's trim schedule reproduced exactly). With a megakernel tree under
params["kernel"], prefill hands the cache over in K1's layout and each
talker step is one call of K1 (ops/cuda/talker_megakernel.py).

A talker tree placed on a tp mesh (parallel.sharding.shard_params) runs
the same loop on every rank: each keeps the cache of its local KV heads
and sums the row-parallel products over tp inside the talker step, so
every rank holds the same logits and hidden state, and the replicated code
predictor (K2 when cp_params carries "kernel") draws the same codes on
each from the same seed.

stack_states / decode_chunk_batched decode B single-stream states side by
side through the same decode_step, one batched step a frame with every
linear at M = B (the batched serving path, models/serving.py, supersedes
them; tests and the chip smoke run them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Qwen3TTSConfig
from ..ops.cuda import talker_megakernel as tmk
from ..ops.sampling import NEG_INF, gumbel_noise, sample_token, talker_valid_mask
from . import code_predictor as cp_mod
from . import talker as talker_mod

KV_WINDOW = 192
TRIM_INTERVAL = 15
MAX_CONSECUTIVE_PAD = 6
RING_SLACK = 224  # > KV_WINDOW + TRIM_INTERVAL; keeps ring slots collision-free

# Length buckets of the batched serving path (models/serving.py): every
# stream's prompt and trailing text are padded to one bucket, so the ring
# slot is shared and a lockstep step has one shape per bucket pair
PROMPT_BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
TRAILING_BUCKETS = (32, 64, 128, 256, 512, 1024)


def pick_bucket(n: int, buckets=PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


@dataclass(frozen=True)
class GenStatics:
    """Static generation parameters of the batched path (hashable): with
    the batch width and the trailing bucket they key the lockstep step's
    CUDA graph (serving.LockstepGraph)."""

    config: Qwen3TTSConfig
    capacity: int
    chunk_steps: int
    track_cp_penalty: bool
    repetition_penalty: float = 1.05


def prefill(params: dict, prompt_data, config: Qwen3TTSConfig,
            capacity: int | None = None) -> dict:
    """Run the prompt through the talker and build the decode state (a dict
    of device tensors). `capacity`: the ring's slots, at least the prompt's
    length + RING_SLACK (the default); states stacked by stack_states need
    one capacity."""
    embeds = prompt_data.input_embeds
    p = embeds.shape[1]
    dev = embeds.device
    if capacity is None:
        capacity = p + RING_SLACK
    elif capacity < p + RING_SLACK:
        raise ValueError(f"capacity {capacity} < prompt {p} + RING_SLACK {RING_SLACK}")
    cache = talker_mod.init_kv_cache(config, capacity, 1, embeds.dtype, dev,
                                     talker_mod.kv_heads(params, config))
    h_last, cache = talker_mod.talker_prefill(params, embeds, cache, config)
    if "kernel" in params:
        cache = tmk.cache_to_kernel_layout(cache)
    cc = config.code_predictor_config

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return {
        "cache": cache,
        "h_last": h_last,
        "logits": talker_mod.codec_head(params, h_last)[0, 0],
        "total_len": i64(p),
        "window_start": i64(0),
        "step": i64(0),
        "trailing_idx": i64(0),
        "consecutive_pad": i64(0),
        "eos": torch.tensor(False, device=dev),
        "seen_code0": torch.zeros(config.vocab_size, dtype=torch.bool, device=dev),
        "seen_cp": torch.zeros(cc.num_code_groups - 1, cc.vocab_size, dtype=torch.bool,
                               device=dev),
        "trailing": prompt_data.trailing_hidden,
        "total_text": i64(prompt_data.trailing_hidden.shape[1]),
        "tts_pad_embed": prompt_data.tts_pad_embed,
        "masks": step_masks(config, dev),
    }


def step_masks(config: Qwen3TTSConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(eos/pad -inf mask applied while text remains, sampleable-token mask)."""
    valid = talker_valid_mask(config.vocab_size, pad_id=config.codec_pad_id,
                              eos_id=config.codec_eos_token_id, device=device)
    idx = torch.arange(config.vocab_size, device=device)
    eos_pad = torch.where(
        (idx == config.codec_eos_token_id) | (idx == config.codec_pad_id),
        float(NEG_INF), 0.0,
    )
    return eos_pad, valid


def decode_step(
    params: dict,
    cp_params: dict,
    state: dict,
    config: Qwen3TTSConfig,
    *,
    temperature: float,
    generator: torch.Generator | None,
    track_cp_penalty: bool,
    repetition_penalty: float = 1.05,
    forced_frame: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame. Updates `state` in place and returns (frame [16] int64,
    emitted: bool 0-d tensor). After a stop the state keeps advancing but
    nothing more is emitted. `forced_frame` replaces the sampled codes
    (teacher forcing, for step-by-step comparisons).

    A state of B streams (stack_states) steps every stream at once, each
    as it would alone, with every linear at M = B (no megakernel): frame
    [B, 16] and emitted [B]; draws (temperature > 0) come from `noise`
    [B, 16, V] (stream_noise), not from `generator`."""
    stacked = state["logits"].dim() == 2
    eos_pad_mask, valid_mask = state["masks"]
    has_text = state["trailing_idx"] < state["total_text"]
    lg = state["logits"] + torch.where(has_text[..., None], eos_pad_mask, 0.0)
    code0 = sample_token(
        lg, generator, temperature, seen_mask=state["seen_code0"],
        repetition_penalty=repetition_penalty, valid_mask=valid_mask,
        noise=None if noise is None else noise[:, 0, :config.vocab_size],
    )
    if forced_frame is not None:
        code0 = forced_frame[..., 0]
    is_pad = code0 == config.codec_pad_id
    consec = torch.where(is_pad, state["consecutive_pad"] + 1, 0)
    stop = (code0 == config.codec_eos_token_id) | (is_pad & (consec > MAX_CONSECUTIVE_PAD))
    emitted = ~state["eos"] & ~stop

    cc = config.code_predictor_config
    code0_embed = talker_mod.encode_audio(params, code0.reshape(-1, 1))
    seen_cp = state["seen_cp"] if track_cp_penalty else None
    forced_codes = None if forced_frame is None else forced_frame[..., 1:]
    if stacked:
        codes15, embed_sum = cp_mod.predict_frame_batched(
            cp_params, state["h_last"], code0_embed,
            None if noise is None else noise[:, 1:, :cc.vocab_size], temperature, cc,
            forced_codes=forced_codes, seen_cp=seen_cp, repetition_penalty=repetition_penalty,
        )
    else:
        codes15, embed_sum, _ = cp_mod.predict_frame(
            cp_params, state["h_last"], code0_embed, generator, temperature, seen_cp, cc,
            repetition_penalty=repetition_penalty, forced_codes=forced_codes,
        )
    frame = torch.cat([code0[..., None], codes15], dim=-1)
    state["seen_code0"].scatter_(-1, code0[..., None], True)

    trailing = state["trailing"]
    b, _, hdim = trailing.shape
    t_idx = torch.clamp(state["trailing_idx"], max=trailing.shape[1] - 1).reshape(b, 1, 1)
    text_embed = torch.where(has_text.reshape(b, 1, 1),
                             trailing.gather(1, t_idx.expand(b, 1, hdim)),
                             state["tts_pad_embed"])
    input_embed = (text_embed + embed_sum).to(state["h_last"].dtype)
    if "kernel" in params:
        cos, sin = talker_mod.rope_cos_sin(config, state["total_len"].reshape(1, 1))
        h, logits, cache = tmk.talker_step(
            params["kernel"], input_embed, state["cache"], state["total_len"],
            state["window_start"], cos[0, 0], sin[0, 0], config,
        )
    else:
        h, cache = talker_mod.talker_decode_step(
            params, input_embed, state["cache"], state["total_len"], state["window_start"],
            config,
        )
        logits = talker_mod.codec_head(params, h)[:, 0].reshape(state["logits"].shape)
    total_len = state["total_len"] + 1
    step = state["step"] + 1
    state.update(
        cache=cache,
        h_last=h,
        logits=logits,
        total_len=total_len,
        step=step,
        window_start=torch.where(
            step % TRIM_INTERVAL == 0,
            torch.maximum(state["window_start"], total_len - KV_WINDOW),
            state["window_start"],
        ),
        trailing_idx=state["trailing_idx"] + has_text.long(),
        consecutive_pad=consec,
        eos=state["eos"] | stop,
    )
    return frame, emitted


def decode_chunk(
    params: dict,
    cp_params: dict,
    state: dict,
    config: Qwen3TTSConfig,
    *,
    steps: int,
    temperature: float,
    generator: torch.Generator | None,
    track_cp_penalty: bool,
    repetition_penalty: float = 1.05,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to `steps` frames, queued on the device without a host sync.
    Returns (frames [steps, 16] int64, count, eos) as device tensors; rows
    at and past `count` are not part of the output."""
    frames, count = [], torch.zeros((), dtype=torch.int64, device=state["logits"].device)
    for _ in range(steps):
        frame, emitted = decode_step(
            params, cp_params, state, config, temperature=temperature,
            generator=generator, track_cp_penalty=track_cp_penalty,
            repetition_penalty=repetition_penalty,
        )
        frames.append(frame)
        count = count + emitted.long()
    return torch.stack(frames), count, state["eos"]


def stream_codes(
    params: dict,
    cp_params: dict,
    config: Qwen3TTSConfig,
    prompt_data,
    *,
    temperature: float = 0.9,
    max_tokens: int = 1200,
    chunk_steps: int = 48,
    track_cp_penalty: bool = True,
    repetition_penalty: float = 1.05,
    seed: int = 0,
    initial_state: dict | None = None,
):
    """Generator over raw frame chunks [<= chunk_steps, 16] int32 numpy; one
    host sync per chunk. `initial_state`: a prefill() result of this
    prompt_data to decode from instead of prefilling here (io/verify.py
    checksums the prefill and then resumes from it, so the prompt runs
    once); it is advanced in place."""
    dev = prompt_data.input_embeds.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = initial_state if initial_state is not None else prefill(params, prompt_data, config)
    emitted = 0
    while emitted < max_tokens:
        steps = min(chunk_steps, max_tokens - emitted)
        frames, count, eos = decode_chunk(
            params, cp_params, state, config, steps=steps, temperature=temperature,
            generator=generator, track_cp_penalty=track_cp_penalty,
            repetition_penalty=repetition_penalty,
        )
        host = torch.cat([count.reshape(1), eos.reshape(1).long(), frames.reshape(-1)]).cpu()
        count, eos = int(host[0]), bool(host[1])
        if count > 0:
            emitted += count
            yield host[2:].reshape(steps, -1)[:count].numpy().astype(np.int32)
        if eos:
            break


def generate_codes(params: dict, cp_params: dict, config: Qwen3TTSConfig, prompt_data,
                   **kwargs) -> np.ndarray:
    """Prefill (or `initial_state=`) + chunked decode to completion: raw
    frames [T, 16] int32 (pad frames included; callers filter with
    filter_valid_frames)."""
    chunks = list(stream_codes(params, cp_params, config, prompt_data, **kwargs))
    if not chunks:
        return np.zeros((0, config.code_predictor_config.num_code_groups), np.int32)
    return np.concatenate(chunks, axis=0)


def filter_valid_frames(frames: np.ndarray) -> np.ndarray:
    """Keep frames whose code 0 is a real codebook entry (0 <= code0 < 2048)."""
    if len(frames) == 0:
        return frames
    return frames[(frames[:, 0] >= 0) & (frames[:, 0] < 2048)]


# ---------------------------------------------------------------------------
# Several streams side by side
# ---------------------------------------------------------------------------


def stack_states(states: list[dict], config: Qwen3TTSConfig | None = None) -> dict:
    """Stack B single-stream decode states (prefill's, all with one ring
    capacity) on a stream axis for decode_chunk_batched: the caches as
    {"k", "v": [L, B, Hkv, C, D], "pos": [B, C]}, each per-stream value with
    a leading [B], the trailing text zero-padded to the longest (a stream
    reads only its own rows). A state in K1's ring layout ("k2") is
    converted to the plain k / v layout here, which needs `config`; the
    batched decode refuses that layout."""
    caches = []
    for st in states:
        cache = st["cache"]
        if "k2" in cache:
            if config is None:
                raise ValueError("states carry the megakernel cache layout; pass config= "
                                 "to stack_states so it converts them")
            cache = tmk.kernel_layout_to_cache(cache, config)
        caches.append(cache)
    if len({c["pos"].shape[0] for c in caches}) != 1:
        raise ValueError("stacked states need one ring capacity: prefill them with one "
                         "capacity=")
    t_max = max(st["trailing"].shape[1] for st in states)
    out = {
        "cache": {"k": torch.cat([c["k"] for c in caches], dim=1),
                  "v": torch.cat([c["v"] for c in caches], dim=1),
                  "pos": torch.stack([c["pos"] for c in caches])},
        "trailing": torch.cat([torch.nn.functional.pad(
            st["trailing"], (0, 0, 0, t_max - st["trailing"].shape[1])) for st in states]),
        "masks": states[0]["masks"],
    }
    for key in ("h_last", "tts_pad_embed"):
        out[key] = torch.cat([st[key] for st in states])
    for key in ("logits", "total_len", "window_start", "step", "trailing_idx",
                "consecutive_pad", "eos", "seen_code0", "seen_cp", "total_text"):
        out[key] = torch.stack([st[key] for st in states])
    return out


def stream_noise(generators: list[torch.Generator], config: Qwen3TTSConfig,
                 device) -> torch.Tensor:
    """One frame's Gumbel draws for B streams [B, 16, V], each from its own
    generator in decode_step's order (code 0's, then each group's), so a
    stream of a stacked state draws what it would alone."""
    cc = config.code_predictor_config
    out = torch.zeros(len(generators), cc.num_code_groups,
                      max(config.vocab_size, cc.vocab_size), device=device)
    for i, g in enumerate(generators):
        out[i, 0, :config.vocab_size] = gumbel_noise((config.vocab_size,), g, device)
        for k in range(1, cc.num_code_groups):
            out[i, k, :cc.vocab_size] = gumbel_noise((cc.vocab_size,), g, device)
    return out


def decode_chunk_batched(
    params: dict,
    cp_params: dict,
    states: dict,
    config: Qwen3TTSConfig,
    *,
    steps: int,
    temperature: float,
    generators: list[torch.Generator] | None = None,
    track_cp_penalty: bool,
    repetition_penalty: float = 1.05,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """decode_chunk for the B streams of `states` (stack_states): decode_step
    on the stacked state, one batched step a frame. The megakernels are
    B = 1 launches, so they are dropped and every linear runs at M = B: K3
    on int8 entries, K7 on packed ones, the `w8r` product on the
    megakernels' rowwise weights. A stream that stopped stays parked (it
    computes on and emits nothing). Draws (temperature > 0) come from
    `generators`, one a stream (stream_noise). Updates `states` in place;
    returns (frames [B, steps, 16] int64, counts [B], eos [B]) as device
    tensors."""
    if "k2" in states["cache"]:
        raise ValueError("kernel-layout states must be converted first: "
                         "stack_states(states, config)")
    params = {k: v for k, v in params.items() if k != "kernel"}
    cp_params = {k: v for k, v in cp_params.items() if k != "kernel"}
    b = states["logits"].shape[0]
    dev = states["logits"].device
    if temperature > 0 and (generators is None or len(generators) != b):
        raise ValueError(f"temperature > 0 needs one generator per stream ({b})")
    frames, count = [], torch.zeros(b, dtype=torch.int64, device=dev)
    for _ in range(steps):
        frame, emitted = decode_step(
            params, cp_params, states, config, temperature=temperature, generator=None,
            track_cp_penalty=track_cp_penalty, repetition_penalty=repetition_penalty,
            noise=stream_noise(generators, config, dev) if temperature > 0 else None,
        )
        frames.append(frame)
        count = count + emitted.long()
    return torch.stack(frames, dim=1), count, states["eos"]
