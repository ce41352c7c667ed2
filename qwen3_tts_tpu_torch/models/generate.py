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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Qwen3TTSConfig
from ..ops.cuda import talker_megakernel as tmk
from ..ops.sampling import NEG_INF, sample_token, talker_valid_mask
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


def prefill(params: dict, prompt_data, config: Qwen3TTSConfig) -> dict:
    """Run the prompt through the talker and build the decode state (a dict
    of device tensors)."""
    embeds = prompt_data.input_embeds
    p = embeds.shape[1]
    dev = embeds.device
    cache = talker_mod.init_kv_cache(config, p + RING_SLACK, 1, embeds.dtype, dev)
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame. Updates `state` in place and returns (frame [16] int64,
    emitted: bool 0-d tensor). After a stop the state keeps advancing but
    nothing more is emitted. `forced_frame` replaces the sampled codes
    (teacher forcing, for step-by-step comparisons)."""
    eos_pad_mask, valid_mask = state["masks"]
    has_text = state["trailing_idx"] < state["total_text"]
    lg = state["logits"] + torch.where(has_text, eos_pad_mask, 0.0)
    code0 = sample_token(
        lg, generator, temperature, seen_mask=state["seen_code0"],
        repetition_penalty=repetition_penalty, valid_mask=valid_mask,
    )
    if forced_frame is not None:
        code0 = forced_frame[0]
    is_pad = code0 == config.codec_pad_id
    consec = torch.where(is_pad, state["consecutive_pad"] + 1, 0)
    stop = (code0 == config.codec_eos_token_id) | (is_pad & (consec > MAX_CONSECUTIVE_PAD))
    emitted = ~state["eos"] & ~stop

    code0_embed = talker_mod.encode_audio(params, code0.reshape(1, 1))
    codes15, embed_sum, seen_cp = cp_mod.predict_frame(
        cp_params, state["h_last"], code0_embed, generator, temperature,
        state["seen_cp"] if track_cp_penalty else None,
        config.code_predictor_config, repetition_penalty=repetition_penalty,
        forced_codes=None if forced_frame is None else forced_frame[1:],
    )
    frame = torch.cat([code0.reshape(1), codes15])
    state["seen_code0"].index_fill_(0, code0.reshape(1), True)

    trailing = state["trailing"]
    t_idx = torch.clamp(state["trailing_idx"], max=trailing.shape[1] - 1)
    text_embed = torch.where(
        has_text, trailing.index_select(1, t_idx.reshape(1)), state["tts_pad_embed"]
    )
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
        logits = talker_mod.codec_head(params, h)[0, 0]
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
):
    """Generator over raw frame chunks [<= chunk_steps, 16] int32 numpy; one
    host sync per chunk."""
    dev = prompt_data.input_embeds.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = prefill(params, prompt_data, config)
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
    """Prefill + chunked decode to completion: raw frames [T, 16] int32
    (pad frames included; callers filter with filter_valid_frames)."""
    chunks = list(stream_codes(params, cp_params, config, prompt_data, **kwargs))
    if not chunks:
        return np.zeros((0, config.code_predictor_config.num_code_groups), np.int32)
    return np.concatenate(chunks, axis=0)


def filter_valid_frames(frames: np.ndarray) -> np.ndarray:
    """Keep frames whose code 0 is a real codebook entry (0 <= code0 < 2048)."""
    if len(frames) == 0:
        return frames
    return frames[(frames[:, 0] >= 0) & (frames[:, 0] < 2048)]
