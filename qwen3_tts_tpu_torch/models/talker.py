"""Qwen3-TTS talker: the 28-layer decoder over summed text + codec
embeddings (counterpart of qwen3_tts_tpu/models/talker.py).

Layer weights are stacked on a leading layer axis; the KV cache is a
preallocated ring {"k", "v": [L, B, Hkv, C, D], "pos": [C]} written in place
at slot position % C (streams side by side keep "pos" [B, C] and a position
each), and decode attention masks keys by absolute position against the
window start (the reference's 192-token trim schedule). RMSNorm
runs in fp32; q/k get a per-head RMSNorm before RoPE; interleaved MRoPE when
config.mrope_section is set.

A tree placed on a mesh by parallel.sharding.shard_params runs
tensor-parallel: every function here computes on the rank's local shards
(sharding.local_params), with num_attention_heads / tp and
num_key_value_heads / tp heads, a KV cache of the local KV heads, and the
row-parallel o_proj and down_proj outputs summed over tp (decoder_layers,
the one layer body of prefill, serving's batched prefill and decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Qwen3TTSConfig
from ..ops import rope as rope_ops
from ..ops.attention import causal_mask, gqa_attention_decode, gqa_attention_full
from ..ops.linear import embedding_lookup, linear
from ..ops.norms import rms_norm
from ..ops.sampling import NEG_INF
from ..parallel.sharding import Parallel, local_params


def _layer(params: dict, i: int) -> dict:
    """Layer i's slice of a stacked layer tree (any depth: the
    tensor-parallel layout nests q / k / v and gate / up one level more)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def text_projection(params: dict, x: torch.Tensor) -> torch.Tensor:
    _, params = local_params(params)
    h = F.silu(linear(params["text_projection"]["fc1"], x))
    return linear(params["text_projection"]["fc2"], h)


def encode_text(params: dict, ids: torch.Tensor) -> torch.Tensor:
    _, params = local_params(params)
    dtype = params["norm"]["w"].dtype
    return text_projection(params, embedding_lookup(params["text_embedding"], ids, dtype))


def encode_audio(params: dict, ids: torch.Tensor) -> torch.Tensor:
    _, params = local_params(params)
    return embedding_lookup(params["codec_embedding"], ids, params["norm"]["w"].dtype)


def codec_head(params: dict, h: torch.Tensor) -> torch.Tensor:
    _, params = local_params(params)
    return linear(params["codec_head"], h).float()


def kv_heads(params: dict, config: Qwen3TTSConfig) -> int:
    """The KV heads this rank holds: all of them, or 1 / tp of them for a
    tree placed on a tp mesh."""
    return config.num_key_value_heads // local_params(params)[0].tp_size


def init_kv_cache(config: Qwen3TTSConfig, capacity: int, batch: int = 1,
                  dtype=torch.float32, device=None, kv_heads: int | None = None) -> dict:
    """An empty ring of `kv_heads` KV heads (default: all; a tp rank's
    cache holds its local ones, talker.kv_heads)."""
    nkv = config.num_key_value_heads if kv_heads is None else kv_heads
    shape = (config.num_hidden_layers, batch, nkv, capacity, config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int64, device=device),
    }


def rope_cos_sin(config: Qwen3TTSConfig, positions: torch.Tensor):
    """cos/sin [B, L, head_dim] for absolute positions [B, L]."""
    inv = rope_ops.inv_freq_tensor(config.head_dim, config.rope_theta, positions.device)
    if config.mrope_section is not None:
        return rope_ops.mrope_cos_sin(positions, inv, config.mrope_section)
    return rope_ops.rope_cos_sin(positions, inv)


def layer_qkv(lp: dict, x: torch.Tensor, cos, sin, nq: int, nkv: int, hd: int,
              eps: float):
    """q [B, Hq, L, D], k/v [B, Hkv, L, D] for one layer: fused qkv
    ({"qkv_proj": entry}, one matmul and a split), or the tensor-parallel
    layout ({"qkv_proj": {"q", "k", "v"}}, parallel/sharding.py), where a tp
    split of each section's rows lands on head boundaries."""
    b, l, _ = x.shape
    qp = lp["qkv_proj"]
    if "q" in qp:
        q = linear(qp["q"], x).reshape(b, l, nq, hd)
        k = linear(qp["k"], x).reshape(b, l, nkv, hd)
        v = linear(qp["v"], x).reshape(b, l, nkv, hd)
    else:
        qkv = linear(qp, x)
        q = qkv[..., : nq * hd].reshape(b, l, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, l, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(b, l, nkv, hd)
    q = rms_norm(q, lp["q_norm"]["w"], eps).transpose(1, 2)
    k = rms_norm(k, lp["k_norm"]["w"], eps).transpose(1, 2)
    v = v.transpose(1, 2)
    c, s = cos[:, None], sin[:, None]
    return rope_ops.apply_rope(q, c, s), rope_ops.apply_rope(k, c, s), v


def swiglu(lp: dict, x: torch.Tensor, inter: int) -> torch.Tensor:
    """SwiGLU over fused gate/up ({"gateup_proj": entry}) or the
    tensor-parallel layout ({"gateup_proj": {"gate", "up"}})."""
    gp = lp["gateup_proj"]
    if "gate" in gp:
        return F.silu(linear(gp["gate"], x)) * linear(gp["up"], x)
    gu = linear(gp, x)
    return F.silu(gu[..., :inter]) * gu[..., inter:]


def decoder_layers(params: dict, h: torch.Tensor, cos, sin, attend, config: Qwen3TTSConfig,
                   par: Parallel) -> torch.Tensor:
    """The talker's layers and final norm over h [B, L, H], params local
    (sharding.local_params). attend(i, q, k, v) -> [B, Hq, L, D] is layer
    i's attention (it writes layer i's cache). Under tp each rank holds
    Hq / tp and Hkv / tp heads and I / tp MLP columns; the row-parallel
    o_proj and down_proj give partial sums that par.reduce sums over tp, so
    h stays replicated."""
    eps, hd = config.rms_norm_eps, config.head_dim
    nq = config.num_attention_heads // par.tp_size
    nkv = config.num_key_value_heads // par.tp_size
    inter = config.intermediate_size // par.tp_size
    b, l, _ = h.shape
    for i in range(config.num_hidden_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["input_layernorm"]["w"], eps)
        q, k, v = layer_qkv(lp, x, cos, sin, nq, nkv, hd, eps)
        attn = attend(i, q, k, v)
        h = h + par.reduce(linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, l, -1)))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], eps)
        h = h + par.reduce(linear(lp["down_proj"], swiglu(lp, x2, inter)))
    return rms_norm(h, params["norm"]["w"], eps)


def talker_prefill(params: dict, embeds: torch.Tensor, cache: dict, config: Qwen3TTSConfig,
                   lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill over embeds [B, P, H]: writes K/V of positions [0, P) into
    ring slots [0, P) (in place) and returns (h_last [B, 1, H], cache).
    Exact-length prompts by default (cache["pos"] [C]); with `lengths` [B]
    the rows are prompts padded to P (the batched serving prefill): each
    row attends to its own first lengths[i] keys, its padding slots keep
    pos = -1 in cache["pos"] [B, C], and h_last is its row lengths[i] - 1."""
    par, params = local_params(params)
    b, p, _ = embeds.shape
    dev = embeds.device
    scale = 1.0 / float(config.head_dim) ** 0.5
    idx = torch.arange(p, device=dev)
    cos, sin = rope_cos_sin(config, idx[None].expand(b, p))
    if lengths is None:
        mask = causal_mask(p, dev)
    else:
        ok = (idx[None, :] <= idx[:, None])[None] & (idx[None, None, :] < lengths[:, None, None])
        mask = torch.where(ok, 0.0, float(NEG_INF))[:, None, None]  # [B, 1, 1, P, P]

    def attend(i, q, k, v):
        cache["k"][i, :, :, :p] = k
        cache["v"][i, :, :, :p] = v
        return gqa_attention_full(q, k, v, scale, mask)

    h = decoder_layers(params, embeds, cos, sin, attend, config, par)
    if lengths is None:
        cache["pos"][:p] = idx
        return h[:, p - 1:p], cache
    cache["pos"][:, :p] = torch.where(idx[None] < lengths[:, None], idx[None], -1)
    return h.gather(1, (lengths - 1)[:, None, None].expand(b, 1, h.shape[2])), cache


def talker_decode_step(params: dict, embed: torch.Tensor, cache: dict,
                       position: torch.Tensor, window_start: torch.Tensor,
                       config: Qwen3TTSConfig,
                       slot: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step, on the device with no host sync. embed [B, 1, H].
    One stream: position / window_start 0-d int64 tensors, cache["pos"] [C].
    B streams side by side: both [B], cache["pos"] [B, C], each stream at
    its own position and window. Writes this token's K/V in place at ring
    slot `slot` (0-d, shared by all streams, or [B]; position % C by
    default) and attends over [window_start, position]."""
    par, params = local_params(params)
    b = embed.shape[0]
    scale = 1.0 / float(config.head_dim) ** 0.5
    capacity = cache["pos"].shape[-1]
    pos = cache["pos"].view(-1, capacity)  # [1 or B, C]
    positions = position.reshape(-1)
    slots = (positions % capacity if slot is None else slot.reshape(-1)).expand(pos.shape[0])
    cos, sin = rope_cos_sin(config, positions[:, None].expand(b, 1))
    pos.scatter_(1, slots[:, None], positions[:, None].to(pos.dtype))
    key_pos, start = pos[:, None, None, :], window_start.reshape(-1, 1, 1, 1)

    def attend(i, q, k, v):
        rows = slots[:, None, None, None].expand(b, k.shape[1], 1, k.shape[3])
        cache["k"][i].scatter_(2, rows, k)
        cache["v"][i].scatter_(2, rows, v)
        return gqa_attention_decode(q, cache["k"][i], cache["v"][i], key_pos, start, scale)

    return decoder_layers(params, embed, cos, sin, attend, config, par), cache
