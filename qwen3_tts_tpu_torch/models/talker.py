"""Qwen3-TTS talker: the 28-layer decoder over summed text + codec
embeddings (counterpart of qwen3_tts_tpu/models/talker.py).

Layer weights are stacked on a leading layer axis; the KV cache is a
preallocated ring {"k", "v": [L, B, Hkv, C, D], "pos": [C]} written in place
at slot position % C (streams side by side keep "pos" [B, C] and a position
each), and decode attention masks keys by absolute position against the
window start (the reference's 192-token trim schedule). RMSNorm
runs in fp32; q/k get a per-head RMSNorm before RoPE; interleaved MRoPE when
config.mrope_section is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Qwen3TTSConfig
from ..ops import rope as rope_ops
from ..ops.attention import causal_mask, gqa_attention_decode, gqa_attention_full
from ..ops.linear import embedding_lookup, linear
from ..ops.norms import rms_norm


def _layer(params: dict, i: int) -> dict:
    """Layer i's slice of a stacked layer tree (any depth: the
    tensor-parallel layout nests q / k / v and gate / up one level more)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def text_projection(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(params["text_projection"]["fc1"], x))
    return linear(params["text_projection"]["fc2"], h)


def encode_text(params: dict, ids: torch.Tensor) -> torch.Tensor:
    dtype = params["norm"]["w"].dtype
    return text_projection(params, embedding_lookup(params["text_embedding"], ids, dtype))


def encode_audio(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return embedding_lookup(params["codec_embedding"], ids, params["norm"]["w"].dtype)


def codec_head(params: dict, h: torch.Tensor) -> torch.Tensor:
    return linear(params["codec_head"], h).float()


def init_kv_cache(config: Qwen3TTSConfig, capacity: int, batch: int = 1,
                  dtype=torch.float32, device=None) -> dict:
    shape = (config.num_hidden_layers, batch, config.num_key_value_heads, capacity,
             config.head_dim)
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


def talker_prefill(params: dict, embeds: torch.Tensor, cache: dict,
                   config: Qwen3TTSConfig) -> tuple[torch.Tensor, dict]:
    """Prefill over exact-length embeds [B, P, H]: writes K/V of positions
    [0, P) into ring slots [0, P) (in place) and returns (h_last [B, 1, H],
    cache)."""
    b, p, _ = embeds.shape
    nq, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    scale = 1.0 / float(hd) ** 0.5
    positions = torch.arange(p, device=embeds.device)[None].expand(b, p)
    cos, sin = rope_cos_sin(config, positions)
    mask = causal_mask(p, embeds.device)
    h = embeds
    for i in range(config.num_hidden_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["input_layernorm"]["w"], config.rms_norm_eps)
        q, k, v = layer_qkv(lp, x, cos, sin, nq, nkv, hd, config.rms_norm_eps)
        cache["k"][i, :, :, :p] = k
        cache["v"][i, :, :, :p] = v
        attn = gqa_attention_full(q, k, v, scale, mask)
        h = h + linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, p, -1))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], config.rms_norm_eps)
        h = h + linear(lp["down_proj"], swiglu(lp, x2, config.intermediate_size))
    h = rms_norm(h, params["norm"]["w"], config.rms_norm_eps)
    cache["pos"][:p] = torch.arange(p, device=embeds.device)
    return h[:, p - 1:p], cache


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
    b = embed.shape[0]
    nq, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    scale = 1.0 / float(hd) ** 0.5
    capacity = cache["pos"].shape[-1]
    pos = cache["pos"].view(-1, capacity)  # [1 or B, C]
    positions = position.reshape(-1)
    slots = (positions % capacity if slot is None else slot.reshape(-1)).expand(pos.shape[0])
    cos, sin = rope_cos_sin(config, positions[:, None].expand(b, 1))
    pos.scatter_(1, slots[:, None], positions[:, None].to(pos.dtype))
    rows = slots[:, None, None, None].expand(b, nkv, 1, hd)
    key_pos, start = pos[:, None, None, :], window_start.reshape(-1, 1, 1, 1)
    h = embed
    for i in range(config.num_hidden_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["input_layernorm"]["w"], config.rms_norm_eps)
        q, k, v = layer_qkv(lp, x, cos, sin, nq, nkv, hd, config.rms_norm_eps)
        cache["k"][i].scatter_(2, rows, k)
        cache["v"][i].scatter_(2, rows, v)
        attn = gqa_attention_decode(q, cache["k"][i], cache["v"][i], key_pos, start, scale)
        h = h + linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, 1, -1))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], config.rms_norm_eps)
        h = h + linear(lp["down_proj"], swiglu(lp, x2, config.intermediate_size))
    return rms_norm(h, params["norm"]["w"], config.rms_norm_eps), cache
