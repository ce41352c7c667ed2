"""Attention: full (prefill) GQA, single-token GQA over the ring KV cache
with absolute-position window masking, and plain SDPA for the vocoder, as
in qwen3_tts_tpu/ops/attention.py (fp32 scores and softmax)."""

from __future__ import annotations

import torch

from .sampling import NEG_INF


def gqa_attention_full(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """q [B, Hq, L, D]; k, v [B, Hkv, M, D]; additive mask [.., L, M]."""
    b, hq, l, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, l, d).float()
    scores = torch.einsum("bkgld,bkmd->bkglm", qg, k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkglm,bkmd->bkgld", probs, v)
    return out.reshape(b, hq, l, d)


def causal_mask(l: int, device=None) -> torch.Tensor:
    """Additive float32 causal mask [L, L]."""
    i = torch.arange(l, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, float(NEG_INF))


def gqa_attention_decode(q, k_cache, v_cache, cache_pos, window_start, scale: float):
    """q [B, Hq, 1, D]; caches [B, Hkv, C, D]; cache_pos [C] absolute
    positions (-1 empty). Keys with 0 <= pos and pos >= window_start count."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bkcd->bkgc", qg, k_cache.float()) * scale
    valid = (cache_pos >= 0) & (cache_pos >= window_start)
    scores = torch.where(valid, scores, float(NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgc,bkcd->bkgd", probs, v_cache)
    return out.reshape(b, hq, 1, d)


def sdpa(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """Plain multi-head attention (Hq == Hkv) for the vocoder."""
    scores = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bhmd->bhld", probs, v)
