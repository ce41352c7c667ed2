"""Rotary position embeddings: standard RoPE and interleaved MRoPE, as in
qwen3_tts_tpu/ops/rope.py (fp32 angles, rotate-half on split halves)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def inv_freq(dim: int, base: float) -> np.ndarray:
    """1 / base^(2i/dim) for i in [0, dim/2), float32."""
    return (
        1.0 / np.power(base, np.arange(0, dim, 2, dtype=np.float32) / dim)
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def inv_freq_tensor(dim: int, base: float, device: torch.device) -> torch.Tensor:
    """inv_freq as a tensor on `device`, made once: a fresh host-to-device
    copy per decode step would stall the host on the device's queue."""
    return torch.from_numpy(inv_freq(dim, base)).to(device)


def rope_cos_sin(positions: torch.Tensor, inv: torch.Tensor):
    """positions [..., L] -> cos, sin [..., L, dim] (layout [angles, angles])."""
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def mrope_cos_sin(positions: torch.Tensor, inv: torch.Tensor, mrope_section):
    """Interleaved MRoPE. positions [B, L] (one position stream used for
    t/h/w) or [3, B, L]; returns cos, sin [B, L, dim]."""
    pos3 = torch.stack([positions] * 3) if positions.dim() == 2 else positions
    freqs = pos3.float()[..., None] * inv  # [3, B, L, half]
    half = inv.shape[0]
    idx = torch.arange(half, device=inv.device)
    h_mask = (idx % 3 == 1) & (idx < mrope_section[1] * 3)
    w_mask = (idx % 3 == 2) & (idx < mrope_section[2] * 3)
    combined = torch.where(h_mask, freqs[1], freqs[0])
    combined = torch.where(w_mask, freqs[2], combined)
    emb = torch.cat([combined, combined], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)
