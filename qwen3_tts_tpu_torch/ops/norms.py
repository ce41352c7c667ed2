"""Normalization layers (functional): fp32 islands cast back to the input
dtype, as in qwen3_tts_tpu/ops/norms.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * weight.float()
    return normed.to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)
