"""On-device token sampling, as qwen3_tts_tpu/ops/sampling.py: repetition
penalty (logits of seen tokens divided by the penalty, whatever their
sign), temperature, optional validity mask, then argmax (temperature 0) or a
categorical draw. Draws use Gumbel-max on uniforms from an explicit
torch.Generator on the logits' device, or on noise the caller drew (the
serving path's per-stream Philox draws), so no host sync happens; the
stream differs from jax.random's, and greedy decoding is the parity mode."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = np.float32(-1e30)


def talker_valid_mask(vocab_size: int, codebook_size: int = 2048,
                      pad_id: int = 2148, eos_id: int = 2150, device=None) -> torch.Tensor:
    """Boolean [vocab] mask of sampleable talker tokens."""
    idx = torch.arange(vocab_size, device=device)
    return (idx < codebook_size) | (idx == pad_id) | (idx == eos_id)


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float | torch.Tensor,
    *,
    seen_mask: torch.Tensor | None = None,
    repetition_penalty: float = 1.05,
    valid_mask: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One token id per row of logits [..., V] (int64 on the logits' device).
    `temperature`: a float, or a tensor of one per row (rows at 0 are
    greedy). `noise`: Gumbel noise shaped as the logits, drawn beforehand
    (serving's per-stream draws); else drawn from `generator` for rows at
    temperature > 0."""
    lg = logits.float()
    if seen_mask is not None and repetition_penalty != 1.0:
        lg = lg / torch.where(seen_mask, repetition_penalty, 1.0)
    per_row = isinstance(temperature, torch.Tensor)
    hot = (temperature > 0)[..., None] if per_row else temperature > 0
    if per_row:
        lg = lg / torch.where(hot, temperature.clamp_min(1e-6)[..., None], 1.0)
    elif hot:
        lg = lg / max(temperature, 1e-6)
    if valid_mask is not None:
        lg = torch.where(valid_mask, lg, float(NEG_INF))
    if per_row or hot:
        if noise is None:
            u = torch.rand(lg.shape, generator=generator, device=lg.device)
            noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        lg = lg + (torch.where(hot, noise, 0.0) if per_row else noise)
    return torch.argmax(lg, dim=-1)
