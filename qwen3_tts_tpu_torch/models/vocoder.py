"""Vocoder decoder: 16-codebook codec frames -> 24 kHz waveform
(counterpart of qwen3_tts_tpu/models/vocoder.py).

split-RVQ decode -> causal pre-conv k=3 -> 8-layer causal pre-transformer
-> 2 x (causal transposed conv x2 + ConvNeXt) -> SEANet decoder (initial
conv k=7, 4 blocks of [SnakeBeta, transposed-conv upsample, 3 dilated
residual units], output SnakeBeta + conv -> 1 channel, clip +-1).
Channels-last [B, T, C] throughout. With a "kernel" subtree
(build_vocoder_kernel_params) the pre-transformer, the upsample stages and
the residual units run as the CUDA kernels K4, K5 and K6 (their plain
versions on the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TokenizerDecoderConfig
from ..ops import rope as rope_ops
from ..ops.attention import causal_mask, sdpa
from ..ops.conv import (
    causal_conv1d,
    causal_transpose_conv1d,
    convnext_block,
    left_pad_conv1d,
    snake_beta,
)
from ..ops.cuda.pretransformer_kernel import (
    build_pretransformer_params,
    pre_transformer_packed,
)
from ..ops.cuda.upsample_kernel import build_upsample_stage_params, upsample_stage_fused
from ..ops.cuda.vocoder_kernels import build_seanet_block_params, seanet_block_fused
from ..ops.linear import linear
from ..ops.norms import rms_norm
from ..parallel.sharding import DTensor, Shard

DILATIONS = (1, 3, 9)


def rvq_decode(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, nq, T] -> [B, T, codebook_dim]: each half sums its codebook
    rows and projects out; the halves add."""

    def gather_sum(cbs, half_codes):  # [n, V, D], [B, n, T] -> [B, T, D]
        idx = torch.arange(cbs.shape[0], device=cbs.device)[None, :, None]
        return cbs[idx, half_codes].sum(dim=1)

    sem, aco = params["semantic"], params["acoustic"]
    ns = sem["codebooks"].shape[0]
    out = linear(sem["out_proj"], gather_sum(sem["codebooks"], codes[:, :ns]))
    if codes.shape[1] > ns:
        out = out + linear(aco["out_proj"], gather_sum(aco["codebooks"], codes[:, ns:]))
    return out


def pre_transformer(params: dict, x: torch.Tensor, cfg: TokenizerDecoderConfig) -> torch.Tensor:
    """8-layer causal transformer with LayerScale (plain torch)."""
    b, t, _ = x.shape
    hd, nh = cfg.head_dim, cfg.num_attention_heads
    scale = 1.0 / float(hd) ** 0.5
    h = linear(params["input_proj"], x)
    inv = rope_ops.inv_freq_tensor(hd, cfg.rope_theta, x.device)
    cos, sin = rope_ops.rope_cos_sin(torch.arange(t, device=x.device)[None], inv)
    c, s = cos[:, None], sin[:, None]
    mask = causal_mask(t, x.device) if t > 1 else None
    L = params["layers"]
    for i in range(L["input_layernorm"]["w"].shape[0]):
        lp = {k: {kk: vv[i] for kk, vv in v.items()} for k, v in L.items()}
        xin = rms_norm(h, lp["input_layernorm"]["w"], cfg.rms_norm_eps)

        def heads(name):
            return linear(lp[name], xin).reshape(b, t, nh, hd).transpose(1, 2)

        q = rope_ops.apply_rope(heads("q_proj"), c, s)
        k = rope_ops.apply_rope(heads("k_proj"), c, s)
        attn = sdpa(q, k, heads("v_proj"), scale, mask).transpose(1, 2).reshape(b, t, -1)
        h = h + lp["self_attn_layer_scale"]["w"].to(h.dtype) * linear(lp["o_proj"], attn)
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], cfg.rms_norm_eps)
        m = linear(lp["down_proj"],
                   F.silu(linear(lp["gate_proj"], x2)) * linear(lp["up_proj"], x2))
        h = h + lp["mlp_layer_scale"]["w"].to(h.dtype) * m
    h = rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps)
    return linear(params["output_proj"], h)


def _residual_unit(params: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake_beta(params["act1"], x)
    h = causal_conv1d(params["conv1"], h, dilation=dilation)
    h = snake_beta(params["act2"], h)
    return x + causal_conv1d(params["conv2"], h)


def build_vocoder_kernel_params(params: dict, cfg: TokenizerDecoderConfig,
                                dtype=torch.bfloat16) -> dict:
    """Kernel subtree (K4 pre-transformer, K5 upsample stages with the
    initial conv folded into the last, K6 blocks with the output tail folded
    into the last) from the dense tree; store it under params["kernel"]. A
    layout a kernel does not cover (attention biases, k != stride) raises
    ValueError."""
    dec = params["decoder"]
    pt = build_pretransformer_params(params["pre_transformer"], cfg, dtype)
    stages = params["upsample"]
    up = [
        build_upsample_stage_params(
            st, dtype, initial_conv=dec["initial_conv"] if i == len(stages) - 1 else None
        )
        for i, st in enumerate(stages)
    ]
    last = len(dec["blocks"]) - 1
    blocks = [
        build_seanet_block_params(
            block, rate, dtype,
            tail={"snake": dec["out_snake"], "conv": dec["out_conv"]} if i == last else None,
        )
        for i, (block, rate) in enumerate(zip(dec["blocks"], cfg.upsample_rates))
    ]
    return {"pre_transformer": pt, "upsample": up, "blocks": blocks}


def decode_frames(params: dict, codes: torch.Tensor, cfg: TokenizerDecoderConfig) -> torch.Tensor:
    """codes [B, nq, T] int64 -> waveform [B, T * total_upsample] float32.
    Codes placed on a mesh with their rows on "dp" (a DTensor sharded on
    axis 0; the vocoder params replicated, plain tensors) are decoded on
    each rank over its own rows, with the kernels when params carry them,
    and the waveform comes back placed the same way (sharding.gather_rows
    gathers it on the host)."""
    if isinstance(codes, DTensor):
        if any(isinstance(p, Shard) and p.dim != 0 for p in codes.placements):
            raise ValueError("dp-placed codes are sharded on their batch axis only")
        wav = decode_frames(params, codes.to_local(), cfg)
        return DTensor.from_local(wav, codes.device_mesh, codes.placements, run_check=False)
    kernel = params.get("kernel")
    h = rvq_decode(params["quantizer"], codes)
    h = causal_conv1d(params["pre_conv"], h)
    if kernel is not None:
        h = pre_transformer_packed(
            kernel["pre_transformer"], h, nh=cfg.num_attention_heads, hd=cfg.head_dim,
            eps=cfg.rms_norm_eps,
        )
        for kp in kernel["upsample"]:
            h = upsample_stage_fused(kp, h)  # the last one applied initial_conv
        for kp, rate in zip(kernel["blocks"], cfg.upsample_rates):
            h = seanet_block_fused(kp, h, rate=rate)
        return h.float()  # the last block applied out_snake + out_conv + clip
    h = pre_transformer(params["pre_transformer"], h, cfg)
    for stage, ratio in zip(params["upsample"], cfg.upsampling_ratios):
        h = causal_transpose_conv1d(stage["tconv"], h, stride=ratio)
        h = convnext_block(stage["convnext"], h)
    h = left_pad_conv1d(params["decoder"]["initial_conv"], h)
    for block, rate in zip(params["decoder"]["blocks"], cfg.upsample_rates):
        h = snake_beta(block["snake"], h)
        h = causal_transpose_conv1d(block["up"], h, stride=rate)
        for unit, dil in zip(block["units"], DILATIONS):
            h = _residual_unit(unit, h, dil)
    h = snake_beta(params["decoder"]["out_snake"], h)
    h = left_pad_conv1d(params["decoder"]["out_conv"], h)
    return torch.clamp(h[..., 0].float(), -1.0, 1.0)


def chunked_decode(params: dict, codes: np.ndarray, cfg: TokenizerDecoderConfig, *,
                   device, chunk_size: int = 100, left_context: int = 10,
                   lengths: list[int] | None = None) -> np.ndarray:
    """Decode [B, nq, T] codes in chunks of `chunk_size` frames, each with
    `left_context` frames of re-decoded context, all chunks batched into one
    call; returns [B, T * total_upsample] float32 numpy. `lengths` (each
    stream's valid frames, when streams are padded to one T) skips the rows
    that hold no valid frame; their samples stay 0."""
    codes = np.asarray(codes)
    b, nq, t = codes.shape
    if t == 0:
        return np.zeros((b, 0), np.float32)
    up = cfg.total_upsample
    n_chunks = -(-t // chunk_size)
    padded = np.pad(codes, ((0, 0), (0, 0), (left_context, n_chunks * chunk_size - t)))
    width = chunk_size + left_context
    rows = [(j, i) for i in range(n_chunks) for j in range(b)
            if lengths is None or i * chunk_size < lengths[j]]
    out = np.zeros((b, n_chunks * chunk_size * up), np.float32)
    if not rows:
        return out[:, : t * up]
    batch = np.stack([padded[j, :, i * chunk_size: i * chunk_size + width] for j, i in rows])
    wav = decode_frames(params, torch.from_numpy(batch).long().to(device), cfg)
    wav = wav[:, left_context * up:].cpu().numpy()
    s = chunk_size * up
    for r, (j, i) in enumerate(rows):
        out[j, i * s:(i + 1) * s] = wav[r]
    return out[:, : t * up]


def speech_tokenizer_decode(params: dict, audio_codes, cfg: TokenizerDecoderConfig, *,
                            device, chunk_size: int | None = None,
                            left_context: int | None = None,
                            decode_upsample_rate: int | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """The speech tokenizer's decode: audio_codes [B, T, nq] -> (wav [B, T *
    upsample] float32, lengths [B] int64), where a frame counts toward a
    stream's length iff its code 0 is > 0. Runs chunked_decode (the kernels
    K4, K5, K6 and the blocks' upsample when params carry a "kernel"
    subtree); chunk size and left context default to the
    QWEN3TTS_DECODE_CHUNK_SIZE / QWEN3TTS_DECODE_LEFT_CONTEXT overrides, else
    100 and 10."""
    audio_codes = np.asarray(audio_codes)
    chunk = chunk_size or int(os.environ.get("QWEN3TTS_DECODE_CHUNK_SIZE", "100"))
    ctx = (left_context if left_context is not None
           else int(os.environ.get("QWEN3TTS_DECODE_LEFT_CONTEXT", "10")))
    up = decode_upsample_rate or cfg.total_upsample
    wav = chunked_decode(params, audio_codes.transpose(0, 2, 1), cfg, device=device,
                         chunk_size=chunk, left_context=ctx)
    lengths = (audio_codes[:, :, 0] > 0).sum(axis=1).astype(np.int64) * up
    return wav, lengths
