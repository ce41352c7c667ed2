"""Code predictor (MTP head): the 5-layer transformer that predicts codec
groups 1..15 of a frame from the talker's last hidden state and code 0
(counterpart of qwen3_tts_tpu/models/code_predictor.py).

With a megakernel tree under params["kernel"] and B == 1 a frame is one
call of K2 (ops/cuda/cp_megakernel.py; its plain version for CPU tensors).
Otherwise layer weights, the 15 codec-embedding tables and the 15 lm_heads
are stacked on leading axes; the per-frame loop keeps a 16-slot KV cache
and runs on the device without host syncs (codes stay device tensors).
"""

from __future__ import annotations

import torch

from ..config import CodePredictorConfig
from ..ops import rope as rope_ops
from ..ops.attention import gqa_attention_full
from ..ops.cuda import cp_megakernel as cpk
from ..ops.linear import linear, table_matmul, table_row
from ..ops.norms import rms_norm
from ..ops.sampling import NEG_INF, sample_token
from .talker import _layer, swiglu

CP_CACHE_LEN = 16


def cp_forward(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, start_pos: int, config: CodePredictorConfig):
    """Run the cp transformer over x [B, L, H_in] at positions
    [start_pos, start_pos + L), writing the caches [nl, B, Hkv, 16, D] in
    place; returns (h_last [B, 1, Hc], cache_k, cache_v)."""
    if "small_to_mtp_projection" in params:
        x = linear(params["small_to_mtp_projection"], x)
    b, l, _ = x.shape
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    scale = 1.0 / float(hd) ** 0.5
    dev = x.device
    positions = torch.arange(start_pos, start_pos + l, device=dev)
    inv = rope_ops.inv_freq_tensor(hd, config.rope_theta, dev)
    cos, sin = rope_ops.rope_cos_sin(positions[None], inv)
    slots = torch.arange(CP_CACHE_LEN, device=dev)
    mask = torch.where(
        (slots[None] <= positions[:, None]) & (slots[None] < start_pos + l), 0.0,
        float(NEG_INF),
    )
    h = x
    for i in range(config.num_hidden_layers):
        lp = _layer(params["layers"], i)
        xin = rms_norm(h, lp["input_layernorm"]["w"], config.rms_norm_eps)
        qkv = linear(lp["qkv_proj"], xin)
        q = qkv[..., : nq * hd].reshape(b, l, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, l, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(b, l, nkv, hd)
        q = rms_norm(q, lp["q_norm"]["w"], config.rms_norm_eps).transpose(1, 2)
        k = rms_norm(k, lp["k_norm"]["w"], config.rms_norm_eps).transpose(1, 2)
        c, s = cos[:, None], sin[:, None]
        q, k = rope_ops.apply_rope(q, c, s), rope_ops.apply_rope(k, c, s)
        cache_k[i, :, :, start_pos:start_pos + l] = k
        cache_v[i, :, :, start_pos:start_pos + l] = v.transpose(1, 2)
        attn = gqa_attention_full(q, cache_k[i], cache_v[i], scale, mask)
        h = h + linear(lp["o_proj"], attn.transpose(1, 2).reshape(b, l, -1))
        x2 = rms_norm(h, lp["post_attention_layernorm"]["w"], config.rms_norm_eps)
        h = h + linear(lp["down_proj"], swiglu(lp, x2, config.intermediate_size))
    h = rms_norm(h, params["norm"]["w"], config.rms_norm_eps)
    return h[:, -1:], cache_k, cache_v


def group_logits(params: dict, k_group: int, h_last: torch.Tensor) -> torch.Tensor:
    """fp32 logits [V] of group k_group's lm_head at h_last [1, 1, Hc]."""
    return table_matmul(params["lm_head"], k_group, h_last[:, 0]).float()[0]


def predict_frame(
    params: dict,
    code_hidden: torch.Tensor,
    code0_embed: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    seen_cp: torch.Tensor | None,
    config: CodePredictorConfig,
    repetition_penalty: float = 1.05,
    forced_codes: torch.Tensor | None = None,
    logits_out: list | None = None,
):
    """Codes 1..15 of one frame (B == 1). code_hidden / code0_embed
    [1, 1, H_t]; seen_cp bool [15, V] (None: no penalty), updated in place.
    Returns (codes [15] int64, embed_sum [1, 1, H_t], seen_cp).

    `forced_codes` feeds given codes to the next pass instead of the sampled
    ones (teacher forcing) and `logits_out` collects each group's logits;
    tests use both to compare step by step with another implementation."""
    ng = config.num_code_groups - 1
    b = code_hidden.shape[0]
    dtype, dev = code_hidden.dtype, code_hidden.device
    if "kernel" in params and b == 1:
        buf = None if logits_out is None else torch.empty(ng, config.vocab_size, device=dev)
        out = cpk.predict_frame(
            params["kernel"], code_hidden, code0_embed, cpk.frame_seed(generator, dev),
            temperature, seen_cp, config, repetition_penalty, forced_codes, buf,
        )
        if buf is not None:
            logits_out.extend(buf.unbind(0))
        return out
    shape = (config.num_hidden_layers, b, config.num_key_value_heads, CP_CACHE_LEN,
             config.head_dim)
    cache_k = torch.zeros(shape, dtype=dtype, device=dev)
    cache_v = torch.zeros(shape, dtype=dtype, device=dev)
    emb = params["codec_embedding"]

    def sample_group(k, h_last):
        lg = group_logits(params, k, h_last)
        if logits_out is not None:
            logits_out.append(lg)
        code = sample_token(
            lg, generator, temperature,
            seen_mask=seen_cp[k] if seen_cp is not None else None,
            repetition_penalty=repetition_penalty,
        )
        if forced_codes is not None:
            code = forced_codes[k]
        if seen_cp is not None:
            seen_cp[k].index_fill_(0, code.reshape(1), True)
        return code

    x0 = torch.cat([code_hidden, code0_embed], dim=1)
    h_last, cache_k, cache_v = cp_forward(params, x0, cache_k, cache_v, 0, config)
    codes = [sample_group(0, h_last)]
    embed_sum = code0_embed + table_row(emb, 0, codes[0], dtype)[None, None]
    for k in range(1, ng):
        x = table_row(emb, k - 1, codes[-1], dtype)[None, None]
        h_last, cache_k, cache_v = cp_forward(params, x, cache_k, cache_v, k + 1, config)
        codes.append(sample_group(k, h_last))
        embed_sum = embed_sum + table_row(emb, k, codes[-1], dtype)[None, None]
    return torch.stack(codes), embed_sum, seen_cp


def predict_frame_batched(cp_params: dict, code_hidden: torch.Tensor,
                          code0_embed: torch.Tensor, noise: torch.Tensor | None,
                          temps: float | torch.Tensor, config: CodePredictorConfig,
                          forced_codes: torch.Tensor | None = None,
                          seen_cp: torch.Tensor | None = None,
                          repetition_penalty: float = 1.05,
                          logits_out: list | None = None):
    """Codes 1..15 of B streams' frames (the cp positions are shared, so
    cp_forward's batch dim applies directly). code_hidden / code0_embed
    [B, 1, H]; noise [B, 15, V] Gumbel noise of the groups (None: greedy);
    temps: one temperature or [B]. `seen_cp` [B, 15, V] (updated in place)
    turns on the repetition penalty, which the serving path, like JAX's and
    the streaming paths, leaves off. `forced_codes` [B, 15] feeds given
    codes on (teacher forcing). The heads run in the activations' dtype,
    as predict_frame's, so a stream's logits are its single-stream ones.
    `logits_out` collects each group's fp32 logits [B, V] (tests compare
    them step by step, forced or not).
    Returns (codes [B, 15] int64, embed_sum [B, 1, H])."""
    ng = config.num_code_groups - 1
    b = code_hidden.shape[0]
    dtype, dev = code_hidden.dtype, code_hidden.device
    shape = (config.num_hidden_layers, b, config.num_key_value_heads, CP_CACHE_LEN,
             config.head_dim)
    ck = torch.zeros(shape, dtype=dtype, device=dev)
    cv = torch.zeros(shape, dtype=dtype, device=dev)
    emb, heads = cp_params["codec_embedding"], cp_params["lm_head"]

    def emb_rows(k, codes):
        return table_row(emb, k, codes, dtype)[:, None, :]

    def sample_group(k, h_last):
        if forced_codes is None or logits_out is not None:
            lg = table_matmul(heads, k, h_last[:, 0]).float()
            if logits_out is not None:
                logits_out.append(lg)
        if forced_codes is not None:
            code = forced_codes[:, k]
        else:
            code = sample_token(lg, None, 0.0 if noise is None else temps,
                                seen_mask=None if seen_cp is None else seen_cp[:, k],
                                repetition_penalty=repetition_penalty,
                                noise=None if noise is None else noise[:, k])
        if seen_cp is not None:
            seen_cp[:, k].scatter_(1, code[:, None], True)
        return code

    x0 = torch.cat([code_hidden, code0_embed], dim=1)
    h_last, ck, cv = cp_forward(cp_params, x0, ck, cv, 0, config)
    codes = [sample_group(0, h_last)]
    embed_sum = code0_embed + emb_rows(0, codes[0])
    for k in range(1, ng):
        h_last, ck, cv = cp_forward(cp_params, emb_rows(k - 1, codes[-1]), ck, cv, k + 1,
                                    config)
        codes.append(sample_group(k, h_last))
        embed_sum = embed_sum + emb_rows(k, codes[-1])
    return torch.stack(codes, dim=1), embed_sum
