"""K1: one talker decode step per call, one cooperative launch of a
persistent kernel (CUDA kernel csrc/talker_step.cu; its launch plan in
ops/cuda/persistent.py).

Counterpart of qwen3_tts_tpu/ops/pallas/talker_megakernel.py: the builder of
the kernel's W8A8 tree (build_talker_kernel_params), the ring-cache layout
pair, the wrapper (talker_step_kernel) and the plain PyTorch version of the
same arithmetic (talker_step_plain, the counterpart of
talker_step_w8a8_ref).

Cache layout: the decode path keeps {"k2", "v2": [nl, C, nkv * hd] (model
dtype), "pos": [C] int64}, contiguous per layer, where the JAX kernel keeps
[C, nl * nkv * hd]; cache_to_kernel_layout / kernel_layout_to_cache convert
from and to the standard ring cache {"k", "v": [nl, 1, nkv, C, hd], "pos"}.
A step writes its K/V rows into slot position % C and pos[slot] in place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..quant import w8a8_linear_plain
from . import _build, persistent
from .cp_megakernel import (
    LayerArgs,
    layer_args,
    layer_norms,
    layer_weights,
    rms,
    rowwise,
    w8a8_layer,
)

launches = 0  # decode steps launched since the last reset


def build_talker_kernel_params(params: dict, config) -> dict:
    """Dense (numpy) talker tree -> the kernel's W8A8 tree (numpy): rowwise
    int8 layer weights and codec head, fp32 norm gains."""
    ch_q, ch_s, ch_m = rowwise(params["codec_head"])
    return {
        **layer_norms(params["layers"]),
        "fin_ln": np.asarray(params["norm"]["w"], np.float32)[None, :],
        **layer_weights(params["layers"]),
        "ch_q": ch_q, "ch_s": ch_s, "ch_m": ch_m,
    }


def cache_to_kernel_layout(cache: dict, config=None) -> dict:
    """{"k", "v": [nl, 1, nkv, C, hd], "pos"} -> {"k2", "v2": [nl, C, nkv * hd],
    "pos"} (B = 1)."""
    nl, b, nkv, c, d = cache["k"].shape
    if b != 1:
        raise ValueError("the kernel cache layout is single-stream (B = 1)")

    def conv(x):
        return x[:, 0].permute(0, 2, 1, 3).reshape(nl, c, nkv * d).contiguous()

    return {"k2": conv(cache["k"]), "v2": conv(cache["v"]), "pos": cache["pos"]}


def kernel_layout_to_cache(cache2: dict, config) -> dict:
    """Inverse of cache_to_kernel_layout."""
    nl, c, _ = cache2["k2"].shape
    nkv, d = config.num_key_value_heads, config.head_dim

    def conv(x):
        return x.reshape(nl, c, nkv, d).permute(0, 2, 1, 3)[:, None].contiguous()

    return {"k": conv(cache2["k2"]), "v": conv(cache2["v2"]), "pos": cache2["pos"]}


def talker_step_plain(tkp, embed, cache2, position, window_start, cos, sin, config):
    """Plain PyTorch version of the step. embed [1, 1, hc]; position /
    window_start 0-d int64 tensors; cos / sin [hd] fp32 for `position`.
    Returns (final-normed h [1, 1, hc] in embed's dtype, logits [V] fp32,
    cache2 with this token's rows and position written in place)."""
    hc, hd, nl = config.hidden_size, config.head_dim, config.num_hidden_layers
    nq, nkv, eps = config.num_attention_heads, config.num_key_value_heads, config.rms_norm_eps
    group, scale = nq // nkv, 1.0 / float(hd) ** 0.5
    k2, v2, pos = cache2["k2"], cache2["v2"], cache2["pos"]
    c_len = pos.shape[0]
    cos, sin = cos.reshape(hd).float(), sin.reshape(hd).float()
    valid = (pos >= 0) & (pos >= window_start)
    k_rows, v_rows = [], []

    def attend(l, q, k, v):
        k_rows.append(k.reshape(-1))
        v_rows.append(v.reshape(-1))
        qg = q.reshape(nkv, group, hd)
        kc = k2[l].float().reshape(c_len, nkv, hd)
        vc = v2[l].float().reshape(c_len, nkv, hd)
        sc_c = torch.where(valid, torch.einsum("jgd,cjd->jgc", qg, kc) * scale, -1e30)
        sc_cur = (qg * k[:, None, :]).sum(-1, keepdim=True) * scale
        mx = torch.maximum(sc_c.amax(-1, keepdim=True), sc_cur)
        e_c, e_cur = torch.exp(sc_c - mx), torch.exp(sc_cur - mx)
        denom = e_c.sum(-1, keepdim=True) + e_cur
        out = (torch.einsum("jgc,cjd->jgd", e_c, vc) + e_cur * v[:, None, :]) / denom
        return out.reshape(1, nq * hd)

    h = embed.reshape(1, hc).float()
    for l in range(nl):
        h = w8a8_layer(tkp, l, h, cos, sin, attend, config)
    hf = rms(h, tkp["fin_ln"][0], eps)
    logits = w8a8_linear_plain(hf, tkp["ch_q"], tkp["ch_s"][0], tkp["ch_m"][0])[0]
    slot = (position % c_len).reshape(1)
    k2.index_copy_(1, slot, torch.stack(k_rows)[:, None, :].to(k2.dtype))
    v2.index_copy_(1, slot, torch.stack(v_rows)[:, None, :].to(v2.dtype))
    pos.index_copy_(0, slot, position.reshape(1).to(pos.dtype))
    return hf[None].to(embed.dtype), logits, cache2


class TalkerArgs(ctypes.Structure):
    """Mirror of QtTalkerArgs in csrc/talker_step.cu."""

    _fields_ = [("lay", LayerArgs), ("plan", persistent.Plan)] + _build.struct_fields(
        "fin_ln:p ch_q:p ch_s:p ch_m:p embed:p embed_bf16:i k2:p v2:p kv_bf16:i pos:p "
        "position:p window_start:p cos:p sin:p h_out:p logits:p part:p cnt:p vocab:i C:i"
    )


def talker_step_kernel(tkp, embed, cache2, position, window_start, cos, sin, config):
    """Launch the step on the card (one cooperative launch); same contract
    as talker_step_plain."""
    global launches
    hc, hd, nl = config.hidden_size, config.head_dim, config.num_hidden_layers
    nq, nkv, vocab = config.num_attention_heads, config.num_key_value_heads, config.vocab_size
    k2, v2, pos = cache2["k2"], cache2["v2"], cache2["pos"]
    c_len = pos.shape[0]
    dev = embed.device
    lay, scratch = layer_args(tkp, config, dev)
    _build.require(tkp["ch_q"], "ch_q", dtype=torch.int8)
    persistent.require_aligned(tkp, ("qkv_q", "o_q", "gu_q", "dn_q", "ch_q"))
    for name in ("ch_s", "ch_m", "fin_ln"):
        _build.require(tkp[name], name, dtype=torch.float32)
    _build.require(embed, "embed", dtype=(torch.float32, torch.bfloat16), shape=(1, 1, hc))
    for t, name in ((k2, "k2"), (v2, "v2")):
        _build.require(t, name, dtype=(torch.float32, torch.bfloat16),
                       shape=(nl, c_len, nkv * hd))
    if k2.dtype != v2.dtype:
        raise TypeError("k2 and v2 must share a dtype")
    _build.require(pos, "pos", dtype=torch.int64)
    for t, name in ((position, "position"), (window_start, "window_start")):
        _build.require(t, name, dtype=torch.int64)
    cos, sin = cos.reshape(hd).float().contiguous(), sin.reshape(hd).float().contiguous()
    plan = persistent.talker_plan(config, c_len, dev)
    h_out = torch.empty(hc, dtype=embed.dtype, device=dev)
    logits = torch.empty(vocab, dtype=torch.float32, device=dev)
    part = torch.empty(nq * plan.nch * (hd + 2), dtype=torch.float32, device=dev)
    args = TalkerArgs(
        lay=lay, plan=plan, **{k: tkp[k].data_ptr() for k in ("fin_ln", "ch_q", "ch_s", "ch_m")},
        embed=embed.data_ptr(), embed_bf16=_build.is_bf16(embed),
        k2=k2.data_ptr(), v2=v2.data_ptr(), kv_bf16=_build.is_bf16(k2), pos=pos.data_ptr(),
        position=position.data_ptr(), window_start=window_start.data_ptr(),
        cos=cos.data_ptr(), sin=sin.data_ptr(), h_out=h_out.data_ptr(),
        logits=logits.data_ptr(), part=part.data_ptr(),
        cnt=persistent.counters(dev, nkv).data_ptr(), vocab=vocab, C=c_len,
    )
    _build.check(_build.lib().qt_talker_step(ctypes.addressof(args), _build.stream()),
                 "qt_talker_step")
    launches += 1
    return h_out.reshape(1, 1, hc), logits, cache2


def talker_step(tkp, embed, cache2, position, window_start, cos, sin, config):
    """One talker decode step (B = 1): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = talker_step_kernel if embed.is_cuda else talker_step_plain
    return fn(tkp, embed, cache2, position, window_start, cos, sin, config)
