"""K2: one whole code-predictor frame per call, one cooperative launch of a
persistent kernel (CUDA kernel csrc/cp_frame.cu; its launch plan in
ops/cuda/persistent.py).

Counterpart of qwen3_tts_tpu/ops/pallas/cp_megakernel.py: the builder of
the kernel's W8A8 tree (build_cp_kernel_params), the wrapper
(predict_frame_kernel) and the plain PyTorch version of the same arithmetic
(predict_frame_plain, the counterpart of predict_frame_w8a8_ref). A frame is
16 single-token passes through the cp layers (the talker's hidden state at
position 0, code 0's embedding at position 1, then each sampled code's
projected embedding), each pass after the first ending in group k's lm_head,
the repetition penalty and a Gumbel-argmax draw (ops/cuda/gumbel_sampler.py,
K2g). The raw embedding sum the talker needs comes from the `embr` tables,
in group order (in the kernel, the last thing block 0 does).

The per-frame random seed is a device tensor (the caller draws it from its
torch.Generator), so a frame queues without a host sync.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..quant import dense_entry_np, quantize_rowwise_int8_np, w8a8_linear_plain
from ..rope import inv_freq
from . import _build, persistent
from . import gumbel_sampler as gs

launches = 0  # frames launched since the last reset


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, x * rsqrt(mean(x^2) + eps) * w."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rot_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope_tables(config) -> tuple[np.ndarray, np.ndarray]:
    n_pos = config.num_code_groups
    inv = inv_freq(config.head_dim, config.rope_theta)
    freqs = np.arange(n_pos, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def rowwise(entry_or_w) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rowwise int8 (q, s [.., 1, O], m [.., 1, O]) of an entry or array."""
    w = dense_entry_np(entry_or_w) if isinstance(entry_or_w, dict) else entry_or_w
    q, s, m = quantize_rowwise_int8_np(w)
    return q, s[..., None, :].astype(np.float32), m[..., None, :].astype(np.float32)


def layer_norms(lay: dict) -> dict:
    def ln(w):
        return np.asarray(w, np.float32)[:, None, :]

    return {
        "in_ln": ln(lay["input_layernorm"]["w"]),
        "post_ln": ln(lay["post_attention_layernorm"]["w"]),
        "q_ln": ln(lay["q_norm"]["w"]),
        "k_ln": ln(lay["k_norm"]["w"]),
    }


def layer_weights(lay: dict) -> dict:
    out = {}
    for name, pre in (("qkv_proj", "qkv"), ("o_proj", "o"), ("gateup_proj", "gu"),
                      ("down_proj", "dn")):
        out[f"{pre}_q"], out[f"{pre}_s"], out[f"{pre}_m"] = rowwise(lay[name])
    return out


def w8a8_layer(kp: dict, l: int, h: torch.Tensor, cos, sin, attend, config) -> torch.Tensor:
    """Decoder layer l for one token, h [1, hc] fp32 -> h after the layer (the
    plain form of a layer's phases in csrc/w8a8.cuh). attend(l, q, k, v) is the
    attention over the caller's cache, given this token's normed and rotated
    q [nq, hd] and k [nkv, hd] and its v [nkv, hd]; it returns [1, nq * hd]."""
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    inter, eps = config.intermediate_size, config.rms_norm_eps
    qkv = w8a8_linear_plain(rms(h, kp["in_ln"][l][0], eps), kp["qkv_q"][l],
                            kp["qkv_s"][l][0], kp["qkv_m"][l][0])[0]
    q = rms(qkv[: nq * hd].reshape(nq, hd), kp["q_ln"][l][0], eps)
    k = rms(qkv[nq * hd:(nq + nkv) * hd].reshape(nkv, hd), kp["k_ln"][l][0], eps)
    v = qkv[(nq + nkv) * hd:].reshape(nkv, hd)
    q = q * cos + rot_half(q) * sin
    k = k * cos + rot_half(k) * sin
    h = h + w8a8_linear_plain(attend(l, q, k, v), kp["o_q"][l], kp["o_s"][l][0],
                              kp["o_m"][l][0])
    gu = w8a8_linear_plain(rms(h, kp["post_ln"][l][0], eps), kp["gu_q"][l],
                           kp["gu_s"][l][0], kp["gu_m"][l][0])
    act = F.silu(gu[:, :inter]) * gu[:, inter:]
    return h + w8a8_linear_plain(act, kp["dn_q"][l], kp["dn_s"][l][0], kp["dn_m"][l][0])


class LayerArgs(ctypes.Structure):
    """Mirror of QtLayers in csrc/w8a8.cuh."""

    _fields_ = _build.struct_fields(
        "qkv_q:p o_q:p gu_q:p dn_q:p qkv_s:p qkv_m:p o_s:p o_m:p gu_s:p gu_m:p dn_s:p dn_m:p "
        "in_ln:p post_ln:p q_ln:p k_ln:p h:p qkv:p attn:p gu:p "
        "nl:i hc:i nq:i nkv:i hd:i inter:i eps:f"
    )


_LAYER_KEYS = tuple(f"{p}_{s}" for p in ("qkv", "o", "gu", "dn") for s in "qsm") + (
    "in_ln", "post_ln", "q_ln", "k_ln")


def layer_args(kp: dict, config, dev) -> tuple[LayerArgs, list[torch.Tensor]]:
    """QtLayers for kp's layer stack with fresh fp32 scratch rows on `dev`
    (returned too, to keep them alive through the launch)."""
    hc, hd, nq, nkv = (config.hidden_size, config.head_dim, config.num_attention_heads,
                       config.num_key_value_heads)
    inter = config.intermediate_size
    for name in _LAYER_KEYS:
        _build.require(kp[name], name, dtype=torch.int8 if name.endswith("_q") else torch.float32)
    scratch = [torch.empty(n, dtype=torch.float32, device=dev)
               for n in (hc, (nq + 2 * nkv) * hd, nq * hd, 2 * inter)]
    args = LayerArgs(
        **{k: kp[k].data_ptr() for k in _LAYER_KEYS},
        **{k: t.data_ptr() for k, t in zip(("h", "qkv", "attn", "gu"), scratch)},
        nl=config.num_hidden_layers, hc=hc, nq=nq, nkv=nkv, hd=hd, inter=inter,
        eps=config.rms_norm_eps,
    )
    return args, scratch


def build_cp_kernel_params(cp_params: dict, config) -> dict:
    """Dense (numpy) code-predictor tree -> the kernel's W8A8 tree (numpy).
    With small_to_mtp_projection, the per-group embedding tables are
    projected into cp space for the next-token inputs ("emb") and the raw
    tables ("embr") are kept for the talker-facing embedding sum."""
    hc = config.hidden_size
    lay = cp_params["layers"]
    emb_raw = dense_entry_np(cp_params["codec_embedding"])
    head = dense_entry_np(cp_params["lm_head"])
    proj = cp_params.get("small_to_mtp_projection")
    if proj is not None:
        wp = dense_entry_np(proj)
        bp = np.asarray(proj["b"], np.float32) if "b" in proj else np.zeros((hc,), np.float32)
        emb_in = emb_raw @ wp.T + bp
    else:
        emb_in = emb_raw
    embi = rowwise(emb_in)
    embr = embi if proj is None else rowwise(emb_raw)
    head_q, head_s, head_m = rowwise(head)
    cos, sin = _rope_tables(config)
    kp = {
        **layer_norms(lay),
        "fin_ln": np.asarray(cp_params["norm"]["w"], np.float32)[None, :],
        **layer_weights(lay),
        "head_q": head_q, "head_s": head_s, "head_m": head_m,
        "emb_q": embi[0], "emb_s": embi[1], "emb_m": embi[2],
        "embr_q": embr[0], "embr_s": embr[1], "embr_m": embr[2],
        "cos": cos, "sin": sin,
    }
    if proj is not None:
        kp["proj_w"] = wp
        kp["proj_b"] = bp
    return kp


def frame_seed(generator: torch.Generator | None, device) -> torch.Tensor:
    """A frame's 64-bit sampler seed [1] int64 on `device`, drawn from
    `generator` on the device (zero without one: greedy never reads it)."""
    if generator is None:
        return torch.zeros(1, dtype=torch.int64, device=device)
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=device)


def _x0(kp: dict, code_hidden: torch.Tensor, code0_embed: torch.Tensor) -> torch.Tensor:
    """The first two token inputs [2, hc] fp32, projected into cp space."""
    x0 = torch.cat([code_hidden[0].float(), code0_embed[0].float()], dim=0)
    if "proj_w" in kp:
        x0 = x0 @ kp["proj_w"].float().T + kp["proj_b"].float()
    return x0


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of a stacked table [ng, V, ...] flattened to [ng * V, ...]
    (index_select: no host read of the indices)."""
    return table.reshape(-1, *table.shape[2:]).index_select(0, idx)


def _embed_sum(kp: dict, codes: torch.Tensor, code0_embed: torch.Tensor, dtype) -> torch.Tensor:
    """code0_embed + the 15 raw embedding rows of the codes, summed in
    group order."""
    ng, v = kp["embr_q"].shape[:2]
    idx = torch.arange(ng, device=codes.device) * v + codes
    terms = (_rows(kp["embr_q"], idx).float() * _rows(kp["embr_s"][:, 0], idx)[:, None]
             + _rows(kp["embr_m"][:, 0], idx)[:, None])
    esum = terms[0]
    for k in range(1, ng):
        esum = esum + terms[k]
    return (code0_embed.float() + esum[None, None, :]).to(dtype)


def predict_frame_plain(kp, code_hidden, code0_embed, seed, temperature, seen_cp, config,
                        repetition_penalty: float = 1.05, forced_codes=None, logits_out=None):
    """Plain PyTorch version of the frame. Returns (codes [ng] int64,
    embed_sum [1, 1, th], seen_cp updated in place). `forced_codes` keeps
    given codes instead of the draws (teacher forcing); `logits_out`
    [ng, V] receives each group's logits before the penalty."""
    ng = config.num_code_groups - 1
    n_pos = ng + 1
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    nl, vocab, eps = config.num_hidden_layers, config.vocab_size, config.rms_norm_eps
    group, scale = nq // nkv, 1.0 / float(hd) ** 0.5
    dev = code_hidden.device
    track = seen_cp is not None
    penalty = float(repetition_penalty) if track else 1.0
    temp = max(float(temperature), 0.0)
    noise = gs.gumbel_noise(seed, ng, vocab) if temp > 0 else None

    x0 = _x0(kp, code_hidden, code0_embed)
    kv_k = torch.zeros(nl, n_pos, nkv, hd, device=dev)
    kv_v = torch.zeros(nl, n_pos, nkv, hd, device=dev)
    slots = torch.arange(n_pos, device=dev)

    def token_pass(x, t):
        def attend(l, q, k, v):
            kv_k[l, t] = k
            kv_v[l, t] = v
            sc = torch.einsum("jgd,cjd->jgc", q.reshape(nkv, group, hd), kv_k[l]) * scale
            sc = torch.where(slots <= t, sc, -1e30)
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
            return torch.einsum("jgc,cjd->jgd", p, kv_v[l]).reshape(1, nq * hd)

        h = x[None, :]
        for l in range(nl):
            h = w8a8_layer(kp, l, h, kp["cos"][t], kp["sin"][t], attend, config)
        return rms(h, kp["fin_ln"][0], eps)

    codes = []
    x = x0[0]
    for t in range(n_pos):
        if t == 1:
            x = x0[1]
        h_fin = token_pass(x, t)
        if t == 0:
            continue
        k = t - 1
        lg = w8a8_linear_plain(h_fin, kp["head_q"][k], kp["head_s"][k][0],
                               kp["head_m"][k][0])[0]
        if logits_out is not None:
            logits_out[k] = lg
        if track:
            lg = lg / torch.where(seen_cp[k], penalty, 1.0)
        code = gs.gumbel_pick(lg, temp, None if noise is None else noise[k])
        if forced_codes is not None:
            code = forced_codes[k]
        if track:
            seen_cp[k].index_fill_(0, code.reshape(1), True)
        codes.append(code)
        if t < n_pos - 1:
            idx = (k * vocab + code).reshape(1)
            x = (_rows(kp["emb_q"], idx)[0].float() * _rows(kp["emb_s"][:, 0], idx)
                 + _rows(kp["emb_m"][:, 0], idx))
    codes = torch.stack(codes).long()
    return codes, _embed_sum(kp, codes, code0_embed, code_hidden.dtype), seen_cp


class CpArgs(ctypes.Structure):
    """Mirror of QtCpArgs in csrc/cp_frame.cu."""

    _fields_ = [("lay", LayerArgs), ("plan", persistent.Plan)] + _build.struct_fields(
        "fin_ln:p head_q:p head_s:p head_m:p emb_q:p emb_s:p emb_m:p embr_q:p embr_s:p "
        "embr_m:p cos:p sin:p x0a:p x0b:p x0a_bf16:i x0b_bf16:i code0:p code0_bf16:i esum:p "
        "esum_bf16:i th:i seed:p temp:f seen:p penalty:f forced:p codes:p logits:p kv_k:p "
        "kv_v:p vocab:i ng:i"
    )


def predict_frame_kernel(kp, code_hidden, code0_embed, seed, temperature, seen_cp, config,
                         repetition_penalty: float = 1.05, forced_codes=None, logits_out=None):
    """Launch the frame on the card (one cooperative launch); same contract
    as predict_frame_plain. Without small_to_mtp_projection the kernel reads
    the first two token rows as they are; with it, their projection into cp
    space runs here first."""
    global launches
    ng = config.num_code_groups - 1
    nl, nkv, hd, vocab = (config.num_hidden_layers, config.num_key_value_heads, config.head_dim,
                          config.vocab_size)
    hc, dev = config.hidden_size, code_hidden.device
    lay, scratch = layer_args(kp, config, dev)
    for pre in ("head", "emb", "embr"):
        _build.require(kp[f"{pre}_q"], f"{pre}_q", dtype=torch.int8)
        _build.require(kp[f"{pre}_s"], f"{pre}_s", dtype=torch.float32)
        _build.require(kp[f"{pre}_m"], f"{pre}_m", dtype=torch.float32)
    persistent.require_aligned(kp, ("qkv_q", "o_q", "gu_q", "dn_q", "head_q", "emb_q"))
    for name in ("fin_ln", "cos", "sin"):
        _build.require(kp[name], name, dtype=torch.float32)
    _build.require(seed, "seed", dtype=torch.int64)
    th = kp["embr_q"].shape[-1]
    _build.require(code0_embed, "code0_embed", dtype=(torch.float32, torch.bfloat16),
                   shape=(1, 1, th))
    track = seen_cp is not None
    if track:
        _build.require(seen_cp, "seen_cp", dtype=torch.bool, shape=(ng, vocab))
    if forced_codes is not None:
        _build.require(forced_codes, "forced_codes", dtype=torch.int64, shape=(ng,))
    if logits_out is None:
        logits_out = torch.empty(ng, vocab, dtype=torch.float32, device=dev)
    _build.require(logits_out, "logits_out", dtype=torch.float32, shape=(ng, vocab))
    if "proj_w" in kp:
        x0 = _x0(kp, code_hidden, code0_embed).contiguous()
        x0a, x0b = x0[0], x0[1]
    else:
        x0a, x0b = code_hidden.reshape(-1).contiguous(), code0_embed.reshape(-1)
        if x0a.shape != (hc,) or x0b.shape != (hc,):
            raise ValueError(f"code_hidden and code0_embed must hold {hc} values each")
    codes = torch.empty(ng, dtype=torch.int64, device=dev)
    esum = torch.empty(1, 1, th, dtype=code_hidden.dtype, device=dev)
    kv_k, kv_v = (torch.empty(nl, ng + 1, nkv * hd, dtype=torch.float32, device=dev)
                  for _ in range(2))
    args = CpArgs(
        lay=lay, plan=persistent.cp_plan(config, dev),
        **{k: kp[k].data_ptr() for k in ("fin_ln", "head_q", "head_s", "head_m", "emb_q",
                                         "emb_s", "emb_m", "embr_q", "embr_s", "embr_m",
                                         "cos", "sin")},
        x0a=x0a.data_ptr(), x0b=x0b.data_ptr(), x0a_bf16=_build.is_bf16(x0a),
        x0b_bf16=_build.is_bf16(x0b), code0=code0_embed.data_ptr(),
        code0_bf16=_build.is_bf16(code0_embed),
        esum=esum.data_ptr(), esum_bf16=_build.is_bf16(esum), th=th,
        seed=seed.data_ptr(), temp=max(float(temperature), 0.0),
        seen=seen_cp.view(torch.uint8).data_ptr() if track else None,
        penalty=float(repetition_penalty) if track else 1.0,
        forced=_build.ptr(forced_codes), codes=codes.data_ptr(),
        logits=logits_out.data_ptr(), kv_k=kv_k.data_ptr(), kv_v=kv_v.data_ptr(),
        vocab=vocab, ng=ng,
    )
    _build.check(_build.lib().qt_cp_frame(ctypes.addressof(args), _build.stream()),
                 "qt_cp_frame")
    with _build.COUNT_LOCK:
        launches += 1
    return codes, esum, seen_cp


def predict_frame(kp, code_hidden, code0_embed, seed, temperature, seen_cp, config,
                  repetition_penalty: float = 1.05, forced_codes=None, logits_out=None):
    """One frame's codes 1..15 (B == 1): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = predict_frame_kernel if code_hidden.is_cuda else predict_frame_plain
    return fn(kp, code_hidden, code0_embed, seed, temperature, seen_cp, config,
              repetition_penalty, forced_codes, logits_out)
