"""K4 and K4a: the vocoder's causal pre-transformer (CUDA kernels
csrc/pretransformer.cu).

K4 is the counterpart of qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::
pre_transformer_packed, K4a of pre_transformer_fused: x [B, T, latent] ->
[B, T, latent] through input_proj, nl layers of RMSNorm -> RoPE attention
with LayerScale -> RMSNorm -> SwiGLU with LayerScale, the final norm and
output_proj. K4 reads fused q/k/v and gate/up weights; K4a the per-head
layout of build_pretransformer_fused_params (the JAX builder's arrays). The
residual stream and all intermediates are fp32; weights are fp32 or bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0  # K4 kernel-sequence launches since the last reset
fused_launches = 0  # K4a kernel-sequence launches since the last reset


def _inv_freq(dim: int, base: float) -> np.ndarray:
    return (
        1.0 / np.power(base, np.arange(0, dim, 2, dtype=np.float32) / dim)
    ).astype(np.float32)


def build_pretransformer_params(pt: dict, cfg, dtype=torch.bfloat16) -> dict:
    """Kernel layout from the dense pre_transformer tree (torch tensors,
    models/vocoder.py layout): fused q/k/v and gate/up weights, every
    weight pre-transposed to [in, out]; norms, LayerScales and biases fp32.
    Attention and MLP must be bias-free (the reference vocoder layout)."""
    L = pt["layers"]
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        if "b" in L[name]:
            raise ValueError(f"pre-transformer kernel requires bias-free {name}")

    def wt(t):  # [.., out, in] -> [.., in, out]
        return t.transpose(-1, -2).to(dtype).contiguous()

    def f32(t):
        return t.float().contiguous()

    dev = pt["norm"]["w"].device
    return {
        "wi": wt(pt["input_proj"]["w"]),
        "bi": f32(pt["input_proj"]["b"]),
        "ln1": f32(L["input_layernorm"]["w"]),
        "wqkv": wt(torch.cat([L["q_proj"]["w"], L["k_proj"]["w"], L["v_proj"]["w"]], 1)),
        "wo": wt(L["o_proj"]["w"]),
        "lsa": f32(L["self_attn_layer_scale"]["w"]),
        "ln2": f32(L["post_attention_layernorm"]["w"]),
        "wgu": wt(torch.cat([L["gate_proj"]["w"], L["up_proj"]["w"]], 1)),
        "wd": wt(L["down_proj"]["w"]),
        "lsm": f32(L["mlp_layer_scale"]["w"]),
        "fnorm": f32(pt["norm"]["w"]),
        "wout": wt(pt["output_proj"]["w"]),
        "bout": f32(pt["output_proj"]["b"]),
        "inv_freq": torch.from_numpy(
            _inv_freq(cfg.head_dim, cfg.rope_theta)
        ).to(dev),
    }


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) * w


def pre_transformer_plain(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                          eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel sequence (fp32 arithmetic)."""
    b, t, lat = x.shape
    nl = kp["wqkv"].shape[0]
    d = nh * hd
    inter = kp["wd"].shape[1]
    h = x.float() @ kp["wi"].float() + kp["bi"]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * kp["inv_freq"]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()

    def rope(z):  # [b, nh, t, hd]
        z1, z2 = z[..., : hd // 2], z[..., hd // 2:]
        return z * cos + torch.cat([-z2, z1], -1) * sin

    for l in range(nl):
        xn = _rms(h, kp["ln1"][l], eps)
        qkv = xn @ kp["wqkv"][l].float()
        q, k, v = (
            qkv[..., i * d:(i + 1) * d].reshape(b, t, nh, hd).transpose(1, 2)
            for i in range(3)
        )
        q, k = rope(q), rope(k)
        s = (q @ k.transpose(-1, -2)) * (1.0 / hd ** 0.5)
        p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        o = (p @ v).transpose(1, 2).reshape(b, t, d)
        h = h + kp["lsa"][l] * (o @ kp["wo"][l].float())
        gu = _rms(h, kp["ln2"][l], eps) @ kp["wgu"][l].float()
        m = torch.nn.functional.silu(gu[..., :inter]) * gu[..., inter:]
        h = h + kp["lsm"][l] * (m @ kp["wd"][l].float())
    out = _rms(h, kp["fnorm"], eps) @ kp["wout"].float() + kp["bout"]
    return out.to(x.dtype)


def pre_transformer_kernel(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                           eps: float) -> torch.Tensor:
    """Launch the kernel sequence on a CUDA tensor x [B, T, latent]."""
    global launches
    b, t, lat = x.shape
    nl, hid, d3 = kp["wqkv"].shape
    d = nh * hd
    inter = kp["wd"].shape[1]
    if d3 != 3 * d or hd % 32 or hd > 128:
        raise ValueError(f"pre-transformer kernel: nh={nh}, hd={hd} do not fit "
                         f"wqkv {tuple(kp['wqkv'].shape)} (hd % 32 == 0, <= 128)")
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    for name in ("ln1", "lsa", "ln2", "lsm"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(nl, hid))
    _build.require(kp["inv_freq"], "inv_freq", dtype=torch.float32, shape=(hd // 2,))
    rows = b * t
    lib, st = _build.lib(), _build.stream()
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((rows, hid), **f32)
    xn = torch.empty((rows, hid), **f32)
    qkv = torch.empty((rows, 3 * d), **f32)
    o = torch.empty((rows, d), **f32)
    gu = torch.empty((rows, 2 * inter), **f32)
    mm = torch.empty((rows, inter), **f32)
    out = torch.empty((rows, lat), dtype=x.dtype, device=x.device)
    g = "qt_pt_gemm"

    def rms(src, w):
        _build.check(lib.qt_pt_rmsnorm(src.data_ptr(), w.data_ptr(), xn.data_ptr(),
                                       rows, hid, eps, st), "qt_pt_rmsnorm")

    _build.gemm(g, x.reshape(rows, lat), kp["wi"], h, bias=kp["bi"])
    for l in range(nl):
        rms(h, kp["ln1"][l])
        _build.gemm(g, xn, kp["wqkv"][l], qkv)
        _build.check(lib.qt_pt_rope(qkv.data_ptr(), kp["inv_freq"].data_ptr(),
                                    rows, t, nh, hd, st), "qt_pt_rope")
        _build.check(lib.qt_pt_attention(qkv.data_ptr(), o.data_ptr(), b, t, nh, hd,
                                         1.0 / hd ** 0.5, st), "qt_pt_attention")
        _build.gemm(g, o, kp["wo"][l], h, res=h, scale=kp["lsa"][l])
        rms(h, kp["ln2"][l])
        _build.gemm(g, xn, kp["wgu"][l], gu)
        _build.check(lib.qt_pt_silu_mul(gu.data_ptr(), mm.data_ptr(), rows, inter, st),
                     "qt_pt_silu_mul")
        _build.gemm(g, mm, kp["wd"][l], h, res=h, scale=kp["lsm"][l])
    rms(h, kp["fnorm"])
    _build.gemm(g, xn, kp["wout"], out, bias=kp["bout"])
    launches += 1
    return out.reshape(b, t, lat)


def pre_transformer_packed(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                           eps: float) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return pre_transformer_kernel(kp, x.contiguous(), nh=nh, hd=hd, eps=eps)
    return pre_transformer_plain(kp, x, nh=nh, hd=hd, eps=eps)


# ---------------------------------------------------------------------------
# K4a: the per-head layout
# ---------------------------------------------------------------------------


def build_pretransformer_fused_params(pt: dict, cfg, dtype=torch.bfloat16) -> dict:
    """K4a's layout from the dense pre_transformer tree (torch tensors), the
    arrays of the JAX package's build_pretransformer_kernel_params_device:
    wq/wk/wv [nl, nh, H, hd] and wo [nl, nh, hd, H] per head, wg/wu [nl, H,
    I] and wd [nl, I, H] pre-transposed, wi / wout pre-transposed, in
    `dtype`; norms and LayerScales [nl, 1, H], biases [1, n], fp32; rotm
    [hd, hd] with x @ rotm == rotate_half(x). Plus inv_freq [hd/2] (the JAX
    call takes rope_theta instead). Attention and MLP must be bias-free."""
    L = pt["layers"]
    nh, hd, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        if "b" in L[name]:
            raise ValueError(f"pre-transformer kernel requires bias-free {name}")

    def heads_in(w):  # [nl, nh*hd, H] -> [nl, nh, H, hd]
        return w.reshape(w.shape[0], nh, hd, h).permute(0, 1, 3, 2).to(dtype).contiguous()

    def f32row(w):  # [nl, H] -> [nl, 1, H]
        return w[:, None, :].float().contiguous()

    def wt(w):  # [.., out, in] -> [.., in, out]
        return w.transpose(-1, -2).to(dtype).contiguous()

    dev = pt["norm"]["w"].device
    half = hd // 2
    rotm = torch.zeros(hd, hd, device=dev)
    idx = torch.arange(half, device=dev)
    rotm[idx + half, idx] = -1.0
    rotm[idx, idx + half] = 1.0
    wo = L["o_proj"]["w"]
    return {
        "wi": wt(pt["input_proj"]["w"]),
        "bi": pt["input_proj"]["b"][None].float().contiguous(),
        "ln1": f32row(L["input_layernorm"]["w"]),
        "wq": heads_in(L["q_proj"]["w"]),
        "wk": heads_in(L["k_proj"]["w"]),
        "wv": heads_in(L["v_proj"]["w"]),
        "rotm": rotm,
        "wo": wo.reshape(wo.shape[0], h, nh, hd).permute(0, 2, 3, 1).to(dtype).contiguous(),
        "lsa": f32row(L["self_attn_layer_scale"]["w"]),
        "ln2": f32row(L["post_attention_layernorm"]["w"]),
        "wg": wt(L["gate_proj"]["w"]),
        "wu": wt(L["up_proj"]["w"]),
        "wd": wt(L["down_proj"]["w"]),
        "lsm": f32row(L["mlp_layer_scale"]["w"]),
        "fnorm": pt["norm"]["w"][None].float().contiguous(),
        "wout": wt(pt["output_proj"]["w"]),
        "bout": pt["output_proj"]["b"][None].float().contiguous(),
        "inv_freq": torch.from_numpy(_inv_freq(hd, cfg.rope_theta)).to(dev),
    }


def pre_transformer_fused_plain(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                                eps: float) -> torch.Tensor:
    """Plain PyTorch version (fp32 arithmetic), head by head as the TPU
    kernel computes it, rotate-half as the product with rotm."""
    b, t, _ = x.shape
    nl = kp["wq"].shape[0]
    h = x.float() @ kp["wi"].float() + kp["bi"]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * kp["inv_freq"]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    rotm = kp["rotm"].float()
    for l in range(nl):
        xin = _rms(h, kp["ln1"][l], eps)
        acc = torch.zeros_like(h)
        for j in range(nh):
            qh = xin @ kp["wq"][l, j].float()  # [b, t, hd]
            kh = xin @ kp["wk"][l, j].float()
            vh = xin @ kp["wv"][l, j].float()
            qh = qh * cos + (qh @ rotm) * sin
            kh = kh * cos + (kh @ rotm) * sin
            s = (qh @ kh.transpose(-1, -2)) * (1.0 / hd ** 0.5)
            p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
            acc = acc + (p @ vh) @ kp["wo"][l, j].float()
        h = h + kp["lsa"][l] * acc
        x2 = _rms(h, kp["ln2"][l], eps)
        m = torch.nn.functional.silu(x2 @ kp["wg"][l].float()) * (x2 @ kp["wu"][l].float())
        h = h + kp["lsm"][l] * (m @ kp["wd"][l].float())
    out = _rms(h, kp["fnorm"], eps) @ kp["wout"].float() + kp["bout"]
    return out.to(x.dtype)


def pre_transformer_fused_kernel(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                                 eps: float) -> torch.Tensor:
    """Launch K4a's kernel sequence on a CUDA tensor x [B, T, latent]."""
    global fused_launches
    b, t, lat = x.shape
    nl, nh_w, hid, hd_w = kp["wq"].shape
    inter = kp["wg"].shape[2]
    if (nh_w, hd_w) != (nh, hd) or hd not in (64, 128):
        raise ValueError(f"K4a: nh={nh}, hd={hd} do not fit wq {tuple(kp['wq'].shape)} "
                         "(hd 64 or 128)")
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    wdt = kp["wq"].dtype
    for name, shape in (("wk", kp["wq"].shape), ("wv", kp["wq"].shape),
                        ("wo", (nl, nh, hd, hid)), ("wg", (nl, hid, inter)),
                        ("wu", (nl, hid, inter)), ("wd", (nl, inter, hid))):
        _build.require(kp[name], name, dtype=wdt, shape=shape)
    for name in ("ln1", "lsa", "ln2", "lsm"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(nl, 1, hid))
    _build.require(kp["inv_freq"], "inv_freq", dtype=torch.float32, shape=(hd // 2,))
    rows = b * t
    lib, st = _build.lib(), _build.stream()
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((rows, hid), **f32)
    xn = torch.empty((rows, hid), **f32)
    o = torch.empty((rows, nh * hd), **f32)
    g = torch.empty((rows, inter), **f32)
    u = torch.empty((rows, inter), **f32)
    mm = torch.empty((rows, inter), **f32)
    out = torch.empty((rows, lat), dtype=x.dtype, device=x.device)
    scratch = None  # q/k/v of every (row, head) when they do not fit in shared memory
    if t > lib.qt_pt_head_store_rows(hd):
        scratch = torch.empty((b, nh, 3, t, hd + 1), **f32)
    w_bf16 = _build.is_bf16(kp["wq"])
    gm = "qt_pt_gemm"

    def rms(src, w):
        _build.check(lib.qt_pt_rmsnorm(src.data_ptr(), w.data_ptr(), xn.data_ptr(),
                                       rows, hid, eps, st), "qt_pt_rmsnorm")

    _build.gemm(gm, x.reshape(rows, lat), kp["wi"], h, bias=kp["bi"].reshape(-1))
    for l in range(nl):
        rms(h, kp["ln1"][l])
        _build.check(lib.qt_pt_head_attention(
            xn.data_ptr(), kp["wq"][l].data_ptr(), kp["wk"][l].data_ptr(),
            kp["wv"][l].data_ptr(), w_bf16, kp["inv_freq"].data_ptr(), _build.ptr(scratch),
            o.data_ptr(), b, t, hid, nh, hd, 1.0 / hd ** 0.5, st), "qt_pt_head_attention")
        # o-projection: heads side by side, summed over in order by the GEMM's K loop
        _build.gemm(gm, o, kp["wo"][l].reshape(nh * hd, hid), h, res=h,
                    scale=kp["lsa"][l].reshape(-1))
        rms(h, kp["ln2"][l])
        _build.gemm(gm, xn, kp["wg"][l], g)
        _build.gemm(gm, xn, kp["wu"][l], u)
        _build.check(lib.qt_pt_silu_mul2(g.data_ptr(), u.data_ptr(), mm.data_ptr(),
                                         rows * inter, st), "qt_pt_silu_mul2")
        _build.gemm(gm, mm, kp["wd"][l], h, res=h, scale=kp["lsm"][l].reshape(-1))
    rms(h, kp["fnorm"].reshape(-1))
    _build.gemm(gm, xn, kp["wout"], out, bias=kp["bout"].reshape(-1))
    fused_launches += 1
    return out.reshape(b, t, lat)


def pre_transformer_fused(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                          eps: float) -> torch.Tensor:
    """K4a's entry point: the kernel for a CUDA tensor, the plain version for
    a CPU tensor; any other device raises."""
    if x.is_cuda:
        return pre_transformer_fused_kernel(kp, x.contiguous(), nh=nh, hd=hd, eps=eps)
    if x.device.type == "cpu":
        return pre_transformer_fused_plain(kp, x, nh=nh, hd=hd, eps=eps)
    raise ValueError(f"pre_transformer_fused: no kernel or plain version for {x.device}")
