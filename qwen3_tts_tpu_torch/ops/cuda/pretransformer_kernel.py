"""K4: the vocoder's causal pre-transformer (CUDA kernels
csrc/pretransformer.cu).

Counterpart of qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::
pre_transformer_packed: x [B, T, latent] -> [B, T, latent] through
input_proj, nl layers of RMSNorm -> RoPE attention with LayerScale ->
RMSNorm -> SwiGLU with LayerScale, the final norm and output_proj. The
residual stream and all intermediates are fp32; weights are fp32 or bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0  # kernel-sequence launches since the last reset


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
