"""K5: one ConvNeXt-upsample stage of the vocoder (CUDA kernels
csrc/upsample.cu).

Counterpart of qwen3_tts_tpu/ops/pallas/upsample_kernel.py::
upsample_stage_fused: x [B, T, C] -> [B, 2T, C] through the k=2 stride-2
causal transposed conv and a ConvNeXt block (causal depthwise k=7,
LayerNorm(1e-6), pointwise x4, exact GELU, pointwise back, gamma,
residual); with the folded SEANet initial_conv (the last stage) the output
is [B, 2T, Cic].
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel-sequence launches since the last reset


def build_upsample_stage_params(
    stage: dict, dtype=torch.bfloat16, initial_conv: dict | None = None
) -> dict:
    """Kernel layout for one stage from the dense tree ({"tconv": k=2
    pre-flipped HIO [2, C, C], "convnext": ...}; torch tensors). GEMM
    weights are [in, out] in `dtype`; everything else fp32."""
    w = stage["tconv"]["w"]
    k, cin, cout = w.shape
    if k != 2 or cin != cout:
        raise ValueError(f"upsample kernel expects k==stride==2, C==C (got {tuple(w.shape)})")
    cn = stage["convnext"]
    dw = cn["dwconv"]["w"]
    if dw.shape[0] != 7 or dw.shape[1] != 1:
        raise ValueError(f"upsample kernel expects a depthwise k=7 conv (got {tuple(dw.shape)})")

    def f32(t):
        return t.float().contiguous()

    def wd(t):
        return t.to(dtype).contiguous()

    out = {
        # column half p = output phase p = w[stride - 1 - p]
        "up_w": wd(torch.cat([w[1], w[0]], dim=1)),
        "up_b": f32(torch.cat([stage["tconv"]["b"]] * 2)),
        "dw": f32(dw[:, 0, :]),
        "dw_b": f32(cn["dwconv"]["b"]),
        "ln_w": f32(cn["norm"]["w"]),
        "ln_b": f32(cn["norm"]["b"]),
        "pw1_w": wd(cn["pwconv1"]["w"].T),
        "pw1_b": f32(cn["pwconv1"]["b"]),
        "pw2_w": wd(cn["pwconv2"]["w"].T),
        "pw2_b": f32(cn["pwconv2"]["b"]),
        "gamma": f32(cn["gamma"]),
    }
    if initial_conv is not None:
        w_ic = initial_conv["w"]  # [7, C, Cic] HIO
        if w_ic.shape[0] != 7 or w_ic.shape[1] != cin:
            raise ValueError(f"initial_conv fold expects k=7 from C (got {tuple(w_ic.shape)})")
        out["ic_w"] = wd(w_ic.reshape(7 * cin, w_ic.shape[2]))
        out["ic_b"] = f32(initial_conv["b"])
    return out


def _causal_taps(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """sum_j x[t - (k-1-j)] @ w[j] over [B, S, C] with w [k*C, N] (zeros
    before the sequence start)."""
    b, s, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    wk = w.float().reshape(k, c, -1)
    return sum(xp[:, j:j + s] @ wk[j] for j in range(k))


def upsample_stage_plain(kp: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel sequence (fp32 arithmetic)."""
    b, t, c = x.shape
    z = (x.float() @ kp["up_w"].float() + kp["up_b"]).reshape(b, 2 * t, c)
    zp = torch.nn.functional.pad(z, (0, 0, 6, 0))
    h = kp["dw_b"] + sum(zp[:, j:j + 2 * t] * kp["dw"][j] for j in range(7))
    h = torch.nn.functional.layer_norm(h, (c,), kp["ln_w"], kp["ln_b"], 1e-6)
    a = torch.nn.functional.gelu(h @ kp["pw1_w"].float() + kp["pw1_b"])
    o = z + kp["gamma"] * (a @ kp["pw2_w"].float() + kp["pw2_b"])
    if "ic_w" in kp:
        o = _causal_taps(o, kp["ic_w"], 7) + kp["ic_b"]
    return o.to(x.dtype)


def upsample_stage_kernel(kp: dict, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel sequence on a CUDA tensor x [B, T, C]."""
    global launches
    b, t, c = x.shape
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    for name in ("dw_b", "ln_w", "ln_b", "gamma"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(c,))
    _build.require(kp["dw"], "dw", dtype=torch.float32, shape=(7, c))
    rows2 = b * 2 * t
    f32 = dict(dtype=torch.float32, device=x.device)
    g = "qt_up_gemm"
    z = torch.empty((b * t, 2 * c), **f32)  # == [B*2T, C], phases interleaved
    _build.gemm(g, x.reshape(b * t, c), kp["up_w"], z, bias=kp["up_b"])
    z = z.view(rows2, c)
    h = torch.empty((rows2, c), **f32)
    rc = _build.lib().qt_up_dwconv_layernorm(
        z.data_ptr(), kp["dw"].data_ptr(), kp["dw_b"].data_ptr(),
        kp["ln_w"].data_ptr(), kp["ln_b"].data_ptr(), h.data_ptr(),
        rows2, 2 * t, c, 7, 1e-6, _build.stream(),
    )
    _build.check(rc, "qt_up_dwconv_layernorm")
    a = torch.empty((rows2, kp["pw1_w"].shape[1]), **f32)
    _build.gemm(g, h, kp["pw1_w"], a, bias=kp["pw1_b"], gelu=True)
    fold = "ic_w" in kp
    o = torch.empty((rows2, c), dtype=torch.float32 if fold else x.dtype, device=x.device)
    _build.gemm(g, a, kp["pw2_w"], o, bias=kp["pw2_b"], res=z, scale=kp["gamma"])
    if fold:
        out = torch.empty((rows2, kp["ic_w"].shape[1]), dtype=x.dtype, device=x.device)
        _build.gemm(g, o, kp["ic_w"], out, seq=2 * t, taps=7, bias=kp["ic_b"])
        o = out
    launches += 1
    return o.reshape(b, 2 * t, -1)


def upsample_stage_fused(kp: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return upsample_stage_kernel(kp, x.contiguous())
    return upsample_stage_plain(kp, x)
