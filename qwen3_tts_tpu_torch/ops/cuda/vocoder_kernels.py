"""K6: the SEANet decoder block's residual units (CUDA kernel
csrc/vocoder_units.cu), and the block around them.

Counterpart of qwen3_tts_tpu/ops/pallas/vocoder_kernels.py::
residual_units_fused / seanet_block_fused. A decoder block is SnakeBeta ->
causal transposed-conv upsample (stride r) -> three dilated residual units
(d = 1, 3, 9); the last block also carries out_snake -> out_conv (k=7,
Cout=1) -> clip. The SnakeBeta and the phase-decomposed upsample before the
units stay plain torch ops (a matmul), as they are plain XLA in the JAX
package; the units (and the tail) are the kernel.
"""

from __future__ import annotations

import torch

from . import _build

DILATIONS = (1, 3, 9)
launches = 0  # kernel-sequence launches since the last reset


def _snake_params(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(exp(alpha), 1 / (exp(beta) + 1e-9)) in fp32."""
    a = torch.exp(p["alpha"].float())
    binv = 1.0 / (torch.exp(p["beta"].float()) + 1e-9)
    return a.contiguous(), binv.contiguous()


def build_seanet_block_params(
    block: dict, rate: int, dtype=torch.bfloat16, tail: dict | None = None
) -> dict:
    """Kernel layout for one decoder block from the dense tree ({"snake",
    "up": [2r, Cin, Cout] pre-flipped HIO, "units"}; torch tensors). `tail`
    = {"snake", "conv"} folds out_snake + out_conv + clip into the block."""
    w_up = block["up"]["w"]
    k, cin, cout = w_up.shape
    if k != 2 * rate:
        raise ValueError(f"decoder block expects k = 2 * rate (got k={k}, rate={rate})")

    def wd(t):
        return t.to(dtype).contiguous()

    units = block["units"]
    snakes1 = [_snake_params(u["act1"]) for u in units]
    snakes2 = [_snake_params(u["act2"]) for u in units]
    a0, b0 = _snake_params(block["snake"])
    kp = {
        "snake_a": a0, "snake_binv": b0,
        # out[t*r + p] = x[t] @ w_up[2r-1-p] + x[t-1] @ w_up[r-1-p]
        "w_lo": wd(torch.cat([w_up[2 * rate - 1 - p] for p in range(rate)], dim=1)),
        "w_hi": wd(torch.cat([w_up[rate - 1 - p] for p in range(rate)], dim=1)),
        "up_b": block["up"]["b"].float().contiguous(),
        "u_a1": torch.stack([s[0] for s in snakes1]),
        "u_binv1": torch.stack([s[1] for s in snakes1]),
        "u_w1": wd(torch.stack([u["conv1"]["w"].reshape(7 * cout, cout) for u in units])),
        "u_b1": torch.stack([u["conv1"]["b"].float() for u in units]),
        "u_a2": torch.stack([s[0] for s in snakes2]),
        "u_binv2": torch.stack([s[1] for s in snakes2]),
        "u_w2": wd(torch.stack([u["conv2"]["w"][0] for u in units])),
        "u_b2": torch.stack([u["conv2"]["b"].float() for u in units]),
    }
    if tail is not None:
        kp["t_a"], kp["t_binv"] = _snake_params(tail["snake"])
        kp["t_w"] = wd(tail["conv"]["w"].reshape(-1, 1))  # [7, C, 1] -> [7C, 1]
        kp["t_b"] = tail["conv"]["b"].float().reshape(1).contiguous()
    return kp


def _snake(x, a, binv):
    s = torch.sin(x * a)
    return x + binv * (s * s)


def _dilated_taps(x: torch.Tensor, w: torch.Tensor, k: int, d: int) -> torch.Tensor:
    b, s, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, (k - 1) * d, 0))
    wk = w.float().reshape(k, c, -1)
    return sum(xp[:, j * d:j * d + s] @ wk[j] for j in range(k))


def residual_units_plain(kp: dict, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (fp32 arithmetic, exact sin)."""
    yf = y.float()
    for u, d in enumerate(DILATIONS):
        h = _snake(yf, kp["u_a1"][u], kp["u_binv1"][u])
        h = _dilated_taps(h, kp["u_w1"][u], 7, d) + kp["u_b1"][u]
        h = _snake(h, kp["u_a2"][u], kp["u_binv2"][u])
        yf = yf + (h @ kp["u_w2"][u].float() + kp["u_b2"][u])
    if "t_w" in kp:
        ys = _snake(yf, kp["t_a"], kp["t_binv"])
        wav = _dilated_taps(ys, kp["t_w"], 7, 1) + kp["t_b"]
        return torch.clamp(wav[..., 0], -1.0, 1.0)
    return yf.to(y.dtype)


def residual_units_kernel(kp: dict, y: torch.Tensor) -> torch.Tensor:
    """Launch the kernel sequence on a CUDA tensor y [B, S, C]."""
    global launches
    b, s, c = y.shape
    _build.require(y, "y", dtype=(torch.float32, torch.bfloat16))
    for name in ("u_a1", "u_binv1", "u_b1", "u_a2", "u_binv2", "u_b2"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(3, c))
    rows = b * s
    tail = "t_w" in kp
    g = "qt_units_gemm"
    h = torch.empty((rows, c), dtype=torch.float32, device=y.device)
    acc = torch.empty((rows, c), dtype=torch.float32, device=y.device)
    cur = y.reshape(rows, c)
    for u, d in enumerate(DILATIONS):
        _build.gemm(g, cur, kp["u_w1"][u], h, seq=s, taps=7, dil=d,
                    alpha=kp["u_a1"][u], binv=kp["u_binv1"][u], bias=kp["u_b1"][u])
        last = u == len(DILATIONS) - 1 and not tail
        dst = torch.empty((rows, c), dtype=y.dtype, device=y.device) if last else acc
        _build.gemm(g, h, kp["u_w2"][u], dst, alpha=kp["u_a2"][u],
                    binv=kp["u_binv2"][u], bias=kp["u_b2"][u], res=cur)
        cur = dst
    launches += 1
    if tail:
        wav = torch.empty((rows, 1), dtype=torch.float32, device=y.device)
        _build.gemm(g, cur, kp["t_w"], wav, seq=s, taps=7, alpha=kp["t_a"],
                    binv=kp["t_binv"], bias=kp["t_b"], clip=1.0)
        return wav.reshape(b, s)
    return cur.reshape(b, s, c)


def residual_units_fused(kp: dict, y: torch.Tensor) -> torch.Tensor:
    """Three residual units (+ the tail when kp carries it): y [B, S, C] ->
    [B, S, C], or the clipped fp32 waveform [B, S] with the tail. The kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if y.is_cuda:
        return residual_units_kernel(kp, y.contiguous())
    return residual_units_plain(kp, y)


def block_upsample(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """SnakeBeta + causal transposed-conv upsample as torch ops (one matmul
    per phase pair): x [B, T, Cin] -> [B, T * rate, Cout] in x's dtype."""
    b, t, _ = x.shape
    wdt = kp["w_lo"].dtype
    xs = _snake(x.float(), kp["snake_a"], kp["snake_binv"]).to(wdt)
    prev = torch.nn.functional.pad(xs, (0, 0, 1, 0))[:, :t]
    acc = (xs @ kp["w_lo"]).float() + (prev @ kp["w_hi"]).float()
    return (acc.reshape(b, t * rate, -1) + kp["up_b"]).to(x.dtype)


def seanet_block_fused(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """Decoder block x [B, T, Cin] -> [B, T * rate, Cout] (or the waveform
    [B, T * rate] on the tail block)."""
    return residual_units_fused(kp, block_upsample(kp, x, rate=rate))
