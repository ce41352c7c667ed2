"""K6: the SEANet decoder block's residual units (CUDA kernel
csrc/vocoder_units.cu), and the block around them.

Counterpart of qwen3_tts_tpu/ops/pallas/vocoder_kernels.py::
residual_units_fused / seanet_block_fused. A decoder block is SnakeBeta ->
causal transposed-conv upsample (stride r) -> three dilated residual units
(d = 1, 3, 9); the last block also carries out_snake -> out_conv (k=7,
Cout=1) -> clip. The units (and the tail) are the kernel. The SnakeBeta and
the phase-decomposed upsample before them, plain XLA in the JAX package,
are a causal 2-tap conv here (block_upsample), on the same launches as the
units. With bf16 weights (the pipeline's) both run on the tensor cores
(qt_units_conv, bf16 operands, fp32 sums); with fp32 weights on the exact
fp32 GEMM of csrc/gemm.cuh. The wrappers pick by the weights' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, persistent

DILATIONS = (1, 3, 9)
launches = 0  # kernel-sequence launches since the last reset
upsample_launches = 0  # block_upsample launches since the last reset

# bf16 tensor-core conv tiles (BM rows x BN columns) of csrc/vocoder_units.cu,
# largest first
CONV_TILES = ((128, 128), (128, 96), (128, 64), (64, 64))


class ConvArgs(ctypes.Structure):
    """Mirror of QtConvArgs in csrc/vocoder_units.cu."""

    _fields_ = _build.struct_fields(
        "a:p w:p bias:p res:p res_bf16:i out:p out_bf16:i act_alpha:p act_binv:p act:p "
        "B:i S:i C:i N:i taps:i dil:i")


def conv_tile(b: int, s: int, n: int, sms: int) -> tuple[int, int]:
    """The largest tile whose width divides n and of which there are at
    least `sms` (one per SM) over b sequences of s rows; else 64 x 64 (a
    ragged n is masked at the edge)."""
    for bm, bn in CONV_TILES:
        if n % bn == 0 and b * -(-s // bm) * (n // bn) >= sms:
            return bm, bn
    return 64, 64


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
        # out[t*r + p] = x[t-1] @ w_up[r-1-p] + x[t] @ w_up[2r-1-p]: the taps
        # [w_hi; w_lo] of a causal 2-tap conv to r * Cout columns, where
        # column half p of row t is output row t*r + p; the bias tiled r times
        "up_w": wd(torch.cat([torch.cat([w_up[rate - 1 - p] for p in range(rate)], dim=1),
                              torch.cat([w_up[2 * rate - 1 - p] for p in range(rate)], dim=1)])),
        "up_b": block["up"]["b"].float().repeat(rate).contiguous(),
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
    """Plain PyTorch version (fp32 arithmetic, exact sin). With bf16
    weights each product's activation operand (a SnakeBeta output) is
    rounded to bf16 first, as the JAX kernel rounds to its compute dtype
    and the kernel feeds its tensor cores; sums stay fp32."""
    yf = y.float()
    rounds = kp["u_w1"].dtype == torch.bfloat16

    def op(t):
        return t.bfloat16().float() if rounds else t

    for u, d in enumerate(DILATIONS):
        h = op(_snake(yf, kp["u_a1"][u], kp["u_binv1"][u]))
        h = _dilated_taps(h, kp["u_w1"][u], 7, d) + kp["u_b1"][u]
        h = op(_snake(h, kp["u_a2"][u], kp["u_binv2"][u]))
        yf = yf + (h @ kp["u_w2"][u].float() + kp["u_b2"][u])
    if "t_w" in kp:
        ys = op(_snake(yf, kp["t_a"], kp["t_binv"]))
        wav = _dilated_taps(ys, kp["t_w"], 7, 1) + kp["t_b"]
        return torch.clamp(wav[..., 0], -1.0, 1.0)
    return yf.to(y.dtype)


def _conv(a, w, *, b, s, taps, dil, bias, res=None, out=None, act=None, snake=None) -> None:
    """One bf16 tensor-core causal conv launch (qt_units_conv) over the
    activated bf16 operand a [b * s, C]: out = (res +) bias + conv(a, w)
    when out is given, act = bf16(SnakeBeta `snake` of it) when act is."""
    c, n = a.shape[-1], w.shape[1]
    bm, bn = conv_tile(b, s, n, persistent.sm_count(a.device))
    args = ConvArgs(
        a=a.data_ptr(), w=w.data_ptr(), bias=bias.data_ptr(), res=_build.ptr(res),
        res_bf16=_build.is_bf16(res) if res is not None else 0, out=_build.ptr(out),
        out_bf16=_build.is_bf16(out) if out is not None else 0,
        act_alpha=_build.ptr(snake[0]) if act is not None else None,
        act_binv=_build.ptr(snake[1]) if act is not None else None, act=_build.ptr(act),
        B=b, S=s, C=c, N=n, taps=taps, dil=dil)
    _build.check(_build.lib().qt_units_conv(ctypes.addressof(args), bm, bn, _build.stream()),
                 "qt_units_conv")


def _units_mma(kp: dict, y: torch.Tensor) -> torch.Tensor:
    """bf16 weights: the units (and the tail) on the tensor-core conv. Each
    conv reads its operand already activated in bf16: the first from
    qt_units_snake, the others from the epilogue of the conv before."""
    b, s, c = y.shape
    rows = b * s
    if c % 8:
        raise ValueError(f"K6's bf16 kernel needs channels % 8 == 0 (got {c})")
    for name in ("u_w1", "u_w2"):
        _build.require(kp[name], name, dtype=torch.bfloat16)
    tail = "t_w" in kp
    if tail:
        _build.require(kp["t_w"], "t_w", dtype=torch.bfloat16, shape=(7 * c, 1))
    lib, st = _build.lib(), _build.stream()
    a = torch.empty((rows, c), dtype=torch.bfloat16, device=y.device)
    a2 = torch.empty((rows, c), dtype=torch.bfloat16, device=y.device)
    acc = torch.empty((rows, c), dtype=torch.float32, device=y.device)
    cur = y.reshape(rows, c)
    _build.check(lib.qt_units_snake(cur.data_ptr(), _build.is_bf16(cur), kp["u_a1"][0].data_ptr(),
                                    kp["u_binv1"][0].data_ptr(), a.data_ptr(), rows * c, c, st),
                 "qt_units_snake")
    last = len(DILATIONS) - 1
    for u, d in enumerate(DILATIONS):
        _conv(a, kp["u_w1"][u], b=b, s=s, taps=7, dil=d, bias=kp["u_b1"][u], act=a2,
              snake=(kp["u_a2"][u], kp["u_binv2"][u]))
        if u < last:  # y for the next unit's residual, its operand for its conv1
            out, nxt = acc, (kp["u_a1"][u + 1], kp["u_binv1"][u + 1])
        elif tail:  # only the tail's operand
            out, nxt = None, (kp["t_a"], kp["t_binv"])
        else:
            out, nxt = torch.empty((rows, c), dtype=y.dtype, device=y.device), None
        _conv(a2, kp["u_w2"][u], b=b, s=s, taps=1, dil=1, bias=kp["u_b2"][u], res=cur, out=out,
              act=a if nxt is not None else None, snake=nxt)
        cur = out
    if not tail:
        return cur.reshape(b, s, c)
    wav = torch.empty(rows, dtype=torch.float32, device=y.device)
    _build.check(lib.qt_units_tail(a.data_ptr(), kp["t_w"].data_ptr(), kp["t_b"].data_ptr(),
                                   wav.data_ptr(), rows, s, c, st), "qt_units_tail")
    return wav.reshape(b, s)


def residual_units_kernel(kp: dict, y: torch.Tensor) -> torch.Tensor:
    """Launch the kernels on a CUDA tensor y [B, S, C]: the bf16
    tensor-core conv for bf16 weights, the exact fp32 GEMM sequence for
    fp32 weights."""
    global launches
    b, s, c = y.shape
    _build.require(y, "y", dtype=(torch.float32, torch.bfloat16))
    for name in ("u_a1", "u_binv1", "u_b1", "u_a2", "u_binv2", "u_b2"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(3, c))
    if kp["u_w1"].dtype == torch.bfloat16:
        out = _units_mma(kp, y)
        with _build.COUNT_LOCK:
            launches += 1
        return out
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
    with _build.COUNT_LOCK:
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


def block_upsample_plain(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """Plain PyTorch version of block_upsample: SnakeBeta, its output
    rounded to the weights' dtype (JAX's cast to its compute dtype), then
    both taps as fp32 products of the widened operands, so products are
    exact and sums fp32 as JAX's preferred_element_type=float32; bias, and
    the cast to x's dtype."""
    b, t, cin = x.shape
    xs = _snake(x.float(), kp["snake_a"], kp["snake_binv"]).to(kp["up_w"].dtype).float()
    prev = torch.nn.functional.pad(xs, (0, 0, 1, 0))[:, :t]
    w = kp["up_w"].float()
    acc = prev @ w[:cin] + xs @ w[cin:] + kp["up_b"]
    return acc.reshape(b, t * rate, -1).to(x.dtype)


def block_upsample_kernel(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """Launch the block's upsample on a CUDA tensor x [B, T, Cin] ->
    [B, T * rate, Cout] in x's dtype: with bf16 weights the SnakeBeta
    pre-pass writes the bf16 operand and the tensor-core conv (2 taps)
    makes the output; with fp32 weights one exact fp32 GEMM launch with
    SnakeBeta in its prologue."""
    global upsample_launches
    b, t, cin = x.shape
    n = kp["up_w"].shape[1]
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    _build.require(kp["up_w"], "up_w", dtype=(torch.float32, torch.bfloat16), shape=(2 * cin, n))
    _build.require(kp["up_b"], "up_b", dtype=torch.float32, shape=(n,))
    for name in ("snake_a", "snake_binv"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(cin,))
    rows = b * t
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if kp["up_w"].dtype == torch.bfloat16:
        if cin % 8 or n % 8:
            raise ValueError(f"the bf16 block upsample needs Cin, N % 8 == 0 (got {cin}, {n})")
        xs = torch.empty((rows, cin), dtype=torch.bfloat16, device=x.device)
        _build.check(_build.lib().qt_units_snake(
            x.data_ptr(), _build.is_bf16(x), kp["snake_a"].data_ptr(), kp["snake_binv"].data_ptr(),
            xs.data_ptr(), rows * cin, cin, _build.stream()), "qt_units_snake")
        _conv(xs, kp["up_w"], b=b, s=t, taps=2, dil=1, bias=kp["up_b"], out=out)
    else:
        _build.gemm("qt_units_gemm", x.reshape(rows, cin), kp["up_w"], out, seq=t, taps=2,
                    alpha=kp["snake_a"], binv=kp["snake_binv"], bias=kp["up_b"])
    with _build.COUNT_LOCK:
        upsample_launches += 1
    return out.reshape(b, t * rate, n // rate)


def block_upsample(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """SnakeBeta + causal transposed-conv upsample, x [B, T, Cin] ->
    [B, T * rate, Cout] in x's dtype: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.is_cuda:
        return block_upsample_kernel(kp, x.contiguous(), rate=rate)
    return block_upsample_plain(kp, x, rate=rate)


def seanet_block_fused(kp: dict, x: torch.Tensor, *, rate: int) -> torch.Tensor:
    """Decoder block x [B, T, Cin] -> [B, T * rate, Cout] (or the waveform
    [B, T * rate] on the tail block)."""
    return residual_units_fused(kp, block_upsample(kp, x, rate=rate))
