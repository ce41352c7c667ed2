"""1-D convolution primitives for the vocoder, channels-last [B, T, C] at
every public function, with the JAX package's parameter layouts
(qwen3_tts_tpu/ops/conv.py):

  conv:           {"w": [K, Cin/groups, Cout] (HIO), optional "b": [Cout]}
  transpose conv: {"w": [K, Cin, Cout] HIO, spatially pre-flipped}

Inside, torch's conv1d runs on [B, C, T].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .linear import linear
from .norms import layer_norm


def _torch_w(w: torch.Tensor, dtype) -> torch.Tensor:
    return w.to(dtype).permute(2, 1, 0)  # HIO -> [Cout, Cin/g, K]


def conv1d(params: dict, x: torch.Tensor, *, stride: int = 1, dilation: int = 1,
           groups: int = 1, padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain 1-D conv over [B, T, Cin] -> [B, T', Cout]."""
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(xt, _torch_w(params["w"], x.dtype), stride=stride,
                 dilation=dilation, groups=groups).transpose(1, 2)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def causal_extra_pad(length: int, k_eff: int, stride: int) -> int:
    pad = k_eff - stride
    n_frames = (length - k_eff + pad) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - pad)
    return ideal - length


def causal_conv1d(params: dict, x: torch.Tensor, *, stride: int = 1,
                  dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Causal conv: left pad (k_eff - stride), right pad the ceil-mode rest."""
    k = params["w"].shape[0]
    k_eff = (k - 1) * dilation + 1
    return conv1d(
        params, x, stride=stride, dilation=dilation, groups=groups,
        padding=(k_eff - stride, causal_extra_pad(x.shape[1], k_eff, stride)),
    )


def left_pad_conv1d(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 conv with pure left padding k - 1."""
    return conv1d(params, x, padding=(params["w"].shape[0] - 1, 0))


def transpose_conv1d(params: dict, x: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Full (VALID) transposed conv: [B, T, Cin] -> [B, (T-1)*s + K, Cout]."""
    w = params["w"].to(x.dtype).flip(0).permute(1, 2, 0)  # -> [Cin, Cout, K]
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride).transpose(1, 2)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def causal_transpose_conv1d(params: dict, x: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Transposed conv, then trim (K - stride) from the right: T -> T*stride.
    K == stride is one matmul: out[t*s + p] = x[t] @ w[s-1-p]."""
    w = params["w"]
    k = w.shape[0]
    if k == stride:
        b, t, _ = x.shape
        wf = torch.cat([w[stride - 1 - p] for p in range(stride)], dim=1).to(x.dtype)
        y = (x @ wf).reshape(b, t * stride, w.shape[2])
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y
    y = transpose_conv1d(params, x, stride=stride)
    trim = k - stride
    return y[:, : y.shape[1] - trim] if trim > 0 else y


def snake_beta(params: dict, x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x + 1/(e^beta + eps) * sin(x e^alpha)^2, in fp32."""
    alpha = torch.exp(params["alpha"].float())
    beta = torch.exp(params["beta"].float())
    x32 = x.float()
    y = x32 + (1.0 / (beta + eps)) * torch.sin(x32 * alpha) ** 2
    return y.to(x.dtype)


def convnext_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise k=7 -> LayerNorm(1e-6) -> pw x4 -> exact GELU -> pw
    -> gamma -> residual."""
    h = causal_conv1d(params["dwconv"], x, groups=x.shape[-1])
    h = layer_norm(h, params["norm"]["w"], params["norm"]["b"], 1e-6)
    h = F.gelu(linear(params["pwconv1"], h))
    h = linear(params["pwconv2"], h)
    return x + params["gamma"].to(h.dtype) * h
