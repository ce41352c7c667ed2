"""Audio encoder for ICL voice cloning: 24 kHz waveform -> 16 x T codec codes
(counterpart of qwen3_tts_tpu/models/audio_encoder.py, plain PyTorch: the
JAX encoder reaches no Pallas kernel).

  causal SEANet CNN (initial conv, per ratio [ResnetBlock xN, ELU, strided
  conv k=2r s=r] over the REVERSED upsampling_ratios, final ELU + conv) ->
  8-layer NON-causal transformer (LayerNorm, exact-erf GELU fc1/fc2 MLP,
  LayerScale, RoPE theta 1e4) -> x`compress` downsample conv -> split
  residual VQ encode (L2-argmin nearest codebook row, residual
  subtraction) -> the first encoder_valid_num_quantizers codes.

Channels-last [B, T, C]; the Mimi causal conv padding rule is the vocoder's
(ops.conv.causal_conv1d).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpeechTokenizerConfig, TokenizerEncoderConfig
from ..convert import to_torch
from ..ops import rope as rope_ops
from ..ops.attention import sdpa
from ..ops.conv import causal_conv1d
from ..ops.linear import linear
from ..ops.norms import layer_norm
from ..utils.device import resolve_device


def _elu(x: torch.Tensor) -> torch.Tensor:
    """ELU, alpha 1, through expm1 as the reference computes it."""
    return torch.clamp(x, min=0) + torch.clamp(torch.expm1(x), max=0)


def resnet_block(params: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """ELU -> causal conv k3 (dilated) -> ELU -> causal conv k1, plus x."""
    h = causal_conv1d(params["conv1"], _elu(x), dilation=dilation)
    return x + causal_conv1d(params["conv2"], _elu(h))


def seanet_encode(params: dict, x: torch.Tensor, cfg: TokenizerEncoderConfig) -> torch.Tensor:
    """[B, L, 1] -> [B, L / prod(ratios), hidden_size]."""
    h = causal_conv1d(params["initial_conv"], x)
    for stage, ratio in zip(params["stages"], reversed(cfg.upsampling_ratios)):
        for res, dil_idx in zip(stage["resnets"], range(cfg.num_residual_layers)):
            h = resnet_block(res, h, cfg.dilation_growth_rate ** dil_idx)
        h = causal_conv1d(stage["down"], _elu(h), stride=ratio)
    return causal_conv1d(params["final_conv"], _elu(h))


def encoder_transformer(params: dict, x: torch.Tensor, cfg: TokenizerEncoderConfig) -> torch.Tensor:
    """Bidirectional transformer over [B, T, H]."""
    b, t, _ = x.shape
    hd, nh = cfg.head_dim, cfg.num_attention_heads
    scale = 1.0 / float(hd) ** 0.5
    inv = rope_ops.inv_freq_tensor(hd, cfg.rope_theta, x.device)
    cos, sin = rope_ops.rope_cos_sin(torch.arange(t, device=x.device)[None], inv)
    c, s = cos[:, None], sin[:, None]
    h = x
    for lp in params["layers"]:
        xin = layer_norm(h, lp["input_layernorm"]["w"], lp["input_layernorm"]["b"], cfg.norm_eps)

        def heads(name):
            return linear(lp[name], xin).reshape(b, t, nh, hd).transpose(1, 2)

        q = rope_ops.apply_rope(heads("q_proj"), c, s)
        k = rope_ops.apply_rope(heads("k_proj"), c, s)
        attn = sdpa(q, k, heads("v_proj"), scale).transpose(1, 2).reshape(b, t, -1)
        h = h + lp["self_attn_layer_scale"]["w"] * linear(lp["o_proj"], attn)
        x2 = layer_norm(h, lp["post_attention_layernorm"]["w"],
                        lp["post_attention_layernorm"]["b"], cfg.norm_eps)
        m = linear(lp["fc2"], F.gelu(linear(lp["fc1"], x2)))
        h = h + lp["mlp_layer_scale"]["w"] * m
    return h


def nearest_codes(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L2-argmin over codebook rows: codebook [V, D], x [B, T, D] -> [B, T]."""
    dist = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ codebook.T)
            + (codebook * codebook).sum(-1)[None, None, :])
    return torch.argmin(dist, dim=-1)


def rvq_encode_half(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Residual VQ encode of one half: [B, T, H] -> codes [n, B, T]."""
    residual = linear(params["input_proj"], x)
    codes = []
    for cb in params["codebooks"]:
        idx = nearest_codes(cb, residual)
        codes.append(idx)
        residual = residual - cb[idx]
    return torch.stack(codes)


def encode_hidden(params: dict, audio: torch.Tensor, cfg: TokenizerEncoderConfig) -> torch.Tensor:
    """[B, L] float32 -> the downsampled hidden states [B, T, H] that the
    RVQ encodes."""
    h = seanet_encode(params["seanet"], audio[..., None], cfg)
    h = encoder_transformer(params["transformer"], h, cfg)
    return causal_conv1d(params["downsample"], h, stride=cfg.compress)


def audio_encode(params: dict, audio, cfg: TokenizerEncoderConfig,
                 valid_num_quantizers: int = 16) -> torch.Tensor:
    """[B, L] or [L] float32 -> codes [B, valid_num_quantizers, T] int64."""
    x = audio.float() if audio.dim() > 1 else audio.float()[None]
    h = encode_hidden(params, x, cfg)
    q = params["quantizer"]
    codes = torch.cat([rvq_encode_half(q["semantic"], h), rvq_encode_half(q["acoustic"], h)])
    return codes.transpose(0, 1)[:, :valid_num_quantizers]


def _conv_p(w: dict, prefix: str) -> dict:
    weight = np.asarray(w[f"{prefix}.weight"], np.float32).transpose(2, 1, 0)
    p = {"w": np.ascontiguousarray(weight)}
    if f"{prefix}.bias" in w:
        p["b"] = np.asarray(w[f"{prefix}.bias"], np.float32)
    return p


def _lin_p(w: dict, prefix: str) -> dict:
    weight = np.asarray(w[f"{prefix}.weight"], np.float32)
    p = {"w": weight[:, :, 0] if weight.ndim == 3 else weight}  # conv1d k=1 proj
    if f"{prefix}.bias" in w:
        p["b"] = np.asarray(w[f"{prefix}.bias"], np.float32)
    return p


def load_audio_encoder_params(weights: dict, cfg: TokenizerEncoderConfig) -> dict:
    """The encoder tree (numpy) from the "encoder."-prefixed keys of the
    speech_tokenizer checkpoint; RVQ codebooks = embedding_sum / usage
    (usage clipped at 1e-5). SEANet layer indices follow the reference's flat
    layer list: 0 = initial conv, then per ratio [num_residual_layers
    resnets, ELU, downsample conv], then the final ELU and conv (ELUs hold no
    weights but take indices)."""
    w = {k[len("encoder."):]: v for k, v in weights.items() if k.startswith("encoder.")}
    stats: dict[str, dict[str, np.ndarray]] = {}
    clean = {}
    for k, v in w.items():
        if "._codebook.cluster_usage" in k or "._codebook.embedding_sum" in k:
            base, _, fld = k.partition("._codebook.")
            stats.setdefault(base, {})[fld] = v
        else:
            clean[k] = v
    for base, d in stats.items():
        usage = np.clip(np.asarray(d["cluster_usage"], np.float32), 1e-5, None)
        clean[f"{base}.codebook.embed"] = np.asarray(d["embedding_sum"], np.float32) / usage[:, None]
    w = clean

    idx = 0
    seanet: dict = {"stages": [], "initial_conv": _conv_p(w, f"encoder.layers.{idx}.conv")}
    idx += 1
    for _ratio in reversed(cfg.upsampling_ratios):
        resnets = []
        for _j in range(cfg.num_residual_layers):
            resnets.append({"conv1": _conv_p(w, f"encoder.layers.{idx}.block.1.conv"),
                            "conv2": _conv_p(w, f"encoder.layers.{idx}.block.3.conv")})
            idx += 1
        idx += 1  # ELU
        seanet["stages"].append({"resnets": resnets,
                                 "down": _conv_p(w, f"encoder.layers.{idx}.conv")})
        idx += 1
    idx += 1  # final ELU
    seanet["final_conv"] = _conv_p(w, f"encoder.layers.{idx}.conv")

    def f32(key):
        return np.asarray(w[key], np.float32)

    def tf_layer(i: int) -> dict:
        p = f"encoder_transformer.layers.{i}"
        return {
            "input_layernorm": {"w": f32(f"{p}.input_layernorm.weight"),
                                "b": f32(f"{p}.input_layernorm.bias")},
            "post_attention_layernorm": {"w": f32(f"{p}.post_attention_layernorm.weight"),
                                         "b": f32(f"{p}.post_attention_layernorm.bias")},
            "self_attn_layer_scale": {"w": f32(f"{p}.self_attn_layer_scale.scale")},
            "mlp_layer_scale": {"w": f32(f"{p}.mlp_layer_scale.scale")},
            **{name: _lin_p(w, f"{p}.self_attn.{name}")
               for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "fc1": _lin_p(w, f"{p}.mlp.fc1"),
            "fc2": _lin_p(w, f"{p}.mlp.fc2"),
        }

    def rvq_half(base: str, n: int) -> dict:
        return {"input_proj": _lin_p(w, f"{base}.input_proj"),
                "output_proj": _lin_p(w, f"{base}.output_proj"),
                "codebooks": [f32(f"{base}.layers.{i}.codebook.embed") for i in range(n)]}

    ns = cfg.num_semantic_quantizers
    return {
        "seanet": seanet,
        "transformer": {"layers": [tf_layer(i) for i in range(cfg.num_hidden_layers)]},
        "downsample": _conv_p(w, "downsample.conv.conv"),
        "quantizer": {
            "semantic": rvq_half("quantizer.semantic_residual_vector_quantizer", ns),
            "acoustic": rvq_half("quantizer.acoustic_residual_vector_quantizer",
                                 cfg.num_quantizers - ns),
        },
    }


class AudioEncoder:
    """The pipeline's reference-audio encoder: fp32 weights on `device`
    (default CUDA, as every entry point of the port)."""

    def __init__(self, params: dict, cfg: TokenizerEncoderConfig,
                 valid_num_quantizers: int = 16, *, device=None):
        self.cfg = cfg
        self.valid_num_quantizers = valid_num_quantizers
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device, torch.float32)

    @classmethod
    def from_weights(cls, weights: dict, speech_config: SpeechTokenizerConfig, *,
                     device=None) -> "AudioEncoder":
        cfg = speech_config.encoder_config
        if cfg is None:
            raise ValueError("the speech tokenizer config has no encoder_config")
        return cls(load_audio_encoder_params(weights, cfg), cfg,
                   speech_config.encoder_valid_num_quantizers, device=device)

    @torch.no_grad()
    def encode(self, audio) -> np.ndarray:
        """audio [L] -> codes [valid_num_quantizers, T] int32 numpy."""
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        codes = audio_encode(self.params, x, self.cfg, self.valid_num_quantizers)
        return codes[0].to(torch.int32).cpu().numpy()
