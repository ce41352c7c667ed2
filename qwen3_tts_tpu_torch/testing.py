"""Test and smoke utilities for the PyTorch port (no JAX anywhere).

Random-weight parameter trees in the JAX package's layouts, reference-format
checkpoint export, and a writer of a complete loadable model directory
(config.json, model.safetensors, tokenizer.json, speech_tokenizer/, and
optionally the speaker and audio encoders) at any width, including the full
0.6B one. The trees and the export follow qwen3_tts_tpu/testing.py so both
packages read the same directories.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .config import (
    CodePredictorConfig,
    Qwen3TTSConfig,
    SpeakerEncoderConfig,
    TokenizerDecoderConfig,
    TokenizerEncoderConfig,
)
from .io import safetensors_io
from .ops.quant import quantize_np


def tiny_talker_config(**overrides) -> Qwen3TTSConfig:
    """Small talker config whose every linear input width is a multiple of
    64, so the int8 runtime quantizer (group 64) covers every linear: talker
    hidden 64, text hidden 128, code-predictor hidden 64 with 4 x 16 heads."""
    defaults = dict(
        hidden_size=64,
        num_hidden_layers=2,
        vocab_size=3072,
        text_vocab_size=4096,
        text_hidden_size=128,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        intermediate_size=128,
        rms_norm_eps=1e-6,
        max_position_embeddings=4096,
        rope_theta=1000000.0,
        tts_bos_token_id=4000,
        tts_eos_token_id=4001,
        tts_pad_token_id=4002,
        mrope_section=(3, 3, 2),
        code_predictor_config=CodePredictorConfig(
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            intermediate_size=128,
            vocab_size=2048,
            num_code_groups=16,
        ),
    )
    defaults.update(overrides)
    return Qwen3TTSConfig(**defaults)


def tiny_decoder_config(**overrides) -> TokenizerDecoderConfig:
    """Small vocoder config with the real 1920x upsample structure."""
    defaults = dict(
        latent_dim=32,
        codebook_dim=16,
        codebook_size=2048,
        decoder_dim=64,
        hidden_size=32,
        intermediate_size=64,
        head_dim=8,
        num_attention_heads=4,
        num_key_value_heads=4,
        num_hidden_layers=2,
        num_quantizers=16,
        num_semantic_quantizers=1,
        upsample_rates=(4, 3),
        upsampling_ratios=(2, 2),
        vector_quantization_hidden_dimension=16,
    )
    defaults.update(overrides)
    return TokenizerDecoderConfig(**defaults)


def tiny_speaker_config(**overrides) -> SpeakerEncoderConfig:
    """Small ECAPA config; enc_dim equals the tiny talker's hidden size (64),
    since the embedding joins the codec stream unprojected."""
    defaults = dict(
        enc_dim=64, mel_dim=16, enc_channels=(16, 16, 16, 16, 48),
        enc_kernel_sizes=(5, 3, 3, 3, 1), enc_dilations=(1, 2, 3, 4, 1),
        enc_res2net_scale=8, enc_se_channels=8, enc_attention_channels=8,
    )
    defaults.update(overrides)
    return SpeakerEncoderConfig(**defaults)


def tiny_encoder_config(**overrides) -> TokenizerEncoderConfig:
    """Small audio-encoder config (downsampling 4 x 3 x compress 2)."""
    defaults = dict(
        audio_channels=1, codebook_dim=16, codebook_size=64, compress=2,
        hidden_size=32, intermediate_size=64, kernel_size=7, last_kernel_size=3,
        num_filters=8, num_hidden_layers=2, num_residual_layers=1, num_quantizers=32,
        num_semantic_quantizers=1, upsampling_ratios=(4, 3), head_dim=8,
        num_attention_heads=4, num_key_value_heads=4,
        vector_quantization_hidden_dimension=16,
    )
    defaults.update(overrides)
    return TokenizerEncoderConfig(**defaults)


# ---------------------------------------------------------------------------
# Random parameter trees (JAX package layouts)
# ---------------------------------------------------------------------------


class _RandPool:
    """Cheap pseudo-random weights: one 1M-sample normal pool served as
    offset views (real per-value RNG is minutes for a 0.6B model, and random
    weights only need plausible statistics)."""

    def __init__(self, seed: int):
        self._pool = np.random.default_rng(seed).standard_normal(1 << 20, dtype=np.float32)
        self._off = 0

    def standard_normal(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        reps = n // len(self._pool) + 2
        self._off = (self._off + 977) % len(self._pool)
        return np.tile(self._pool, reps)[self._off: self._off + n].reshape(shape)


def _np_dense(rng, out, inn, bias=False):
    p = {"w": rng.standard_normal((out, inn)) * np.float32(0.02)}
    if bias:
        p["b"] = np.zeros((out,), np.float32)
    return p


def _np_layer_tree(rng, h, nq, nkv, hd, inter, nl):
    def stack(fn):
        e = [fn() for _ in range(nl)]
        return {k: np.stack([x[k] for x in e]) for k in e[0]}

    return {
        "input_layernorm": {"w": np.ones((nl, h), np.float32)},
        "post_attention_layernorm": {"w": np.ones((nl, h), np.float32)},
        "q_norm": {"w": np.ones((nl, hd), np.float32)},
        "k_norm": {"w": np.ones((nl, hd), np.float32)},
        "qkv_proj": stack(lambda: _np_dense(rng, (nq + 2 * nkv) * hd, h)),
        "o_proj": stack(lambda: _np_dense(rng, h, nq * hd)),
        "gateup_proj": stack(lambda: _np_dense(rng, 2 * inter, h)),
        "down_proj": stack(lambda: _np_dense(rng, h, inter)),
    }


def random_host_talker_params(config: Qwen3TTSConfig, seed: int = 0) -> dict:
    """Numpy random talker params (fused q/k/v and gate/up)."""
    rng = _RandPool(seed)
    c = config
    return {
        "text_embedding": {
            "w": rng.standard_normal((c.text_vocab_size, c.text_hidden_size))
            * np.float32(0.02)
        },
        "codec_embedding": {
            "w": rng.standard_normal((c.vocab_size, c.hidden_size)) * np.float32(0.02)
        },
        "text_projection": {
            "fc1": _np_dense(rng, c.text_hidden_size, c.text_hidden_size, True),
            "fc2": _np_dense(rng, c.hidden_size, c.text_hidden_size, True),
        },
        "codec_head": _np_dense(rng, c.vocab_size, c.hidden_size),
        "norm": {"w": np.ones((c.hidden_size,), np.float32)},
        "layers": _np_layer_tree(
            rng, c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.intermediate_size, c.num_hidden_layers,
        ),
    }


def random_host_cp_params(config: Qwen3TTSConfig, seed: int = 1) -> dict:
    """Numpy random code-predictor params."""
    rng = _RandPool(seed)
    cc = config.code_predictor_config
    ng = cc.num_code_groups - 1
    params = {
        "codec_embedding": {
            "w": rng.standard_normal((ng, cc.vocab_size, config.hidden_size))
            * np.float32(0.02)
        },
        "lm_head": {
            "w": rng.standard_normal((ng, cc.vocab_size, cc.hidden_size)) * np.float32(0.02)
        },
        "norm": {"w": np.ones((cc.hidden_size,), np.float32)},
        "layers": _np_layer_tree(
            rng, cc.hidden_size, cc.num_attention_heads, cc.num_key_value_heads,
            cc.head_dim, cc.intermediate_size, cc.num_hidden_layers,
        ),
    }
    if cc.hidden_size != config.hidden_size:
        params["small_to_mtp_projection"] = _np_dense(
            rng, cc.hidden_size, config.hidden_size, bias=True
        )
    return params


def random_vocoder_params(
    cfg: TokenizerDecoderConfig, seed: int = 2, device="cpu"
) -> dict:
    """Random dense vocoder tree (models/vocoder.py layout) as fp32 torch
    tensors on `device`, drawn from a seeded torch.Generator there. Norm
    gains are 1; LayerScale and ConvNeXt gamma are 0.1 so every branch
    contributes to the output."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def dense(o, i, bias=True):
        p = {"w": rnd(o, i)}
        if bias:
            p["b"] = rnd(o)
        return p

    def conv(k, ci, co):
        return {"w": rnd(k, ci, co), "b": rnd(co)}

    def snake(c):
        return {"alpha": rnd(c, scale=0.1), "beta": rnd(c, scale=0.1)}

    h, hd, nh = cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads
    nl, latent = cfg.num_hidden_layers, cfg.latent_dim
    cb = cfg.codebook_dim // 2
    ns = cfg.num_semantic_quantizers
    ones = lambda *s: torch.ones(*s, device=dev)  # noqa: E731

    def stack(fn, n):
        items = [fn() for _ in range(n)]

        def merge(xs):
            if isinstance(xs[0], dict):
                return {k: merge([x[k] for x in xs]) for k in xs[0]}
            return torch.stack(xs)

        return merge(items)

    def tf_layer():
        return {
            "input_layernorm": {"w": ones(h)},
            "post_attention_layernorm": {"w": ones(h)},
            "self_attn_layer_scale": {"w": ones(h) * 0.1},
            "mlp_layer_scale": {"w": ones(h) * 0.1},
            "q_proj": dense(nh * hd, h, cfg.attention_bias),
            "k_proj": dense(nh * hd, h, cfg.attention_bias),
            "v_proj": dense(nh * hd, h, cfg.attention_bias),
            "o_proj": dense(h, nh * hd, cfg.attention_bias),
            "gate_proj": dense(cfg.intermediate_size, h, False),
            "up_proj": dense(cfg.intermediate_size, h, False),
            "down_proj": dense(h, cfg.intermediate_size, False),
        }

    def rvq(n):
        return {
            "codebooks": rnd(n, cfg.codebook_size, cb, scale=1.0),
            "out_proj": dense(cfg.codebook_dim, cb, False),
        }

    params = {
        "quantizer": {"semantic": rvq(ns), "acoustic": rvq(cfg.num_quantizers - ns)},
        "pre_conv": conv(3, cfg.codebook_dim, latent),
        "pre_transformer": {
            "input_proj": dense(h, latent),
            "layers": stack(tf_layer, nl),
            "norm": {"w": ones(h)},
            "output_proj": dense(latent, h),
        },
        "upsample": [
            {
                "tconv": conv(r, latent, latent),
                "convnext": {
                    "dwconv": conv(7, 1, latent),
                    "norm": {"w": ones(latent), "b": rnd(latent)},
                    "pwconv1": dense(4 * latent, latent),
                    "pwconv2": dense(latent, 4 * latent),
                    "gamma": ones(latent) * 0.1,
                },
            }
            for r in cfg.upsampling_ratios
        ],
    }
    blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        cin, cout = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        blocks.append({
            "snake": snake(cin),
            "up": conv(2 * rate, cin, cout),
            "units": [
                {"act1": snake(cout), "conv1": conv(7, cout, cout),
                 "act2": snake(cout), "conv2": conv(1, cout, cout)}
                for _ in range(3)
            ],
        })
    out_dim = cfg.decoder_dim // 2 ** len(cfg.upsample_rates)
    params["decoder"] = {
        "initial_conv": conv(7, latent, cfg.decoder_dim),
        "blocks": blocks,
        "out_snake": snake(out_dim),
        "out_conv": conv(7, out_dim, 1),
    }
    return params


def _np_conv(rng, k, cin, cout) -> dict:
    """Conv {"w": [K, Cin, Cout], "b": zeros}, weights scaled by 1/sqrt(fan
    in) so a deep random stack stays finite at full width."""
    w = rng.standard_normal((k, cin, cout)) * np.float32(1.0 / np.sqrt(k * cin))
    return {"w": w, "b": np.zeros((cout,), np.float32)}


def random_speaker_encoder_params(config: SpeakerEncoderConfig, seed: int = 3) -> dict:
    """Numpy random ECAPA tree (models/speaker_encoder.py layout)."""
    rng = _RandPool(seed)
    ch, kz, r = config.enc_channels, config.enc_kernel_sizes, config.enc_res2net_scale

    def se_res2net(cin, cout, k):
        return {
            "tdnn1": _np_conv(rng, 1, cin, cout),
            "tdnn2": _np_conv(rng, 1, cout, cout),
            "se_block": {"conv1": _np_conv(rng, 1, cout, config.enc_se_channels),
                         "conv2": _np_conv(rng, 1, config.enc_se_channels, cout)},
            "res2net_block": {"blocks": [_np_conv(rng, k, cout // r, cout // r)
                                         for _ in range(r - 1)]},
        }

    return {
        "blocks": [_np_conv(rng, kz[0], config.mel_dim, ch[0]),
                   se_res2net(ch[0], ch[1], kz[1]), se_res2net(ch[1], ch[2], kz[2]),
                   se_res2net(ch[2], ch[3], kz[3])],
        "mfa": _np_conv(rng, kz[4], ch[1] + ch[2] + ch[3], ch[4]),
        "asp": {"tdnn": _np_conv(rng, 1, ch[4] * 3, config.enc_attention_channels),
                "conv": _np_conv(rng, 1, config.enc_attention_channels, ch[4])},
        "fc": _np_conv(rng, 1, ch[4] * 2, config.enc_dim),
    }


def random_audio_encoder_params(cfg: TokenizerEncoderConfig, seed: int = 4) -> dict:
    """Numpy random audio-encoder tree (models/audio_encoder.py layout)."""
    rng = _RandPool(seed)
    nf, h = cfg.num_filters, cfg.hidden_size
    seanet: dict = {"initial_conv": _np_conv(rng, cfg.kernel_size, cfg.audio_channels, nf),
                    "stages": []}
    cur = nf
    for i, ratio in enumerate(reversed(cfg.upsampling_ratios)):
        out = nf * 2 ** (i + 1)
        resnets = [{"conv1": _np_conv(rng, cfg.residual_kernel_size, cur, cur // cfg.compress),
                    "conv2": _np_conv(rng, 1, cur // cfg.compress, cur)}
                   for _ in range(cfg.num_residual_layers)]
        seanet["stages"].append({"resnets": resnets, "down": _np_conv(rng, 2 * ratio, cur, out)})
        cur = out
    seanet["final_conv"] = _np_conv(rng, cfg.last_kernel_size, cur, h)
    nhd = cfg.num_attention_heads * cfg.head_dim

    def tf_layer():
        ones, zeros = np.ones((h,), np.float32), np.zeros((h,), np.float32)
        scale = np.full((h,), cfg.layer_scale_initial_scale, np.float32)
        return {
            "input_layernorm": {"w": ones, "b": zeros},
            "post_attention_layernorm": {"w": ones, "b": zeros},
            "self_attn_layer_scale": {"w": scale},
            "mlp_layer_scale": {"w": scale},
            "q_proj": _np_dense(rng, nhd, h), "k_proj": _np_dense(rng, nhd, h),
            "v_proj": _np_dense(rng, nhd, h), "o_proj": _np_dense(rng, h, nhd),
            "fc1": _np_dense(rng, cfg.intermediate_size, h, True),
            "fc2": _np_dense(rng, h, cfg.intermediate_size, True),
        }

    d = cfg.vector_quantization_hidden_dimension

    def rvq_half(n):
        return {"input_proj": _np_dense(rng, d, h), "output_proj": _np_dense(rng, h, d),
                "codebooks": [rng.standard_normal((cfg.codebook_size, d)) * np.float32(0.1)
                              for _ in range(n)]}

    ns = cfg.num_semantic_quantizers
    return {
        "seanet": seanet,
        "transformer": {"layers": [tf_layer() for _ in range(cfg.num_hidden_layers)]},
        "downsample": _np_conv(rng, 2 * cfg.compress, h, h),
        "quantizer": {"semantic": rvq_half(ns), "acoustic": rvq_half(cfg.num_quantizers - ns)},
    }


# ---------------------------------------------------------------------------
# Reference-format checkpoint export
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_talker_checkpoint(params: dict, cp_params: dict, config: Qwen3TTSConfig) -> dict:
    """Dense (talker, cp) numpy trees -> reference-format checkpoint keys."""
    out = {}

    def put_linear(prefix, entry):
        out[f"{prefix}.weight"] = entry["w"]
        if "b" in entry:
            out[f"{prefix}.bias"] = entry["b"]

    def put_layers(prefix, lp, n, nq_hd, nkv_hd, inter):
        for i in range(n):
            p = f"{prefix}.layers.{i}"
            out[f"{p}.input_layernorm.weight"] = lp["input_layernorm"]["w"][i]
            out[f"{p}.post_attention_layernorm.weight"] = lp["post_attention_layernorm"]["w"][i]
            out[f"{p}.self_attn.q_norm.weight"] = lp["q_norm"]["w"][i]
            out[f"{p}.self_attn.k_norm.weight"] = lp["k_norm"]["w"][i]
            qkv = {k: v[i] for k, v in lp["qkv_proj"].items()}
            a, b = nq_hd, nq_hd + nkv_hd
            put_linear(f"{p}.self_attn.q_proj", {k: v[:a] for k, v in qkv.items()})
            put_linear(f"{p}.self_attn.k_proj", {k: v[a:b] for k, v in qkv.items()})
            put_linear(f"{p}.self_attn.v_proj", {k: v[b:] for k, v in qkv.items()})
            put_linear(f"{p}.self_attn.o_proj", {k: v[i] for k, v in lp["o_proj"].items()})
            gu = {k: v[i] for k, v in lp["gateup_proj"].items()}
            put_linear(f"{p}.mlp.gate_proj", {k: v[:inter] for k, v in gu.items()})
            put_linear(f"{p}.mlp.up_proj", {k: v[inter:] for k, v in gu.items()})
            put_linear(f"{p}.mlp.down_proj", {k: v[i] for k, v in lp["down_proj"].items()})

    t = "talker.model"
    out[f"{t}.text_embedding.weight"] = params["text_embedding"]["w"]
    out[f"{t}.codec_embedding.weight"] = params["codec_embedding"]["w"]
    put_linear(f"{t}.text_projection.linear_fc1", params["text_projection"]["fc1"])
    put_linear(f"{t}.text_projection.linear_fc2", params["text_projection"]["fc2"])
    put_linear(f"{t}.codec_head", params["codec_head"])
    out[f"{t}.norm.weight"] = params["norm"]["w"]
    put_layers(t, params["layers"], config.num_hidden_layers,
               config.num_attention_heads * config.head_dim,
               config.num_key_value_heads * config.head_dim, config.intermediate_size)

    c = "talker.code_predictor.model"
    cc = config.code_predictor_config
    for i in range(cc.num_code_groups - 1):
        out[f"{c}.codec_embedding.{i}.weight"] = cp_params["codec_embedding"]["w"][i]
        out[f"{c}.lm_head.{i}.weight"] = cp_params["lm_head"]["w"][i]
    out[f"{c}.norm.weight"] = cp_params["norm"]["w"]
    if "small_to_mtp_projection" in cp_params:
        put_linear(f"{c}.small_to_mtp_projection", cp_params["small_to_mtp_projection"])
    put_layers(c, cp_params["layers"], cc.num_hidden_layers,
               cc.num_attention_heads * cc.head_dim, cc.num_key_value_heads * cc.head_dim,
               cc.intermediate_size)
    return {k: _np(v) for k, v in out.items()}


def export_vocoder_checkpoint(params: dict) -> dict:
    """Dense vocoder tree -> reference-format keys (torch conv layouts, RVQ
    EMA stats)."""
    out = {}

    def put_conv(prefix, entry, transpose=False):
        w = _np(entry["w"])  # HIO [K, Cin, Cout]; transpose convs pre-flipped
        out[f"{prefix}.weight"] = np.ascontiguousarray(
            w.transpose(1, 2, 0)[:, :, ::-1] if transpose else w.transpose(2, 1, 0)
        )
        if "b" in entry:
            out[f"{prefix}.bias"] = _np(entry["b"])

    def put_linear(prefix, entry):
        out[f"{prefix}.weight"] = _np(entry["w"])
        if "b" in entry:
            out[f"{prefix}.bias"] = _np(entry["b"])

    def put_snake(prefix, entry):
        out[f"{prefix}.alpha"] = _np(entry["alpha"])
        out[f"{prefix}.beta"] = _np(entry["beta"])

    pre = "decoder"
    q = params["quantizer"]
    for half, base in (("semantic", "rvq_first"), ("acoustic", "rvq_rest")):
        cbs = _np(q[half]["codebooks"])
        for i in range(cbs.shape[0]):
            b = f"{pre}.quantizer.{base}.vq.layers.{i}._codebook"
            out[f"{b}.cluster_usage"] = np.ones((cbs.shape[1],), np.float32)
            out[f"{b}.embedding_sum"] = cbs[i]
        out[f"{pre}.quantizer.{base}.output_proj.weight"] = _np(q[half]["out_proj"]["w"])[:, :, None]
    put_conv(f"{pre}.pre_conv.conv", params["pre_conv"])
    pt = params["pre_transformer"]
    put_linear(f"{pre}.pre_transformer.input_proj", pt["input_proj"])
    put_linear(f"{pre}.pre_transformer.output_proj", pt["output_proj"])
    out[f"{pre}.pre_transformer.norm.weight"] = _np(pt["norm"]["w"])
    L = pt["layers"]
    for i in range(_np(L["input_layernorm"]["w"]).shape[0]):
        p = f"{pre}.pre_transformer.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = _np(L["input_layernorm"]["w"][i])
        out[f"{p}.post_attention_layernorm.weight"] = _np(L["post_attention_layernorm"]["w"][i])
        out[f"{p}.self_attn_layer_scale.scale"] = _np(L["self_attn_layer_scale"]["w"][i])
        out[f"{p}.mlp_layer_scale.scale"] = _np(L["mlp_layer_scale"]["w"][i])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_linear(f"{p}.self_attn.{name}", {k: v[i] for k, v in L[name].items()})
        for name in ("gate_proj", "up_proj", "down_proj"):
            put_linear(f"{p}.mlp.{name}", {k: v[i] for k, v in L[name].items()})
    for i, stage in enumerate(params["upsample"]):
        put_conv(f"{pre}.upsample.{i}.0.conv", stage["tconv"], transpose=True)
        cn = stage["convnext"]
        put_conv(f"{pre}.upsample.{i}.1.dwconv.conv", cn["dwconv"])
        out[f"{pre}.upsample.{i}.1.norm.weight"] = _np(cn["norm"]["w"])
        out[f"{pre}.upsample.{i}.1.norm.bias"] = _np(cn["norm"]["b"])
        put_linear(f"{pre}.upsample.{i}.1.pwconv1", cn["pwconv1"])
        put_linear(f"{pre}.upsample.{i}.1.pwconv2", cn["pwconv2"])
        out[f"{pre}.upsample.{i}.1.gamma"] = _np(cn["gamma"])
    dec = params["decoder"]
    put_conv(f"{pre}.decoder.0.conv", dec["initial_conv"])
    for i, block in enumerate(dec["blocks"]):
        p = f"{pre}.decoder.{i + 1}.block"
        put_snake(f"{p}.0", block["snake"])
        put_conv(f"{p}.1.conv", block["up"], transpose=True)
        for j, unit in enumerate(block["units"]):
            u = f"{p}.{j + 2}"
            put_snake(f"{u}.act1", unit["act1"])
            put_conv(f"{u}.conv1.conv", unit["conv1"])
            put_snake(f"{u}.act2", unit["act2"])
            put_conv(f"{u}.conv2.conv", unit["conv2"])
    n = len(dec["blocks"])
    put_snake(f"{pre}.decoder.{n + 1}", dec["out_snake"])
    put_conv(f"{pre}.decoder.{n + 2}.conv", dec["out_conv"])
    return out


def export_speaker_encoder_checkpoint(params: dict) -> dict:
    """ECAPA tree -> "speaker_encoder." keys with torch conv layouts."""
    out = {}

    def put(prefix, entry):
        out[f"speaker_encoder.{prefix}.weight"] = np.ascontiguousarray(
            _np(entry["w"]).transpose(2, 1, 0))
        out[f"speaker_encoder.{prefix}.bias"] = _np(entry["b"])

    put("blocks.0.conv", params["blocks"][0])
    for i in range(1, 4):
        b = params["blocks"][i]
        put(f"blocks.{i}.tdnn1.conv", b["tdnn1"])
        put(f"blocks.{i}.tdnn2.conv", b["tdnn2"])
        put(f"blocks.{i}.se_block.conv1", b["se_block"]["conv1"])
        put(f"blocks.{i}.se_block.conv2", b["se_block"]["conv2"])
        for j, blk in enumerate(b["res2net_block"]["blocks"]):
            put(f"blocks.{i}.res2net_block.blocks.{j}.conv", blk)
    put("mfa.conv", params["mfa"])
    put("asp.tdnn.conv", params["asp"]["tdnn"])
    put("asp.conv", params["asp"]["conv"])
    put("fc", params["fc"])
    return out


def export_audio_encoder_checkpoint(params: dict, cfg: TokenizerEncoderConfig) -> dict:
    """Audio-encoder tree -> "encoder." keys with torch layouts, the
    codebooks as RVQ EMA stats (usage 1)."""
    out = {}

    def put_conv(prefix, entry):
        out[f"encoder.{prefix}.weight"] = np.ascontiguousarray(_np(entry["w"]).transpose(2, 1, 0))
        if "b" in entry:
            out[f"encoder.{prefix}.bias"] = _np(entry["b"])

    def put_lin(prefix, entry, as_conv=False):
        w = _np(entry["w"])
        out[f"encoder.{prefix}.weight"] = w[:, :, None] if as_conv else w
        if "b" in entry:
            out[f"encoder.{prefix}.bias"] = _np(entry["b"])

    sea = params["seanet"]
    put_conv("encoder.layers.0.conv", sea["initial_conv"])
    idx = 1
    for stage in sea["stages"]:
        for res in stage["resnets"]:
            put_conv(f"encoder.layers.{idx}.block.1.conv", res["conv1"])
            put_conv(f"encoder.layers.{idx}.block.3.conv", res["conv2"])
            idx += 1
        idx += 1  # ELU
        put_conv(f"encoder.layers.{idx}.conv", stage["down"])
        idx += 1
    put_conv(f"encoder.layers.{idx + 1}.conv", sea["final_conv"])  # after the final ELU
    for i, lp in enumerate(params["transformer"]["layers"]):
        p = f"encoder_transformer.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"encoder.{p}.{norm}.weight"] = _np(lp[norm]["w"])
            out[f"encoder.{p}.{norm}.bias"] = _np(lp[norm]["b"])
        for scale in ("self_attn_layer_scale", "mlp_layer_scale"):
            out[f"encoder.{p}.{scale}.scale"] = _np(lp[scale]["w"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_lin(f"{p}.self_attn.{name}", lp[name])
        put_lin(f"{p}.mlp.fc1", lp["fc1"])
        put_lin(f"{p}.mlp.fc2", lp["fc2"])
    put_conv("downsample.conv.conv", params["downsample"])
    for half, base in (("semantic", "quantizer.semantic_residual_vector_quantizer"),
                       ("acoustic", "quantizer.acoustic_residual_vector_quantizer")):
        q = params["quantizer"][half]
        put_lin(f"{base}.input_proj", q["input_proj"], as_conv=True)
        put_lin(f"{base}.output_proj", q["output_proj"], as_conv=True)
        for i, cb in enumerate(q["codebooks"]):
            cb = _np(cb)
            out[f"encoder.{base}.layers.{i}._codebook.cluster_usage"] = np.ones(
                (cb.shape[0],), np.float32)
            out[f"encoder.{base}.layers.{i}._codebook.embedding_sum"] = cb
    return out


# ---------------------------------------------------------------------------
# Model directory
# ---------------------------------------------------------------------------


def make_tiny_tokenizer_json() -> dict:
    """A loadable tokenizer.json: byte-fallback vocab + chat specials."""
    vocab = {"<0x%02X>" % b: b for b in range(256)}
    vocab["Ġ"] = 256
    vocab["Ċ"] = 257
    for i, ch in enumerate(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,!?'\";:-"
    ):
        vocab[ch] = 258 + i
    added = [
        {"content": "<|im_start|>", "id": 400, "special": True},
        {"content": "<|im_end|>", "id": 401, "special": True},
    ]
    return {"model": {"vocab": vocab, "merges": []}, "added_tokens": added}


def config_to_json_dict(cfg: Qwen3TTSConfig) -> dict:
    """The flat config.json layout the loaders consume."""
    cc = cfg.code_predictor_config
    d = {
        k: getattr(cfg, k)
        for k in (
            "hidden_size", "num_hidden_layers", "vocab_size", "text_vocab_size",
            "text_hidden_size", "num_attention_heads", "num_key_value_heads",
            "head_dim", "intermediate_size", "rms_norm_eps",
            "max_position_embeddings", "rope_theta", "tts_bos_token_id",
            "tts_eos_token_id", "tts_pad_token_id", "codec_bos_id",
            "codec_eos_token_id", "codec_pad_id", "codec_nothink_id",
            "codec_think_bos_id", "codec_think_eos_id",
        )
    }
    d["spk_id"] = cfg.spk_id
    d["code_predictor_config"] = {
        k: getattr(cc, k)
        for k in (
            "hidden_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "head_dim", "intermediate_size", "rms_norm_eps",
            "rope_theta", "vocab_size", "num_code_groups",
        )
    }
    if cfg.mrope_section is not None:
        d["rope_scaling"] = {"mrope_section": list(cfg.mrope_section)}
    if cfg.tts_model_type is not None:
        d["tts_model_type"] = cfg.tts_model_type
    return d


def decoder_config_to_json_dict(dec) -> dict:
    """A decoder or encoder config as its JSON dict (tuples as lists)."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(dec).items()}


def write_model_dir(
    path,
    config: Qwen3TTSConfig,
    decoder_config: TokenizerDecoderConfig,
    seed: int = 0,
    weight_dtype=torch.bfloat16,
    *,
    with_encoders: bool = False,
    speaker_config: SpeakerEncoderConfig | None = None,
    encoder_config: TokenizerEncoderConfig | None = None,
    tts_model_type: str | None = None,
):
    """Write a loadable random-weight model directory at any width (the full
    0.6B one included); weights are stored in `weight_dtype` (bf16, as real
    checkpoints are). With with_encoders, the speaker encoder
    (`speaker_config`, default SpeakerEncoderConfig() with enc_dim the
    talker's hidden size) goes into model.safetensors as "speaker_encoder."
    keys and the audio encoder (`encoder_config`, default
    TokenizerEncoderConfig()) into the vocoder file as "encoder." keys, with
    its config in speech_tokenizer/config.json; both stored in fp32.
    tts_model_type ("voice_design", "custom_voice", "base") goes into
    config.json. Returns (talker_params, cp_params, vocoder_params), the
    dense source trees before the storage cast."""
    path = os.fspath(path)
    os.makedirs(os.path.join(path, "speech_tokenizer"), exist_ok=True)
    if tts_model_type is not None:
        config = dataclasses.replace(config, tts_model_type=tts_model_type)
    params = random_host_talker_params(config, seed)
    cp_params = random_host_cp_params(config, seed + 1)
    voc = random_vocoder_params(decoder_config, seed + 2)

    def cast(d: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(weight_dtype)
                for k, v in d.items()}

    def f32(d: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in d.items()}

    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_json_dict(config), f)
    main = cast(export_talker_checkpoint(params, cp_params, config))
    if with_encoders:
        spk = speaker_config or SpeakerEncoderConfig(enc_dim=config.hidden_size)
        main.update(f32(export_speaker_encoder_checkpoint(
            random_speaker_encoder_params(spk, seed + 3))))
    safetensors_io.save_file(main, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(make_tiny_tokenizer_json(), f)
    total = decoder_config.total_upsample
    st_cfg = {
        "decoder_config": decoder_config_to_json_dict(decoder_config),
        "encoder_valid_num_quantizers": 16,
        "input_sample_rate": 24000,
        "output_sample_rate": 24000,
        "decode_upsample_rate": total,
        "encode_downsample_rate": total,
    }
    st_weights = cast(export_vocoder_checkpoint(voc))
    if with_encoders:
        enc = encoder_config or TokenizerEncoderConfig()
        st_weights.update(f32(export_audio_encoder_checkpoint(
            random_audio_encoder_params(enc, seed + 4), enc)))
        st_cfg["encoder_config"] = decoder_config_to_json_dict(enc)
    with open(os.path.join(path, "speech_tokenizer", "config.json"), "w") as f:
        json.dump(st_cfg, f)
    safetensors_io.save_file(
        st_weights, os.path.join(path, "speech_tokenizer", "model.safetensors"))
    return params, cp_params, voc


def write_prequantized_model_dir(
    path,
    config: Qwen3TTSConfig,
    decoder_config: TokenizerDecoderConfig,
    *,
    widths=(4,),
    group_size: int = 64,
    seed: int = 0,
):
    """write_model_dir, then every eligible talker `.weight` (2-D, not a norm,
    input width a multiple of `group_size`) re-stored packed in MLX's layout
    (uint32 `.weight`, fp32 `.scales` / `.biases`), cycling through `widths`
    (a width that does not pack the row falls back to 4), and config.json
    declares `"quantization": {"bits": widths[0], "group_size": ...}`, so the
    loaders keep the linears packed. Returns write_model_dir's dense trees."""
    path = os.fspath(path)
    ret = write_model_dir(path, config, decoder_config, seed=seed)
    main_path = os.path.join(path, "model.safetensors")
    weights = safetensors_io.load_file(main_path)
    out = {}
    i = 0
    for key in sorted(weights):
        a = np.asarray(weights[key])
        if (key.startswith("talker.") and key.endswith(".weight") and a.ndim == 2
                and "norm" not in key and a.shape[-1] % group_size == 0):
            bits = widths[i % len(widths)]
            i += 1
            if (a.shape[-1] * bits) % 32:
                bits = 4
            packed, scales, biases = quantize_np(a.astype(np.float32), bits, group_size)
            stem = key[: -len(".weight")]
            out[key] = packed
            out[f"{stem}.scales"] = scales
            out[f"{stem}.biases"] = biases
        else:  # stored as write_model_dir stored it (bf16 is exact in fp32)
            out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    safetensors_io.save_file(out, main_path)
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path, encoding="utf-8") as f:
        raw = json.load(f)
    raw["quantization"] = {"bits": widths[0], "group_size": group_size}
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(raw, f)
    return ret
