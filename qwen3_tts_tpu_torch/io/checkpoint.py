"""Checkpoint loading: reference-format safetensors -> numpy param trees.

A jax-free copy of qwen3_tts_tpu/io/checkpoint.py (tests pin the trees
equal):

  - talker / code-predictor key remap ("talker.", "code_predictor.model.",
    "model." prefixes; "audio_decoder." keys dropped)
  - dequantize-on-load of packed (.weight uint + .scales [+ .biases])
    triples when the checkpoint is not declared pre-quantized
  - keep-packed load of a pre-quantized checkpoint (config.quantization
    set, as MLX's 4/6/8-bit checkpoints declare): uint32 linears and tables
    stay packed {"wq", "scales"[, "biases"]} for K7 and the gather-dequant
    lookups; bits and group size are derived per tensor from its shapes, so
    mixed widths load too (fused or stacked entries of different widths
    fall back to their exact dense values)
  - vocoder sanitizer: prefix rules, encoder keys dropped, RVQ codebooks
    rebuilt from EMA stats, conv kernels re-laid channels-last

Layouts (the JAX package's, kept so the two trees compare like with like):
  conv torch [Cout, Cin, K]            -> HIO [K, Cin, Cout]
  transpose conv torch [Cin, Cout, K]  -> flip K -> HIO [K, Cin, Cout]
  linear / embedding                   -> unchanged ([out, in] / [V, D])
Per-layer weights are stacked on a leading layer axis; q/k/v and gate/up
are fused on the output axis.
"""

from __future__ import annotations

import numpy as np

from ..config import Qwen3TTSConfig, QuantizationSettings, TokenizerDecoderConfig
from ..ops.quant import dequantize_np, derive_packed_dims


def remap_talker_keys(weights: dict) -> dict:
    out = {}
    for key, value in weights.items():
        if key.startswith("audio_decoder."):
            continue
        k = key
        if k.startswith("talker."):
            k = k[len("talker."):]
        if k.startswith("code_predictor.model."):
            k = "code_predictor." + k[len("code_predictor.model."):]
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = value
    return out


def _derived_bits(wq, scales, settings: QuantizationSettings) -> tuple[int, int]:
    """Per-tensor (bits, group_size) from the packed shapes: mixed-width
    checkpoints store different widths per tensor, so settings only give
    the group-size hint."""
    entry = {"wq": wq, "scales": scales}
    if settings.enabled and settings.group_size != 64:
        entry[f"g{settings.group_size}"] = np.zeros((0,), np.int8)
    bits, gs, _ = derive_packed_dims(entry)
    return bits, gs


def dequantize_weights(weights: dict, settings: QuantizationSettings) -> dict:
    """Expand every packed triple to a float16 dense weight."""
    out = dict(weights)
    drop: set[str] = set()
    for key in list(out):
        if not key.endswith(".weight"):
            continue
        w = out[key]
        if w.dtype not in (np.uint8, np.uint16, np.uint32):
            continue
        scales_key = key[: -len(".weight")] + ".scales"
        biases_key = key[: -len(".weight")] + ".biases"
        scales = out.get(scales_key)
        if scales is None:
            continue
        biases = out.get(biases_key)
        packed = np.ascontiguousarray(w).view(np.uint32) if w.dtype != np.uint32 else w
        bits, gs = _derived_bits(packed, scales, settings)
        out[key] = dequantize_np(
            packed, np.asarray(scales, np.float32),
            np.asarray(biases, np.float32) if biases is not None else None,
            bits=bits, group_size=gs, dtype=np.float16,
        )
        drop.update((scales_key, biases_key))
    for k in drop:
        out.pop(k, None)
    return {k: v for k, v in out.items() if not (k.endswith(".scales") or k.endswith(".biases"))}


def _group_marker(settings: QuantizationSettings) -> dict:
    """The zero-size "g<N>" key that records a group size other than 64 for
    derive_packed_dims ((words, groups) alone is ambiguous)."""
    if settings.enabled and settings.group_size != 64:
        return {f"g{settings.group_size}": np.zeros((0,), np.int8)}
    return {}


def _linear_entry(w: dict, prefix: str, dtype) -> dict:
    """Dense {"w"[, "b"]} or packed {"wq", "scales"[, "biases"][, "b"]}."""
    weight = w[f"{prefix}.weight"]
    entry: dict = {}
    if weight.dtype == np.uint32:
        entry["wq"] = weight
        entry["scales"] = np.asarray(w[f"{prefix}.scales"], dtype)
        if f"{prefix}.biases" in w:
            entry["biases"] = np.asarray(w[f"{prefix}.biases"], dtype)
    else:
        entry["w"] = np.asarray(weight, dtype)
    if f"{prefix}.bias" in w:
        entry["b"] = np.asarray(w[f"{prefix}.bias"], dtype)
    return entry


def _entry_dense(entry: dict, dtype) -> np.ndarray:
    """One linear / table entry as a dense weight."""
    if "w" in entry:
        return np.asarray(entry["w"], dtype)
    bits, gs, _ = derive_packed_dims(entry)
    return dequantize_np(entry["wq"], entry["scales"], entry.get("biases"),
                         bits=bits, group_size=gs, dtype=dtype)


def _fuse_out(*entries: dict) -> dict:
    """Fuse linear params along the output axis (q/k/v, gate/up); packed rows
    are independent, so packed entries of one width fuse as they are. Entries
    of different storage or width fuse their exact dense values."""
    keys = entries[0].keys()
    mismatched = any(e.keys() != keys for e in entries[1:]) or any(
        np.asarray(e[k]).shape[1:] != np.asarray(entries[0][k]).shape[1:]
        for e in entries[1:] for k in (keys & e.keys()) if k != "b"
    )
    if mismatched:
        out = {"w": np.concatenate([_entry_dense(e, np.float32) for e in entries], axis=0)}
        if all("b" in e for e in entries):
            out["b"] = np.concatenate([np.asarray(e["b"], np.float32) for e in entries], axis=0)
        return out
    return {k: np.concatenate([e[k] for e in entries], axis=0) for k in keys}


def _stack(entries: list[dict], dtype=np.float32) -> dict:
    """Stack param dicts on a new leading axis; entries that differ in keys,
    shapes or types (layers quantized at different widths) stack their
    exact dense values instead."""
    keys = entries[0].keys()
    homogeneous = all(e.keys() == keys for e in entries) and all(
        np.asarray(e[k]).shape == np.asarray(entries[0][k]).shape
        and np.asarray(e[k]).dtype == np.asarray(entries[0][k]).dtype
        for e in entries for k in keys
    )
    if homogeneous:
        return {k: np.stack([e[k] for e in entries]) for k in keys}
    out = {"w": np.stack([_entry_dense(e, dtype) for e in entries])}
    if all("b" in e for e in entries):
        out["b"] = np.stack([np.asarray(e["b"], dtype) for e in entries])
    return out


def _embed_entry(w: dict, prefix: str, settings: QuantizationSettings, dtype,
                 keep_packed: bool) -> dict:
    """A table: packed storage kept when `keep_packed` (lookups gather and
    dequantize rows), else dense (a checkpoint that is not pre-quantized has
    had its packed triples dequantized already)."""
    weight = w[f"{prefix}.weight"]
    if keep_packed and weight.dtype == np.uint32 and f"{prefix}.scales" in w:
        entry = {"wq": weight, "scales": np.asarray(w[f"{prefix}.scales"], dtype)}
        if f"{prefix}.biases" in w:
            entry["biases"] = np.asarray(w[f"{prefix}.biases"], dtype)
        return {**entry, **_group_marker(settings)}
    return {"w": np.asarray(weight, dtype)}


def load_talker_checkpoint(
    weights: dict, config: Qwen3TTSConfig, dtype=np.float32
) -> tuple[dict, dict]:
    """Assemble (talker_params, cp_params) numpy trees: packed linears and
    tables kept for a pre-quantized checkpoint, dense otherwise."""
    w = remap_talker_keys(weights)
    settings = config.quantization_settings
    keep_packed = config.quantization is not None
    if not keep_packed:
        dq = QuantizationSettings(
            enabled=True,
            bits=settings.bits if settings.enabled else 8,
            group_size=settings.group_size if settings.enabled else 64,
        )
        w = dequantize_weights(w, dq)

    def lin(p: str) -> dict:
        entry = _linear_entry(w, p, dtype)
        return {**entry, **_group_marker(settings)} if "wq" in entry else entry

    norm = lambda p: {"w": np.asarray(w[f"{p}.weight"], dtype)}  # noqa: E731
    table = lambda p: _embed_entry(w, p, settings, dtype, keep_packed)  # noqa: E731

    def layers(pre: str, n: int) -> dict:
        def field(fmt, builder):
            return _stack([builder(fmt.format(i=i)) for i in range(n)])

        return {
            "input_layernorm": field(f"{pre}layers.{{i}}.input_layernorm", norm),
            "post_attention_layernorm": field(
                f"{pre}layers.{{i}}.post_attention_layernorm", norm
            ),
            "q_norm": field(f"{pre}layers.{{i}}.self_attn.q_norm", norm),
            "k_norm": field(f"{pre}layers.{{i}}.self_attn.k_norm", norm),
            "qkv_proj": field(
                f"{pre}layers.{{i}}", lambda p: _fuse_out(
                    lin(f"{p}.self_attn.q_proj"), lin(f"{p}.self_attn.k_proj"),
                    lin(f"{p}.self_attn.v_proj"),
                )
            ),
            "o_proj": field(f"{pre}layers.{{i}}.self_attn.o_proj", lin),
            "gateup_proj": field(
                f"{pre}layers.{{i}}", lambda p: _fuse_out(
                    lin(f"{p}.mlp.gate_proj"), lin(f"{p}.mlp.up_proj")
                )
            ),
            "down_proj": field(f"{pre}layers.{{i}}.mlp.down_proj", lin),
        }

    params = {
        "text_embedding": table("text_embedding"),
        "codec_embedding": table("codec_embedding"),
        "text_projection": {
            "fc1": lin("text_projection.linear_fc1"),
            "fc2": lin("text_projection.linear_fc2"),
        },
        "codec_head": lin("codec_head"),
        "norm": norm("norm"),
        "layers": layers("", config.num_hidden_layers),
    }

    cp_cfg = config.code_predictor_config
    ng = cp_cfg.num_code_groups - 1
    cp_params = {
        "codec_embedding": _stack(
            [table(f"code_predictor.codec_embedding.{i}") for i in range(ng)]
        ),
        "lm_head": _stack([table(f"code_predictor.lm_head.{i}") for i in range(ng)]),
        "norm": norm("code_predictor.norm"),
        "layers": layers("code_predictor.", cp_cfg.num_hidden_layers),
    }
    if "code_predictor.small_to_mtp_projection.weight" in w:
        cp_params["small_to_mtp_projection"] = lin("code_predictor.small_to_mtp_projection")
    return params, cp_params


def _strip_vocoder_prefix(key: str) -> str | None:
    k = key
    if k.startswith("audio_decoder."):
        k = k[len("audio_decoder."):]
    if k.startswith("decoder."):
        k = k[len("decoder."):]
    if k.startswith("encoder.") or ".encoder." in k:
        return None
    return k


def reconstruct_codebooks(weights: dict) -> dict:
    """`<base>._codebook.{cluster_usage,embedding_sum}` ->
    `<base>.codebook.embed` = sum / clip(usage, 1e-5)."""
    out = {}
    stats: dict[str, dict[str, np.ndarray]] = {}
    for key, v in weights.items():
        if "._codebook.cluster_usage" in key or "._codebook.embedding_sum" in key:
            base, _, field = key.partition("._codebook.")
            stats.setdefault(base, {})[field] = v
            continue
        out[key] = v
    for base, d in stats.items():
        usage = np.clip(np.asarray(d["cluster_usage"], np.float32), 1e-5, None)
        out[f"{base}.codebook.embed"] = (
            np.asarray(d["embedding_sum"], np.float32) / usage[:, None]
        )
    return out


def _conv_entry(w: dict, prefix: str, dtype, transpose_conv: bool = False) -> dict:
    weight = np.asarray(w[f"{prefix}.weight"], np.float32)
    if transpose_conv:
        weight = weight[:, :, ::-1].transpose(2, 0, 1)  # [Cin,Cout,K] -> flipped HIO
    else:
        weight = weight.transpose(2, 1, 0)  # [Cout,Cin,K] -> HIO
    entry = {"w": np.ascontiguousarray(weight).astype(dtype)}
    if f"{prefix}.bias" in w:
        entry["b"] = np.asarray(w[f"{prefix}.bias"], dtype)
    return entry


def _stack_tree(entries: list[dict]) -> dict:
    out = {}
    for k, v in entries[0].items():
        if isinstance(v, dict):
            out[k] = _stack_tree([e[k] for e in entries])
        else:
            out[k] = np.stack([e[k] for e in entries])
    return out


def load_vocoder_checkpoint(
    weights: dict, cfg: TokenizerDecoderConfig, dtype=np.float32
) -> dict:
    """Assemble the vocoder numpy tree from a speech_tokenizer checkpoint."""
    w0 = {}
    for key, v in weights.items():
        k = _strip_vocoder_prefix(key)
        if k is not None:
            w0[k] = v
    w = reconstruct_codebooks(w0)

    lin = lambda p: _linear_entry(w, p, dtype)  # noqa: E731
    norm = lambda p: {"w": np.asarray(w[f"{p}.weight"], dtype)}  # noqa: E731
    snake = lambda p: {  # noqa: E731
        "alpha": np.asarray(w[f"{p}.alpha"], dtype).reshape(-1),
        "beta": np.asarray(w[f"{p}.beta"], dtype).reshape(-1),
    }

    def rvq_half(base: str, n: int) -> dict:
        cbs = np.stack(
            [np.asarray(w[f"{base}.vq.layers.{i}.codebook.embed"], dtype) for i in range(n)]
        )
        proj = np.asarray(w[f"{base}.output_proj.weight"], np.float32)
        if proj.ndim == 3:  # conv1d k=1 [Cout, Cin, 1]
            proj = proj[:, :, 0]
        return {"codebooks": cbs, "out_proj": {"w": proj.astype(dtype)}}

    ns = cfg.num_semantic_quantizers
    na = cfg.num_quantizers - ns

    def tf_layer(i: int) -> dict:
        p = f"pre_transformer.layers.{i}"
        return {
            "input_layernorm": norm(f"{p}.input_layernorm"),
            "post_attention_layernorm": norm(f"{p}.post_attention_layernorm"),
            "self_attn_layer_scale": {
                "w": np.asarray(w[f"{p}.self_attn_layer_scale.scale"], dtype)
            },
            "mlp_layer_scale": {"w": np.asarray(w[f"{p}.mlp_layer_scale.scale"], dtype)},
            "q_proj": lin(f"{p}.self_attn.q_proj"),
            "k_proj": lin(f"{p}.self_attn.k_proj"),
            "v_proj": lin(f"{p}.self_attn.v_proj"),
            "o_proj": lin(f"{p}.self_attn.o_proj"),
            "gate_proj": lin(f"{p}.mlp.gate_proj"),
            "up_proj": lin(f"{p}.mlp.up_proj"),
            "down_proj": lin(f"{p}.mlp.down_proj"),
        }

    def convnext(p: str) -> dict:
        return {
            "dwconv": _conv_entry(w, f"{p}.dwconv.conv", dtype),
            "norm": {
                "w": np.asarray(w[f"{p}.norm.weight"], dtype),
                "b": np.asarray(w[f"{p}.norm.bias"], dtype),
            },
            "pwconv1": lin(f"{p}.pwconv1"),
            "pwconv2": lin(f"{p}.pwconv2"),
            "gamma": np.asarray(w[f"{p}.gamma"], dtype),
        }

    params = {
        "quantizer": {
            "semantic": rvq_half("quantizer.rvq_first", ns),
            "acoustic": rvq_half("quantizer.rvq_rest", na),
        },
        "pre_conv": _conv_entry(w, "pre_conv.conv", dtype),
        "pre_transformer": {
            "input_proj": lin("pre_transformer.input_proj"),
            "layers": _stack_tree([tf_layer(i) for i in range(cfg.num_hidden_layers)]),
            "norm": norm("pre_transformer.norm"),
            "output_proj": lin("pre_transformer.output_proj"),
        },
        "upsample": [
            {
                "tconv": _conv_entry(w, f"upsample.{i}.0.conv", dtype, transpose_conv=True),
                "convnext": convnext(f"upsample.{i}.1"),
            }
            for i in range(len(cfg.upsampling_ratios))
        ],
    }

    n_blocks = len(cfg.upsample_rates)
    blocks = []
    for i in range(n_blocks):
        p = f"decoder.{i + 1}.block"
        units = [
            {
                "act1": snake(f"{p}.{j + 2}.act1"),
                "conv1": _conv_entry(w, f"{p}.{j + 2}.conv1.conv", dtype),
                "act2": snake(f"{p}.{j + 2}.act2"),
                "conv2": _conv_entry(w, f"{p}.{j + 2}.conv2.conv", dtype),
            }
            for j in range(3)
        ]
        blocks.append(
            {
                "snake": snake(f"{p}.0"),
                "up": _conv_entry(w, f"{p}.1.conv", dtype, transpose_conv=True),
                "units": units,
            }
        )
    params["decoder"] = {
        "initial_conv": _conv_entry(w, "decoder.0.conv", dtype),
        "blocks": blocks,
        "out_snake": snake(f"decoder.{n_blocks + 1}"),
        "out_conv": _conv_entry(w, f"decoder.{n_blocks + 2}.conv", dtype),
    }
    return params
