"""Model configuration dataclasses (a copy of qwen3_tts_tpu/config.py; the
port cannot import the JAX package, so tests pin the two equal).

Semantics mirror the reference configs (decode rules, defaults, nesting):
  - Qwen3TTSConfig / CodePredictorConfigJSON: reference Qwen3Config.swift:8-318
  - Tokenizer (vocoder) encoder/decoder configs: reference SpeechTokenizer.swift:9-88
  - AudioDecoderConfig nesting ("decoder_config" key): reference AudioDecoder.swift:7-102
  - QuantizationSettings: reference QuantizedLayerFactory.swift:6-43

These are plain frozen dataclasses (hashable), parsed
from the same JSON files the reference reads (config.json with optional nested
"talker_config", speech_tokenizer/config.json with nested "decoder_config").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantizationSettings:
    """Runtime quantization settings (reference QuantizedLayerFactory.swift:6-43)."""

    enabled: bool = False
    bits: int = 4
    group_size: int = 64
    mode: str = "affine"

    @staticmethod
    def full_precision() -> "QuantizationSettings":
        return QuantizationSettings(enabled=False, bits=4, group_size=64)

    @staticmethod
    def quantized_4bit() -> "QuantizationSettings":
        return QuantizationSettings(enabled=True, bits=4, group_size=64)

    @staticmethod
    def quantized_6bit() -> "QuantizationSettings":
        return QuantizationSettings(enabled=True, bits=6, group_size=64)

    @staticmethod
    def from_dict(cfg: Mapping[str, Any] | None) -> "QuantizationSettings":
        """Mirror of `QuantizationSettings(from:)` (QuantizedLayerFactory.swift:32-42):
        enabled iff a bits value is present."""
        if cfg is not None and cfg.get("bits") is not None:
            return QuantizationSettings(
                enabled=True,
                bits=int(cfg["bits"]),
                group_size=int(cfg.get("group_size") or 64),
                mode=str(cfg.get("mode") or "affine"),
            )
        return QuantizationSettings()


# ---------------------------------------------------------------------------
# Code predictor (MTP head)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CodePredictorConfig:
    """Code-predictor config (reference Qwen3Config.swift:8-46, 284-318)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 65536
    rope_theta: float = 1000000.0
    vocab_size: int = 2048
    num_code_groups: int = 16

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "CodePredictorConfig":
        if d is None:
            return CodePredictorConfig()
        names = {f.name for f in dataclasses.fields(CodePredictorConfig)}
        return CodePredictorConfig(**{k: v for k, v in d.items() if k in names})


# ---------------------------------------------------------------------------
# Talker config
# ---------------------------------------------------------------------------

_DEFAULT_SPK_ID = {
    "serena": 3066,
    "vivian": 3065,
    "uncle_fu": 3010,
    "ryan": 3061,
    "aiden": 2861,
    "ono_anna": 2873,
    "sohee": 2864,
    "eric": 2875,
    "dylan": 2878,
}


@dataclass(frozen=True)
class Qwen3TTSConfig:
    """Talker model config (reference Qwen3Config.swift:65-281).

    `from_json` handles both flat layouts and layouts nested under
    "talker_config" (Qwen3Config.swift:208-253); special-token defaults match
    the reference; mrope_section comes from rope_scaling.mrope_section.
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 28
    vocab_size: int = 3072
    text_vocab_size: int = 151936
    text_hidden_size: int = 2048
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0

    # Special token IDs (defaults: Qwen3Config.swift:117-125,231-240)
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671
    codec_bos_id: int = 2149
    codec_eos_token_id: int = 2150
    codec_pad_id: int = 2148
    codec_nothink_id: int = 2155
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157

    # Speaker-name -> codec-vocab id map (hashable tuple; dict view via spk_id)
    spk_id_items: tuple[tuple[str, int], ...] = tuple(sorted(_DEFAULT_SPK_ID.items()))

    code_predictor_config: CodePredictorConfig = field(default_factory=CodePredictorConfig)

    # None = base model, or "voice_design" / "custom_voice"
    tts_model_type: str | None = None

    # Interleaved MRoPE sections (from rope_scaling.mrope_section); None = plain RoPE
    mrope_section: tuple[int, int, int] | None = None

    # Pre-quantized checkpoint metadata ("quantization" key) and
    # dequantize-on-load metadata ("quantization_config" key)
    quantization: QuantizationSettings | None = None
    quantization_config: QuantizationSettings | None = None

    @property
    def spk_id(self) -> dict[str, int]:
        return dict(self.spk_id_items)

    @property
    def quantization_settings(self) -> QuantizationSettings:
        """Prefers quantization_config over quantization (Qwen3Config.swift:275-280)."""
        cfg = self.quantization_config or self.quantization
        return cfg if cfg is not None else QuantizationSettings()

    @staticmethod
    def standard() -> "Qwen3TTSConfig":
        """The `.standard` preset (Qwen3Config.swift:104-128)."""
        return Qwen3TTSConfig()

    @staticmethod
    def standard_1_7b() -> "Qwen3TTSConfig":
        """1.7B-class dims (the reference ships 1.7B checkpoints,
        README.md:168-176; their config.json carries the dims — this preset
        mirrors the published Qwen3-TTS-12Hz-1.7B layout: 2048 hidden /
        6144 intermediate talker over the same 28-layer GQA structure, with
        the 1024-hidden code predictor reached through
        small_to_mtp_projection)."""
        return Qwen3TTSConfig(
            hidden_size=2048,
            intermediate_size=6144,
            text_hidden_size=2048,
            code_predictor_config=CodePredictorConfig(),
        )

    @staticmethod
    def from_json(text_or_dict: str | Mapping[str, Any]) -> "Qwen3TTSConfig":
        raw: Mapping[str, Any]
        if isinstance(text_or_dict, str):
            raw = json.loads(text_or_dict)
        else:
            raw = text_or_dict

        # Model fields come from the nested talker_config if present, else flat
        # (Qwen3Config.swift:211-216). tts_* token ids and tts_model_type /
        # quantization* always come from the TOP-LEVEL container
        # (Qwen3Config.swift:231-233, 250-252).
        src: Mapping[str, Any] = raw.get("talker_config", raw)

        def s(key: str, default: Any) -> Any:
            v = src.get(key)
            return default if v is None else v

        def top(key: str, default: Any) -> Any:
            v = raw.get(key)
            return default if v is None else v

        mrope = None
        rope_scaling = src.get("rope_scaling")
        if isinstance(rope_scaling, Mapping):
            ms = rope_scaling.get("mrope_section")
            if ms is not None:
                mrope = tuple(int(x) for x in ms)

        quant = raw.get("quantization")
        quant_cfg = raw.get("quantization_config")

        spk = s("spk_id", {})
        return Qwen3TTSConfig(
            hidden_size=int(src["hidden_size"]),
            num_hidden_layers=int(src["num_hidden_layers"]),
            vocab_size=int(src["vocab_size"]),
            text_vocab_size=int(src["text_vocab_size"]),
            text_hidden_size=int(s("text_hidden_size", 2048)),
            num_attention_heads=int(src["num_attention_heads"]),
            num_key_value_heads=int(s("num_key_value_heads", 8)),
            head_dim=int(s("head_dim", 128)),
            intermediate_size=int(src["intermediate_size"]),
            rms_norm_eps=float(src["rms_norm_eps"]),
            max_position_embeddings=int(src["max_position_embeddings"]),
            rope_theta=float(src["rope_theta"]),
            tts_bos_token_id=int(top("tts_bos_token_id", 151672)),
            tts_eos_token_id=int(top("tts_eos_token_id", 151673)),
            tts_pad_token_id=int(top("tts_pad_token_id", 151671)),
            codec_bos_id=int(s("codec_bos_id", 2149)),
            codec_eos_token_id=int(s("codec_eos_token_id", 2150)),
            codec_pad_id=int(s("codec_pad_id", 2148)),
            codec_nothink_id=int(s("codec_nothink_id", 2155)),
            codec_think_bos_id=int(s("codec_think_bos_id", 2156)),
            codec_think_eos_id=int(s("codec_think_eos_id", 2157)),
            spk_id_items=tuple(sorted((str(k), int(v)) for k, v in spk.items())),
            code_predictor_config=CodePredictorConfig.from_dict(
                s("code_predictor_config", None)
            ),
            tts_model_type=raw.get("tts_model_type"),
            mrope_section=mrope,
            quantization=(
                QuantizationSettings.from_dict(quant) if quant is not None else None
            ),
            quantization_config=(
                QuantizationSettings.from_dict(quant_cfg)
                if quant_cfg is not None
                else None
            ),
        )


# ---------------------------------------------------------------------------
# Speech tokenizer (vocoder) configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TokenizerEncoderConfig:
    """Mimi-style audio-encoder config (reference SpeechTokenizer.swift:9-40)."""

    audio_channels: int = 1
    codebook_dim: int = 256
    codebook_size: int = 2048
    compress: int = 2
    dilation_growth_rate: int = 2
    hidden_size: int = 512
    intermediate_size: int = 2048
    kernel_size: int = 7
    last_kernel_size: int = 3
    num_filters: int = 64
    num_hidden_layers: int = 8
    num_residual_layers: int = 1
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    residual_kernel_size: int = 3
    upsampling_ratios: tuple[int, ...] = (8, 6, 5, 4)
    head_dim: int = 64
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8000
    layer_scale_initial_scale: float = 0.01
    vector_quantization_hidden_dimension: int = 256

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "TokenizerEncoderConfig":
        if d is None:
            return TokenizerEncoderConfig()
        names = {f.name for f in dataclasses.fields(TokenizerEncoderConfig)}
        kwargs = {k: v for k, v in d.items() if k in names and v is not None}
        if "upsampling_ratios" in kwargs:
            kwargs["upsampling_ratios"] = tuple(kwargs["upsampling_ratios"])
        return TokenizerEncoderConfig(**kwargs)


@dataclass(frozen=True)
class TokenizerDecoderConfig:
    """Vocoder decoder config (reference SpeechTokenizer.swift:42-74)."""

    attention_bias: bool = False
    attention_dropout: float = 0.0
    latent_dim: int = 1024
    codebook_dim: int = 512
    codebook_size: int = 2048
    decoder_dim: int = 1536
    hidden_act: str = "silu"
    hidden_size: int = 512
    intermediate_size: int = 1024
    layer_scale_initial_scale: float = 0.01
    max_position_embeddings: int = 8000
    head_dim: int = 64
    num_attention_heads: int = 16
    num_hidden_layers: int = 8
    num_key_value_heads: int = 16
    num_quantizers: int = 16
    num_semantic_quantizers: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    semantic_codebook_size: int = 4096
    sliding_window: int = 72
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: tuple[int, ...] = (2, 2)
    vector_quantization_hidden_dimension: int = 512

    @property
    def total_upsample(self) -> int:
        """upsample_rates x upsampling_ratios product = samples per codec frame
        (SpeechTokenizer.swift:858-859): default 8*5*4*3 * 2*2 = 1920."""
        total = 1
        for r in tuple(self.upsample_rates) + tuple(self.upsampling_ratios):
            total *= r
        return total

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "TokenizerDecoderConfig":
        if d is None:
            return TokenizerDecoderConfig()
        names = {f.name for f in dataclasses.fields(TokenizerDecoderConfig)}
        kwargs = {k: v for k, v in d.items() if k in names and v is not None}
        for tup_key in ("upsample_rates", "upsampling_ratios"):
            if tup_key in kwargs:
                kwargs[tup_key] = tuple(kwargs[tup_key])
        return TokenizerDecoderConfig(**kwargs)


@dataclass(frozen=True)
class SpeechTokenizerConfig:
    """Top-level speech_tokenizer/config.json (reference SpeechTokenizer.swift:76-88,
    AudioDecoder.swift:7-102 — the JSON nests decoder_config / encoder_config)."""

    decoder_config: TokenizerDecoderConfig = field(default_factory=TokenizerDecoderConfig)
    encoder_config: TokenizerEncoderConfig | None = None
    encoder_valid_num_quantizers: int = 16
    input_sample_rate: int = 24000
    output_sample_rate: int = 24000
    decode_upsample_rate: int = 1920
    encode_downsample_rate: int = 1920

    @staticmethod
    def from_json(text_or_dict: str | Mapping[str, Any]) -> "SpeechTokenizerConfig":
        raw: Mapping[str, Any]
        if isinstance(text_or_dict, str):
            raw = json.loads(text_or_dict)
        else:
            raw = text_or_dict
        enc = raw.get("encoder_config")
        return SpeechTokenizerConfig(
            decoder_config=TokenizerDecoderConfig.from_dict(raw.get("decoder_config")),
            encoder_config=TokenizerEncoderConfig.from_dict(enc) if enc else None,
            encoder_valid_num_quantizers=int(
                raw.get("encoder_valid_num_quantizers") or 16
            ),
            input_sample_rate=int(raw.get("input_sample_rate") or 24000),
            output_sample_rate=int(raw.get("output_sample_rate") or 24000),
            decode_upsample_rate=int(raw.get("decode_upsample_rate") or 1920),
            encode_downsample_rate=int(raw.get("encode_downsample_rate") or 1920),
        )


# ---------------------------------------------------------------------------
# Speaker encoder (ECAPA-TDNN) config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """ECAPA-TDNN x-vector extractor config (reference SpeakerEncoder.swift:399-416)."""

    enc_dim: int = 1024
    mel_dim: int = 128
    enc_channels: tuple[int, ...] = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    enc_attention_channels: int = 128
    sample_rate: int = 24000
