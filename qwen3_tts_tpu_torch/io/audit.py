"""Checkpoint-layout audit: check a safetensors file against the expected
key / shape manifest before loading it (counterpart of
qwen3_tts_tpu/io/audit.py).

The loaders (io/checkpoint.py, the encoders' from_weights) follow the
reference's key layout, but a key-name typo or a transposed shape would
otherwise show only as wrong audio. The manifests come from the same
serializers the tests round-trip (testing.export_*), run over shape-only
trees (testing.ShapePool, the meta device for the vocoder), so the 0.6B and
1.7B manifests cost no memory and loader and audit cannot drift apart.

For a published checkpoint:
  1. python scripts/torch_audit_checkpoint.py <model_dir>   # layout must PASS
  2. python scripts/torch_verify_checkpoint.py <model_dir> --golden G.json
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import testing
from ..config import (
    Qwen3TTSConfig,
    QuantizationSettings,
    SpeakerEncoderConfig,
    SpeechTokenizerConfig,
)


def _shapes(weights: dict) -> dict[str, tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in weights.items()}


def expected_talker_manifest(config: Qwen3TTSConfig) -> dict[str, tuple[int, ...]]:
    """Main-file keys (talker + code predictor) at their dense shapes."""
    pool = testing.ShapePool()
    return _shapes(testing.export_talker_checkpoint(
        testing.random_host_talker_params(config, rng=pool),
        testing.random_host_cp_params(config, rng=pool), config))


def expected_vocoder_manifest(st_config: SpeechTokenizerConfig) -> dict[str, tuple[int, ...]]:
    return _shapes(testing.export_vocoder_checkpoint(
        testing.random_vocoder_params(st_config.decoder_config, device="meta")))


def expected_audio_encoder_manifest(
    st_config: SpeechTokenizerConfig,
) -> dict[str, tuple[int, ...]]:
    cfg = st_config.encoder_config
    if cfg is None:
        return {}
    return _shapes(testing.export_audio_encoder_checkpoint(
        testing.random_audio_encoder_params(cfg, rng=testing.ShapePool()), cfg))


def expected_speaker_manifest(
    config: SpeakerEncoderConfig | None = None,
) -> dict[str, tuple[int, ...]]:
    return _shapes(testing.export_speaker_encoder_checkpoint(
        testing.random_speaker_encoder_params(config or SpeakerEncoderConfig(),
                                              rng=testing.ShapePool())))


_FLOAT_DTYPES = {"F64", "F32", "F16", "BF16"}


@dataclass
class AuditReport:
    missing: list[str] = field(default_factory=list)
    shape_mismatch: list[str] = field(default_factory=list)
    unexpected: list[str] = field(default_factory=list)
    quantized_keys: int = 0
    dense_keys: int = 0

    @property
    def ok(self) -> bool:
        return not (self.missing or self.shape_mismatch)

    def summary(self) -> str:
        lines = [
            f"dense keys:      {self.dense_keys}",
            f"quantized keys:  {self.quantized_keys}",
            f"missing:         {len(self.missing)}",
            f"shape mismatch:  {len(self.shape_mismatch)}",
            f"unexpected:      {len(self.unexpected)}",
        ]
        lines += [f"  MISSING  {name}" for name in self.missing[:20]]
        lines += [f"  SHAPE    {name}" for name in self.shape_mismatch[:20]]
        lines += [f"  EXTRA    {name}" for name in self.unexpected[:20]]
        lines.append("PASS" if self.ok else "FAIL")
        return "\n".join(lines)


def _packed_shape(shape, bits, group_size):
    """Dense [.., O, K] -> (packed, scales) shapes, or None if not packable."""
    if len(shape) < 2:
        return None
    k = shape[-1]
    if k % group_size or (k * bits) % 32:
        return None
    return (*shape[:-1], k * bits // 32), (*shape[:-1], k // group_size)


def audit_header(
    header: dict[str, tuple[str, tuple[int, ...]]],
    manifest: dict[str, tuple[int, ...]],
    settings: QuantizationSettings | None = None,
    ignore_prefixes: tuple[str, ...] = (),
) -> AuditReport:
    """Compare a safetensors header ({name: (dtype, shape)}) with a manifest.
    Each expected weight may be stored dense at its manifest shape, or
    quantized as (uint32 weight, scales[, biases]) at any valid width (6, 8,
    4, 3 or 2 bits after the settings' own: a mixed-width checkpoint carries
    several) and the settings' group size."""
    rep = AuditReport()
    bits = settings.bits if settings and settings.enabled else 4
    gs = settings.group_size if settings and settings.enabled else 64
    consumed: set[str] = set()

    for key, shape in manifest.items():
        if key not in header:
            rep.missing.append(key)
            continue
        dtype, actual = header[key]
        consumed.add(key)
        if tuple(actual) == tuple(shape) and dtype in _FLOAT_DTYPES:
            rep.dense_keys += 1
            continue
        scales_key = key[: -len(".weight")] + ".scales" if key.endswith(".weight") else None
        cand_bits = [bits] + [x for x in (6, 8, 4, 3, 2) if x != bits]
        matched = False
        for cb in cand_bits:
            pk = _packed_shape(shape, cb, gs)
            if (pk is not None and dtype == "U32" and tuple(actual) == pk[0]
                    and scales_key is not None and scales_key in header
                    and tuple(header[scales_key][1]) == pk[1]):
                matched = True
                break
        if matched:
            rep.quantized_keys += 1
            consumed.add(scales_key)
            biases_key = scales_key.replace(".scales", ".biases")
            if biases_key in header:
                consumed.add(biases_key)
            continue
        rep.shape_mismatch.append(
            f"{key}: expected {tuple(shape)} (or packed at any of {cand_bits} bits / "
            f"g{gs}), got {dtype} {tuple(actual)}")

    for key in header:
        if key not in consumed and not any(key.startswith(p) for p in ignore_prefixes):
            rep.unexpected.append(key)
    return rep
