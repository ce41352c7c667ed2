"""The port's convert-and-verify harness (qwen3_tts_tpu_torch/io/verify.py)
on the JAX package's synthetic golden checkpoint (qwen3_tts_tpu/testing.py
write_golden_model_dir: packed uint32 triples at widths 4 / 6 / 8, dense
stragglers, the quantization block, both encoders), held against the
committed golden tests/golden/tiny_reference_format.json, which the JAX
package wrote. The JAX collect_report is not called (its own test is
slow).

- the port's exact report (fp32 on the CPU) passes the golden at the
  cpu-fp32 tier, frames compared (all 12 greedy frames equal), and the
  port's layout audit passes on the same dir;
- the port's production report (the CPU default configuration in bf16)
  passes tpu-bf16 and fails cpu-fp32;
- codec_head.scales x1.5 fails tpu-bf16, in the exact and the production
  report;
- compare_reports and TOLERANCE_TIERS equal the JAX package's on synthetic
  reports.
Tolerances are the tier table's, copied unchanged."""

import copy
import os
import shutil

import jax  # noqa: F401  (conftest keeps it on the CPU)
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.io import verify as jverify
from qwen3_tts_tpu.testing import write_golden_model_dir as jax_write_golden_model_dir
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig, SpeechTokenizerConfig
from qwen3_tts_tpu_torch.io import audit, safetensors_io, verify
from qwen3_tts_tpu_torch.testing import tiny_speaker_config

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_reference_format.json")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "m")
    jax_write_golden_model_dir(path)
    return path


def corrupt(src: str, dst: str) -> str:
    """A copy of `src` with the talker codec head's scales x1.5 (a wrong
    dequantization scale)."""
    shutil.copytree(src, dst)
    p = os.path.join(dst, "model.safetensors")
    w = safetensors_io.load_file(p)
    key = next(k for k in sorted(w) if k.endswith("codec_head.scales"))
    w[key] = np.asarray(w[key]) * np.float32(1.5)
    safetensors_io.save_file(w, p)
    return dst


def test_exact_report_passes_the_committed_golden(golden_dir):
    golden = verify.load_golden(GOLDEN)
    report = verify.collect_report(golden_dir, device="cpu")
    errs = verify.compare_reports(report, golden)
    assert not errs, "\n".join(errs)
    assert report["frames"] == golden["frames"] and len(report["frames"]) == 12
    assert report["ref_codes_row0"] == golden["ref_codes_row0"]

    # the port's audit passes on the JAX writer's dir (its tiny ECAPA dims
    # given, as config.json does not carry them)
    with open(os.path.join(golden_dir, "config.json")) as f:
        config = Qwen3TTSConfig.from_json(f.read())
    header = safetensors_io.load_header(os.path.join(golden_dir, "model.safetensors"))
    manifest = {**audit.expected_talker_manifest(config),
                **audit.expected_speaker_manifest(tiny_speaker_config())}
    rep = audit.audit_header(header, manifest, config.quantization_settings)
    assert rep.ok and not rep.unexpected and rep.quantized_keys >= 8, rep.summary()
    st = os.path.join(golden_dir, "speech_tokenizer")
    with open(os.path.join(st, "config.json")) as f:
        st_cfg = SpeechTokenizerConfig.from_json(f.read())
    rep = audit.audit_header(
        safetensors_io.load_header(os.path.join(st, "model.safetensors")),
        {**audit.expected_vocoder_manifest(st_cfg),
         **audit.expected_audio_encoder_manifest(st_cfg)})
    assert rep.ok and not rep.unexpected, rep.summary()


def test_production_report_passes_bf16_tier_only(golden_dir):
    golden = verify.load_golden(GOLDEN)
    report = verify.collect_report(golden_dir, production=True, device="cpu")
    errs = verify.compare_reports(report, golden, tier="tpu-bf16")
    assert not errs, "\n".join(errs)
    assert "wav" in golden["checksums"]  # the waveform is pinned
    assert verify.compare_reports(report, golden, tier="cpu-fp32")


@pytest.mark.parametrize("production", [False, True], ids=["exact", "production"])
def test_corruption_fails_bf16_tier(golden_dir, tmp_path, production):
    broken = corrupt(golden_dir, str(tmp_path / "broken"))
    report = verify.collect_report(broken, production=production, device="cpu")
    errs = verify.compare_reports(report, verify.load_golden(GOLDEN), tier="tpu-bf16")
    assert any("prefill_logits" in e for e in errs), errs


def test_compare_reports_and_tiers_equal_jax():
    assert verify.TOLERANCE_TIERS == jverify.TOLERANCE_TIERS
    golden = verify.load_golden(GOLDEN)
    rng = np.random.default_rng(0)
    cases = [copy.deepcopy(golden)]
    for scale in (1e-5, 2e-4, 2e-2, 5e-2, 1e-1):  # inside and past each tier
        r = copy.deepcopy(golden)
        for name, v in r["checksums"].items():
            r["checksums"][name] = [x * (1 + scale * rng.standard_normal()) for x in v]
        cases.append(r)
    r = copy.deepcopy(golden)
    r["frames"][3][0] += 1
    del r["checksums"]["wav"]
    r["ref_codes_row0"] = r["ref_codes_row0"][:-1]
    r["seed"] = 1
    cases.append(r)
    r = copy.deepcopy(golden)
    r["frames"] = r["frames"][:5]
    cases.append(r)
    for got in cases:
        for tier in verify.TOLERANCE_TIERS:
            for rtol in (None, 1e-3):
                assert (verify.compare_reports(got, golden, rtol=rtol, tier=tier)
                        == jverify.compare_reports(got, golden, rtol=rtol, tier=tier))
    assert verify._stat(torch.arange(5.0)) == jverify._stat(np.arange(5.0))
    assert verify._stat(np.zeros(0)) == jverify._stat(np.zeros(0))
