"""The port's checkpoint-layout audit (qwen3_tts_tpu_torch/io/audit.py and
scripts/torch_audit_checkpoint.py) against the JAX package's
(qwen3_tts_tpu/io/audit.py):

- the four manifests equal JAX's key for key and shape for shape, at the
  tiny dims, at 0.6B and at 1.7B (the port's come from shape-only trees);
- the audit passes on the port's golden dir (testing.write_golden_model_dir:
  packed triples at three widths, dense stragglers, both encoders);
- missing, mismatched and unexpected keys are reported as JAX's audit
  reports them on the same header;
- the script passes on the port's golden dir and fails on a broken one, in
  a subprocess with a timeout.
The JAX writer's golden dir is audited in tests/test_torch_verify.py."""

import os
import subprocess
import sys

import jax  # noqa: F401  (conftest keeps it on the CPU)
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.io import audit as jaudit
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.io import audit, safetensors_io

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(dims: str):
    """(JAX, port) talker, speech-tokenizer and speaker configs at `dims`."""
    if dims == "tiny":
        jst = jtesting.tiny_speech_tokenizer_config()
        tst = tconfig.SpeechTokenizerConfig(
            decoder_config=ttesting.tiny_decoder_config(codebook_size=64),
            encoder_config=ttesting.tiny_encoder_config())
        return ((jtesting.tiny_talker_config(), jst, jtesting.tiny_speaker_config()),
                (ttesting.golden_talker_config(), tst, ttesting.tiny_speaker_config()))
    name = {"0.6B": "standard", "1.7B": "standard_1_7b"}[dims]
    jst = jconfig.SpeechTokenizerConfig(decoder_config=jconfig.TokenizerDecoderConfig(),
                                        encoder_config=jconfig.TokenizerEncoderConfig())
    tst = tconfig.SpeechTokenizerConfig(decoder_config=tconfig.TokenizerDecoderConfig(),
                                        encoder_config=tconfig.TokenizerEncoderConfig())
    return ((getattr(jconfig.Qwen3TTSConfig, name)(), jst, None),
            (getattr(tconfig.Qwen3TTSConfig, name)(), tst, None))


@pytest.mark.parametrize("dims", ["tiny", "0.6B", "1.7B"])
def test_manifests_equal_jax(dims):
    (jc, jst, jspk), (tc, tst, tspk) = configs(dims)
    pairs = [
        (audit.expected_talker_manifest(tc), jaudit.expected_talker_manifest(jc)),
        (audit.expected_vocoder_manifest(tst), jaudit.expected_vocoder_manifest(jst)),
        (audit.expected_audio_encoder_manifest(tst),
         jaudit.expected_audio_encoder_manifest(jst)),
        (audit.expected_speaker_manifest(tspk), jaudit.expected_speaker_manifest(jspk)),
    ]
    for got, want in pairs:
        assert got == want
        assert len(got) > 20
    if dims == "0.6B":
        m = pairs[0][0]
        assert m["talker.model.text_embedding.weight"] == (151936, 2048)
        assert m["talker.code_predictor.model.lm_head.14.weight"] == (2048, 1024)


@pytest.fixture(scope="module")
def port_golden_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "m")
    ttesting.write_golden_model_dir(path)
    return path


def test_audit_passes_on_port_golden_dir(port_golden_dir):
    d = port_golden_dir
    with open(os.path.join(d, "config.json")) as f:
        config = tconfig.Qwen3TTSConfig.from_json(f.read())
    assert config.quantization is not None and config.quantization.enabled
    header = safetensors_io.load_header(os.path.join(d, "model.safetensors"))
    manifest = {**audit.expected_talker_manifest(config),
                **audit.expected_speaker_manifest(ttesting.tiny_speaker_config())}
    rep = audit.audit_header(header, manifest, config.quantization_settings)
    assert rep.ok and not rep.unexpected, rep.summary()
    packed = [k for k, (dt, _) in header.items() if k.endswith(".weight") and dt == "U32"]
    widths = {header[k][1][-1] * 32 // (header[k[:-len(".weight")] + ".scales"][1][-1] * 64)
              for k in packed}
    assert rep.quantized_keys == len(packed) >= 8 and widths == {4, 6, 8}
    assert rep.dense_keys > 0 and any(k.startswith("speaker_encoder.") for k in header)
    st = os.path.join(d, "speech_tokenizer")
    st_header = safetensors_io.load_header(os.path.join(st, "model.safetensors"))
    assert any("cluster_usage" in k for k in st_header)
    assert any("embedding_sum" in k for k in st_header)
    with open(os.path.join(st, "config.json")) as f:
        st_cfg = tconfig.SpeechTokenizerConfig.from_json(f.read())
    rep = audit.audit_header(st_header, {**audit.expected_vocoder_manifest(st_cfg),
                                         **audit.expected_audio_encoder_manifest(st_cfg)})
    assert rep.ok and not rep.unexpected, rep.summary()


def test_audit_reports_missing_and_mismatched_keys():
    config = ttesting.golden_talker_config()
    manifest = audit.expected_talker_manifest(config)
    settings = tconfig.QuantizationSettings(enabled=True, bits=4, group_size=64)
    jsettings = jconfig.QuantizationSettings(enabled=True, bits=4, group_size=64)
    header, keys = {}, sorted(manifest)
    for i, k in enumerate(keys):
        pk = audit._packed_shape(manifest[k], (4, 6, 8)[i % 3], 64)
        if pk is not None and k.endswith(".weight"):
            header[k] = ("U32", pk[0])
            header[k[: -len(".weight")] + ".scales"] = ("F32", pk[1])
            header[k[: -len(".weight")] + ".biases"] = ("F32", pk[1])
        else:
            header[k] = ("BF16", manifest[k])
    assert audit._packed_shape((8, 100), 4, 64) is None
    assert audit._packed_shape((8, 128), 6, 64) == ((8, 24), (8, 2))
    rep = audit.audit_header(header, manifest, settings)
    assert rep.ok and rep.quantized_keys > 10 and not rep.unexpected, rep.summary()

    dense = next(k for k in keys if header[k][0] == "BF16" and len(manifest[k]) == 2)
    packed = next(k for k in keys if header[k][0] == "U32")
    missing = keys[len(keys) // 2]
    header[dense] = ("BF16", tuple(reversed(manifest[dense])))  # transposed
    header[packed] = ("U32", (header[packed][1][0], header[packed][1][1] + 1))  # no width
    del header[missing]
    header["talker.model.extra.weight"] = ("F32", (3, 3))
    rep = audit.audit_header(header, manifest, settings)
    jrep = jaudit.audit_header(header, manifest, jsettings)
    assert not rep.ok
    assert rep.missing == jrep.missing == [missing]
    assert rep.shape_mismatch == jrep.shape_mismatch and len(rep.shape_mismatch) == 2
    assert rep.unexpected == jrep.unexpected and "talker.model.extra.weight" in rep.unexpected
    assert (rep.dense_keys, rep.quantized_keys) == (jrep.dense_keys, jrep.quantized_keys)
    assert rep.summary() == jrep.summary()


def test_audit_script(port_golden_dir, tmp_path):
    script = os.path.join(REPO, "scripts", "torch_audit_checkpoint.py")

    def run(d):
        return subprocess.run([sys.executable, script, d, "--skip-speaker"],
                              capture_output=True, text=True, cwd=REPO, timeout=300)

    r = run(port_golden_dir)
    assert r.returncode == 0 and '"audit": "pass"' in r.stdout, r.stdout + r.stderr
    broken = str(tmp_path / "broken")
    os.makedirs(os.path.join(broken, "speech_tokenizer"))
    for name in ("config.json", "speech_tokenizer/config.json",
                 "speech_tokenizer/model.safetensors"):
        with open(os.path.join(port_golden_dir, name), "rb") as f, \
                open(os.path.join(broken, name), "wb") as g:
            g.write(f.read())
    w = safetensors_io.load_file(os.path.join(port_golden_dir, "model.safetensors"))
    del w[sorted(k for k in w if k.endswith("codec_head.scales"))[0]]
    safetensors_io.save_file(w, os.path.join(broken, "model.safetensors"))
    r = run(broken)
    assert r.returncode == 1 and '"audit": "fail"' in r.stdout, r.stdout + r.stderr
    assert np.any(["SHAPE" in line for line in r.stdout.splitlines()])
