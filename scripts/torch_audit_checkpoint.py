"""Audit a Qwen3-TTS checkpoint directory's layout before first use, with the
PyTorch port (counterpart of scripts/audit_checkpoint.py; reads headers only,
so it needs no device):

    python scripts/torch_audit_checkpoint.py <model_dir> [--skip-speaker]

Checks model.safetensors (talker + code predictor [+ speaker_encoder]) and
speech_tokenizer/model.safetensors (vocoder [+ audio encoder]) against the
key / shape manifests of qwen3_tts_tpu_torch/io/audit.py. Dense and packed
(uint32 + scales / biases, any width) storage both pass. --skip-speaker
ignores the speaker_encoder.* keys, whose ECAPA dims config.json does not
give (a checkpoint with a non-standard speaker encoder, as the tiny test
fixtures). Prints a summary per file and, last, {"audit": "pass"|"fail"};
exits 1 on a missing key or a shape mismatch.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qwen3_tts_tpu_torch.config import Qwen3TTSConfig, SpeechTokenizerConfig  # noqa: E402
from qwen3_tts_tpu_torch.io import audit, safetensors_io  # noqa: E402


def main(model_dir: str, skip_speaker: bool = False) -> int:
    ok = True
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        config = Qwen3TTSConfig.from_json(f.read())
    settings = config.quantization_settings

    main_path = os.path.join(model_dir, "model.safetensors")
    header = safetensors_io.load_header(main_path)
    manifest = audit.expected_talker_manifest(config)
    ignore = ()
    if any(k.startswith("speaker_encoder.") for k in header):
        if skip_speaker:
            ignore = ("speaker_encoder.",)
        else:
            manifest.update(audit.expected_speaker_manifest())
    rep = audit.audit_header(header, manifest, settings, ignore_prefixes=ignore)
    print(f"== {main_path} ==")
    print(rep.summary())
    ok &= rep.ok

    st_path = os.path.join(model_dir, "speech_tokenizer", "model.safetensors")
    if os.path.exists(st_path):
        with open(os.path.join(model_dir, "speech_tokenizer", "config.json"),
                  encoding="utf-8") as f:
            st_cfg = SpeechTokenizerConfig.from_json(f.read())
        st_header = safetensors_io.load_header(st_path)
        st_manifest = audit.expected_vocoder_manifest(st_cfg)
        if any(k.startswith("encoder.") for k in st_header):
            st_manifest.update(audit.expected_audio_encoder_manifest(st_cfg))
        rep = audit.audit_header(st_header, st_manifest, settings)
        print(f"== {st_path} ==")
        print(rep.summary())
        ok &= rep.ok

    print(json.dumps({"audit": "pass" if ok else "fail"}))
    return 0 if ok else 1


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 1:
        print(__doc__)
        sys.exit(2)
    sys.exit(main(args[0], skip_speaker="--skip-speaker" in sys.argv))
