"""Convert-and-verify harness: golden parity reports for a checkpoint dir
(counterpart of qwen3_tts_tpu/io/verify.py).

`collect_report` loads a model directory through the port's pipeline,
checksums the assembled prompt and the prefill, decodes greedy codec frames
from that prefill, vocodes them, and checksums every prompt mode and the
encoders' outputs; `compare_reports` diffs a report against a golden. The
same command runs on the synthetic checkpoint (testing.write_golden_model_dir)
and on published weights:

    python scripts/torch_verify_checkpoint.py <model_dir> --golden golden.json

Goldens are written in the exact mode (fp32, no runtime quantization, the
megakernels and the vocoder kernels off, TF32 off on CUDA), where greedy
frames are exact, and compared at the `cpu-fp32` tier. The same golden
checks a production run (`production=True`: the pipeline's default
configuration in bf16 on its device, the card's kernels included) at the
`tpu-bf16` tier: checksums, the vocoder waveform among them, at bf16-scale
tolerances. The tier names are the golden format's and the CLI's; on this
port `tpu-bf16` is the tier of a bf16 kernel run, which runs on the card.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from ..models import generate as gen_mod
from ..models import prompt as prompt_mod
from ..pipeline import Qwen3TTSPipeline, Qwen3TTSPipelineConfiguration

GOLDEN_TEXT = "The golden parity sentence exercises every module once."
GOLDEN_SPEAKER = "aiden"
GOLDEN_MAX_TOKENS = 12
GOLDEN_SEED = 0

# Per-tier comparison policy, with the JAX package's numbers. cpu-fp32: the
# golden's own mode, frames exact, checksums tight. tpu-bf16 (a bf16,
# quantized, kernel run against an fp32 golden): checksums, the vocoder
# waveform included, at bf16-scale tolerances; greedy frames are not
# compared, because on random weights bf16 and quantization drift flips most
# near-zero-margin argmaxes, while a corrupted checkpoint (codec_head scales
# x1.5) still fails the prefill_logits checksum. atol floors the near-zero
# mean of zero-centred activations, where a relative error means nothing.
TOLERANCE_TIERS: dict[str, dict] = {
    "cpu-fp32": {
        "rtol": {"default": 1e-4},
        "atol": 1e-6,
        "compare_frames": True,
    },
    "tpu-bf16": {
        "rtol": {"default": 3e-2, "wav": 6e-2, "prefill_logits": 4e-2},
        "atol": 5e-3,
        "compare_frames": False,
    },
}


def _stat(arr) -> list[float]:
    """[mean, std, absmax] in float64."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    a = np.asarray(arr, np.float64).reshape(-1)
    if a.size == 0:
        return [0.0, 0.0, 0.0]
    return [float(a.mean()), float(a.std()), float(np.abs(a).max())]


@contextlib.contextmanager
def _no_tf32(device: torch.device):
    """TF32 off for CUDA matmuls and convolutions inside, restored after."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _load(model_dir: str, production: bool, device):
    """The exact mode (fp32, everything a kernel or a quantizer could change
    off) or, with production, the default configuration in bf16."""
    if production:
        return Qwen3TTSPipeline(model_dir, Qwen3TTSPipelineConfiguration(),
                                dtype=torch.bfloat16, device=device)
    exact = Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False,
        use_cp_megakernel=False,
        use_talker_megakernel=False,
        use_vocoder_kernels=False,
    )
    return Qwen3TTSPipeline(model_dir, exact, dtype=torch.float32, device=device)


def collect_report(
    model_dir: str,
    *,
    text: str = GOLDEN_TEXT,
    speaker: str = GOLDEN_SPEAKER,
    max_tokens: int = GOLDEN_MAX_TOKENS,
    seed: int = GOLDEN_SEED,
    production: bool = False,
    device=None,
) -> dict:
    """Load `model_dir` through the pipeline and record greedy frames plus
    per-stage checksums [mean, std, absmax]:
    the prompt, the prefill (the talker's last hidden state and logits),
    the waveform of the frames decoded from that prefill, each prompt mode's
    embeddings on fixed synthetic inputs, and the encoders' outputs on a
    fixed tone. `device` as the pipeline's (default: QWEN3TTS_DEVICE, else
    cuda)."""
    pl = _load(model_dir, production, device)
    with contextlib.nullcontext() if production else _no_tf32(pl.device):
        return _report(pl, text, speaker, max_tokens, seed)


def _report(pl, text: str, speaker: str, max_tokens: int, seed: int) -> dict:
    checks: dict[str, list[float]] = {}
    pd = prompt_mod.assemble_prompt(pl.params, pl.config, pl.tokenizer, text, speaker=speaker)
    if pd is None:
        raise ValueError("prompt assembly returned None (text too short?)")
    checks["prompt_embeds"] = _stat(pd.input_embeds)
    checks["trailing_hidden"] = _stat(pd.trailing_hidden)

    # the prefill, checksummed, then decoded from: the prompt runs once
    state = gen_mod.prefill(pl.params, pd, pl.config)
    checks["prefill_h_last"] = _stat(state["h_last"])
    checks["prefill_logits"] = _stat(state["logits"])
    frames = gen_mod.generate_codes(
        pl.params, pl.cp_params, pl.config, pd, temperature=0.0, max_tokens=max_tokens,
        seed=seed, chunk_steps=8, initial_state=state,
    )
    valid = gen_mod.filter_valid_frames(frames)
    checks["wav"] = _stat(pl._decode_to_audio(valid))

    # Every prompt mode's embeddings, on FIXED synthetic inputs (not encoder
    # outputs), so the pins exist for any checkpoint and stay comparable at
    # the tpu-bf16 tier; the encoders are pinned below
    instruct = "A calm low voice, slightly slow."
    syn_emb = np.sin(0.7 * np.arange(pl.config.hidden_size, dtype=np.float64)).astype(np.float32)
    syn_codes = [[(i * 37 + 11) % 2048 for i in range(12)]]
    for name, kw in (
        ("prompt_voice_design", dict(instruct=instruct)),
        ("prompt_custom_voice", dict(speaker=speaker, instruct=instruct)),
        ("prompt_spk_embedding", dict(speaker_embedding=syn_emb)),
        ("prompt_icl", dict(reference_transcript="reference words spoken before",
                            reference_audio_codes=syn_codes)),
    ):
        mpd = prompt_mod.assemble_prompt(pl.params, pl.config, pl.tokenizer, text, **kw)
        checks[name] = _stat(mpd.input_embeds)

    report = {
        "format_version": 1,
        "text": text,
        "speaker": speaker,
        "max_tokens": max_tokens,
        "seed": seed,
        "frames": np.asarray(valid, np.int64).tolist(),
        "n_raw_frames": int(len(frames)),
        "checksums": checks,
    }
    tone = (0.25 * np.sin(2 * np.pi * 220.0 * np.arange(24000) / 24000.0)).astype(np.float32)
    if pl.speaker_encoder is not None:
        report["checksums"]["speaker_embedding"] = _stat(pl.extract_speaker_embedding(tone))
    if pl.audio_encoder is not None:
        codes = pl.encode_reference_audio(tone)
        report["ref_codes_row0"] = np.asarray(codes[0], np.int64).tolist()
    return report


def compare_reports(got: dict, golden: dict, rtol: float | None = None,
                    tier: str = "cpu-fp32") -> list[str]:
    """Mismatch messages (empty = PASS) under the tier's policy
    (TOLERANCE_TIERS): cpu-fp32 compares frames exactly and checksums
    tightly; tpu-bf16 compares checksums only, the waveform included. An
    explicit `rtol` overrides the tier's for every checksum."""
    policy = TOLERANCE_TIERS[tier]
    tols = policy["rtol"]
    atol = policy["atol"]
    errs: list[str] = []
    for key in ("text", "speaker", "max_tokens", "seed"):
        if key in golden and got.get(key) != golden[key]:
            errs.append(f"setting {key!r}: got {got.get(key)!r} != golden {golden[key]!r}")
    if "frames" in golden and policy["compare_frames"]:
        gf, wf = got.get("frames", []), golden["frames"]
        if gf != wf:
            n = min(len(gf), len(wf))
            first = next((i for i in range(n) if gf[i] != wf[i]), n)
            errs.append(f"frames mismatch: {len(gf)} vs {len(wf)} frames, first "
                        f"difference at frame {first}")
    if (policy["compare_frames"] and "ref_codes_row0" in golden
            and got.get("ref_codes_row0") != golden["ref_codes_row0"]):
        errs.append("reference-audio semantic codes (row 0) mismatch")
    for name, want in golden.get("checksums", {}).items():
        have = got.get("checksums", {}).get(name)
        if have is None:
            errs.append(f"checksum {name!r} missing from report")
            continue
        tol = rtol if rtol is not None else tols.get(name, tols["default"])
        if not np.allclose(have, want, rtol=tol, atol=atol):
            errs.append(f"checksum {name!r}: {have} != golden {want} (rtol={tol:g})")
    return errs


def load_golden(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_golden(report: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
