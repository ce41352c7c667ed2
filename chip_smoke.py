"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # one card

Phases (each prints its own lines; any failure exits non-zero):
  1. device  - the card's name and power limit; TF32 off for fp32 references
  2. build   - nvcc builds the kernels from qwen3_tts_tpu_torch/csrc/
  3. kernels - each CUDA kernel against its plain PyTorch version at the
               0.6B main path's shapes, fp32 and bf16, with times
  4. pipeline- a random-weight 0.6B model dir, Qwen3TTSPipeline in bf16 on
               the card, generate() and generate_stream(); checks the audio
               and that every kernel ran during this phase
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# fp32 tolerances: different summation orders over K <= 7 * 1536 terms in
# fp32 give rel RMS ~1e-6; bf16: outputs are rounded to bf16 (2^-9 relative)
# and both sides read the same bf16 weights
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNELS = {
    "int8_matmul": ("qwen3_tts_tpu_torch/csrc/quant_matmul.cu",
                    "qwen3_tts_tpu/ops/pallas/quant_matmul.py:221"),
    "pre_transformer": ("qwen3_tts_tpu_torch/csrc/pretransformer.cu",
                        "qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py:209"),
    "upsample_stage": ("qwen3_tts_tpu_torch/csrc/upsample.cu",
                       "qwen3_tts_tpu/ops/pallas/upsample_kernel.py:152"),
    "residual_units": ("qwen3_tts_tpu_torch/csrc/vocoder_units.cu",
                       "qwen3_tts_tpu/ops/pallas/vocoder_kernels.py:205"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_rms(got, ref) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt().clamp_min(1e-30))


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Record:
    """Worst error and summed times per kernel over its comparisons."""

    def __init__(self):
        self.rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
                     for k in KERNELS}

    def add(self, name, label, dtype, got, ref, ms, plain_ms):
        import torch

        err = rel_rms(got.float(), ref.float())
        abs_err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype]
        log(f"[kernels] {name} {label} {dtype}: rel_rms={err:.3e} (tol {TOL[dtype]:g}) "
            f"max_abs={abs_err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel {name} {label} {dtype} disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        if dtype == "bfloat16":  # the pipeline's working type
            row["ms"] += ms
            row["plain_ms"] += plain_ms


def phase_kernels(rec: Record) -> None:
    import torch

    from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
    from qwen3_tts_tpu_torch.ops.cuda import (
        pretransformer_kernel as ptk,
        quant_matmul as qm,
        upsample_kernel as upk,
        vocoder_kernels as vk,
    )
    from qwen3_tts_tpu_torch.testing import random_vocoder_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # K3 at every linear shape of the 0.6B talker / code predictor
    # (qkv, o, gate/up, down, codec_head, text fc1, fc2, cp lm_head)
    shapes = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024),
              (1024, 3072), (2048, 2048), (1024, 2048)]
    for k, o in shapes:
        w8 = torch.randint(0, 256, (o, k), generator=gen, device=dev, dtype=torch.uint8)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * 1e-3
        b = randn(o, k // 64, scale=0.02)
        for dtype in ("float32", "bfloat16"):
            for m in (1, 2, 64, 300):
                x = randn(m, k).to(getattr(torch, dtype))
                got = qm.int8_matmul_kernel(x, w8, s, b)
                ref = qm.int8_matmul_plain(x, w8, s, b)
                it = 50 if m <= 2 else 10
                rec.add("int8_matmul", f"M={m} K={k} O={o}", dtype, got, ref,
                        time_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b), it),
                        time_ms(lambda: qm.int8_matmul_plain(x, w8, s, b), it))

    cfg = TokenizerDecoderConfig()
    dense = random_vocoder_params(cfg, seed=0, device=dev)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, dt)
        for t in (26, 110):
            x = randn(1, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            rec.add("pre_transformer", f"T={t}", dtype,
                    ptk.pre_transformer_kernel(kp, x, **kw),
                    ptk.pre_transformer_plain(kp, x, **kw),
                    time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 5),
                    time_ms(lambda: ptk.pre_transformer_plain(kp, x, **kw), 5))

        stages = dense["upsample"]
        for t in (26, 110):
            x = randn(1, t, cfg.latent_dim).to(dt)
            for i, stage in enumerate(stages):
                ic = dense["decoder"]["initial_conv"] if i == len(stages) - 1 else None
                sp = upk.build_upsample_stage_params(stage, dt, initial_conv=ic)
                got = upk.upsample_stage_kernel(sp, x)
                rec.add("upsample_stage", f"stage{i} T={t}", dtype, got,
                        upk.upsample_stage_plain(sp, x),
                        time_ms(lambda: upk.upsample_stage_kernel(sp, x), 5),
                        time_ms(lambda: upk.upsample_stage_plain(sp, x), 5))
                x = got

        blocks = dense["decoder"]["blocks"]
        for t in (26, 110):
            x = randn(1, 4 * t, cfg.decoder_dim, scale=0.5).to(dt)
            for i, (block, rate) in enumerate(zip(blocks, cfg.upsample_rates)):
                tail = None
                if i == len(blocks) - 1:
                    tail = {"snake": dense["decoder"]["out_snake"],
                            "conv": dense["decoder"]["out_conv"]}
                bp = vk.build_seanet_block_params(block, rate, dt, tail=tail)
                y = vk.block_upsample(bp, x, rate=rate)
                got = vk.residual_units_kernel(bp, y)
                rec.add("residual_units", f"block{i} S={y.shape[1]}", dtype, got,
                        vk.residual_units_plain(bp, y),
                        time_ms(lambda: vk.residual_units_kernel(bp, y), 3),
                        time_ms(lambda: vk.residual_units_plain(bp, y), 3))
                x = got if got.dim() == 3 else None
    torch.cuda.synchronize()


def phase_pipeline(card: str) -> dict:
    """The port's main path on the card at the 0.6B width; returns the
    launch count of each kernel during this phase."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import vocoder as voc
    from qwen3_tts_tpu_torch.ops.cuda import (
        pretransformer_kernel as ptk,
        quant_matmul as qm,
        upsample_kernel as upk,
        vocoder_kernels as vk,
    )
    from qwen3_tts_tpu_torch.testing import write_model_dir

    modules = {"int8_matmul": qm, "pre_transformer": ptk, "upsample_stage": upk,
               "residual_units": vk}
    text = ("The quick brown fox jumps over the lazy dog, and then it runs far "
            "away into the quiet green forest.")
    spf = qt.TokenizerDecoderConfig().total_upsample
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_model_dir(d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0)
        log(f"[pipeline] wrote a random-weight 0.6B model dir in "
            f"{time.perf_counter() - t0:.1f} s")

        # count the valid frames the pipeline keeps (it filters through this
        # module attribute)
        kept: list[int] = []
        filt = gen_mod.filter_valid_frames

        def counting_filter(frames):
            out = filt(frames)
            kept.append(len(out))
            return out

        gen_mod.filter_valid_frames = counting_filter
        for m in modules.values():
            m.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pl = qt.Qwen3TTSPipeline(d, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            audio = pl.generate(text, speaker="aiden", max_tokens=96, seed=0)
            gen_s = time.perf_counter() - t0
            frames = kept[-1]
            ok = bool(np.isfinite(audio).all()) and len(audio) == frames * spf
            log(f"[pipeline] generate: {frames} valid frames, {len(audio)} samples "
                f"(expect {frames} x {spf}), finite={bool(np.isfinite(audio).all())} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok or frames == 0:
                raise SystemExit("generate() output is wrong")
            dur = len(audio) / pl.sample_rate
            log(f"[pipeline] load {load_s:.2f} s, generate {gen_s:.2f} s for {dur:.2f} s "
                f"of audio, RTF {gen_s / dur:.3f} ({card}, bf16, int8 weights)")

            kept.clear()
            t0 = time.perf_counter()
            first = None
            chunks = []
            for ch in pl.generate_stream(text, speaker="aiden", max_tokens=96, seed=0):
                if first is None and len(ch.samples):
                    first = time.perf_counter() - t0
                chunks.append(ch)
            stream_s = time.perf_counter() - t0
            pos = 0
            for ch in chunks:
                a, b = ch.token_range
                if (a != pos or len(ch.samples) != (b - a) * spf
                        or not np.isfinite(ch.samples).all()):
                    raise SystemExit(f"stream chunk {ch.token_range} does not tile the frames")
                pos = b
            if pos != sum(kept) or not chunks[-1].is_final or len(chunks[-1].samples):
                raise SystemExit(f"stream covered {pos} frames of {sum(kept)}")
            log(f"[pipeline] generate_stream: {len(chunks)} chunks over {pos} frames, "
                f"ranges tile, finals {[c.is_final for c in chunks].count(True)}; "
                f"first audio {first:.2f} s, total {stream_s:.2f} s, RTF "
                f"{stream_s / (pos * spf / pl.sample_rate):.3f} ({card})")
            launches = {k: m.launches for k, m in modules.items()}
            log(f"[pipeline] kernel launches during the pipeline phase: {launches}")
            if not all(launches.values()):
                raise SystemExit("a kernel of the main path was not launched")

            # the frame loop queues a whole chunk without a host sync
            state = gen_mod.prefill(pl.params, pl._assemble(text, "aiden"), pl.config)
            kw = dict(steps=3, temperature=0.85, track_cp_penalty=True,
                      generator=torch.Generator(device="cuda").manual_seed(0))
            gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log("[pipeline] a 3-frame decode chunk ran with torch's sync debug mode "
                "set to error: no host sync inside the chunk")

            # the kernel vocoder path against the plain torch vocoder on the
            # generated codes, both fp32 (kernel weights fp32 for this check)
            codes = torch.from_numpy(
                np.ascontiguousarray(filt(gen_mod.generate_codes(
                    pl.params, pl.cp_params, pl.config,
                    pl._assemble(text, "aiden"), temperature=0.85, max_tokens=18,
                    seed=0,
                )).T[None])
            ).long().cuda()
            dense = {k: v for k, v in pl.vocoder_params.items() if k != "kernel"}
            cfg = pl.speech_config.decoder_config
            ref = voc.decode_frames(dense, codes, cfg)
            k32 = dict(dense, kernel=voc.build_vocoder_kernel_params(dense, cfg, torch.float32))
            got = voc.decode_frames(k32, codes, cfg)
            err = rel_rms(got, ref)
            log(f"[pipeline] vocoder kernels vs plain torch vocoder on {codes.shape[2]} "
                f"generated frames (fp32): rel_rms={err:.3e} (tol 1e-3)")
            if not (err <= 1e-3):
                raise SystemExit("kernel vocoder path disagrees with the plain vocoder")
        finally:
            gen_mod.filter_valid_frames = filt
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from qwen3_tts_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2

    card = card_line()
    log(card)  # nvidia-smi --query-gpu=name,power.limit, as it prints them
    log(f"[device] torch.cuda: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"[build] nvcc sm_90a build of {len(_build.sources())} sources: "
        f"{time.perf_counter() - t0:.1f} s -> {_build.build_dir()}")

    rec = Record()
    phase_kernels(rec)
    launches = phase_pipeline(card)

    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = rec.rows[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
