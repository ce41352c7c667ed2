"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # one card

Phases, in this order (each prints its own lines; any failure exits
non-zero):
  device      - the card's name and power limit; TF32 off for fp32 references
  build       - nvcc builds the kernels from qwen3_tts_tpu_torch/csrc/, one
                process per source, in parallel
  megakernels - K1 (talker step, C = 260 with a wrapped ring, a trimmed
                window of ~200 slots and one of 3 slots), K2 (code-predictor
                frame, with and without the repetition penalty) and K2g
                (Gumbel sampler: same draws as its plain version, chi-square
                of 100k draws) at 0.6B; K1 and K2 are each one persistent
                cooperative launch: their grids and shared memory, one device
                kernel per call (profiler), repeated runs bit-identical, the
                weight bytes per second they reach, the cost of one grid
                barrier (a launch of n barriers) times the barriers a step
                and a frame make
  kernels     - K3, K4, K4a, K5, K6 and K7 against their plain PyTorch
                versions at the 0.6B main path's shapes, fp32 and bf16, with
                times and bounds (K7 at 4 and 6 bits on the mixed mode's
                linears, and one 2-, 3- and 8-bit shape, each at M = 1 and
                M = 300; K4a at T = 26 and 110, B = 1 and 2, also against K4
                on the same weights, and at T = 300, whose q/k/v do not fit
                in shared memory)
  fused-pretransformer - K4a's own entry point, pre_transformer_fused, on
                the 0.6B vocoder's pre-transformer (no pipeline path runs
                it, in this port or in the JAX package): launch counts
  sampler     - K2g's own entry point, gumbel_sample, on the code
                predictor's 2048 logits: a frame's 15 draws, sampled and
                greedy, from fp32 and bf16 logits (no pipeline path launches
                its kernel: K2 makes the draws with its device function
                inside its own launch): launch counts
  pipeline    - the default configuration (megakernels on): a random-weight
                0.6B model dir, Qwen3TTSPipeline in bf16, generate() and
                generate_stream(); checks the audio and that K1, K2,
                K3 (text projection), K4, K5, K6 ran (K2g's kernel not, its
                draws made inside K2); a decode chunk with no
                host sync; K1/K2 against their plain versions teacher-forced
                over the generated frames; the kernel vocoder against the
                plain one; a profile of the frame loop
  k3-pipeline - the same with the megakernels off (every linear on K3)
  mixed-pipeline - runtime_quantization_mode="mixed_4_6" with the
                megakernels off on the same dir: every talker and
                code-predictor linear on K7 at 4 or 6 bits, K1-K3 idle; a
                decode chunk with no host sync, a profile of the frame loop,
                and the prefill logits with K7 against those with its plain
                version swapped in, in a bf16 and an fp32 model
  prequant-pipeline - a 0.6B dir pre-quantized to 4 bits, group 64 (MLX's
                layout, written by write_prequantized_model_dir), in the
                default configuration: K1, K2, K7 (text projection),
                K4-K6 ran and K3 and K2g's kernel did not; a decode chunk with no host sync
                (packed embedding gathers in the frame loop); K1/K2
                teacher-forced on the kernel trees built from packed weights; a
                profile of the frame loop
  modes-pipeline - a 0.6B dir with the speaker and audio encoders at full
                width, default configuration: generate_voice_design,
                generate_custom_voice, a streamed VoiceDesign run, a speaker
                embedding and reference codes of a 5 s clip it generated
                (held against the port's CPU run in fp32), generate with that
                embedding, generate_icl, generate_batch on three sentences,
                generate_to_file, warmup; RTF per mode, encoder times,
                resident bytes, and K1, K2, K3, K4, K5, K6 launched,
                K2g's kernel, K4a and K7 not
The line before the last is {"kernels": [...]} and the last is
{"ok": true, "device": {...}}.

Times: a call whose back-to-back CUDA-event time is under 50 us is timed
again by replaying a CUDA graph of it (device time, without Python's
dispatch); each kernel line says which method it used. Bounds: the larger of
the bytes a call must move over 3.35 TB/s and its operations over the
card's peak rate for their type (989 TFLOP/s bf16, 67 TFLOP/s fp32 outside
the tensor cores, 1,979 TOP/s int8).
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
# W8A8 (K1, K2): both sides quantize activations to int8, a discontinuous
# step. fp32 sums in another order put an activation on the other side of a
# rounding boundary about twice per 0.6B talker step; that moves the GEMV's
# output by ~1e-3 and every later layer then rounds its own activations
# apart. Measured on the card: K/V rows agree to ~1e-7 per layer up to the
# first such step (layer 16 of 28), then drift to 1.7e-2 by the last layer;
# logits 1.6e-2. So K1 is held to more than this limit (phase_megakernels):
# in fp32 its K/V rows must agree to ROW_TOL through layer 1, and a case
# with a 3-slot window gives the current token's own term a large weight.
TOL_W8A8 = {"float32": 5e-2, "bfloat16": 5e-2}
ROW_TOL = 1e-5  # K/V rows before any rounding step: fp32 sum order only
NEAR_TIE = 1e-2  # a code may differ only where the scores are this close
HBM = 3.35e12
RATE = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
KERNELS = {
    "int8_matmul": ("qwen3_tts_tpu_torch/csrc/quant_matmul.cu",
                    "qwen3_tts_tpu/ops/pallas/quant_matmul.py:221"),
    "pre_transformer": ("qwen3_tts_tpu_torch/csrc/pretransformer.cu",
                        "qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py:209"),
    "upsample_stage": ("qwen3_tts_tpu_torch/csrc/upsample.cu",
                       "qwen3_tts_tpu/ops/pallas/upsample_kernel.py:152"),
    "residual_units": ("qwen3_tts_tpu_torch/csrc/vocoder_units.cu",
                       "qwen3_tts_tpu/ops/pallas/vocoder_kernels.py:205"),
    "talker_step": ("qwen3_tts_tpu_torch/csrc/talker_step.cu",
                    "qwen3_tts_tpu/ops/pallas/talker_megakernel.py:50"),
    "cp_frame": ("qwen3_tts_tpu_torch/csrc/cp_frame.cu",
                 "qwen3_tts_tpu/ops/pallas/cp_megakernel.py:217"),
    "gumbel_sample": ("qwen3_tts_tpu_torch/csrc/cp_frame.cu",
                      "qwen3_tts_tpu/ops/pallas/cp_megakernel.py:185"),
    "packed_matmul": ("qwen3_tts_tpu_torch/csrc/packed_matmul.cu",
                      "qwen3_tts_tpu/ops/pallas/quant_matmul.py:93"),
    "pre_transformer_fused": ("qwen3_tts_tpu_torch/csrc/pretransformer.cu",
                              "qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py:51"),
}
TEXT = ("The quick brown fox jumps over the lazy dog, and then it runs far "
        "away into the quiet green forest.")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def counters() -> dict:
    """kernel name -> (wrapper module, name of its launch count)."""
    from qwen3_tts_tpu_torch.ops.cuda import (
        cp_megakernel,
        gumbel_sampler,
        packed_matmul,
        pretransformer_kernel,
        quant_matmul,
        talker_megakernel,
        upsample_kernel,
        vocoder_kernels,
    )

    return {"int8_matmul": (quant_matmul, "launches"),
            "pre_transformer": (pretransformer_kernel, "launches"),
            "upsample_stage": (upsample_kernel, "launches"),
            "residual_units": (vocoder_kernels, "launches"),
            "talker_step": (talker_megakernel, "launches"),
            "cp_frame": (cp_megakernel, "launches"),
            "gumbel_sample": (gumbel_sampler, "launches"),
            "packed_matmul": (packed_matmul, "launches"),
            "pre_transformer_fused": (pretransformer_kernel, "fused_launches")}


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def check_counts(label: str, launches: dict, need, idle) -> None:
    log(f"[{label}] kernel launches during this run: {launches}")
    missing = [k for k in need if not launches[k]]
    if missing or any(launches[k] for k in idle):
        raise SystemExit(f"[{label}] kernels not launched: {missing}, or launched where "
                         f"they should not be: {[k for k in idle if launches[k]]}")


def rel_rms(got, ref) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt().clamp_min(1e-30))


def _events_ms(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int) -> tuple[float, str]:
    """(ms per call, method). Back-to-back calls between CUDA events; a call
    under 50 us reads the host's dispatch rate that way, so it is timed again
    by replaying a CUDA graph of one call (torch.profiler's device total if
    the call cannot be captured)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = _events_ms(lambda: [fn() for _ in range(iters)]) / iters
    if ms >= 0.05:
        return ms, "events"
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        return _events_ms(lambda: [graph.replay() for _ in range(iters)]) / iters, "graph"
    except RuntimeError:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return device_us(prof) / 1e3 / iters, "profiler"


def device_us(prof) -> float:
    """Summed device time (us) of every kernel in a torch.profiler run."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return total


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations") for `nbytes` moved and
    ops {type: count}."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / RATE[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Record:
    """Worst error and summed times / bounds per kernel over its comparisons
    (times and bounds over the bf16 ones, the pipeline's working type)."""

    def __init__(self):
        self.rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "t_bytes": 0.0, "t_ops": 0.0} for k in KERNELS}

    def add(self, name, label, dtype, err, abs_err, tol, timing, plain_timing, nb, ops,
            extra="", timed=True):
        """`timed`: the call is the main path's, so its times and bound count
        in the kernel's row."""
        ok = err == err and err <= tol  # NaN fails
        (ms, how), (pms, phow) = timing, plain_timing
        b_ms, b_by = bound(nb, ops)
        log(f"[kernels] {name} {label} {dtype}: rel_rms={err:.3e} (tol {tol:g}) "
            f"max_abs={abs_err:.3e}{extra} kernel {ms:.4f} ms ({how}) plain {pms:.4f} ms "
            f"({phow}) bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel {name} {label} {dtype} disagrees with its plain version")
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        if dtype == "bfloat16" and timed:
            row["ms"] += ms
            row["plain_ms"] += pms
            row["bound_ms"] += b_ms
            row["t_bytes"] += nb / HBM
            row["t_ops"] += sum(n / RATE[k] for k, n in ops.items())

    def compare(self, name, label, dtype, got, ref, timing, plain_timing, nb, ops, timed=True):
        import torch

        err = rel_rms(got.float(), ref.float())
        abs_err = float((got.float() - ref.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            err = float("nan")
        self.add(name, label, dtype, err, abs_err, TOL[dtype], timing, plain_timing, nb, ops,
                 timed=timed)


def weight_numel(kp: dict, names) -> int:
    return sum(kp[n].numel() for n in names if n in kp)


def phase_kernels(rec: Record) -> None:
    import torch

    from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
    from qwen3_tts_tpu_torch.ops.cuda import (
        packed_matmul as pm,
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
                nb = nbytes(x, w8, s, b, got)
                rec.compare("int8_matmul", f"M={m} K={k} O={o}", dtype, got, ref,
                            time_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b), it),
                            time_ms(lambda: qm.int8_matmul_plain(x, w8, s, b), it),
                            nb, {dtype: 2 * m * k * o})

    # K7 at the mixed 4/6-bit mode's 0.6B linears (4-bit gate/up, o, down;
    # 6-bit qkv and codec head: the main path's, timed) and one 2-, 3- and
    # 8-bit shape (text fc1, cp lm_head, down), group 64; random bit
    # patterns are valid packed values at every width
    packed = [(4, 1024, 6144, True), (4, 2048, 1024, True), (4, 3072, 1024, True),
              (6, 1024, 4096, True), (6, 1024, 3072, True),
              (2, 2048, 2048, False), (3, 1024, 2048, False), (8, 3072, 1024, False)]
    for bits, k, o, main in packed:
        wq = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.int32)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * (2e-2 / 2 ** bits)
        b = randn(o, k // 64, scale=0.01)
        for dtype in ("float32", "bfloat16"):
            for m in (1, 300):
                x = randn(m, k).to(getattr(torch, dtype))
                got = pm.packed_matmul_kernel(x, wq, s, b, bits, 64)
                ref = pm.packed_matmul_plain(x, wq, s, b, bits, 64)
                it = 50 if m == 1 else 10
                err = rel_rms(got.float(), ref.float())
                if not bool(torch.isfinite(got.float()).all()):
                    err = float("nan")
                rec.add("packed_matmul", f"{bits}-bit M={m} K={k} O={o}", dtype, err,
                        float((got.float() - ref.float()).abs().max()), TOL[dtype],
                        time_ms(lambda: pm.packed_matmul_kernel(x, wq, s, b, bits, 64), it),
                        time_ms(lambda: pm.packed_matmul_plain(x, wq, s, b, bits, 64), it),
                        nbytes(x, wq, s, b, got), {dtype: 2 * m * k * o}, timed=main)

    cfg = TokenizerDecoderConfig()
    dense = random_vocoder_params(cfg, seed=0, device=dev)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, dt)
        mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
        for t in (26, 110):
            x = randn(1, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_kernel(kp, x, **kw)
            attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            rec.compare("pre_transformer", f"T={t}", dtype, got,
                        ptk.pre_transformer_plain(kp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 5),
                        time_ms(lambda: ptk.pre_transformer_plain(kp, x, **kw), 5),
                        nbytes(x, got, *kp.values()), {dtype: 2 * t * mats + attn})

        # K4a: the same function over the per-head layout, at the shapes of
        # the vocoder's stream window and blocking rows, B = 1 (timed) and
        # 2; against its plain version and against K4 on the same weights
        fp = ptk.build_pretransformer_fused_params(dense["pre_transformer"], cfg, dt)
        fmats = weight_numel(fp, ("wi", "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wout"))
        for b, t in ((1, 26), (1, 110), (2, 26), (2, 110), (1, 300)):
            x = randn(b, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_fused_kernel(fp, x, **kw)
            k4 = ptk.pre_transformer_kernel(kp, x, **kw)
            vs_k4 = rel_rms(got.float(), k4.float())
            attn = 2 * fp["wq"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            rec.compare("pre_transformer_fused", f"B={b} T={t}", dtype, got,
                        ptk.pre_transformer_fused_plain(fp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw), 5),
                        time_ms(lambda: ptk.pre_transformer_fused_plain(fp, x, **kw), 5),
                        nbytes(x, got, *fp.values()), {dtype: b * (2 * t * fmats + attn)},
                        timed=b == 1 and t != 300)
            log(f"[kernels] pre_transformer_fused B={b} T={t} {dtype}: against K4 on the same "
                f"weights rel_rms={vs_k4:.3e} (tol {TOL[dtype]:g})")
            if not vs_k4 <= TOL[dtype]:
                raise SystemExit("K4a disagrees with K4 on the same weights")

        stages = dense["upsample"]
        for t in (26, 110):
            x = randn(1, t, cfg.latent_dim).to(dt)
            for i, stage in enumerate(stages):
                ic = dense["decoder"]["initial_conv"] if i == len(stages) - 1 else None
                sp = upk.build_upsample_stage_params(stage, dt, initial_conv=ic)
                got = upk.upsample_stage_kernel(sp, x)
                c = x.shape[-1]
                ops = (2 * t * sp["up_w"].numel()
                       + 2 * 2 * t * (weight_numel(sp, ("pw1_w", "pw2_w", "ic_w")) + 7 * c))
                rec.compare("upsample_stage", f"stage{i} T={t}", dtype, got,
                            upk.upsample_stage_plain(sp, x),
                            time_ms(lambda: upk.upsample_stage_kernel(sp, x), 5),
                            time_ms(lambda: upk.upsample_stage_plain(sp, x), 5),
                            nbytes(x, got, *sp.values()), {dtype: ops})
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
                rows = y.shape[0] * y.shape[1]
                ops = 2 * rows * weight_numel(bp, ("u_w1", "u_w2", "t_w"))
                units = [v for k, v in bp.items() if k.startswith(("u_", "t_"))]
                rec.compare("residual_units", f"block{i} S={y.shape[1]}", dtype, got,
                            vk.residual_units_plain(bp, y),
                            time_ms(lambda: vk.residual_units_kernel(bp, y), 3),
                            time_ms(lambda: vk.residual_units_plain(bp, y), 3),
                            nbytes(y, got, *units), {dtype: ops})
                x = got if got.dim() == 3 else None
    torch.cuda.synchronize()


def chisq_pvalue(counts, probs) -> float:
    """Chi-square goodness of fit with bins of expectation below 5 merged."""
    from scipy import stats

    counts = np.asarray(counts, np.float64)
    exp = np.asarray(probs, np.float64) * counts.sum()
    order = np.argsort(exp)
    counts, exp = counts[order], exp[order]
    while len(exp) > 2 and exp[0] < 5.0:
        exp[1] += exp[0]
        counts[1] += counts[0]
        exp, counts = exp[1:], counts[1:]
    exp *= counts.sum() / exp.sum()
    return float(stats.chisquare(counts, exp).pvalue)


def talker_case(rec: Record, tkp: dict, cfg, gen, dt, ws: int, main: bool) -> None:
    """K1 against its plain version at C = 260, position 300, window start
    `ws`: h, logits and the new K/V rows within TOL_W8A8; every other ring
    slot untouched and pos[slot] written; in fp32 on the main case, the K/V
    rows of layers 0 and 1 within ROW_TOL (a fault in layer 0's attention,
    such as a lost current-token column or a wrong window, shows there)."""
    import torch

    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    dtype = str(dt).split(".")[-1]
    nl, kvw, hc = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim, cfg.hidden_size
    c_len, position = 260, 300
    slots = torch.arange(c_len, device=dev)
    pos = torch.where(slots < position % c_len, slots + c_len, slots)
    n_valid = int(((pos >= 0) & (pos >= ws)).sum())
    cos, sin = talker_mod.rope_cos_sin(cfg, torch.full((1, 1), position, device=dev))
    cos, sin = cos[0, 0], sin[0, 0]
    pos_t, ws_t = torch.tensor(position, device=dev), torch.tensor(ws, device=dev)
    slot = position % c_len
    cache = {"k2": (torch.randn(nl, c_len, kvw, generator=gen, device=dev) * 0.3).to(dt),
             "v2": (torch.randn(nl, c_len, kvw, generator=gen, device=dev) * 0.3).to(dt),
             "pos": pos}
    embed = (torch.randn(1, 1, hc, generator=gen, device=dev) * 0.5).to(dt)
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    hk, lk, _ = tmk.talker_step_kernel(tkp, embed, ck, pos_t, ws_t, cos, sin, cfg)
    hp, lp, _ = tmk.talker_step_plain(tkp, embed, cp, pos_t, ws_t, cos, sin, cfg)
    torch.cuda.synchronize()
    errs = [rel_rms(hk.float(), hp.float()), rel_rms(lk, lp)]
    for name in ("k2", "v2"):
        errs.append(rel_rms(ck[name][:, slot].float(), cp[name][:, slot].float()))
    untouched = all(torch.equal(torch.cat([ck[n][:, :slot], ck[n][:, slot + 1:]], 1),
                                torch.cat([cache[n][:, :slot], cache[n][:, slot + 1:]], 1))
                    for n in ("k2", "v2"))
    pos_ok = torch.equal(ck["pos"], cp["pos"]) and int(ck["pos"][slot]) == position
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (hk, lk))
    per_layer = [max(rel_rms(ck[n][l, slot].float(), cp[n][l, slot].float())
                     for n in ("k2", "v2")) for l in range(nl)]
    apart = [e > ROW_TOL for e in per_layer]
    first = apart.index(True) if any(apart) else nl
    rows_ok = not (main and dt == torch.float32) or first >= 2
    err = max(errs) if (untouched and pos_ok and finite and rows_ok) else float("nan")
    flip = int(torch.argmax(lk)) != int(torch.argmax(lp))
    log(f"[megakernels] talker_step {dtype} window={ws}: K/V row rel RMS per layer, kernel vs "
        "plain: " + " ".join(f"{e:.1e}" for e in per_layer))
    esize = torch.finfo(dt).bits // 8
    w_names = [f"{p}_{s}" for p in ("qkv", "o", "gu", "dn", "ch") for s in "qsm"]
    w_bytes = nbytes(*(tkp[n] for n in w_names),
                     *(tkp[n] for n in ("in_ln", "post_ln", "q_ln", "k_ln", "fin_ln")))
    int8_ops = 2 * sum(tkp[f"{p}_q"].numel() for p in ("qkv", "o", "gu", "dn", "ch"))
    nb = w_bytes + (n_valid * 2 + 2) * nl * kvw * esize + 2 * hc * esize + lk.numel() * 4
    attn_ops = 4 * cfg.num_attention_heads * cfg.head_dim * (n_valid + 1) * nl
    timing = time_ms(lambda: tmk.talker_step_kernel(tkp, embed, ck, pos_t, ws_t, cos, sin, cfg),
                     20)
    rec.add("talker_step", f"C={c_len} pos={position} window={ws} ({n_valid} slots)", dtype,
            err, float((lk - lp).abs().max()), TOL_W8A8[dtype], timing,
            time_ms(lambda: tmk.talker_step_plain(tkp, embed, cp, pos_t, ws_t, cos, sin, cfg),
                    3),
            nb, {"int8": int8_ops, "float32": attn_ops},
            extra=f" (h, logits, k row, v row: {', '.join(f'{e:.1e}' for e in errs)}; "
                  f"argmax {'differs' if flip else 'agrees'}; K/V rows agree to {ROW_TOL:g} "
                  f"through layer {first - 1}"
                  f"{'' if rows_ok else ', need layer 1'}; ring and pos "
                  f"{'ok' if untouched and pos_ok else 'WRONG'})",
            timed=main)
    return timing[0], w_bytes, (embed, cache, pos_t, ws_t, cos, sin)


def phase_megakernels(rec: Record, card: str, talker_dense: dict, cp_dense: dict) -> None:
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.convert import to_torch
    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    cfg = qt.Qwen3TTSConfig.standard()
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    tkp = to_torch(tmk.build_talker_kernel_params(talker_dense, cfg), dev)
    ckp = to_torch(cpk.build_cp_kernel_params(cp_dense, cfg.code_predictor_config), dev)
    log(f"[megakernels] built the 0.6B K1 / K2 trees in {time.perf_counter() - t0:.1f} s")

    # K1: ring of C = 260 (prompt 36 + 224) at position 300: slots 0..39 hold
    # 260..299 (wrapped), and slot 40, where the token goes, holds 40 (masked,
    # as in decoding). Window start 99 (trimmed at step 255, ~200 valid
    # slots) is the main path's case; window start 297 leaves 3 valid slots,
    # so the current token's own term carries about a quarter of each head's
    # attention and a fault in it moves the logits far past TOL_W8A8.
    k1 = {}
    for dtype in ("float32", "bfloat16"):
        for ws in (99, 297):
            k1[dtype, ws] = talker_case(rec, tkp, cfg, gen, getattr(torch, dtype), ws,
                                        main=ws == 99)

    # K2: one frame, temperature 0.85, with and without the penalty; the
    # plain version replays the kernel's codes and its own picks must match
    # except at near ties
    cc = cfg.code_predictor_config
    ng, v, chc = cc.num_code_groups - 1, cc.vocab_size, cc.hidden_size
    lay_names = [f"{p}_{s}" for p in ("qkv", "o", "gu", "dn") for s in "qsm"]
    lay_bytes = nbytes(*(ckp[n] for n in lay_names),
                       *(ckp[n] for n in ("in_ln", "post_ln", "q_ln", "k_ln", "fin_ln")))
    head_bytes = nbytes(ckp["head_q"], ckp["head_s"], ckp["head_m"])
    cp_ops = (2 * (ng + 1) * sum(ckp[f"{p}_q"].numel() for p in ("qkv", "o", "gu", "dn"))
              + 2 * ckp["head_q"].numel())
    seed = torch.tensor([20240607], device=dev)
    k2 = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        hidden = torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev).to(dt)
        code0 = (torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev) * 0.5).to(dt)
        for track in (True, False):
            seen = (torch.rand(ng, v, generator=gen, device=dev) < 0.3) if track else None
            sk = seen.clone() if track else None
            lk = torch.empty(ng, v, device=dev)
            codes, ek, sk = cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85, sk,
                                                     cc, 1.05, None, lk)
            sp = seen.clone() if track else None
            lp = torch.empty(ng, v, device=dev)
            _, ep, sp = cpk.predict_frame_plain(ckp, hidden, code0, seed, 0.85, sp, cc, 1.05,
                                                codes, lp)
            torch.cuda.synchronize()
            noise = 0.85 * gs.gumbel_noise(seed, ng, v)
            agree, ties, bad = 0, 0, 0
            for k in range(ng):
                score = lp[k] / torch.where(seen[k], 1.05, 1.0) if track else lp[k]
                score = score + noise[k]
                pick, want = int(torch.argmax(score)), int(codes[k])
                if pick == want:
                    agree += 1
                elif float(score[pick] - score[want]) <= NEAR_TIE * float(score.abs().max()):
                    ties += 1
                else:
                    bad += 1
            same = torch.equal(ek, ep) and (not track or torch.equal(sk, sp))
            err = rel_rms(lk, lp)
            if bad or not same or not bool(torch.isfinite(lk).all()):
                err = float("nan")
            nb = (lay_bytes + head_bytes + nbytes(ckp["cos"], ckp["sin"]) + 2 * chc * 4
                  + (ng - 1) * (chc + 8) + lk.numel() * 4 + ng * 8
                  + (2 * ng * v if track else 0))
            sk2 = seen.clone() if track else None
            sp2 = seen.clone() if track else None
            k2[dtype, track] = (time_ms(lambda: cpk.predict_frame_kernel(
                ckp, hidden, code0, seed, 0.85, sk2, cc), 10), (hidden, code0, seen))
            rec.add("cp_frame", f"penalty={'on' if track else 'off'} T=0.85", dtype, err,
                    float((lk - lp).abs().max()), TOL_W8A8[dtype], k2[dtype, track][0],
                    time_ms(lambda: cpk.predict_frame_plain(ckp, hidden, code0, seed, 0.85,
                                                            sp2, cc), 2),
                    nb, {"int8": cp_ops},
                    extra=f" (codes: {agree}/{ng} picked alike, {ties} near ties)",
                    timed=track)

    persistent_checks(card, cfg, tkp, ckp, seed, k1[("bfloat16", 99)], k2[("bfloat16", True)],
                      lay_bytes, head_bytes)

    # K2g: the kernel draws exactly the plain version's codes; 100k draws
    # follow softmax(lg / T)
    logits = torch.randn(v, generator=gen, device=dev) * 2.0
    gseed = torch.tensor([7], device=dev)
    got = gs.gumbel_sample_kernel(logits, gseed, 0.85, 100_000)
    ref = gs.gumbel_sample_plain(logits, gseed, 0.85, 4096)
    torch.cuda.synchronize()
    lb = logits.bfloat16()  # logits as a bf16 model hands them over
    same = (int((got[:4096] != ref).sum())
            + int((gs.gumbel_sample(lb, gseed, 0.85, 4096)
                   != gs.gumbel_sample_plain(lb, gseed, 0.85, 4096)).sum()))
    p = torch.softmax(logits.double() / 0.85, 0).cpu().numpy()
    pval = chisq_pvalue(np.bincount(got.cpu().numpy(), minlength=v), p)
    greedy_ok = bool((gs.gumbel_sample_kernel(logits, gseed, 0.0, 64) == torch.argmax(logits))
                     .all())
    log(f"[megakernels] gumbel_sample: 100000 draws over V={v} at T=0.85: chi-square p = "
        f"{pval:.4f} (need >= 1e-3); the first 4096 draws from fp32 and from bf16 logits "
        f"differ from the plain version's in {same}; greedy draws are the argmax: "
        f"{greedy_ok}")
    if pval < 1e-3 or same or not greedy_ok:
        raise SystemExit("the Gumbel sampler kernel is off")
    one = logits.clone()
    ops = v * 110  # Philox-4x32-10 (~100 integer operations), two logs, select
    rec.add("gumbel_sample", f"1 draw V={v} (as in K2)", "bfloat16", 0.0, 0.0, 0.0,
            time_ms(lambda: gs.gumbel_sample_kernel(one, gseed, 0.85, 1), 50),
            time_ms(lambda: gs.gumbel_sample_plain(one, gseed, 0.85, 1), 20),
            v * 4 + 16, {"float32": ops})
    torch.cuda.synchronize()


def device_kernels(prof) -> list[str]:
    """Names of the device activities (kernels, copies) a profiler run saw."""
    import torch

    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def persistent_checks(card: str, cfg, tkp: dict, ckp: dict, seed, k1_main, k2_main,
                      lay_bytes: int, head_bytes: int) -> None:
    """K1 and K2 as persistent cooperative launches at 0.6B, bf16 (the main
    cases): each launch's grid and dynamic shared memory; one device kernel
    per call (torch.profiler); two runs bit for bit alike; the weight bytes
    per second each achieves; and the cost of one grid barrier, timed as a
    launch of n barriers (csrc/grid_barrier.cu), times the barriers a step
    and a frame make: the design's floor."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import persistent as ps
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    dev = torch.device("cuda")
    cc = cfg.code_predictor_config
    k1_ms, k1_bytes, (embed, cache, pos_t, ws_t, cos, sin) = k1_main
    (k2_ms, _), (hidden, code0, seen) = k2_main
    tplan, cplan = ps.talker_plan(cfg, cache["pos"].shape[0], dev), ps.cp_plan(cc, dev)
    for name, pl in (("talker_step (K1)", tplan), ("cp_frame (K2)", cplan)):
        log(f"[megakernels] {name}: one cooperative launch of {pl.grid} blocks x {ps.PK_NT} "
            f"threads, {pl.smem} bytes of dynamic shared memory ({pl.buf} per weight buffer), "
            f"attention in {pl.nch} chunk(s) of {pl.S} slots per kv head")

    def k1():
        c = {k: v.clone() for k, v in cache.items()}
        h, lg, c = tmk.talker_step_kernel(tkp, embed, c, pos_t, ws_t, cos, sin, cfg)
        return h, lg, c["k2"], c["v2"], c["pos"]

    def k2():
        lg = torch.empty(cc.num_code_groups - 1, cc.vocab_size, device=dev)
        codes, esum, s = cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85,
                                                  seen.clone(), cc, logits_out=lg)
        return codes, esum, s, lg

    calls = (lambda: tmk.talker_step_kernel(tkp, embed, cache, pos_t, ws_t, cos, sin, cfg),
             lambda: cpk.predict_frame_kernel(ckp, hidden, code0, seed, 0.85, None, cc))
    for name, fn, call in (("talker_step", k1, calls[0]), ("cp_frame", k2, calls[1])):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                call()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        log(f"[megakernels] {name}: two runs bit-identical: {same}; 4 calls ran "
            f"{len(kernels)} device kernels ({sorted(set(kernels))}) ({card})")
        if not same or len(kernels) != 4 or len(set(kernels)) != 1:
            raise SystemExit(f"{name} is not one deterministic kernel per call")


    n_pass = cc.num_code_groups
    per_step = 5 * cfg.num_hidden_layers
    per_frame = n_pass * 5 * cc.num_hidden_layers + (n_pass - 1)
    ps.grid_barriers(16)
    torch.cuda.synchronize()
    n = 4000
    t0 = min(_events_ms(lambda: ps.grid_barriers(0)) for _ in range(5))
    tn = min(_events_ms(lambda: ps.grid_barriers(n)) for _ in range(5))
    us = (tn - t0) / n * 1e3
    log(f"[megakernels] grid barrier: {us:.3f} us each ({n} in one launch of "
        f"{tplan.grid} blocks, less an empty launch); {per_step} per talker step = "
        f"{per_step * us / 1e3:.4f} ms, {per_frame} per code-predictor frame = "
        f"{per_frame * us / 1e3:.4f} ms ({card})")
    once = lay_bytes + head_bytes
    streamed = n_pass * lay_bytes + head_bytes
    log(f"[megakernels] talker_step bf16: {k1_ms:.4f} ms for {k1_bytes} weight bytes = "
        f"{k1_bytes / k1_ms / 1e9:.3f} TB/s of the card's 3.35; cp_frame bf16: {k2_ms:.4f} ms: "
        f"{once} weight bytes read once = {once / k2_ms / 1e9:.3f} TB/s, {streamed} streamed "
        f"over the {n_pass} passes = {streamed / k2_ms / 1e9:.3f} TB/s ({card})")


def _counting(gen_mod):
    """Wrap gen_mod.filter_valid_frames to record the frames kept."""
    kept: list[int] = []
    filt = gen_mod.filter_valid_frames

    def counting_filter(frames):
        out = filt(frames)
        kept.append(len(out))
        return out

    gen_mod.filter_valid_frames = counting_filter
    return kept, filt


def run_pipeline(card: str, d: str, label: str, configuration, need: tuple[str, ...],
                 idle: tuple[str, ...]):
    """Load, generate (96 frames) and stream on one configuration; returns
    (pipeline, launch counts of this run, metrics)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    spf = qt.TokenizerDecoderConfig().total_upsample
    kept, filt = _counting(gen_mod)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = qt.Qwen3TTSPipeline(d, configuration, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        audio = pl.generate(TEXT, speaker="aiden", max_tokens=96, seed=0)
        gen_s = time.perf_counter() - t0
        frames = kept[-1]
        ok = bool(np.isfinite(audio).all()) and len(audio) == frames * spf
        log(f"[{label}] generate: {frames} valid frames, {len(audio)} samples "
            f"(expect {frames} x {spf}), finite={bool(np.isfinite(audio).all())} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or frames == 0:
            raise SystemExit("generate() output is wrong")
        dur = len(audio) / pl.sample_rate

        kept.clear()
        t0 = time.perf_counter()
        first = None
        chunks = []
        for ch in pl.generate_stream(TEXT, speaker="aiden", max_tokens=96, seed=0):
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
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames = filt
    metrics = {"load_s": load_s, "generate_s": gen_s, "rtf": gen_s / dur,
               "stream_rtf": stream_s / (pos * spf / pl.sample_rate),
               "first_audio_s": first, "resident_bytes": pl.model_resident_bytes()}
    log(f"[{label}] load {load_s:.2f} s, generate {gen_s:.2f} s for {dur:.2f} s of audio, "
        f"RTF {metrics['rtf']:.3f}; generate_stream: {len(chunks)} chunks over {pos} frames, "
        f"first audio {first:.2f} s, RTF {metrics['stream_rtf']:.3f}; resident "
        f"{metrics['resident_bytes']} bytes ({card}, bf16)")
    check_counts(label, launches, need, idle)
    return pl, launches, metrics


def no_sync_chunk(pl, label: str) -> None:
    """A 3-frame decode chunk queues without a host sync."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    state = gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)
    kw = dict(steps=3, temperature=0.85, track_cp_penalty=True,
              generator=torch.Generator(device="cuda").manual_seed(0))
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[{label}] a 3-frame decode chunk ran with torch's sync debug mode set to error: "
        "no host sync inside the chunk")


def teacher_forced(pl, card: str, label: str = "pipeline") -> None:
    """K1 + K2 against their plain versions, teacher-forced over the frames
    generate() makes: both decode the same frames from their own states;
    the talker logits after each step are compared. The two rings drift
    apart by the W8A8 rounding steps of every earlier step, so the
    tolerance is TOL_W8A8's (measured 3.3e-2 at most over the 96 frames)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk

    pd = pl._assemble(TEXT, "aiden")
    frames = torch.from_numpy(gen_mod.generate_codes(
        pl.params, pl.cp_params, pl.config, pd, temperature=0.85, max_tokens=96, seed=0,
        chunk_steps=12, track_cp_penalty=True,
    )).long().cuda()
    sk = gen_mod.prefill(pl.params, pd, pl.config)
    sp = gen_mod.prefill(pl.params, pd, pl.config)
    errs, flips = [], 0
    kw = dict(temperature=0.0, generator=None, track_cp_penalty=True)
    t0 = time.perf_counter()
    for f in frames:
        gen_mod.decode_step(pl.params, pl.cp_params, sk, pl.config, forced_frame=f, **kw)
        talker, frame = tmk.talker_step, cpk.predict_frame
        tmk.talker_step, cpk.predict_frame = tmk.talker_step_plain, cpk.predict_frame_plain
        try:
            gen_mod.decode_step(pl.params, pl.cp_params, sp, pl.config, forced_frame=f, **kw)
        finally:
            tmk.talker_step, cpk.predict_frame = talker, frame
        errs.append(rel_rms(sk["logits"], sp["logits"]))
        flips += int(torch.argmax(sk["logits"]) != torch.argmax(sp["logits"]))
    torch.cuda.synchronize()
    worst = max(errs)
    log(f"[{label}] teacher-forced over {len(frames)} generated frames, kernels vs plain "
        f"versions (bf16 model): talker logits rel RMS max {worst:.3e} mean "
        f"{float(np.mean(errs)):.3e} (tol {TOL_W8A8['bfloat16']:g}), code-0 argmax flips "
        f"{flips}/{len(frames)}; {time.perf_counter() - t0:.1f} s ({card})")
    if not worst <= TOL_W8A8["bfloat16"]:
        raise SystemExit("the megakernel decode disagrees with its plain version")


def mixed_prefill_check(pl, card: str, dtype: str) -> None:
    """Prompt assembly and prefill with K7 against the same with K7's plain
    version swapped into the dispatch: talker logits within TOL[dtype] (the
    model's dtype)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm

    def logits():
        return gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)["logits"]

    got = logits()
    kernel = pm.packed_matmul_kernel
    pm.packed_matmul_kernel = pm.packed_matmul_plain
    try:
        ref = logits()
    finally:
        pm.packed_matmul_kernel = kernel
    torch.cuda.synchronize()
    err = rel_rms(got, ref)
    log(f"[mixed-pipeline] prefill logits, K7 vs its plain version in every packed linear "
        f"({dtype} model): rel RMS {err:.3e} (tol {TOL[dtype]:g}), argmax "
        f"{'agrees' if int(torch.argmax(got)) == int(torch.argmax(ref)) else 'differs'} "
        f"({card})")
    if not err <= TOL[dtype]:
        raise SystemExit("prefill with K7 disagrees with its plain version")


def vocoder_check(pl) -> None:
    """The kernel vocoder path against the plain torch vocoder on generated
    codes, both fp32 (kernel weights fp32 for this check)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import vocoder as voc

    codes = torch.from_numpy(np.ascontiguousarray(gen_mod.filter_valid_frames(
        gen_mod.generate_codes(pl.params, pl.cp_params, pl.config, pl._assemble(TEXT, "aiden"),
                               temperature=0.85, max_tokens=18, seed=0)).T[None])).long().cuda()
    dense = {k: v for k, v in pl.vocoder_params.items() if k != "kernel"}
    cfg = pl.speech_config.decoder_config
    ref = voc.decode_frames(dense, codes, cfg)
    k32 = dict(dense, kernel=voc.build_vocoder_kernel_params(dense, cfg, torch.float32))
    err = rel_rms(voc.decode_frames(k32, codes, cfg), ref)
    log(f"[pipeline] vocoder kernels vs plain torch vocoder on {codes.shape[2]} generated "
        f"frames (fp32): rel_rms={err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise SystemExit("kernel vocoder path disagrees with the plain vocoder")


def profile_frames(pl, label: str, card: str, steps: int = 8) -> None:
    """Wall time per frame of a decode chunk against the device time the
    profiler sees in it, and the kernels that take it."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    state = gen_mod.prefill(pl.params, pl._assemble(TEXT, "aiden"), pl.config)
    kw = dict(temperature=0.85, track_cp_penalty=True,
              generator=torch.Generator(device="cuda").manual_seed(0))
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=2, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=steps, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        gen_mod.decode_chunk(pl.params, pl.cp_params, state, pl.config, steps=steps, **kw)
        torch.cuda.synchronize()
    dev_ms = device_us(prof) / 1e3 / steps
    per_frame = len(device_kernels(prof)) / steps
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / steps / 1e3, e.count // steps, e.key[:48]))
    rows.sort(reverse=True)
    if dev_ms > 0:
        log(f"[{label}] frame loop over {steps} frames: wall {wall:.3f} ms/frame, device busy "
            f"{dev_ms:.3f} ms/frame (profiler), idle {100 * (1 - dev_ms / wall):.1f}%, "
            f"{per_frame:.1f} device kernels/frame ({card})")
    else:
        log(f"[{label}] frame loop: wall {wall:.2f} ms/frame; device time not measured "
            "(the profiler saw no device activity)")
    for ms, n, key in rows[:8]:
        log(f"[{label}]   {ms:.3f} ms/frame in {n} launches/frame: {key}")


def phase_fused_path(card: str) -> dict:
    """K4a through its entry point, pre_transformer_fused, at the 0.6B
    vocoder's width (bf16 weights, fp32 residual input as the vocoder gives
    it): a stream window, a blocking row and two blocking rows. Counts are
    set to 0 just before and read just after."""
    import torch

    from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
    from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
    from qwen3_tts_tpu_torch.testing import random_vocoder_params

    dev = torch.device("cuda")
    cfg = TokenizerDecoderConfig()
    fp = ptk.build_pretransformer_fused_params(
        random_vocoder_params(cfg, seed=1, device=dev)["pre_transformer"], cfg, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn(b, t, cfg.latent_dim, generator=gen, device=dev)
          for b, t in ((1, 26), (1, 110), (2, 110))]
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [ptk.pre_transformer_fused(fp, x, **kw) for x in xs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    ok = all(o.shape == x.shape and bool(torch.isfinite(o).all()) for o, x in zip(outs, xs))
    log(f"[fused-pretransformer] pre_transformer_fused on [1, 26], [1, 110], [2, 110] x "
        f"{cfg.latent_dim}: {wall * 1e3:.1f} ms in all, outputs finite and shaped "
        f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise SystemExit("pre_transformer_fused output is wrong")
    check_counts("fused-pretransformer", launches, need=("pre_transformer_fused",),
                 idle=tuple(k for k in KERNELS if k != "pre_transformer_fused"))
    return launches


def phase_sampler_path(card: str) -> dict:
    """K2g through its entry point, gumbel_sample, at the code predictor's
    vocabulary: a frame's draws (one per code group) from one seed, sampled
    and greedy, from fp32 and from bf16 logits; each against its plain
    version. Counts are set to 0 just before and read just after."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs

    dev = torch.device("cuda")
    cc = qt.Qwen3TTSConfig.standard().code_predictor_config
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn(v, generator=gen, device=dev) * 2.0
    seed = torch.tensor([11], device=dev)
    cases = [(lg, temp) for lg in (logits, logits.bfloat16()) for temp in (0.85, 0.0)]
    torch.cuda.synchronize()
    reset_counts()
    outs = [gs.gumbel_sample(lg, seed, temp, ng) for lg, temp in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    ok = all(o.shape == (ng,) and torch.equal(o, gs.gumbel_sample_plain(lg, seed, temp, ng))
             for o, (lg, temp) in zip(outs, cases))
    log(f"[sampler] gumbel_sample: {ng} draws over V={v}, T=0.85 and greedy, fp32 and bf16 "
        f"logits: the plain version's codes {'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise SystemExit("gumbel_sample disagrees with its plain version")
    check_counts("sampler", launches, need=("gumbel_sample",),
                 idle=tuple(k for k in KERNELS if k != "gumbel_sample"))
    return launches


LONG = ("The first sentence of this long text talks about the weather, which was calm and "
        "bright all through the quiet morning hours before anyone in the small town woke "
        "up. The second sentence moves on to the busy market, where people bought bread and "
        "fruit and talked with their neighbours for a long while in the sun. The third "
        "sentence ends the story as the sun goes down slowly over the hills and the children "
        "walk home along the river for their supper.")


def phase_modes(card: str, d: str):
    """Every generation mode on the default configuration of a 0.6B dir
    with the speaker and audio encoders; returns (launch counts over the
    whole phase, metrics)."""
    import torch

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.frontend.chunker import chunk_text
    from qwen3_tts_tpu_torch.io import safetensors_io
    from qwen3_tts_tpu_torch.io.wav import parse_wav
    from qwen3_tts_tpu_torch.models import audio_encoder as aenc
    from qwen3_tts_tpu_torch.models import speaker_encoder as spk
    from qwen3_tts_tpu_torch.pipeline import resident_bytes

    label = "modes-pipeline"
    m: dict = {}
    spf = 0  # samples per frame, from the loaded pipeline

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check_audio(name, audio, frames=None):
        ok = (audio.dtype == np.float32 and len(audio) > 0 and bool(np.isfinite(audio).all())
              and (frames is None or len(audio) == frames * spf))
        if not ok:
            raise SystemExit(f"[{label}] {name}: {len(audio)} samples, not the audio expected")

    def rtf(name, fn, frames=None):
        audio, secs = timed(fn)
        check_audio(name, audio, frames)
        m[f"{name}_rtf"] = secs / (len(audio) / 24000)
        log(f"[{label}] {name}: {secs:.2f} s for {len(audio) / 24000:.2f} s of audio, "
            f"RTF {m[f'{name}_rtf']:.3f}")
        return audio

    reset_counts()
    pl, m["load_s"] = timed(lambda: qt.Qwen3TTSPipeline(d, device="cuda"))
    spf = pl._samples_per_frame
    if not (pl.supports_voice_cloning and pl.supports_icl):
        raise SystemExit(f"[{label}] the encoders did not load")
    m["resident_bytes"] = pl.model_resident_bytes()
    enc_bytes = resident_bytes(pl.speaker_encoder.params, pl.audio_encoder.params)
    log(f"[{label}] load {m['load_s']:.2f} s; resident {m['resident_bytes']} bytes, of which "
        f"the encoders {enc_bytes} (fp32)")
    design = rtf("voice_design", lambda: pl.generate_voice_design(
        TEXT, "A warm, low narrator voice.", max_tokens=96, seed=0), 96)
    rtf("custom_voice", lambda: pl.generate_custom_voice(
        TEXT, "aiden", "Speak cheerfully.", max_tokens=96, seed=0), 96)

    t0 = time.perf_counter()
    first, n = None, 0
    for ch in pl.generate_stream_voice_design(TEXT, "A warm, low narrator voice.",
                                              max_tokens=96, seed=0):
        if first is None and len(ch.samples):
            first = time.perf_counter() - t0
        if len(ch.samples):
            check_audio("stream chunk", ch.samples, ch.token_range[1] - ch.token_range[0])
        n += len(ch.samples)
    m["stream_first_audio_s"], m["stream_rtf"] = first, (time.perf_counter() - t0) / (n / 24000)
    log(f"[{label}] streamed VoiceDesign: first audio {first:.2f} s, RTF {m['stream_rtf']:.3f}")

    ref = design[: 5 * 24000]  # a 5 s clip of generated speech
    emb, m["speaker_encoder_s"] = timed(lambda: pl.extract_speaker_embedding(ref))
    codes, m["audio_encoder_s"] = timed(lambda: pl.encode_reference_audio(ref))
    log(f"[{label}] 5 s clip: speaker embedding {emb.shape} in {m['speaker_encoder_s']:.3f} s, "
        f"reference codes {len(codes)} x {len(codes[0])} in {m['audio_encoder_s']:.3f} s")
    rtf("speaker_embedding", lambda: pl.generate(TEXT, speaker_embedding=emb, max_tokens=96,
                                                 seed=0), 96)
    rtf("icl", lambda: pl.generate_icl(TEXT, "The words of the reference clip.", codes,
                                       max_tokens=96, seed=0), 96)

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    chunks = chunk_text(LONG)
    kept, filt = _counting(gen_mod)  # valid frames of each chunk
    try:
        long_audio = rtf("generate_batch", lambda: pl.generate_batch(LONG, "aiden", seed=0))
        batch_frames = list(kept)
        kept.clear()
        with tempfile.TemporaryDirectory() as out_dir:
            path = f"{out_dir}/long.wav"
            count, secs = timed(lambda: pl.generate_to_file(LONG, path, "aiden", seed=0))
            with open(path, "rb") as f:
                samples, rate, channels = parse_wav(f.read())
        file_frames = list(kept)
    finally:
        gen_mod.filter_valid_frames = filt
    # chunks of at most 600 frames, joined by 480-sample crossfades
    want = sum(batch_frames) * spf - 480 * (sum(1 for n in batch_frames if n) - 1)
    log(f"[{label}] generate_batch: {len(chunks)} chunks of {batch_frames} frames")
    if len(chunks) != 3 or len(long_audio) != want or max(batch_frames) > 600:
        raise SystemExit(f"[{label}] generate_batch: {len(chunks)} chunks, {len(long_audio)} "
                         f"samples, expected 3 and {want}")
    if (count != sum(file_frames) * spf or len(samples) != count
            or (rate, channels) != (24000, 1)):
        raise SystemExit(f"[{label}] generate_to_file wrote {count} samples / {len(samples)}")
    m["generate_to_file_rtf"] = secs / (count / 24000)
    log(f"[{label}] generate_to_file: {count} samples in {secs:.2f} s, RTF "
        f"{m['generate_to_file_rtf']:.3f}")
    _, m["warmup_s"] = timed(pl.warmup)
    log(f"[{label}] warmup: {m['warmup_s']:.2f} s")
    launches = read_counts()
    check_counts(label, launches, need=("talker_step", "cp_frame", "int8_matmul",
                                        "pre_transformer", "upsample_stage", "residual_units"),
                 idle=("gumbel_sample", "packed_matmul", "pre_transformer_fused"))

    # the card's encoders (fp32, TF32 off) against the port's CPU run
    t0 = time.perf_counter()
    spk_cpu = spk.SpeakerEncoder.from_weights(
        {k: v for k, v in safetensors_io.load_file(f"{d}/model.safetensors").items()
         if k.startswith("speaker_encoder.")}, device="cpu")
    st = safetensors_io.load_file(f"{d}/speech_tokenizer/model.safetensors")
    enc_cpu = aenc.AudioEncoder.from_weights({k: v for k, v in st.items() if "encoder." in k},
                                             pl.speech_config, device="cpu")
    emb_err = rel_rms(torch.from_numpy(emb), torch.from_numpy(spk_cpu.extract_embedding(ref)))
    x = torch.from_numpy(ref)[None]
    with torch.no_grad():
        h_card = aenc.encode_hidden(pl.audio_encoder.params, x.cuda(), pl.audio_encoder.cfg)
        h_cpu = aenc.encode_hidden(enc_cpu.params, x, enc_cpu.cfg)
    h_err = rel_rms(h_card.cpu(), h_cpu)
    cpu_codes = enc_cpu.encode(ref)
    same = float((np.stack(codes) == cpu_codes).mean())
    log(f"[{label}] card vs CPU (fp32): speaker embedding rel_rms={emb_err:.3e}, encoder "
        f"hidden states rel_rms={h_err:.3e} (tol 1e-4 each), reference codes equal in "
        f"{100 * same:.2f}% (need 99%) ({time.perf_counter() - t0:.1f} s)")
    if not (emb_err <= 1e-4 and h_err <= 1e-4 and same >= 0.99):
        raise SystemExit("the encoders on the card disagree with their CPU run")
    m["codes_equal"] = same
    del pl
    torch.cuda.empty_cache()
    return launches, m


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

    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.testing import write_model_dir, write_prequantized_model_dir

    t_start = time.perf_counter()
    card = card_line()
    log(card)  # nvidia-smi --query-gpu=name,power.limit, as it prints them
    log(f"[device] torch.cuda: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"[build] nvcc sm_90a build of {len(_build.sources())} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s -> {_build.build_dir()}")

    rec = Record()
    results, launches = {}, {}
    vocoder = ("pre_transformer", "upsample_stage", "residual_units")
    megakernels = ("talker_step", "cp_frame")
    sampler = ("gumbel_sample",)  # its kernel: K2 draws inside its own launch
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        talker_dense, cp_dense, _ = write_model_dir(
            d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0)
        log(f"[pipeline] wrote a random-weight 0.6B model dir in "
            f"{time.perf_counter() - t0:.1f} s")
        phase_megakernels(rec, card, talker_dense, cp_dense)
        del talker_dense, cp_dense
        phase_kernels(rec)
        launches["fused_path"] = phase_fused_path(card)
        launches["sampler_path"] = phase_sampler_path(card)

        pl, launches["megakernels"], results["megakernels"] = run_pipeline(
            card, d, "pipeline", None, need=megakernels + ("int8_matmul",) + vocoder,
            idle=sampler + ("packed_matmul",))
        no_sync_chunk(pl, "pipeline")
        teacher_forced(pl, card)
        vocoder_check(pl)
        profile_frames(pl, "pipeline", card)
        del pl
        torch.cuda.empty_cache()

        off = qt.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                               use_cp_megakernel=False)
        pl, launches["k3_path"], results["k3"] = run_pipeline(
            card, d, "k3-pipeline", off, need=("int8_matmul",) + vocoder,
            idle=megakernels + sampler + ("packed_matmul",))
        no_sync_chunk(pl, "k3-pipeline")
        profile_frames(pl, "k3-pipeline", card, steps=4)
        del pl
        torch.cuda.empty_cache()

        mixed = qt.Qwen3TTSPipelineConfiguration(runtime_quantization_mode="mixed_4_6",
                                                 use_talker_megakernel=False,
                                                 use_cp_megakernel=False)
        pl, launches["mixed"], results["mixed"] = run_pipeline(
            card, d, "mixed-pipeline", mixed, need=("packed_matmul",) + vocoder,
            idle=megakernels + sampler + ("int8_matmul",))
        no_sync_chunk(pl, "mixed-pipeline")
        profile_frames(pl, "mixed-pipeline", card, steps=4)
        mixed_prefill_check(pl, card, "bfloat16")
        del pl
        torch.cuda.empty_cache()
        # the same in an fp32 model, where no output rounds to bf16
        pl = qt.Qwen3TTSPipeline(d, mixed, device="cuda", dtype=torch.float32)
        mixed_prefill_check(pl, card, "float32")
        del pl
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_prequantized_model_dir(d, qt.Qwen3TTSConfig.standard(),
                                     qt.TokenizerDecoderConfig(), widths=(4,), group_size=64)
        log(f"[prequant-pipeline] wrote a random-weight 0.6B model dir pre-quantized to 4 bits, "
            f"group 64, in {time.perf_counter() - t0:.1f} s")
        pl, launches["prequant"], results["prequant"] = run_pipeline(
            card, d, "prequant-pipeline", None,
            need=megakernels + ("packed_matmul",) + vocoder, idle=sampler + ("int8_matmul",))
        no_sync_chunk(pl, "prequant-pipeline")
        teacher_forced(pl, card, "prequant-pipeline")
        profile_frames(pl, "prequant-pipeline", card)
        del pl
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_model_dir(d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0,
                        with_encoders=True, tts_model_type="base")
        log(f"[modes-pipeline] wrote a random-weight 0.6B model dir with the speaker encoder "
            f"(SpeakerEncoderConfig()) and the audio encoder (TokenizerEncoderConfig()) in "
            f"{time.perf_counter() - t0:.1f} s")
        launches["modes"], results["modes"] = phase_modes(card, d)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; pipeline metrics "
        f"{json.dumps(results)}")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = rec.rows[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches["megakernels"][name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
               "library_ms": None}
        if name == "packed_matmul":  # its two paths
            row["launches"] = launches["prequant"][name] + launches["mixed"][name]
        if name == "pre_transformer_fused":  # its own entry point
            row["launches"] = launches["fused_path"][name]
        if name == "gumbel_sample":  # its own entry point
            row["launches"] = launches["sampler_path"][name]
        for path in ("k3_path", "mixed", "prequant", "modes"):
            row[f"launches_{path}"] = launches[path][name]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
