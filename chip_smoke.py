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
                and a frame make; K2's time at temperature 0 (no noise
                drawn) and 0.85, in turns
  kernels     - K3, K4, K4a, K5, K6, K7 and the SEANet blocks' upsample
                against their plain PyTorch versions at the 0.6B main path's
                shapes, fp32 and bf16, with times and bounds (K3 at M = 1,
                2, 64, 300, the text projection's 3 and 114, the serving
                step's 8 and 16 and the K3 configuration's batched prefill's
                512 (the last three not summed in the kernels line); K7 at 4 and
                6 bits on the mixed mode's linears, and one 2-, 3- and 8-bit
                shape, each at M = 1 and M = 300, and the 4-bit text
                projection at 3 and 114; past their M0 (the tensor-core
                tile) two calls bit-identical, one device kernel a call
                (profiler), and a dense bf16 torch.matmul of the same shape
                as a yardstick; the tile at every width and group size,
                with and without biases, at ragged shapes; M0's sweep, GEMV
                against tile at gate/up, fc1 and fc2 for M = 2..64; K4a at T = 26 and
                110, B = 1 and 2, and at T = 300, also against K4 on the
                same weights (bf16: bit for bit, the same persistent launch;
                fp32: the exact sequences), one device kernel a call with
                bf16 weights (profiler); K4, K5 and K6 with bf16 weights (the
                persistent launches and the tensor-core conv) at T = 26 and
                110 (K4, K6 also B = 2; K4, K5, K6 and the blocks' upsample
                also at B = 8, at a serve window's T = 26 and at
                generate_many's T = 110; K5 from fp32 and bf16 input), their
                TFLOP/s (K5 also its share of the bytes bound), K4's and
                K5's event against their profiler device time and one
                device kernel a call; the blocks' upsample (the 2-tap
                tensor-core conv) at blocks 0-3, at K6's shapes; and one
                bf16 torch conv1d of block 0's first 7-tap conv beside K6's
                launch of it, as a yardstick for the tile (the port never
                calls conv1d)
  fused-pretransformer - K4a's own entry point, pre_transformer_fused, on
                the 0.6B vocoder's pre-transformer (no pipeline path runs
                it, in this port or in the JAX package): launch counts, and
                its outputs equal K4's on the same weights
  sampler     - K2g's own entry point, gumbel_sample, on the code
                predictor's 2048 logits: a frame's 15 draws, sampled and
                greedy, from fp32 and bf16 logits and from a row 4 bytes
                off 16-byte alignment (no pipeline path launches
                its kernel: K2 makes the draws with its device function
                inside its own launch): launch counts
  pipeline    - the default configuration (megakernels on): a random-weight
                0.6B model dir, Qwen3TTSPipeline in bf16, generate() and
                generate_stream(); checks the audio and that K1, K2,
                K3 (text projection), K4, K5, K6 and the blocks' upsample ran
                (K2g's kernel not, its draws made inside K2); generate.
                prefill's ms (in every pipeline phase); K3 timed at the
                text projection's own shapes; a decode chunk with no
                host sync; K1/K2 against their plain versions teacher-forced
                over the generated frames; the kernel vocoder against the
                plain one, with fp32 and with bf16 kernel weights; the
                device time of a 26-frame and a 110-frame vocoder window by
                kernel; a profile of the frame loop
  serving     - batched lockstep serving on the pipeline phase's model
                (megakernel configuration's weights; the batched path drops
                the megakernels and runs the `w8r` product at M = B):
                generate_many on 8 texts of different lengths at
                temperature 0 and 0.85, generate_many_stream on the 8
                (batch_size=8) and on 6 through 4 slots (2 admitted
                mid-flight); each lockstep step one CUDA graph replay; the
                audio checked, K4, K5, K6, the blocks' upsample and K3 (text
                projection) launched, K1 and K2 not; then the step at B = 1,
                4, 8 by graph and eagerly (wall, device, capture s, graph
                pool bytes, frames/s), the graph against the eager step at
                temperature 0 (same frames and state), and B = 8 against
                B = 1 teacher-forced (TOL_BATCH, no code-0 flip outside a
                near-tie); the `w8r` product against the fp32 product it
                replaced (TF32 off) at the step's shapes, M = 8
  service     - the always-on service over HTTP on localhost, on the same
                model: server.serve(batch_size=8, warmup=True), then a burst
                of 8 streamed requests at temperature 0, 4 staggered
                arrivals into the running batch (one at 0.85), a client
                that hangs up after its first audio, a /v1/audio/speech pcm
                request and a /tts_many of 2 texts beside the busy service;
                every response well formed, /stats identities after the
                drain (one cancel, no failure, no restart), the graphs of
                the service's keys unchanged by the traffic, K3-K6 and the
                blocks' upsample launched and K1 / K2 not, each burst
                stream teacher-forced against B = 1 on its own frames;
                first PCM byte per request, serving RTF and frames/s over
                the burst, warmup seconds
  k3-pipeline - the same with the megakernels off (every linear on K3);
                then 16 lockstep steps at B = 8 from one graph (K3's
                wrapper counts the warm-up and the capture, twice a step's
                launches at M = 8 and 16; the replays' K3 kernels are
                counted by name in a profile of 5 replays: a step's
                launches each)
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
                (packed embedding gathers in the frame loop); K7 timed at
                the text projection's own shapes; K1/K2
                teacher-forced on the kernel trees built from packed weights; a
                profile of the frame loop
  modes-pipeline - a 0.6B dir with the speaker and audio encoders at full
                width, default configuration: generate_voice_design,
                generate_custom_voice, a streamed VoiceDesign run, a speaker
                embedding and reference codes of a 5 s clip it generated
                (held against the port's CPU run in fp32), generate with that
                embedding, generate_icl, generate_batch on three sentences,
                generate_to_file, warmup; RTF per mode, encoder times,
                resident bytes, and K1, K2, K3, K4, K5, K6 and the blocks'
                upsample launched,
                K2g's kernel, K4a and K7 not
The line before the last is {"kernels": [...]} (each row with its launches on
every path: "launches" on the pipeline phase, "launches_<path>" on the
others, "launches_serving" on the serving runs and "launches_service" on
the service's traffic: the wrappers' calls, eager and captured, not the
graph replays) and the last is
{"ok": true, "device": {...}}.

Times: a call whose back-to-back CUDA-event time is under 50 us is timed
again by replaying a CUDA graph of it (device time, without Python's
dispatch); each kernel line says which method it used. Bounds: the larger of
the bytes a call must move over 3.35 TB/s and its operations over the
card's peak rate for their type (989 TFLOP/s bf16, 67 TFLOP/s fp32 outside
the tensor cores, 1,979 TOP/s int8).
"""

from __future__ import annotations

import base64
import json
import re
import subprocess
import sys
import tempfile
import threading
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
# K4a against K4 on the same weights. fp32: both are exact fp32 paths, sums
# in another order only. bf16: both are the same persistent launch, K4a
# reading its per-head arrays in place: the same items, K order and
# roundings, so the outputs are equal bit for bit.
K4A_VS_K4 = {"float32": 1e-4, "bfloat16": 0.0}
# The vocoder with bf16 kernel weights against the fp32 plain vocoder: bf16
# rounding of the weights and of every product's operands (2^-9 each) over
# ~25 products in a row (8 pre-transformer layers, 2 upsample stages, 4
# blocks of 3 units) adds up like a random walk to ~1e-2; held at 5x that.
TOL_VOCODER_BF16 = 5e-2
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
    # the counterpart of plain XLA (seanet_block_fused's two products), not
    # of a Pallas kernel: K6's tensor-core conv with 2 taps
    "block_upsample": ("qwen3_tts_tpu_torch/csrc/vocoder_units.cu",
                       "qwen3_tts_tpu/ops/pallas/vocoder_kernels.py:410"),
}
PLAIN_XLA = {"block_upsample"}  # KERNELS entries that replace plain XLA code
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
            "pre_transformer_fused": (pretransformer_kernel, "fused_launches"),
            "block_upsample": (vocoder_kernels, "upsample_launches")}


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
        return graph_ms(fn, iters), "graph"
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

    # K4 with bf16 weights is one cooperative launch a call: shown by the
    # profiler first (see one_kernel_per_call)
    cfg = TokenizerDecoderConfig()
    dense = random_vocoder_params(cfg, seed=0, device=dev)
    kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, torch.bfloat16)
    mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    # K3 and K7 past their M0 run the tensor-core tile, one device kernel a
    # call with K split (fc1 at M = 114) or not (gate/up at M = 300)
    for name, k, o, m, bits in (("fc1", 2048, 2048, 114, None), ("gate_up", 1024, 6144, 300, 4)):
        x = randn(m, k).to(torch.bfloat16)
        w, s, b = qmm_weights(gen, dev, bits, k, o)
        if bits is None:
            call = lambda: qm.int8_matmul_kernel(x, w, s, b)  # noqa: E731
        else:
            call = lambda: pm.packed_matmul_kernel(x, w, s, b, bits, 64)  # noqa: E731
        for _ in range(3):  # the first calls load the kernel and size the counters
            call()
        one_kernel_per_call("int8_matmul" if bits is None else f"packed_matmul {bits}-bit",
                            f"tile, {name} M={m} K={k} O={o}", call, time_ms(call, 20)[0],
                            2 * m * k * o, expect="qt_qmm_tile_kernel")
    fp = ptk.build_pretransformer_fused_params(dense["pre_transformer"], cfg, torch.bfloat16)
    for b, t in ((1, 26), (1, 110), (2, 110)):
        x = randn(b, t, cfg.latent_dim).to(torch.bfloat16)
        attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
        one_kernel_per_call("pre_transformer", f"B={b} T={t}",
                            lambda: ptk.pre_transformer_kernel(kp, x, **kw),
                            time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 20)[0],
                            b * (2 * t * mats + attn))
        # K4a with bf16 weights: the same persistent kernel, one launch a call
        one_kernel_per_call("pre_transformer_fused", f"B={b} T={t}",
                            lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw),
                            time_ms(lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw),
                                    20)[0],
                            b * (2 * t * mats + attn), expect="qt_pt_persistent_kernel")
    # K5 with bf16 weights is one cooperative launch a stage call, from the
    # pipeline's fp32 input and from bf16 input
    stages = dense["upsample"]
    ups = {dt: [upk.build_upsample_stage_params(
        st, dt, initial_conv=dense["decoder"]["initial_conv"] if i == len(stages) - 1 else None)
        for i, st in enumerate(stages)] for dt in (torch.float32, torch.bfloat16)}
    for i, sp in enumerate(ups[torch.bfloat16]):
        for xdt in (torch.float32, torch.bfloat16):
            t = 26 * 2 ** i
            x = randn(1, t, cfg.latent_dim).to(xdt)
            one_kernel_per_call("upsample_stage", f"stage{i} T={t} x {str(xdt)[6:]}",
                                lambda: upk.upsample_stage_kernel(sp, x),
                                time_ms(lambda: upk.upsample_stage_kernel(sp, x), 20)[0],
                                upsample_ops(sp, t))
    for t in (26, 110):
        x = randn(1, t, cfg.latent_dim)
        for i, sp in enumerate(ups[torch.bfloat16]):
            x = upsample_phases(sp, x, f"stage{i} T={x.shape[1]}")

    # K3 at every linear shape of the 0.6B talker / code predictor
    # (qkv, o, gate/up, down, codec_head, text fc1, fc2, cp lm_head), and at
    # the text projection's own rows (M = 3 and 114) on fc1 and fc2; past
    # M0 the tile, whose two calls give the same bits. K3 and K7 are timed
    # by CUDA-graph replay: at 0.01-0.06 ms a call their back-to-back event
    # time reads the wrapper's host dispatch (0.03-0.17 ms)
    shapes = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024),
              (1024, 3072), (2048, 2048), (1024, 2048)]
    for k, o in shapes:
        w8, s, b = qmm_weights(gen, dev, None, k, o)
        rows = ((1, 2, 3, 8, 16, 64, 114, 300, 512) if k == 2048
                else (1, 2, 8, 16, 64, 300, 512))
        for dtype in ("float32", "bfloat16"):
            for m in rows:
                x = randn(m, k).to(getattr(torch, dtype))
                got = qm.int8_matmul_kernel(x, w8, s, b)
                ref = qm.int8_matmul_plain(x, w8, s, b)
                it = 50 if m <= 3 else 10
                nb = nbytes(x, w8, s, b, got)
                rec.compare("int8_matmul", f"M={m} K={k} O={o}", dtype, got, ref,
                            (graph_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b)), "graph"),
                            time_ms(lambda: qm.int8_matmul_plain(x, w8, s, b), it),
                            nb, {dtype: 2 * m * k * o}, timed=m not in (8, 16, 512))
                if m > qm.M0:
                    same_bits("int8_matmul", f"M={m} K={k} O={o} {dtype}", got,
                              lambda: qm.int8_matmul_kernel(x, w8, s, b))
                if dtype == "bfloat16" and m in (114, 300):
                    dense_yardstick("int8_matmul", x, o, f"M={m} K={k} O={o}")

    # K7 at the mixed 4/6-bit mode's 0.6B linears (4-bit gate/up, o, down;
    # 6-bit qkv and codec head: the main path's, timed) and one 2-, 3- and
    # 8-bit shape (text fc1, cp lm_head, down), group 64; random bit
    # patterns are valid packed values at every width
    # and the pre-quantized configuration's text projection (fc1 2048 ->
    # 2048, fc2 2048 -> 1024 at 4 bits) at its own rows, M = 3 and 114
    packed = [(4, 1024, 6144, True), (4, 2048, 1024, True), (4, 3072, 1024, True),
              (6, 1024, 4096, True), (6, 1024, 3072, True), (4, 2048, 2048, True),
              (2, 2048, 2048, False), (3, 1024, 2048, False), (8, 3072, 1024, False)]
    for bits, k, o, main in packed:
        wq, s, b = qmm_weights(gen, dev, bits, k, o)
        rows = (1, 3, 114, 300) if (bits, k) == (4, 2048) else (1, 300)
        for dtype in ("float32", "bfloat16"):
            for m in rows:
                x = randn(m, k).to(getattr(torch, dtype))
                got = pm.packed_matmul_kernel(x, wq, s, b, bits, 64)
                ref = pm.packed_matmul_plain(x, wq, s, b, bits, 64)
                it = 50 if m <= 3 else 10
                err = rel_rms(got.float(), ref.float())
                if not bool(torch.isfinite(got.float()).all()):
                    err = float("nan")
                rec.add("packed_matmul", f"{bits}-bit M={m} K={k} O={o}", dtype, err,
                        float((got.float() - ref.float()).abs().max()), TOL[dtype],
                        (graph_ms(lambda: pm.packed_matmul_kernel(x, wq, s, b, bits, 64)), "graph"),
                        time_ms(lambda: pm.packed_matmul_plain(x, wq, s, b, bits, 64), it),
                        nbytes(x, wq, s, b, got), {dtype: 2 * m * k * o}, timed=main)
                if m > pm.M0:
                    same_bits("packed_matmul", f"{bits}-bit M={m} K={k} O={o} {dtype}", got,
                              lambda: pm.packed_matmul_kernel(x, wq, s, b, bits, 64))
                if dtype == "bfloat16" and m in (114, 300) and bits == 4:
                    dense_yardstick("packed_matmul", x, o, f"{bits}-bit M={m} K={k} O={o}")
    tile_widths(rec, gen, dev)
    m0_sweep(gen, dev)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp = ptk.build_pretransformer_params(dense["pre_transformer"], cfg, dt)
        mats = weight_numel(kp, ("wi", "wqkv", "wo", "wgu", "wd", "wout"))
        for b, t in ((1, 26), (1, 110), (2, 110), (8, 26), (8, 110)):
            x = randn(b, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_kernel(kp, x, **kw)
            attn = 2 * kp["wqkv"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            ops = b * (2 * t * mats + attn)
            rec.compare("pre_transformer", f"B={b} T={t}", dtype, got,
                        ptk.pre_transformer_plain(kp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_kernel(kp, x, **kw), 20),
                        time_ms(lambda: ptk.pre_transformer_plain(kp, x, **kw), 5),
                        nbytes(x, got, *kp.values()), {dtype: ops}, timed=b == 1)

        # K4a: the same function over the per-head layout, at the shapes of
        # the vocoder's stream window and blocking rows, B = 1 (timed) and
        # 2; against its plain version and against K4 on the same weights
        # (bf16: bit for bit)
        fp = ptk.build_pretransformer_fused_params(dense["pre_transformer"], cfg, dt)
        fmats = weight_numel(fp, ("wi", "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wout"))
        for b, t in ((1, 26), (1, 110), (2, 26), (2, 110), (1, 300)):
            x = randn(b, t, cfg.latent_dim).to(dt)
            kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
            got = ptk.pre_transformer_fused_kernel(fp, x, **kw)
            k4 = ptk.pre_transformer_kernel(kp, x, **kw)
            vs_k4 = rel_rms(got.float(), k4.float())
            if dtype == "bfloat16" and not torch.equal(got, k4):
                vs_k4 = float("nan")
            attn = 2 * fp["wq"].shape[0] * cfg.num_attention_heads * cfg.head_dim * t * (t + 1)
            rec.compare("pre_transformer_fused", f"B={b} T={t}", dtype, got,
                        ptk.pre_transformer_fused_plain(fp, x, **kw),
                        time_ms(lambda: ptk.pre_transformer_fused_kernel(fp, x, **kw), 5),
                        time_ms(lambda: ptk.pre_transformer_fused_plain(fp, x, **kw), 5),
                        nbytes(x, got, *fp.values()), {dtype: b * (2 * t * fmats + attn)},
                        timed=b == 1 and t != 300)
            log(f"[kernels] pre_transformer_fused B={b} T={t} {dtype}: against K4 on the same "
                f"weights rel_rms={vs_k4:.3e} (tol {K4A_VS_K4[dtype]:g}"
                f"{', bit for bit' if dtype == 'bfloat16' else ''})")
            if not vs_k4 <= K4A_VS_K4[dtype]:
                raise SystemExit("K4a disagrees with K4 on the same weights")

        # K5 at the stream window's and the generate window's rows, B = 1
        # and the serving paths' 8; the pipeline hands it fp32 input
        # (timed), bf16 input checked beside it
        for b, t in ((1, 26), (1, 110), (8, 26), (8, 110)):
            for xdt in (dt,) if dtype == "float32" else (torch.float32, torch.bfloat16):
                x = randn(b, t, cfg.latent_dim).to(xdt)
                for i, sp in enumerate(ups[dt]):
                    got = upk.upsample_stage_kernel(sp, x)
                    ti = x.shape[1]
                    timing = time_ms(lambda: upk.upsample_stage_kernel(sp, x), 10)
                    nb = nbytes(x, got, *sp.values())
                    rec.compare("upsample_stage", f"stage{i} B={b} T={ti} x {str(xdt)[6:]}",
                                dtype, got, upk.upsample_stage_plain(sp, x), timing,
                                time_ms(lambda: upk.upsample_stage_plain(sp, x), 5),
                                nb, {dtype: b * upsample_ops(sp, ti)},
                                timed=xdt == torch.float32 and b == 1)
                    if dtype == "bfloat16" and b == 1:
                        b_ms = bound(nb, {dtype: upsample_ops(sp, ti)})[0]
                        log(f"[kernels] upsample_stage stage{i} T={ti} x {str(xdt)[6:]} bf16: "
                            f"{upsample_ops(sp, ti) / timing[0] / 1e9:.1f} TFLOP/s of the card's "
                            f"989, {100 * b_ms / timing[0]:.1f}% of the bytes bound "
                            f"({nb / timing[0] / 1e9:.3f} TB/s of 3.35)")
                    x = got

        blocks = dense["decoder"]["blocks"]
        for b, t in ((1, 26), (1, 110), (2, 26), (8, 26), (8, 110)):
            x = randn(b, 4 * t, cfg.decoder_dim, scale=0.5).to(dt)
            for i, (block, rate) in enumerate(zip(blocks, cfg.upsample_rates)):
                tail = None
                if i == len(blocks) - 1:
                    tail = {"snake": dense["decoder"]["out_snake"],
                            "conv": dense["decoder"]["out_conv"]}
                bp = vk.build_seanet_block_params(block, rate, dt, tail=tail)
                y = vk.block_upsample_kernel(bp, x, rate=rate)
                up_ops = 2 * x.shape[0] * x.shape[1] * bp["up_w"].numel()
                rec.compare("block_upsample", f"block{i} B={b} T={x.shape[1]}", dtype, y,
                            vk.block_upsample_plain(bp, x, rate=rate),
                            time_ms(lambda: vk.block_upsample_kernel(bp, x, rate=rate), 10),
                            time_ms(lambda: vk.block_upsample_plain(bp, x, rate=rate), 3),
                            nbytes(x, y, bp["up_w"], bp["up_b"], bp["snake_a"],
                                   bp["snake_binv"]), {dtype: up_ops}, timed=b == 1)
                if dtype == "bfloat16" and b == 1:
                    upsample_yardstick(bp, x, rate, f"block{i} T={x.shape[1]}")
                got = vk.residual_units_kernel(bp, y)
                rows = y.shape[0] * y.shape[1]
                ops = 2 * rows * weight_numel(bp, ("u_w1", "u_w2", "t_w"))
                units = [v for k, v in bp.items() if k.startswith(("u_", "t_"))]
                timing = time_ms(lambda: vk.residual_units_kernel(bp, y), 5)
                rec.compare("residual_units", f"block{i} B={b} S={y.shape[1]}", dtype, got,
                            vk.residual_units_plain(bp, y), timing,
                            time_ms(lambda: vk.residual_units_plain(bp, y), 3),
                            nbytes(y, got, *units), {dtype: ops}, timed=b == 1)
                if dtype == "bfloat16":
                    log(f"[kernels] residual_units block{i} B={b} S={y.shape[1]} bf16: "
                        f"{ops / timing[0] / 1e9:.1f} TFLOP/s of the card's 989")
                    if i == 0 and b == 1 and t == 26:
                        conv_yardstick(bp, y)
                x = got if got.dim() == 3 else None
    torch.cuda.synchronize()


def qmm_weights(gen, dev, bits: int | None, k: int, o: int):
    """Random K3 (bits None: uint8 [o, k]) or K7 (MLX words of `bits`)
    weights, group 64, with fp32 scales and biases; random bit patterns are
    valid packed values at every width."""
    import torch

    if bits is None:
        w = torch.randint(0, 256, (o, k), generator=gen, device=dev, dtype=torch.uint8)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * 1e-3
        return w, s, torch.randn(o, k // 64, generator=gen, device=dev) * 0.02
    w = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    s = torch.rand(o, k // 64, generator=gen, device=dev) * (2e-2 / 2 ** bits)
    return w, s, torch.randn(o, k // 64, generator=gen, device=dev) * 0.01


def same_bits(name: str, label: str, got, call) -> None:
    """A second call gives the same bits (the tile's split-K sum is
    fixed-order)."""
    import torch

    if not torch.equal(call(), got):
        raise SystemExit(f"{name} {label}: two calls differ")


def dense_yardstick(name: str, x, o: int, label: str) -> None:
    """One dense bf16 torch.matmul of the same shape, beside the kernel's
    time: a yardstick only (not the same function; no port path calls
    it)."""
    import torch

    w = torch.randn(x.shape[1], o, device=x.device).to(torch.bfloat16)
    ms = graph_ms(lambda: x @ w)
    log(f"[kernels] yardstick, {name} {label}: one dense bf16 torch.matmul {ms:.4f} ms (graph, "
        f"{2 * x.shape[0] * x.shape[1] * o / ms / 1e9:.1f} TFLOP/s)")


def tile_widths(rec: Record, gen, dev) -> None:
    """K3 and K7 past their M0 at every width the tile takes: K3, and K7
    at 2, 3, 4, 6 and 8 bits, group sizes 32, 64 and 128, with and without
    biases, at ragged shapes (M = 9 and 130 rows, O = 200 columns, K = 352
    at group 32: half a K step past the last whole one), fp32 and bf16 x,
    against their plain versions; every call is one launch and two calls
    give the same bits."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    o, worst, n = 200, {}, 0
    for m in (9, 130):
        for dtype in (torch.float32, torch.bfloat16):
            cases = []
            x = torch.randn(m, 320, generator=gen, device=dev).to(dtype)
            w8, s, b = qmm_weights(gen, dev, None, 320, o)
            cases.append(("int8_matmul", "K=320", qm,
                          lambda x=x, w8=w8, s=s, b=b: qm.int8_matmul_kernel(x, w8, s, b),
                          lambda x=x, w8=w8, s=s, b=b: qm.int8_matmul_plain(x, w8, s, b)))
            for bits in (2, 3, 4, 6, 8):
                for gs in (32, 64, 128):
                    k = 352 if gs == 32 else 384
                    wq = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen,
                                       device=dev, dtype=torch.int64).to(torch.int32)
                    s = torch.rand(o, k // gs, generator=gen, device=dev) * 1e-2
                    b = torch.randn(o, k // gs, generator=gen, device=dev) * 0.1
                    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                    for bb in (b, None):
                        args = (x, wq, s, bb, bits, gs)
                        cases.append(("packed_matmul", f"{bits}-bit gs={gs} K={k} biases="
                                      f"{bb is not None}", pm,
                                      lambda a=args: pm.packed_matmul_kernel(*a),
                                      lambda a=args: pm.packed_matmul_plain(*a)))
            for name, label, mod, kernel, plain in cases:
                label = f"{label} M={m} {str(dtype)[6:]}"
                before = mod.launches
                got = kernel()
                if mod.launches != before + 1 or m <= mod.M0:
                    raise SystemExit(f"[kernels] tile {name} {label}: not one launch of the tile")
                ref = plain()
                err = rel_rms(got.float(), ref.float())
                tol = TOL[str(dtype)[6:]]
                if not (err <= tol and bool(torch.isfinite(got.float()).all())):
                    raise SystemExit(f"[kernels] tile {name} {label}: rel RMS {err:.3e} "
                                     f"(tol {tol:g})")
                same_bits(name, label, got, kernel)
                row = rec.rows[name]
                row["max_abs_err"] = max(row["max_abs_err"],
                                         float((got.float() - ref.float()).abs().max()))
                key = (name, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), err)
                n += 1
    log(f"[kernels] the tile at every width past M0: {n} calls (K3; K7 at 2/3/4/6/8 bits, "
        f"groups 32/64/128, with and without biases; M = 9 and 130, O = 200, K = 320-384), "
        f"worst rel RMS " + ", ".join(f"{k[0]} {k[1]} {e:.3e}" for k, e in sorted(worst.items()))
        + " (tol 1e-4 fp32, 2e-2 bf16); two calls bit-identical in each")


def m0_sweep(gen, dev) -> None:
    """M0's sweep: the GEMV and the tile for M = 2..64 at gate/up (1024 ->
    6144) and the text projection's fc1 (2048 -> 2048) and fc2 (2048 ->
    1024), bf16 x, K3 and K7 at 4 bits, device time (CUDA-graph replay).
    The M0 it gives a kernel is the largest M at which the GEMV is faster
    summed over fc1 and fc2, the text projection's shapes: the only calls
    with 1 < M <= 8 on a pipeline path (decode runs M = 1, prefill M = 9);
    logged beside each wrapper's M0."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    keep = qm.M0, pm.M0
    total: dict = {}
    try:
        for name, k, o in (("gate/up", 1024, 6144), ("fc1", 2048, 2048), ("fc2", 2048, 1024)):
            w8, s, b = qmm_weights(gen, dev, None, k, o)
            wq, s4, b4 = qmm_weights(gen, dev, 4, k, o)
            for m in (2, 3, 4, 8, 16, 32, 64):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                t = {}
                for path, m0 in (("gemv", 1 << 30), ("tile", 0)):
                    qm.M0 = pm.M0 = m0
                    t["K3", path] = graph_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b))
                    t["K7", path] = graph_ms(lambda: pm.packed_matmul_kernel(x, wq, s4, b4, 4, 64))
                for key, v in t.items():
                    if name != "gate/up":
                        total[key + (m,)] = total.get(key + (m,), 0.0) + v
                log(f"[kernels] M0 sweep, {name} M={m}: K3 GEMV {t['K3', 'gemv']:.4f} ms, tile "
                    f"{t['K3', 'tile']:.4f}; K7 4-bit GEMV {t['K7', 'gemv']:.4f}, tile "
                    f"{t['K7', 'tile']:.4f} (graph)")
    finally:
        qm.M0, pm.M0 = keep
    swept = {kern: max([m for m in (2, 3, 4, 8, 16, 32, 64)
                        if total[kern, "gemv", m] < total[kern, "tile", m]], default=1)
             for kern in ("K3", "K7")}
    log(f"[kernels] M0 sweep: the GEMV is faster summed over fc1 and fc2 up to M = "
        f"{swept['K3']} (K3), {swept['K7']} (K7 4-bit); the wrappers' M0: K3 {qm.M0}, "
        f"K7 {pm.M0}")


def graph_ms(fn, iters: int = 50) -> float:
    """ms a call by replaying a CUDA graph of one call (device time)."""
    import torch

    fn()
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
    return _events_ms(lambda: [graph.replay() for _ in range(iters)]) / iters


def upsample_ops(sp: dict, t: int) -> int:
    """2 x the multiply-adds of one K5 stage call on [1, t, C]: the up
    GEMM, the depthwise taps and the 2t-row pointwise GEMMs (and the
    initial conv)."""
    c = sp["dw"].shape[1]
    return (2 * t * sp["up_w"].numel()
            + 2 * 2 * t * (weight_numel(sp, ("pw1_w", "pw2_w", "ic_w")) + 7 * c))


def upsample_phases(sp: dict, x, label: str):
    """K5's time by phase (bf16 weights, fp32 input as the pipeline's):
    the kernel's own clock at each phase boundary (upsample_stage_kernel's
    `stamps`), the median of 9 calls; returns the stage's output."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import upsample_kernel as upk

    names = upk.stage_phases("ic_w" in sp, x.dtype == torch.float32)
    stamps = torch.zeros(len(names) + 1, dtype=torch.int64, device=x.device)
    runs = []
    for _ in range(9):
        out = upk.upsample_stage_kernel(sp, x, stamps=stamps)
        torch.cuda.synchronize()
        runs.append(stamps.diff().double().cpu() / 1e3)
    us = torch.stack(runs).median(0).values.tolist()
    log(f"[kernels] upsample_stage {label} bf16 by phase (us, each up to and with its barrier; "
        f"median of 9): " + ", ".join(f"{n} {v:.1f}" for n, v in zip(names, us))
        + f"; sum {sum(us):.1f}")
    return out


def one_kernel_per_call(name: str, label: str, call, event_ms: float, ops: int,
                        expect: str | None = None) -> None:
    """A call is one device kernel: torch.profiler over 4 calls sees 4
    device kernels of one name; its profiler device time beside its
    CUDA-event time (the gap is host dispatch), and the bf16 TFLOP/s it
    reaches. A profiler window taken later in the kernels phase, after its
    K3 / K7 timings, has lost the record of one of the 4 kernels, in every
    window (the same calls profiled at the start of the phase, or in a
    process of their own, show all 4; why is not known), so the check runs
    at the start of the phase; a window with fewer records is still
    repeated, up to three windows, and more records, or another kernel's,
    fail at once."""
    import torch

    call()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                call()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        seen.append(len(kernels))
        if len(kernels) > 4 or len(set(kernels)) > 1:
            raise SystemExit(f"{name} is not one device kernel per call: {kernels}")
        if expect and not all(expect in k for k in kernels):
            raise SystemExit(f"{name} {label} did not launch {expect}: {kernels}")
        if len(kernels) == 4:
            break
    dev_ms = device_us(prof) / 1e3 / max(len(kernels), 1)
    log(f"[kernels] {name} {label} bf16: 4 calls ran {len(kernels)} device kernels "
        f"({sorted(set(kernels))}; records per window {seen}); device time {dev_ms:.4f} ms a "
        f"call (profiler) against {event_ms:.4f} ms (events); {ops / event_ms / 1e9:.1f} "
        f"TFLOP/s of the card's 989")
    if len(kernels) != 4:
        raise SystemExit(f"{name}: no profiler window saw one device kernel per call")


def conv_yardstick(bp: dict, y) -> None:
    """K6's launch of block 0's first 7-tap conv (d = 1, bf16 weights and
    operand, its SnakeBeta epilogue) beside one bf16 torch conv1d (cuDNN)
    of the same conv on the same operand: a yardstick for the tile, not
    K6's function (conv1d has no causal zeroing or SnakeBeta epilogue),
    and no port path calls conv1d."""
    import torch
    import torch.nn.functional as F

    from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

    b, s, c = y.shape
    a = vk._snake(y.float(), bp["u_a1"][0], bp["u_binv1"][0]).to(torch.bfloat16)
    flat = a.reshape(b * s, c)
    a2 = torch.empty_like(flat)

    def kernel():
        vk._conv(flat, bp["u_w1"][0], b=b, s=s, taps=7, dil=1, bias=bp["u_b1"][0], act=a2,
                 snake=(bp["u_a2"][0], bp["u_binv2"][0]))

    w = bp["u_w1"][0].reshape(7, c, c).permute(2, 1, 0).contiguous()  # [out, in, k]
    xin = F.pad(a.transpose(1, 2), (6, 0))
    ops = 2 * b * s * 7 * c * c
    k_ms, k_how = time_ms(kernel, 20)
    l_ms, l_how = time_ms(lambda: F.conv1d(xin, w), 20)
    log(f"[kernels] yardstick, block 0's first 7-tap conv at S={s}, C={c}: K6's launch "
        f"{k_ms:.4f} ms ({k_how}, {ops / k_ms / 1e9:.1f} TFLOP/s), one bf16 torch conv1d "
        f"{l_ms:.4f} ms ({l_how}, {ops / l_ms / 1e9:.1f} TFLOP/s)")


def upsample_yardstick(bp: dict, x, rate: int, label: str) -> None:
    """The block upsample's 2-tap conv beside the form it replaced: SnakeBeta
    and two bf16 torch matmuls whose bf16 products are summed (not the JAX
    package's function, which keeps the products in fp32; no port path
    calls it)."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import vocoder_kernels as vk

    b, t, cin = x.shape

    def matmuls():
        xs = vk._snake(x.float(), bp["snake_a"], bp["snake_binv"]).bfloat16()
        prev = torch.nn.functional.pad(xs, (0, 0, 1, 0))[:, :t]
        acc = (xs @ bp["up_w"][cin:]).float() + (prev @ bp["up_w"][:cin]).float()
        return (acc + bp["up_b"]).reshape(b, t * rate, -1).to(x.dtype)

    k_ms, k_how = time_ms(lambda: vk.block_upsample_kernel(bp, x, rate=rate), 20)
    m_ms, m_how = time_ms(matmuls, 20)
    log(f"[kernels] yardstick, block_upsample {label}: the 2-tap conv {k_ms:.4f} ms ({k_how}), "
        f"the SnakeBeta + two bf16 torch matmuls it replaced {m_ms:.4f} ms ({m_how})")


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

    # K2's draws: a frame at temperature 0, where the pick skips Philox and
    # both logs, against one at 0.85, in turns (bf16, penalty on)
    hidden, code0, seen = k2[("bfloat16", True)][1]
    by_temp = {0.0: [], 0.85: []}
    for _ in range(3):
        for temp in (0.0, 0.85, 0.85, 0.0):
            s2 = seen.clone()
            by_temp[temp].append(time_ms(lambda: cpk.predict_frame_kernel(
                ckp, hidden, code0, seed, temp, s2, cc), 20)[0])
    med = {temp: float(np.median(v)) for temp, v in by_temp.items()}
    log(f"[megakernels] cp_frame bf16 penalty on: {med[0.0]:.4f} ms at temperature 0, "
        f"{med[0.85]:.4f} ms at 0.85 (medians of 6 in turns; runs {by_temp}): the draws' "
        f"noise {(med[0.85] - med[0.0]) * 1e3:.2f} us a frame ({card})")

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
    prefill = prefill_ms(pl, label, card)
    metrics = {"load_s": load_s, "generate_s": gen_s, "rtf": gen_s / dur,
               "stream_rtf": stream_s / (pos * spf / pl.sample_rate),
               "first_audio_s": first, "resident_bytes": pl.model_resident_bytes(),
               "prefill_ms": prefill}
    log(f"[{label}] load {load_s:.2f} s, generate {gen_s:.2f} s for {dur:.2f} s of audio, "
        f"RTF {metrics['rtf']:.3f}; generate_stream: {len(chunks)} chunks over {pos} frames, "
        f"first audio {first:.2f} s, RTF {metrics['stream_rtf']:.3f}; resident "
        f"{metrics['resident_bytes']} bytes ({card}, bf16)")
    check_counts(label, launches, need, idle)
    return pl, launches, metrics


def text_projection(pl, card: str, label: str, kernel: str) -> None:
    """K3 (kernel "K3") or K7 ("K7") at the shapes the prompt's text
    projection hands it on this configuration (K3's only launches in the
    megakernel configuration, K7's in the pre-quantized one): each shape's
    time beside its bound and its plain version's, from the calls one
    prompt assembly makes."""
    import torch

    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    mod, attr, plain = ((qm, "int8_matmul_kernel", qm.int8_matmul_plain) if kernel == "K3"
                        else (pm, "packed_matmul_kernel", pm.packed_matmul_plain))
    calls = []
    fn = getattr(mod, attr)

    def recording(*args):
        calls.append(args)
        return fn(*args)

    setattr(mod, attr, recording)
    try:
        pl._assemble(TEXT, "aiden")
    finally:
        setattr(mod, attr, fn)
    torch.cuda.synchronize()
    seen = {}
    for args in calls:
        x, w = args[0], args[1]
        seen.setdefault((x.shape[0], x.shape[1], w.shape[0], str(x.dtype)[6:]), []).append(args)
    for (m, k, o, dt), same in seen.items():
        args = same[0]
        ms = graph_ms(lambda: fn(*args))
        ev = _events_ms(lambda: [fn(*args) for _ in range(20)]) / 20
        p_ms, p_how = time_ms(lambda: plain(*args), 10)
        nb = (nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
              + m * o * args[0].element_size())
        b_ms, b_by = bound(nb, {dt: 2 * m * k * o})
        log(f"[{label}] {kernel} in the text projection: M={m} K={k} O={o} {dt}, {len(same)} "
            f"launch(es) a prompt ({'GEMV' if m <= mod.M0 else 'tile'}): {ms:.4f} ms (graph; "
            f"{ev:.4f} by events with the host's dispatch) against a bound of {b_ms:.4f} ms "
            f"({b_by}); plain {p_ms:.4f} ms ({p_how}) ({card})")


def prefill_ms(pl, label: str, card: str) -> float:
    """generate.prefill's wall time on this configuration (after the
    prompt's assembly, each run ended by a device sync): the median of 7."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod

    pd = pl._assemble(TEXT, "aiden")
    gen_mod.prefill(pl.params, pd, pl.config)
    runs = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_mod.prefill(pl.params, pd, pl.config)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(runs))
    log(f"[{label}] generate.prefill of the {pd.input_embeds.shape[1]}-row prompt: {med:.3f} ms "
        f"(median of 7, {min(runs):.3f}-{max(runs):.3f}) ({card}, bf16)")
    return med


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
    codes: with fp32 kernel weights (the exact paths, tol 1e-3), and with
    the pipeline's bf16 kernel weights (K4 and K6 on the tensor cores; tol
    TOL_VOCODER_BF16)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import vocoder as voc

    codes = torch.from_numpy(np.ascontiguousarray(gen_mod.filter_valid_frames(
        gen_mod.generate_codes(pl.params, pl.cp_params, pl.config, pl._assemble(TEXT, "aiden"),
                               temperature=0.85, max_tokens=18, seed=0)).T[None])).long().cuda()
    dense = {k: v for k, v in pl.vocoder_params.items() if k != "kernel"}
    cfg = pl.speech_config.decoder_config
    ref = voc.decode_frames(dense, codes, cfg)
    for dt, tol in ((torch.float32, 1e-3), (torch.bfloat16, TOL_VOCODER_BF16)):
        kern = dict(dense, kernel=voc.build_vocoder_kernel_params(dense, cfg, dt))
        err = rel_rms(voc.decode_frames(kern, codes, cfg), ref)
        log(f"[pipeline] vocoder kernels ({dt} weights) vs plain torch vocoder (fp32) on "
            f"{codes.shape[2]} generated frames: rel_rms={err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise SystemExit("kernel vocoder path disagrees with the plain vocoder")


def vocoder_windows(pl, card: str) -> None:
    """Device time of one vocoder window by kernel (torch.profiler), at the
    stream's 26 rows (18 frames + 8 of context) and generate's 110 (100 +
    10), on the pipeline's kernel vocoder."""
    import torch

    from qwen3_tts_tpu_torch.models import vocoder as voc

    cfg = pl.speech_config.decoder_config
    gen = torch.Generator(device="cuda").manual_seed(5)
    for t in (26, 110):
        codes = torch.randint(0, cfg.codebook_size, (1, cfg.num_quantizers, t), generator=gen,
                              device="cuda")
        voc.decode_frames(pl.vocoder_params, codes, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voc.decode_frames(pl.vocoder_params, codes, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            voc.decode_frames(pl.vocoder_params, codes, cfg)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us / 1e3, e.count, e.key[:60]))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        log(f"[pipeline] one {t}-frame vocoder window: {total:.3f} ms of device time in "
            f"{sum(r[1] for r in rows)} device kernels, {wall:.3f} ms wall ({card})")
        for ms, n, key in rows[:10]:
            log(f"[pipeline]   {ms:.3f} ms in {n} launches: {key}")


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
    pt = random_vocoder_params(cfg, seed=1, device=dev)["pre_transformer"]
    fp = ptk.build_pretransformer_fused_params(pt, cfg, torch.bfloat16)
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
    k4 = ptk.build_pretransformer_params(pt, cfg, torch.bfloat16)
    ok = all(o.shape == x.shape and bool(torch.isfinite(o).all())
             and torch.equal(o, ptk.pre_transformer_kernel(k4, x, **kw))
             for o, x in zip(outs, xs))
    log(f"[fused-pretransformer] pre_transformer_fused on [1, 26], [1, 110], [2, 110] x "
        f"{cfg.latent_dim}: {wall * 1e3:.1f} ms in all, outputs finite, shaped and equal to "
        f"K4's on the same weights {'ok' if ok else 'FAIL'} ({card})")
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
    off = torch.randn(v + 1, generator=gen, device=dev)[1:]  # 4 bytes off: scalar loads
    cases = [(lg, temp) for lg in (logits, logits.bfloat16(), off) for temp in (0.85, 0.0)]
    torch.cuda.synchronize()
    reset_counts()
    outs = [gs.gumbel_sample(lg, seed, temp, ng) for lg, temp in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    ok = all(o.shape == (ng,) and torch.equal(o, gs.gumbel_sample_plain(lg, seed, temp, ng))
             for o, (lg, temp) in zip(outs, cases))
    log(f"[sampler] gumbel_sample: {ng} draws over V={v}, T=0.85 and greedy, fp32 and bf16 "
        f"logits and an unaligned row: the plain version's codes {'ok' if ok else 'FAIL'} "
        f"({card})")
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
                                        "pre_transformer", "upsample_stage", "residual_units",
                                        "block_upsample"),
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


SERVE_TEXTS = (
    "Good morning.",
    "The train leaves at half past nine from the second platform.",
    "Please remember to water the plants on the balcony before you go out tonight.",
    "A short one.",
    TEXT,
    "Numbers like twelve, forty and three hundred are read out in full by the voice.",
    "The museum opens its new wing to the public next week, with paintings from four "
    "centuries and a garden of sculptures behind the old library.",
    "Thank you for calling, we will be with you shortly.",
)
# B = 8 against B = 1, teacher-forced: both read the same bf16 weights, but
# the `w8r` product's fp32 sums run in another order at M = 8 (and 512 in
# prefill) than at M = 1 (and 64), and each layer's output is rounded to
# bf16 before the next reads it: a sum that lands on the other side of a
# rounding boundary moves that element by 2^-9, and the random-weight
# layers carry it on, as the W8A8 steps of TOL_W8A8's note do (1.6e-2 on
# the logits there). Held at TOL["bfloat16"]; in fp32 on the CPU the two
# widths agree to ~2e-7
TOL_BATCH = TOL["bfloat16"]


def _serving_state(pl, texts, statics):
    """A prefilled B = len(texts) serving state of `texts` (built-in speaker),
    the trailing text padded to its bucket."""
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv

    pds = [pl._assemble(t, "aiden") for t in texts]
    t_bucket = gen_mod.pick_bucket(max(pd.trailing_hidden.shape[1] for pd in pds),
                                   gen_mod.TRAILING_BUCKETS)
    e, tr, lengths, totals = srv._pad_prompts(pds, statics.capacity - gen_mod.RING_SLACK,
                                              t_bucket)
    return srv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                               srv._device_ints(range(len(texts)), e.device), statics)


def _statics(pl, chunk: int):
    from qwen3_tts_tpu_torch.models import generate as gen_mod

    # prompt bucket 64: the built-in speaker's 9-row prompts
    return gen_mod.GenStatics(config=pl.config, capacity=64 + gen_mod.RING_SLACK,
                              chunk_steps=chunk, track_cp_penalty=False)


def _state_diff(a: dict, b: dict) -> tuple[float, bool]:
    """(largest rel RMS over the float arrays, every integer / bool array equal)."""
    import torch

    worst, same = 0.0, True
    for k, v in a.items():
        if isinstance(v, dict):
            w, s = _state_diff(v, b[k])
            worst, same = max(worst, w), same and s
        elif v.is_floating_point():
            worst = max(worst, rel_rms(v.float(), b[k].float()))
        else:
            same = same and bool(torch.equal(v, b[k]))
    return worst, same


def step_times(pl, card: str, label: str, widths=(1, 4, 8)) -> dict:
    """The lockstep step at each batch width: graph capture s and pool
    bytes; wall ms a step by graph replay (20 replays ended by a sync) and
    by the eager step (3 steps); device ms a step of each (profiler);
    device kernels a step."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    out = {}
    statics = _statics(pl, 1)
    p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
    for b in widths:
        state = _serving_state(pl, SERVE_TEXTS[:b], statics)
        eager = srv._clone(state)
        g_state = srv.bind(pl.params, pl.cp_params, state, statics, True)
        g = g_state.graph
        g.set_temps(np.full(b, 0.85, np.float32))
        temps = torch.full((b,), 0.85, device=state["logits"].device)

        def wall(fn, n):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        def device(fn, n, top=0):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                us = (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0))
                if us > 0:
                    rows.append((us / n / 1e3, e.count // n, e.key[:60]))
            for ms, k, key in sorted(rows, reverse=True)[:top]:
                log(f"[{label}]   B={b} graph step: {ms:.3f} ms in {k} launches: {key}")
            return device_us(prof) / 1e3 / n, len(device_kernels(prof)) / n

        def eager_step():
            srv.lockstep_step(p, cp, eager, temps, statics, True)

        check_pool(g, label)
        r = {"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
             "graph_ms": wall(g.replay, 20), "eager_ms": wall(eager_step, 3),
             "graph_events_ms": _events_ms(lambda: [g.replay() for _ in range(20)]) / 20}
        r["graph_device_ms"], r["kernels"] = device(g.replay, 5, top=8 if b == 8 else 0)
        r["eager_device_ms"], r["eager_kernels"] = device(eager_step, 2)
        r["frames_per_s"] = b / r["graph_ms"] * 1e3

        def dev_ms(v):
            return f"{v:.3f} ms" if v > 0 else "not measured (the profiler saw no device time)"

        log(f"[{label}] lockstep step B={b} (T=0.85): graph {r['graph_ms']:.3f} ms wall, "
            f"{r['graph_events_ms']:.3f} ms by events over 20 replays, device "
            f"{dev_ms(r['graph_device_ms'])} in {r['kernels']:.0f} device kernels; eager "
            f"{r['eager_ms']:.3f} ms wall, device {dev_ms(r['eager_device_ms'])} in "
            f"{r['eager_kernels']:.0f} device kernels; capture {r['capture_s']:.3f} s, graph "
            f"pool {r['pool_bytes']} bytes; {r['frames_per_s']:.1f} frames/s ({card}, bf16)")
        out[b] = r
        del g_state, state, eager
        torch.cuda.empty_cache()
    return out


def graph_vs_eager(pl, card: str, steps: int = 8):
    """B = 8 at temperature 0: a chunk of graph replays against the same
    steps run eagerly from a copy of the state: the same frames, the same
    integer state, float state within TOL["bfloat16"]. Returns the frames."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    statics = _statics(pl, steps)
    state = _serving_state(pl, SERVE_TEXTS, statics)
    eager = srv._clone(state)
    frames, _, _, state = srv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0, statics)
    p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
    temps = torch.zeros(len(SERVE_TEXTS), device=eager["logits"].device)
    ref = []
    for _ in range(steps):
        srv.lockstep_step(p, cp, eager, temps, statics, False)
        ref.append(eager["frame"].clone())
    ref = torch.stack(ref, dim=1)
    worst, same = _state_diff(state, eager)
    codes_equal = bool(torch.equal(frames, ref))
    bitwise = worst == 0.0 and same
    log(f"[serving] graph vs eager, B=8, {steps} steps at temperature 0: frames "
        f"{'equal' if codes_equal else 'DIFFER'}; state: integer arrays "
        f"{'equal' if same else 'DIFFER'}, float arrays rel RMS max {worst:.3e} "
        f"(tol {TOL['bfloat16']:g}; {'bit for bit' if bitwise else 'not bit for bit'}) ({card})")
    if not (codes_equal and same and worst <= TOL["bfloat16"]):
        raise SystemExit("the lockstep step's CUDA graph disagrees with the eager step")
    return frames


def batch_vs_single(pl, card: str, frames) -> None:
    """B = 8 against B = 1, teacher-forced over the graph run's frames: the
    talker logits after each step of streams 0 and 6 (the shortest and the
    longest text) at B = 1 against the same stream's at B = 8."""
    valid = (frames[..., 0] >= 0).all(0)  # steps every stream emitted
    steps = int(valid.long().cumprod(0).sum())
    if steps < 4:
        raise SystemExit(f"[serving] only {steps} steps where every stream emitted")
    statics = _statics(pl, steps)
    wide = _serving_state(pl, SERVE_TEXTS, statics)
    singles = {j: _serving_state(pl, SERVE_TEXTS[j:j + 1], statics) for j in (0, 6)}
    held_against_single(pl, card, "serving", statics, wide, singles, frames[:, :steps])


def _greedy_scores(state: dict, statics):
    """The scores a greedy lockstep step takes its code 0 from (as
    serving.lockstep_step: the eos / pad mask while text remains, the
    repetition penalty on seen codes, the validity mask), [B, V] fp32."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.sampling import NEG_INF

    eos_pad_mask, valid_mask = gen_mod.step_masks(statics.config, state["logits"].device)
    has_text = state["trailing_idx"] < state["total_texts"]
    lg = (state["logits"] + torch.where(has_text[:, None], eos_pad_mask, 0.0)).float()
    lg = lg / torch.where(state["seen_code0"], statics.repetition_penalty, 1.0)
    # masked codes (NEG_INF added) as -inf, so they set no near-tie's scale
    return torch.where(valid_mask & (lg > float(NEG_INF) / 2), lg, float("-inf"))


def _near_tie(scores, a: int, w: int) -> bool:
    """Scores a and w within NEAR_TIE of the largest finite score."""
    import torch

    top = float(scores[torch.isfinite(scores)].abs().max())
    gap = float((scores[a] - scores[w]).abs())
    return bool(torch.isfinite(scores[w])) and gap <= NEAR_TIE * top


def held_against_single(pl, card: str, label: str, statics, wide, singles: dict, frames,
                        emitted: bool = False) -> None:
    """Steps the B = len(frames) state `wide` and the B = 1 states
    `singles` (row -> state) eagerly, teacher-forced with frames [B, steps,
    16], and holds each single's talker logits after every step against its
    row of the wide ones: rel RMS <= TOL_BATCH, and a code-0 argmax that
    differs only at a near-tie (the two scores within NEAR_TIE of the
    largest score). `emitted` (greedy streams' own frames): also each
    frame's code 0 against the greedy pick of its single's state before
    that step, off only at a near-tie, so a frame the run computed or
    routed wrongly fails."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv

    p, cp = srv._drop_kernel(pl.params), srv._drop_kernel(pl.cp_params)
    b, steps = frames.shape[:2]
    dev = wide["logits"].device
    errs, flips, ties = [], 0, 0
    picks, misses, miss_ties = 0, [], 0
    for i in range(steps):
        if emitted:
            for j, one in singles.items():
                sc = _greedy_scores(one, statics)[0]
                a, got = int(torch.argmax(sc)), int(frames[j, i, 0])
                picks += 1
                if a != got:
                    if _near_tie(sc, a, got):
                        miss_ties += 1
                    else:
                        misses.append((j, i, got, a))
        srv.lockstep_step(p, cp, wide, torch.zeros(b, device=dev), statics, False,
                          forced=frames[:, i])
        for j, one in singles.items():
            srv.lockstep_step(p, cp, one, torch.zeros(1, device=dev), statics, False,
                              forced=frames[j:j + 1, i])
            lg = one["logits"][0]
            errs.append(rel_rms(lg, wide["logits"][j]))
            a, w = int(torch.argmax(lg)), int(torch.argmax(wide["logits"][j]))
            if a != w:
                if _near_tie(lg, a, w):
                    ties += 1
                else:
                    flips += 1
    worst = max(errs)
    log(f"[{label}] B={b} vs B=1 teacher-forced over {steps} steps, streams "
        f"{sorted(singles)}: talker logits rel RMS max {worst:.3e} mean "
        f"{float(np.mean(errs)):.3e} (tol {TOL_BATCH:g}), code-0 argmax flips {flips} "
        f"(+{ties} at near-ties) of {len(errs)} ({card}, bf16)")
    if emitted:
        log(f"[{label}] emitted code 0 against the B=1 greedy pick before its step: "
            f"{len(misses)} off (+{miss_ties} at near-ties) of {picks}"
            + (f"; first (row, step, emitted, pick): {misses[:4]}" if misses else ""))
    if not worst <= TOL_BATCH or flips:
        raise SystemExit(f"[{label}] the B = {b} lockstep step disagrees with B = 1")
    if misses:
        raise SystemExit(f"[{label}] the emitted frames disagree with the B = 1 greedy picks")


def phase_serving(pl, card: str):
    """Batched serving on the megakernel configuration's weights (the
    megakernels idle: the batched path runs the `w8r` product at M = B):
    generate_many on 8 texts at temperature 0 and 0.85, generate_many_stream
    on the 8 (batch_size=8) and on 6 through 4 slots (2 admitted
    mid-flight), each output checked; then, outside the counted run, the
    step's times at B = 1, 4, 8, graph against eager, B = 8 against B = 1.
    Returns (launch counts of the counted run, metrics)."""
    import torch

    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv

    label, spf, m = "serving", pl._samples_per_frame, {}
    kept, filt = _counting(gen_mod)
    admit, admits = srv.admit_stream, []

    def counting_admit(*args, **kwargs):
        admits.append(args[1])
        return admit(*args, **kwargs)

    srv.admit_stream = counting_admit
    try:
        torch.cuda.synchronize()
        reset_counts()
        graphs_before = sum(len(v) for v in srv.graphs(pl.params).values())
        for temp in (0.0, 0.85):
            kept.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = pl.generate_many(list(SERVE_TEXTS), "aiden", temperature=temp,
                                    max_tokens=96, seed=0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ok = (len(kept) == 8 and all(n > 0 for n in kept)
                  and all(len(o) == n * spf and np.isfinite(o).all()
                          for o, n in zip(outs, kept)))
            audio_s = sum(len(o) for o in outs) / pl.sample_rate
            m[f"generate_many_rtf_t{temp}"] = secs / audio_s
            log(f"[{label}] generate_many, 8 texts, T={temp}: {kept} valid frames, {secs:.3f} s "
                f"for {audio_s:.2f} s of audio, serving RTF {secs / audio_s:.4f}, "
                f"{sum(kept) / secs:.1f} frames/s with the vocoder {'ok' if ok else 'FAIL'} "
                f"({card}, bf16)")
            if not ok:
                raise SystemExit(f"generate_many output is wrong at T={temp}")
        for texts, width in ((SERVE_TEXTS, 8), (SERVE_TEXTS[:6], 4)):
            admits.clear()
            first, got = {}, {i: [] for i in range(len(texts))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, ch in pl.generate_many_stream(list(texts), "aiden", temperature=0.85,
                                                 max_tokens=96, batch_size=width, seed=0):
                if len(ch.samples) and i not in first:
                    first[i] = time.perf_counter() - t0
                got[i].append(ch)
            secs = time.perf_counter() - t0
            audio_s = 0.0
            for i, cs in got.items():
                pos = 0
                for c in cs:
                    if (c.token_range[0] != pos or not np.isfinite(c.samples).all()
                            or len(c.samples) != (c.token_range[1] - pos) * spf):
                        raise SystemExit(f"[{label}] stream chunk {c.token_range} of text {i} "
                                         "does not tile its frames")
                    pos = c.token_range[1]
                    audio_s += len(c.samples) / pl.sample_rate
                if sum(c.is_final for c in cs) != 1 or not cs[-1].is_final or pos == 0:
                    raise SystemExit(f"[{label}] text {i}: not one final chunk, or no audio")
            m[f"stream_rtf_b{width}"] = secs / audio_s
            m[f"stream_first_audio_b{width}"] = [first[i] for i in sorted(first)]
            log(f"[{label}] generate_many_stream, {len(texts)} texts, batch_size={width}: "
                f"{len(admits)} admitted mid-flight, {secs:.3f} s for {audio_s:.2f} s of audio, "
                f"serving RTF {secs / audio_s:.4f}; first audio per text (s): "
                + ", ".join(f"{first[i]:.3f}" for i in sorted(first)) + f" ({card}, bf16)")
            if width == 4 and len(admits) < 2:
                raise SystemExit(f"[{label}] {len(admits)} admissions; expected at least 2")
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames = filt
        srv.admit_stream = admit
    check_counts(label, launches, need=("int8_matmul",) + ("pre_transformer", "upsample_stage",
                                                          "residual_units", "block_upsample"),
                 idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul",
                       "pre_transformer_fused"))
    pool = srv.graphs(pl.params)
    for key, gs in pool.items():
        for g in gs:
            check_pool(g, label)
            log(f"[{label}] graph B={key[0]} capacity={key[1]} trailing={key[2]} "
                f"chunk_steps={key[4].chunk_steps} sampled={key[5]}: captured in "
                f"{g.capture_s:.3f} s, pool {g.pool_bytes} bytes")
    log(f"[{label}] graphs captured in the counted run: "
        f"{sum(len(v) for v in pool.values()) - graphs_before}")
    m["w8r_product"] = w8r_product(pl, card)
    m["steps"] = step_times(pl, card, label)
    frames = graph_vs_eager(pl, card)
    batch_vs_single(pl, card, frames)
    return launches, m


# The `w8r` product against the fp32 product it replaced, and with TF32
# allowed against not: exact operands, so only fp32 sum order separates
# them (1.4-2.5e-7 on the card); a product that dropped x's third bf16 part
# would be off by ~2^-17 (8e-6), one rounded to TF32 by ~1e-3
TOL_W8R = 1e-6


def w8r_product(pl, card: str) -> dict:
    """The `w8r` product (fp32 GEMMs of bf16-valued parts; no precision
    flag read or written) against the product it replaced (the fp32 GEMM
    of x, TF32 off as main() sets it) at a lockstep step's shapes, M = 8:
    talker layer 0's linears, the codec head and the code predictor's
    layer 0 on bf16 x (one part, the same GEMM: bit for bit), and its
    group-0 lm head on fp32 x (three parts). Then, on every shape, fp32 x
    that is not bf16-valued (three parts), against the old product and
    with TF32 allowed against without, compared before any bf16 rounding.
    Prints each shape's rel RMS and both times (CUDA events); fails past
    TOL_W8R. Returns the worst rel RMS of each comparison and the summed
    times."""
    import torch

    from qwen3_tts_tpu_torch.models import talker as talker_mod
    from qwen3_tts_tpu_torch.ops import linear as lin

    def old(entry, x):
        q = entry["w8r"]
        y = torch.matmul(x.float(), q.float().transpose(-1, -2))
        return (y * entry["s"][0].float() + entry["m"][0].float()
                * x.float().sum(-1, keepdim=True)).to(x.dtype)

    cases = [(f"talker {k}", e, torch.bfloat16)
             for k, e in talker_mod._layer(pl.params["layers"], 0).items() if "w8r" in e]
    cases.append(("codec head", pl.params["codec_head"], torch.bfloat16))
    cases += [(f"cp {k}", e, torch.bfloat16)
              for k, e in talker_mod._layer(pl.cp_params["layers"], 0).items() if "w8r" in e]
    cases.append(("cp lm_head[0]", {k: v[0] for k, v in pl.cp_params["lm_head"].items()},
                  torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"vs_old": 0.0, "fp32_vs_old": 0.0, "tf32_on": 0.0, "ms": 0.0, "old_ms": 0.0}
    for name, entry, dt in cases:
        k = entry["w8r"].shape[1]
        x = torch.randn(8, 1, k, device="cuda", generator=gen).to(dt)
        err = rel_rms(lin._w8r_linear(entry, x).float(), old(entry, x).float())
        xf = torch.randn(8, 1, k, device="cuda", generator=gen)
        exact = lin._w8r_linear(entry, xf)
        err32 = rel_rms(exact, old(entry, xf))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = rel_rms(lin._w8r_linear(entry, xf), exact)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        (ms, how), (oms, ohow) = (time_ms(lambda: lin._w8r_linear(entry, x), 50),
                                  time_ms(lambda: old(entry, x), 50))
        for key, v in (("vs_old", err), ("fp32_vs_old", err32), ("tf32_on", tf32)):
            out[key] = max(out[key], v)
        out["ms"] += ms
        out["old_ms"] += oms
        log(f"[serving] w8r product {name} {tuple(entry['w8r'].shape)} x {dt}: rel RMS "
            f"against the fp32 (TF32 off) product {err:.3e}; fp32 x (not bf16-valued): "
            f"against it {err32:.3e}, TF32 allowed against not {tf32:.3e}; {ms:.4f} ms "
            f"({how}) against {oms:.4f} ms ({ohow}) ({card})")
    log(f"[serving] w8r product: worst rel RMS against the old product {out['vs_old']:.3e} "
        f"(fp32 x not bf16-valued: {out['fp32_vs_old']:.3e}), TF32 allowed against not "
        f"{out['tf32_on']:.3e} (tol {TOL_W8R:g}); summed {out['ms']:.4f} ms against "
        f"{out['old_ms']:.4f} ms at M = 8 ({card})")
    if not max(out["vs_old"], out["fp32_vs_old"], out["tf32_on"]) <= TOL_W8R:
        raise SystemExit("the w8r product disagrees with the fp32 product")
    return out


# The service phase: a burst of 8 requests of BURST_TOKENS frames each (the
# serving cell's 96) into the idle batch; then, while two long requests
# keep the batch running, 4 staggered arrivals (one sampled), a client that
# hangs up after its first audio, an OpenAI-style pcm request and a
# /tts_many of 2 texts. Each text's
# trailing tokens fit the service's default trailing bucket (64) with the
# test model dir's character-level tokenizer
SERVICE_TEXTS = (
    "Good morning.",
    "The train leaves at half past nine.",
    "Please water the plants tonight.",
    "A short one.",
    "The quick brown fox jumps over the dog.",
    "Numbers like twelve are read in full.",
    "The museum opens its new wing next week.",
    "Thank you, we will be with you shortly.",
)
BURST_TOKENS = 96
LATE_TEXTS = ("A late arrival takes a freed slot.", "A sampled request joins later.",
              "The third late arrival.", "Last of the late arrivals.")


def _http_client(port: int, path: str, body: dict, out: dict, hang_up: bool = False) -> None:
    """POST `body`; records status, headers, the whole body, and the time
    to the first PCM byte (after a WAV header of a streamed wav). hang_up:
    close the socket right after the first PCM byte."""
    import http.client
    import socket

    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out.update(status=r.status, headers={k.lower(): v for k, v in r.getheaders()})
        streamed = out["headers"].get("transfer-encoding") == "chunked"
        head = r.read(44) if streamed and out["headers"].get("content-type") == "audio/wav" else b""
        first = r.read(1)
        out["first_s"] = time.perf_counter() - t0
        if hang_up:
            conn.sock.shutdown(socket.SHUT_RDWR)
            conn.close()
            out["body"] = head + first
            return
        out["body"] = head + first + r.read()
        out["end"] = time.perf_counter()
        conn.close()
    except Exception as e:  # checked by the caller
        out["error"] = f"{type(e).__name__}: {e}"


def _pcm_ok(data: bytes, spf: int) -> tuple[bool, int]:
    """(whole frames of finite, non-silent 16-bit PCM, sample count)."""
    pcm = np.frombuffer(data, np.int16) if len(data) % 2 == 0 else np.zeros(0, np.int16)
    return bool(len(pcm) and len(pcm) % spf == 0 and np.abs(pcm).max() > 0), len(pcm)


def phase_service(pl, card: str):
    """The always-on service over HTTP on localhost (server.serve at B = 8,
    warmup=True): a burst of 8 streamed requests at temperature 0 into the
    idle batch; then, while two long requests keep the batch running, 4
    staggered arrivals (one at 0.85), a client that hangs up after its
    first audio, an OpenAI-style pcm request and a /tts_many of 2 texts
    beside the busy service. Checks every
    response, the /stats identities after the drain, that the traffic
    captured no graph of the service's keys, the launch counts, and each
    greedy burst stream teacher-forced against B = 1 on its own frames (a
    smoke tool records them: a wrapped filter_valid_frames hands the
    service worker's raw frames to a recording _RowPacker). Returns (launch
    counts of the traffic, metrics)."""
    import http.client

    import torch

    from qwen3_tts_tpu_torch import server
    from qwen3_tts_tpu_torch.io.wav import streaming_wav_header
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.models import serving as srv

    label, spf, m = "service", pl._samples_per_frame, {}
    raw, last = {}, {}
    filt, packer_cls = gen_mod.filter_valid_frames, srv._RowPacker

    def recording_filter(frames):
        last[threading.get_ident()] = frames
        return filt(frames)

    class RecordingPacker(packer_cls):
        def feed(self, key, valid, done):
            raw.setdefault(key, []).append(last.pop(threading.get_ident()))
            return super().feed(key, valid, done)

    gen_mod.filter_valid_frames, srv._RowPacker = recording_filter, RecordingPacker
    httpd = None
    try:
        pool = srv.graphs(pl.params)
        keys_before = set(pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        httpd = server.serve(pl, port=0, batch_size=8, warmup=True)
        warm_s = time.perf_counter() - t0
        svc, port = httpd.tts_service, httpd.server_address[1]
        ours = {k: [(id(g), g.capture_s) for g in gs] for k, gs in pool.items()
                if k[4] == svc.statics}
        log(f"[{label}] serve(batch_size=8, warmup=True): {warm_s:.2f} s; graphs of the "
            f"service's keys: " + ", ".join(f"B={k[0]} capacity={k[1]} trailing={k[2]} "
                                            f"sampled={k[5]} captured in {gs[0][1]:.3f} s"
                                            for k, gs in ours.items())
            + f"; {len(set(pool) - keys_before)} keys new in the warmup ({card})")
        if sorted(k[5] for k in ours) != [False, True] or any(len(v) != 1 for v in ours.values()):
            raise SystemExit(f"[{label}] warmup left graphs {ours}; expected one greedy and "
                             "one sampled")
        keys_warm = set(pool)
        torch.cuda.synchronize()
        reset_counts()
        outs = {}

        def go(name, path, body, **kw):
            outs[name] = {}
            th = threading.Thread(target=_http_client, args=(port, path, body, outs[name]),
                                  kwargs=kw)
            th.start()
            return th

        # the burst alone, into the idle batch
        t_burst = time.perf_counter()
        threads = [go(f"burst{i}", "/tts?stream=1", {
            "text": SERVICE_TEXTS[i], "speaker": "aiden", "temperature": 0.0,
            "max_tokens": BURST_TOKENS, "seed": 100 + i}) for i in range(8)]
        for th in threads:
            th.join(timeout=600)
        # two long requests keep the batch running; once they decode, the
        # staggered arrivals, a hang-up, /v1 and /tts_many
        threads = [go(f"carrier{i}", "/tts?stream=1", {
            "text": SERVICE_TEXTS[4 + i], "speaker": "aiden", "temperature": 0.0,
            "max_tokens": 120, "seed": 400 + i}) for i in range(2)]
        t_carrier = time.perf_counter()
        while (not all("first_s" in outs[f"carrier{i}"] or "error" in outs[f"carrier{i}"]
                       for i in range(2)) and time.perf_counter() - t_carrier < 120):
            time.sleep(0.005)
        for i, text in enumerate(LATE_TEXTS):
            threads.append(go(f"late{i}", "/tts?stream=1", {
                "text": text, "speaker": "aiden", "temperature": 0.85 if i == 1 else 0.0,
                "max_tokens": 48, "seed": 200 + i}))
            if i == 0:
                threads.append(go("hangup", "/tts?stream=1", {
                    "text": SERVICE_TEXTS[6], "speaker": "aiden", "temperature": 0.0,
                    "max_tokens": 240, "seed": 300}, hang_up=True))
                threads.append(go("speech_pcm", "/v1/audio/speech", {
                    "input": SERVICE_TEXTS[2], "voice": "aiden", "response_format": "pcm",
                    "temperature": 0.0, "max_tokens": 36, "seed": 301}))
                threads.append(go("tts_many", "/tts_many", {
                    "texts": [SERVICE_TEXTS[1], SERVICE_TEXTS[3]], "speaker": "aiden",
                    "temperature": 0.0, "max_tokens": 36, "batch_size": 2, "seed": 302}))
            time.sleep(0.3)
        for th in threads:
            th.join(timeout=600)
        deadline = time.perf_counter() + 120
        while True:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/stats")
            stats = json.loads(conn.getresponse().read())
            conn.close()
            done = stats["requests_completed"] + stats["requests_failed"] + stats[
                "requests_cancelled"]
            if done == stats["requests_submitted"] or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        gen_mod.filter_valid_frames, srv._RowPacker = filt, packer_cls
        if httpd is not None:
            httpd.shutdown()
    log(f"[{label}] /stats after the drain: {json.dumps(stats)}")
    bad = [n for n, o in outs.items() if "error" in o or o.get("status") != 200]
    if bad:
        raise SystemExit(f"[{label}] requests failed: {[(n, outs[n]) for n in bad]}")
    # well-formed responses
    header = streaming_wav_header(pl.sample_rate)
    burst_audio_s, burst_frames, firsts = 0.0, 0, []
    for name, o in outs.items():
        h = o["headers"]
        if name == "tts_many":
            wavs = json.loads(o["body"])["wavs"]
            pcm = [base64.b64decode(w)[44:] for w in wavs]
            ok = len(wavs) == 2 and all(_pcm_ok(x, spf)[0] for x in pcm)
        elif name == "speech_pcm":
            ok = h.get("content-type") == "audio/pcm" and _pcm_ok(o["body"], spf)[0]
        elif name == "hangup":
            ok = o["body"][:44] == header and len(o["body"]) == 45
        else:
            ok = (h.get("transfer-encoding") == "chunked" and o["body"][:44] == header
                  and _pcm_ok(o["body"][44:], spf)[0])
            if name.startswith("burst"):
                n = _pcm_ok(o["body"][44:], spf)[1]
                burst_audio_s += n / pl.sample_rate
                burst_frames += n // spf
                firsts.append(o["first_s"])
        if not ok:
            raise SystemExit(f"[{label}] {name}: malformed response {h} "
                             f"({len(o.get('body', b''))} bytes)")
    m["warmup_s"] = warm_s
    m["burst_first_audio_s"] = firsts
    m["late_first_audio_s"] = [outs[f"late{i}"]["first_s"] for i in range(4)]
    burst_s = max(outs[f"burst{i}"]["end"] for i in range(8)) - t_burst
    m["burst_rtf"] = burst_s / burst_audio_s
    m["burst_frames_per_s"] = burst_frames / burst_s
    log(f"[{label}] burst of 8 streamed requests into the idle batch (T=0, max_tokens "
        f"{BURST_TOKENS}): "
        f"{burst_s:.3f} s for {burst_audio_s:.2f} s of audio, serving RTF "
        f"{m['burst_rtf']:.4f}, {m['burst_frames_per_s']:.1f} frames/s; first PCM byte "
        f"over HTTP per request (s): " + ", ".join(f"{x:.3f}" for x in firsts)
        + f" ({card}, bf16)")
    log(f"[{label}] staggered arrivals into the running batch (two requests of 120 frames "
        f"decoding): first PCM byte (s): "
        + ", ".join(f"{x:.3f}" for x in m["late_first_audio_s"])
        + f"; hang-up after {outs['hangup']['first_s']:.3f} s ({card}, bf16)")
    # the drain and its identities
    ident = stats["requests_submitted"] == (stats["requests_completed"]
                                            + stats["requests_failed"]
                                            + stats["requests_cancelled"])
    if (not ident or stats["worker_restarts"] or stats["requests_failed"]
            or stats["requests_cancelled"] != 1):
        raise SystemExit(f"[{label}] /stats after the drain breaks its identities: {stats}")
    # no capture of the service's keys after warmup; /tts_many's own keys
    after = {k: [(id(g), g.capture_s) for g in gs] for k, gs in pool.items()
             if k[4] == svc.statics}
    new = {k: len(pool[k]) for k in set(pool) - keys_warm}
    log(f"[{label}] graphs of the service's keys after the traffic: "
        f"{'unchanged' if after == ours else 'CHANGED'}; keys captured by /tts_many beside "
        f"it: {[(k[0], k[1], k[2], k[5], n) for k, n in new.items()]}")
    if after != ours or any(k[4] == svc.statics or n != 1 for k, n in new.items()):
        raise SystemExit(f"[{label}] the traffic captured a lockstep graph of the service")
    check_counts(label, launches, need=("int8_matmul", "pre_transformer", "upsample_stage",
                                        "residual_units", "block_upsample"),
                 idle=("talker_step", "cp_frame", "gumbel_sample", "packed_matmul",
                       "pre_transformer_fused"))
    # each greedy burst stream, teacher-forced against B = 1
    burst = sorted((r for r in raw if 100 <= getattr(r, "seed", -1) < 108), key=lambda r: r.seed)
    if len(burst) != 8:
        raise SystemExit(f"[{label}] recorded {len(burst)} burst streams of 8")
    streams = [np.concatenate(raw[r]) for r in burst]
    steps = min(8, min(len(f) for f in streams))
    frames = torch.from_numpy(np.stack([f[:steps] for f in streams]).astype(np.int64)).cuda()
    wide = svc._prefill_bootstrap(dict(enumerate(burst)))
    singles = {j: svc._prefill(r) for j, r in enumerate(burst)}
    held_against_single(pl, card, label, svc.statics, wide, singles, frames, emitted=True)
    return launches, m


def serving_k3(pl, card: str):
    """16 lockstep steps of the K3 configuration at B = 8: every talker and
    code-predictor linear on K3 at M = 8 (the cp's first pass at 16), from
    one graph. The counts are set to 0 before the graph's warm-up and
    capture and read after the steps: K3's wrapper counts the warm-up's and
    the capture's calls, twice the launches the capture recorded (the M of
    each call is recorded). A replay launches the recorded kernels without
    the wrapper: K3's device kernels are counted by name in a profile of 5
    replays and must be the capture's launches each. Returns the counts."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    statics = _statics(pl, 16)
    state = _serving_state(pl, SERVE_TEXTS, statics)
    fn, ms = qm.int8_matmul_kernel, []

    def recording(x, *args):
        ms.append(x.shape[0])
        return fn(x, *args)

    torch.cuda.synchronize()
    reset_counts()
    qm.int8_matmul_kernel = recording
    try:
        state = srv.bind(pl.params, pl.cp_params, state, statics, True)
    finally:
        qm.int8_matmul_kernel = fn
    g = state.graph
    check_pool(g, "k3-serving")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, counts, _, state = srv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.85,
                                                        statics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    hist = {mm: ms.count(mm) // 2 for mm in sorted(set(ms))}  # warm-up and capture
    per_step = g.step_launches[srv._COUNTED.index(qm)]
    replayed = replayed_k3(g, 5)
    ok = (launches["int8_matmul"] == 2 * per_step > 0 and replayed == 5 * per_step
          and bool((frames[..., 0] >= 0).all()) and 8 in hist)
    log(f"[k3-serving] 16 lockstep steps at B=8 (T=0.85) from one graph: {secs * 1e3:.1f} ms, "
        f"{secs / 16 * 1e3:.3f} ms a step; K3's wrapper {launches['int8_matmul']} calls in the "
        f"warm-up and the capture ({per_step} a step; M of a step's launches: {hist}); K3 "
        f"kernels in a profile of 5 replays {replayed} (expected {5 * per_step}); graph "
        f"captured in {g.capture_s:.3f} s, pool {g.pool_bytes} bytes "
        f"{'ok' if ok else 'FAIL'} ({card}, bf16)")
    if not ok:
        raise SystemExit("the K3 configuration's lockstep steps did not run K3 at M = 8 "
                         "in every replay")
    check_counts("k3-serving", launches, need=("int8_matmul",),
                 idle=tuple(k for k in KERNELS if k != "int8_matmul"))
    step_times(pl, card, "k3-serving", widths=(8,))
    return launches


# K3's device kernels: its GEMV, and the shared tile at 8 bits (K7's 8-bit
# tile has the same name; K7 is idle in the K3 configuration)
K3_NAMES = re.compile(r"qt_int8_matmul_kernel|qt_qmm_tile_kernel<8,")


def replayed_k3(g, n: int) -> int:
    """K3's device kernels in a torch.profiler window of n replays of graph
    g. A window short of n times the capture's launches is taken again, up
    to three windows (a profiler window can lose records; see
    one_kernel_per_call); the last window's count is returned."""
    import torch

    from qwen3_tts_tpu_torch.models import serving as srv
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    want = n * g.step_launches[srv._COUNTED.index(qm)]
    for window in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                g.replay()
            torch.cuda.synchronize()
        names = [name for name in device_kernels(prof) if K3_NAMES.search(name)]
        got = len(names)
        if got >= want:
            log(f"[k3-serving] K3 kernels in {n} replays by name: "
                + ", ".join(f"{names.count(k)} {k[:70]}" for k in sorted(set(names))))
            break
        log(f"[k3-serving] profile window {window}: {got} K3 kernels of {want}")
    return got


def check_pool(g, label: str) -> None:
    """A graph's pool must have grown at its capture."""
    if g.pool_bytes <= 0:
        raise SystemExit(f"[{label}] graph pool read {g.pool_bytes} bytes at its capture")


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
    vocoder = ("pre_transformer", "upsample_stage", "residual_units", "block_upsample")
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
        text_projection(pl, card, "pipeline", "K3")
        teacher_forced(pl, card)
        vocoder_check(pl)
        vocoder_windows(pl, card)
        profile_frames(pl, "pipeline", card)
        launches["serving"], results["serving"] = phase_serving(pl, card)
        launches["service"], results["service"] = phase_service(pl, card)
        del pl
        torch.cuda.empty_cache()

        off = qt.Qwen3TTSPipelineConfiguration(use_talker_megakernel=False,
                                               use_cp_megakernel=False)
        pl, launches["k3_path"], results["k3"] = run_pipeline(
            card, d, "k3-pipeline", off, need=("int8_matmul",) + vocoder,
            idle=megakernels + sampler + ("packed_matmul",))
        no_sync_chunk(pl, "k3-pipeline")
        profile_frames(pl, "k3-pipeline", card, steps=4)
        launches["serving_k3"] = serving_k3(pl, card)
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
        text_projection(pl, card, "prequant-pipeline", "K7")
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
        if name in PLAIN_XLA:
            row["counterpart_of"] = "plain XLA"
        for path in ("k3_path", "mixed", "prequant", "modes"):
            row[f"launches_{path}"] = launches[path][name]
        row["launches_serving"] = launches["serving"][name] + launches["serving_k3"][name]
        row["launches_service"] = launches["service"][name]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
