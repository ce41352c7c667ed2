"""K3 and K7 and the 0.6B prefill on one GPU, timed for the PyTorch port of
one checkout, so that two commits can be compared on one card:

    python3 scripts/torch_qmm_compare.py [--root DIR] [--label NAME] [--kernels-only]

`--root` is the checkout whose `qwen3_tts_tpu_torch` is imported (default:
the one holding this script); its kernels build into `DIR/build/kernels`.
To compare two commits, unpack one with `git archive` into a directory that
.gitignore lists and run the script on both trees in one call, in turns
(parent, change, change, parent).

Prints the card (name, power limit) and one JSON line per measurement:
- K3 (int8, group 64) and K7 (4-bit, group 64; 6-bit qkv) on bf16 x at the
  0.6B shapes: the text projection (fc1 2048 -> 2048, fc2 2048 -> 1024) at
  M = 114 and 3, gate/up (1024 -> 6144) at M = 1 and 300, qkv (1024 -> 4096)
  at M = 300; ms a call by CUDA events over back-to-back calls and by the
  replay of a CUDA graph of one call (device time without Python); the
  plain version at M = 114 and one dense bf16 torch.matmul of each shape
  (a yardstick: not the same function);
- where the tree has the tensor-core tile (ops/cuda/qmm_tile.py), the tile
  at each K split (1-16) beside the plan's choice at the 0.6B shapes (the
  data split_k's cost model is fitted to);
- prefill (`generate.prefill` after `_assemble`) and the prompt assembly
  alone, per configuration (megakernel, K3, mixed 4/6-bit, pre-quantized
  4-bit), on a random-weight 0.6B model in bf16: median ms of 7 runs, each
  ended by torch.cuda.synchronize().
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

TEXT = ("The quick brown fox jumps over the lazy dog, and then it runs far "
        "away into the quiet green forest.")


def emit(label: str, **row) -> None:
    print(json.dumps({"tree": label, **row}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels-only", action="store_true", help="skip the prefill timings")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or root
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_qmm_compare: needs a CUDA GPU", file=sys.stderr)
        return 2
    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.models import generate as gen_mod
    from qwen3_tts_tpu_torch.ops.cuda import _build
    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
    from qwen3_tts_tpu_torch.testing import write_model_dir, write_prequantized_model_dir

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    assert qt.__file__.startswith(root), (qt.__file__, root)
    t0 = time.perf_counter()
    _build.lib()
    emit(label, what="build_s", s=time.perf_counter() - t0, card=card)

    def events_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        for _ in range(iters):
            fn()
        e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]) / iters

    def graph_ms(fn, iters):
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return events_ms(graph.replay, iters)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def int8_weights(k, o):
        w8 = torch.randint(0, 256, (o, k), generator=gen, device=dev, dtype=torch.uint8)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * 1e-3
        b = torch.randn(o, k // 64, generator=gen, device=dev) * 0.02
        return w8, s, b

    def packed_weights(bits, k, o):
        wq = torch.randint(-2 ** 31, 2 ** 31, (o, k * bits // 32), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.int32)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * (2e-2 / 2 ** bits)
        b = torch.randn(o, k // 64, generator=gen, device=dev) * 0.01
        return wq, s, b

    shapes = [("fc1", 114, 2048, 2048), ("fc2", 114, 2048, 1024), ("fc1", 3, 2048, 2048),
              ("fc2", 3, 2048, 1024), ("gate_up", 300, 1024, 6144), ("gate_up", 1, 1024, 6144)]
    for name, m, k, o in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w8, s, b = int8_weights(k, o)
        wq, s4, b4 = packed_weights(4, k, o)
        dense = torch.randn(k, o, generator=gen, device=dev).to(torch.bfloat16)
        row = dict(what="kernel", name=name, m=m, k=k, o=o, card=card)
        emit(label, kernel="K3", **row,
             events_ms=events_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b), 20),
             graph_ms=graph_ms(lambda: qm.int8_matmul_kernel(x, w8, s, b), 50),
             plain_ms=(events_ms(lambda: qm.int8_matmul_plain(x, w8, s, b), 10)
                       if m == 114 else None))
        emit(label, kernel="K7 4-bit", **row,
             events_ms=events_ms(lambda: pm.packed_matmul_kernel(x, wq, s4, b4, 4, 64), 20),
             graph_ms=graph_ms(lambda: pm.packed_matmul_kernel(x, wq, s4, b4, 4, 64), 50),
             plain_ms=(events_ms(lambda: pm.packed_matmul_plain(x, wq, s4, b4, 4, 64), 10)
                       if m == 114 else None))
        emit(label, kernel="dense bf16 torch.matmul (yardstick)", **row,
             events_ms=events_ms(lambda: x @ dense, 20), graph_ms=graph_ms(lambda: x @ dense, 50))
    x = torch.randn(300, 1024, generator=gen, device=dev).to(torch.bfloat16)
    wq, s6, b6 = packed_weights(6, 1024, 4096)
    emit(label, kernel="K7 6-bit", what="kernel", name="qkv", m=300, k=1024, o=4096, card=card,
         events_ms=events_ms(lambda: pm.packed_matmul_kernel(x, wq, s6, b6, 6, 64), 20),
         graph_ms=graph_ms(lambda: pm.packed_matmul_kernel(x, wq, s6, b6, 6, 64), 50))

    try:
        from qwen3_tts_tpu_torch.ops.cuda import qmm_tile
    except ImportError:
        qmm_tile = None
    if qmm_tile is not None:
        # the plan's choice beside every K split it could make
        plan_fn, split_fn = qmm_tile.plan, qmm_tile.split_k
        try:
            for name, m, k, o, bits in (("fc1", 114, 2048, 2048, 8), ("fc2", 114, 2048, 1024, 8),
                                        ("fc1", 114, 2048, 2048, 4), ("qkv", 300, 1024, 4096, 6),
                                        ("gate_up", 300, 1024, 6144, 8),
                                        ("gate_up", 300, 1024, 6144, 4),
                                        ("gate_up", 9, 1024, 6144, 8),
                                        ("down", 300, 3072, 1024, 8)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                w, sc, bi = int8_weights(k, o) if bits == 8 else packed_weights(bits, k, o)

                def call():
                    if bits == 8:
                        return qm.int8_matmul_kernel(x, w, sc, bi)
                    return pm.packed_matmul_kernel(x, w, sc, bi, bits, 64)

                qmm_tile.plan, qmm_tile.split_k = plan_fn, split_fn
                chosen = plan_fn(m, o, k, 64, bits, True, torch.cuda.get_device_properties(
                    dev).multi_processor_count).ks
                for ks in (1, 2, 3, 4, 6, 8, 12, 16):
                    qmm_tile.split_k = lambda *_a, ks=ks: ks
                    qmm_tile.plan = functools.lru_cache(maxsize=None)(plan_fn.__wrapped__)
                    emit(label, what="plan_sweep", name=name, bits=bits, m=m, k=k, o=o, ks=ks,
                         graph_ms=graph_ms(call, 50), chosen=chosen, card=card)
        finally:
            qmm_tile.plan, qmm_tile.split_k = plan_fn, split_fn

    if args.kernels_only:
        return 0
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as dq:
        write_model_dir(d, qt.Qwen3TTSConfig.standard(), qt.TokenizerDecoderConfig(), seed=0)
        write_prequantized_model_dir(dq, qt.Qwen3TTSConfig.standard(),
                                     qt.TokenizerDecoderConfig(), widths=(4,), group_size=64)
        off = dict(use_talker_megakernel=False, use_cp_megakernel=False)
        configs = [("megakernel", d, None),
                   ("k3", d, qt.Qwen3TTSPipelineConfiguration(**off)),
                   ("mixed", d, qt.Qwen3TTSPipelineConfiguration(
                       runtime_quantization_mode="mixed_4_6", **off)),
                   ("prequant", dq, None)]
        for name, path, cfg in configs:
            pl = qt.Qwen3TTSPipeline(path, cfg, device="cuda")
            pd = pl._assemble(TEXT, "aiden")
            gen_mod.prefill(pl.params, pd, pl.config)
            assemble, prefill = [], []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pd = pl._assemble(TEXT, "aiden")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                gen_mod.prefill(pl.params, pd, pl.config)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                assemble.append((t1 - t0) * 1e3)
                prefill.append((t2 - t1) * 1e3)
            emit(label, what="prefill", config=name, prompt_rows=int(pd.input_embeds.shape[1]),
                 assemble_ms=statistics.median(assemble), prefill_ms=statistics.median(prefill),
                 prefill_ms_all=prefill, card=card)
            del pl
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
