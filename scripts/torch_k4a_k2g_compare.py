"""K4a (the per-head pre-transformer), K2 (the code-predictor frame) at
temperature 0 and 0.85, and K2g (the Gumbel pick) on one GPU, timed for the
PyTorch port of one checkout, so that two commits can be compared on one
card:

    python3 scripts/torch_k4a_k2g_compare.py [--root DIR] [--label NAME]

`--root` is the checkout whose `qwen3_tts_tpu_torch` is imported (default:
the one holding this script); its kernels build into `DIR/build/kernels`.
To compare two commits, unpack one with `git archive` into a directory that
.gitignore lists and run the script on both trees in one call, in turns
(parent, change, change, parent).

Prints the card (name, power limit) and one JSON line per measurement, all
on random weights at the 0.6B widths, bf16:
- K4a (`pre_transformer_fused_kernel`) and K4 (`pre_transformer_kernel`) on
  the same vocoder weights at (B, T) = (1, 26), (1, 110), (2, 26), (2, 110)
  and (1, 300), fp32 input as the vocoder hands it: ms a call by CUDA events
  over 20 back-to-back calls, the median of 5 such runs; and whether K4a's
  output equals K4's bit for bit;
- K2 (`predict_frame_kernel`, penalty on) at temperature 0, where the pick
  draws no noise, and at 0.85, in turns: the median of 8 runs of 20 calls
  each, and their difference, the draws' noise a frame;
- K2g (`gumbel_sample_kernel`) for one draw over the code predictor's 2048
  logits and for 15 draws: ms a call by the replay of a CUDA graph of one
  call (device time without Python), the median of 5 runs of 200 replays.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def emit(label: str, **row) -> None:
    print(json.dumps({"tree": label, **row}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or root
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_k4a_k2g_compare: needs a CUDA GPU", file=sys.stderr)
        return 2
    import qwen3_tts_tpu_torch as qt
    from qwen3_tts_tpu_torch.convert import to_torch
    from qwen3_tts_tpu_torch.ops.cuda import _build
    from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
    from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
    from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
    from qwen3_tts_tpu_torch.testing import random_host_cp_params, random_vocoder_params

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

    # K4a and K4 on the same weights
    cfg = qt.TokenizerDecoderConfig()
    pt = random_vocoder_params(cfg, seed=0, device=dev)["pre_transformer"]
    fused = ptk.build_pretransformer_fused_params(pt, cfg, torch.bfloat16)
    packed = ptk.build_pretransformer_params(pt, cfg, torch.bfloat16)
    kw = dict(nh=cfg.num_attention_heads, hd=cfg.head_dim, eps=cfg.rms_norm_eps)
    for b, t in ((1, 26), (1, 110), (2, 26), (2, 110), (1, 300)):
        x = torch.randn(b, t, cfg.latent_dim, generator=gen, device=dev)
        k4a = lambda: ptk.pre_transformer_fused_kernel(fused, x, **kw)  # noqa: E731
        k4 = lambda: ptk.pre_transformer_kernel(packed, x, **kw)  # noqa: E731
        same = bool(torch.equal(k4a(), k4()))
        runs = {"K4a": [], "K4": []}
        for _ in range(5):
            for name, fn in (("K4a", k4a), ("K4", k4)):
                runs[name].append(events_ms(fn, 20))
        for name, r in runs.items():
            emit(label, what="kernel", kernel=name, b=b, t=t, events_ms=statistics.median(r),
                 runs=r, **({"equal_to_k4": same} if name == "K4a" else {}), card=card)

    # K2 at temperature 0 and 0.85, in turns
    config = qt.Qwen3TTSConfig.standard()
    cc = config.code_predictor_config
    ckp = to_torch(cpk.build_cp_kernel_params(random_host_cp_params(config, 1), cc), dev)
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    hidden = torch.randn(1, 1, config.hidden_size, generator=gen, device=dev).bfloat16()
    code0 = (torch.randn(1, 1, config.hidden_size, generator=gen, device=dev) * 0.5).bfloat16()
    seen = torch.rand(ng, v, generator=gen, device=dev) < 0.3
    seed = torch.tensor([20240607], device=dev)
    runs = {0.0: [], 0.85: []}
    for i in range(8):
        for temp in ((0.0, 0.85) if i % 2 == 0 else (0.85, 0.0)):
            s2 = seen.clone()
            runs[temp].append(events_ms(
                lambda: cpk.predict_frame_kernel(ckp, hidden, code0, seed, temp, s2, cc), 20))
    med = {temp: statistics.median(r) for temp, r in runs.items()}
    for temp, r in runs.items():
        emit(label, what="kernel", kernel="K2", temperature=temp, events_ms=med[temp], runs=r,
             card=card)
    emit(label, what="K2 draws' noise", us_per_frame=(med[0.85] - med[0.0]) * 1e3, card=card)

    # K2g: one draw and a frame's 15
    logits = torch.randn(v, generator=gen, device=dev) * 2.0
    gseed = torch.tensor([7], device=dev)
    for n in (1, ng):
        call = lambda: gs.gumbel_sample_kernel(logits, gseed, 0.85, n)  # noqa: E731
        r = [graph_ms(call, 200) for _ in range(5)]
        emit(label, what="kernel", kernel="K2g", draws=n, graph_ms=statistics.median(r),
             runs=r, card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
