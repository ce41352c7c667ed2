"""The GEMV of K3 and K7 (csrc/qmm_gemv.cuh) at every K split, beside the
tile and the library call, on one GPU:

    python3 scripts/torch_qmm_gemv_sweep.py [--out FILE]

Prints the card (name, power limit), the registers, stack and spills of
each GEMV kernel from the build's ptxas log, the floor of an empty launch
timed the cold way below (grids of 1, 264 and 768 blocks of 256 threads,
and each writing a float a block),
and one JSON line per measurement (also written to FILE, where given):
- "gemv": K3 (int8) and K7 (4-bit, group 64) on bf16 x at the 0.6B shapes
  (qkv 1024 -> 4096, o 2048 -> 1024, gate/up 1024 -> 6144, down 3072 ->
  1024, codec head 1024 -> 3072, cp lm head 1024 -> 2048, text fc1 2048 ->
  2048, fc2 2048 -> 1024) at M = 1, 2, 3, 4, 8 and 16, at every K split L
  (threads an output group: 4 .. 256; the C entries' `ks`), flagged where
  L is the plan's: ms a call cold (chip_smoke.cold_ms: one CUDA graph of a
  call per copy of the weights, the copies over 64 MB so that the L2 holds
  none) and warm (chip_smoke.graph_ms: a graph of one call replayed), its
  rel RMS against the plain version and whether two calls give the same
  bits; at the plan's L also fp32 x;
- "tile": the tile (the wrapper with M0 = 0) at the same shapes and M, cold;
- "library": torch._weight_int4pack_mm on K7's 4-bit weights, cold and warm.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("qkv", 1024, 4096), ("o", 2048, 1024), ("gate/up", 1024, 6144), ("down", 3072, 1024),
          ("codec head", 1024, 3072), ("cp lm head", 1024, 2048), ("fc1", 2048, 2048),
          ("fc2", 2048, 1024)]


def ptxas_lines(log_path: str) -> list[str]:
    """The ptxas report of each GEMV kernel: <BITS, MT, bf16 x>, then its
    stack, spills and registers."""
    out, lines = [], open(log_path).read().splitlines()
    for i, line in enumerate(lines):
        hit = re.search(r"qt_qmm_gemv_kernelILi(\d+)ELi(\d+)ELb(\d)E", line)
        if "Compiling entry function" in line and hit:
            tail = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "stack frame" in ln or "Used" in ln]
            out.append(f"qt_qmm_gemv_kernel<{hit.group(1)}, {hit.group(2)}, {hit.group(3)}>: "
                       + "; ".join(tail))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("torch_qmm_gemv_sweep: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen3_tts_tpu_torch.ops.cuda import _build, qmm_gemv
    from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
    from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    _build.build()
    lib = _build.lib()
    for line in ptxas_lines(os.path.join(_build.build_dir(), "ptxas.log")):
        print(f"[ptxas] {line}", flush=True)
    for blocks in (1, 264, 768):
        for store in (False, True):
            print(f"[floor] empty kernel, {blocks} blocks of 256 threads"
                  f"{', writing a float a block' if store else ''}, cold way: "
                  f"{cs.launch_floor_ms(blocks, store):.4f} ms", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w") if args.out else None

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = (1, 2, 3, 4, 8, 16)

    def raw(kernel, x, w, s, b, ks):
        """One GEMV call through the C entry with the plan argument `ks`."""
        m, k = x.shape
        o = w.shape[0]
        y = torch.empty(m, o, dtype=x.dtype, device=dev)
        if kernel == "K3":
            rc = lib.qt_int8_matmul(x.data_ptr(), _build.is_bf16(x), w.data_ptr(), s.data_ptr(),
                                    b.data_ptr(), y.data_ptr(), m, o, k, m, ks, None, None,
                                    _build.stream())
        else:
            rc = lib.qt_packed_matmul(x.data_ptr(), _build.is_bf16(x), w.data_ptr(), 4, 64,
                                      s.data_ptr(), b.data_ptr(), y.data_ptr(), m, o, k, m, ks,
                                      None, None, _build.stream())
        _build.check(rc, f"{kernel} GEMV")
        return y

    for kernel in ("K3", "K7"):
        bits = None if kernel == "K3" else 4
        for name, k, o in SHAPES:
            w, s, b = cs.qmm_weights(gen, dev, bits, k, o)
            copies = cs.cold_copies(w, s, b)
            for m in rows:
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                    bf = dtype == torch.bfloat16
                    p = qmm_gemv.plan(m, o, k, bf)
                    if bits is None:
                        ref = qm.int8_matmul_plain(x, w, s, b)
                    else:
                        ref = pm.packed_matmul_plain(x, w, s, b, 4, 64)
                    lanes = (4, 8, 16, 32, 64, 128, 256) if bf else (p.lanes,)
                    for lv in lanes:
                        pl = qmm_gemv.with_lanes(m, o, k, bf, lv)
                        got = raw(kernel, x, w, s, b, pl.ks)
                        err = cs.rel_rms(got.float(), ref.float())
                        same = bool(torch.equal(raw(kernel, x, w, s, b, pl.ks), got))
                        cold = cs.cold_ms([lambda c=c, ks=pl.ks: raw(kernel, x, *c, ks)
                                           for c in copies])
                        warm = cs.graph_ms(lambda ks=pl.ks: raw(kernel, x, w, s, b, ks))
                        emit(kind="gemv", kernel=kernel, shape=name, m=m, k=k, o=o,
                             dtype=str(dtype)[6:], lanes=lv, plan=lv == p.lanes,
                             blocks=pl.blocks, cold_ms=cold, warm_ms=warm, rel_rms=err,
                             same_bits=same)
                    if not bf:
                        continue
                    keep = qm.M0, pm.M0
                    qm.M0 = pm.M0 = 0
                    try:
                        if bits is None:
                            fns = [lambda c=c: qm.int8_matmul_kernel(x, *c) for c in copies]
                        else:
                            fns = [lambda c=c: pm.packed_matmul_kernel(x, *c, 4, 64)
                                   for c in copies]
                        emit(kind="tile", kernel=kernel, shape=name, m=m, k=k, o=o,
                             cold_ms=cs.cold_ms(fns), warm_ms=cs.graph_ms(fns[0]))
                    finally:
                        qm.M0, pm.M0 = keep
                    if bits == 4:
                        packs = [cs.int4pack_weights(*c, k) for c in copies]
                        fns = [lambda pz=pz: torch._weight_int4pack_mm(x, pz[0], 64, pz[1])
                               for pz in packs]
                        emit(kind="library", kernel=kernel, shape=name, m=m, k=k, o=o,
                             cold_ms=cs.cold_ms(fns), warm_ms=cs.graph_ms(fns[0]))
                        del packs, fns
            del copies
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
