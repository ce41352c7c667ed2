"""Where the GEMV of K3 and K7 (csrc/qmm_gemv.cuh) spends its time, on one
GPU: copies of it with one part taken out each, timed beside the whole at
0.6B shapes, with the whole's SASS summarised.

    python3 scripts/torch_qmm_gemv_ablation.py

Each variant patches a copy of csrc/ under $TMPDIR, builds packed_matmul.cu
alone with nvcc (sm_90a, all variants in parallel) and is called through
its C entry on bf16 x at 4 bits, group 64, with the plan's K split, timed
cold (chip_smoke.cold_ms: one CUDA graph of a call per copy of the weights,
the copies over 64 MB). A variant that drops work computes wrong results:
only its time means anything; the compiler also drops what only fed the
part taken out. Variants:
  whole      - the GEMV as it is
  no_weights - without the loads of the weights, scales and biases
  no_x       - without staging x (its shared memory read as it is)
  no_dequant - the weights' words used as the fp32 weights: no unpack, no
               s q + b (the loads and the products stay)
  no_reduce  - without the warp's butterfly (each lane's sum stored)
  empty      - the kernel returns at once: its launch alone (its registers,
               shared memory and arguments)
Prints the card (name, power limit), the whole's instruction mix (cuobjdump
-sass of the one-row bf16 kernel at 4 bits: loads, shuffles, local memory,
barriers, total) and one line per variant.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "qwen3_tts_tpu_torch", "csrc")

FETCH0 = "  qg_fetch<BITS, R>(a, o0, j, C, G, wv, sv, bv);\n"
FETCH = "    if (it) qg_fetch<BITS, R>(a, o0, c, C, G, wv, sv, bv);\n"
NO_FETCH = ("  for (int i = 0; i < R; ++i) {\n    for (int q = 0; q < BITS; ++q) "
            "wv[i][q] = j * 0x01010101u + q;\n    sv[i] = 1.f, bv[i] = 0.f;\n  }\n")
STAGE1 = "    for (int idx = tid; idx < mt * C * 4; idx += QG_NT) {\n"
STAGE2 = "    for (int idx = tid; idx < mt * row_pieces; idx += QG_NT) {\n"
DEQUANT = "          w[i][e] = fmaf(qg_q<BITS>(wv[i], p * VPP + e), sv[i], bv[i]);\n"
REDUCE = "  QgHalve<V, 16>::run(v, lane);\n"
TOP = "  extern __shared__ __align__(16) unsigned char qg_smem[];\n"
VARIANTS = {
    "whole": [],
    "no_weights": [(FETCH0, NO_FETCH), (FETCH, "")],
    "no_x": [(STAGE1, STAGE1.replace("mt * C * 4", "0")),
             (STAGE2, STAGE2.replace("mt * row_pieces", "0"))],
    "no_dequant": [(DEQUANT,
                    "          w[i][e] = __uint_as_float(wv[i][(p * VPP + e) % BITS]);\n")],
    "no_reduce": [(REDUCE, "")],
    "empty": [(TOP, TOP + "  if (a.M > 0) return;\n")],
}
# (name, K, O, M): the plan's K split at each
CASES = [("o", 2048, 1024, 1), ("gate/up", 1024, 6144, 1), ("down", 3072, 1024, 1),
         ("cp lm head", 1024, 2048, 1), ("fc1", 2048, 2048, 3), ("gate/up", 1024, 6144, 8)]
SASS = {"global loads": r"\bLDG\b", "shared loads": r"\bLDS\b", "FMAs": r"\bFFMA\b",
        "local memory": r"\b(LDL|STL)\b", "barriers": r"\bBAR\b", "shuffles": r"\bSHFL\b",
        "byte permutes": r"\bPRMT\b", "integer divisions (calls)": r"\bCALL\b"}


def sass_summary(obj: str) -> str:
    """Instruction counts of the one-row bf16 GEMV kernel at 4 bits in an
    object file."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", obj], capture_output=True, text=True).stdout
    body, keep = [], False
    for line in out.splitlines():
        if "Function :" in line:
            keep = "qt_qmm_gemv_kernelILi4ELi1ELb1E" in line
        elif keep and re.search(r"/\*[0-9a-f]{4}\*/", line):
            body.append(line)
    counts = {k: sum(1 for ln in body if re.search(p, ln)) for k, p in SASS.items()}
    return f"{len(body)} instructions; " + ", ".join(f"{k} {v}" for k, v in counts.items())


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_qmm_gemv_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix="qmm_gemv_ablation_")
    header = open(os.path.join(CSRC, "qmm_gemv.cuh")).read()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC"]
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(CSRC, d)
        text = header
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: the GEMV no longer has {old.strip()!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, "qmm_gemv.cuh"), "w") as f:
            f.write(text)
        src = os.path.join(d, "packed_matmul.cu")
        procs[name] = subprocess.Popen(
            f"{nvcc} {' '.join(flags)} -c -o {d}/k.o {src} && "
            f"{nvcc} {' '.join(flags)} -shared -o {d}/lib.so {d}/k.o",
            shell=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"variant {name} did not build:\n{out[-4000:]}")
    print(cs.card_line(), flush=True)
    print(f"[sass] whole, qt_qmm_gemv_kernel<4, 1, bf16>: "
          f"{sass_summary(os.path.join(work, 'whole', 'k.o'))}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    from qwen3_tts_tpu_torch.ops.cuda import qmm_gemv

    data = []
    for name, k, o, m in CASES:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        wq, s, b = cs.qmm_weights(gen, dev, 4, k, o)
        lanes = qmm_gemv.plan(m, o, k, True).ks
        data.append((f"{name} M={m} L={lanes}", x, cs.cold_copies(wq, s, b), m, o, k, lanes))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in VARIANTS:
        fn = ctypes.CDLL(os.path.join(work, name, "lib.so")).qt_packed_matmul
        fn.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr,
                       ptr]
        fn.restype = i32
        row = []
        for label, x, copies, m, o, k, w in data:
            def call(c, x=x, m=m, o=o, k=k, w=w):
                y = torch.empty(m, o, dtype=x.dtype, device=dev)
                rc = fn(x.data_ptr(), 1, c[0].data_ptr(), 4, 64, c[1].data_ptr(), c[2].data_ptr(),
                        y.data_ptr(), m, o, k, m, w, None, None,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")

            row.append(f"{label} {cs.cold_ms([lambda c=c: call(c) for c in copies]):.4f} ms")
        print(f"{name:10s} | " + "; ".join(row), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
