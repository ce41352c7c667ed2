"""Where K3's tensor-core tile (csrc/qmm_tile.cuh) spends its time, on one
GPU: copies of the tile with one part taken out each, timed beside the
whole at the 0.6B shapes.

    python3 scripts/torch_qmm_ablation.py

Each variant patches a copy of csrc/ under $TMPDIR, builds quant_matmul.cu
alone with nvcc (sm_90a, all variants in parallel) and is called through
its C entry on bf16 x with the K split given (device time, CUDA-graph
replay of one call, mean of 50). A variant that drops work computes wrong
results: only its time means anything. Variants:
  whole      - the tile as it is
  no_ones    - without the MMA against a B of ones that forms X = sum x
  no_unpack  - without the prologue's unpack of the raw weights into bf16
  no_mma     - without the MMAs (ldmatrix stays)
  no_scales  - without the cp.async of the scales and biases
  no_fold    - without the per-group fold acc += s P + b X
  no_weights - without the cp.async of the raw weights
  skeleton   - no loads, no unpack: the ring's waits and barriers, the
               MMAs, the fold and the store
Prints the card (name, power limit) and one line per variant.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "qwen3_tts_tpu_torch", "csrc")

X_FETCH = "  for (int idx = tid; idx < QM_BM * XCH; idx += QM_NT) {"
W_FETCH = "  for (int idx = tid; idx < QM_BN * wch; idx += QM_NT) {"
SB_FETCH = "  for (int idx = tid; idx < 2 * ng * QM_BN; idx += QM_NT) {"
NONE = "  for (int idx = tid; idx < 0; idx += QM_NT) {"
UNPACK = "    qm_unpack<BITS>(st + L::X_BYTES, wb);\n"
MMA_P = ("            qt_mma(P[mi][nj], af, bq[nj >> 1][2 * (nj & 1)], "
         "bq[nj >> 1][2 * (nj & 1) + 1]);\n")
MMA_X = "          qt_mma(X[mi], af, QM_ONES, QM_ONES);\n"
FOLD = "      if ((k0 + (c + 1) * 16) % a.gs == 0) {"
VARIANTS = {
    "whole": [],
    "no_ones": [(MMA_X, "")],
    "no_unpack": [(UNPACK, "")],
    "no_mma": [(MMA_P, "            ;\n"), (MMA_X, "")],
    "no_scales": [(SB_FETCH, NONE)],
    "no_fold": [(FOLD, "      if (a.gs < 0) {")],
    "no_weights": [(W_FETCH, NONE)],
    "skeleton": [(UNPACK, ""), (X_FETCH, NONE), (W_FETCH, NONE), (SB_FETCH, NONE)],
}
# (name, M, K, O, K split)
CASES = [("gate/up", 300, 1024, 6144, 1), ("fc1", 114, 2048, 2048, 8), ("fc2", 114, 2048, 1024, 8),
         ("gate/up", 9, 1024, 6144, 4)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_qmm_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="qmm_ablation_")
    header = open(os.path.join(CSRC, "qmm_tile.cuh")).read()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(CSRC, d)
        text = header
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: the tile no longer has {old.strip()!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, "qmm_tile.cuh"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "quant_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"variant {name} did not build:\n{out[-4000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def graph_ms(fn, iters=50):
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
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters

    data = []
    for name, m, k, o, ks in CASES:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w8 = torch.randint(0, 256, (o, k), generator=gen, device=dev, dtype=torch.uint8)
        s = torch.rand(o, k // 64, generator=gen, device=dev) * 1e-3
        b = torch.randn(o, k // 64, generator=gen, device=dev) * 0.02
        tiles = -(-m // 64) * -(-o // 128)
        part = torch.empty(ks * m * o, device=dev)
        cnt = torch.zeros(tiles, dtype=torch.int32, device=dev)
        y = torch.empty(m, o, dtype=x.dtype, device=dev)
        data.append((f"{name} M={m} ks={ks}", (x, w8, s, b, y, m, o, k, ks, part, cnt)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in VARIANTS:
        fn = ctypes.CDLL(os.path.join(work, name, "lib.so")).qt_int8_matmul
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        fn.restype = i32
        row = []
        for label, (x, w8, s, b, y, m, o, k, ks, part, cnt) in data:
            def call():
                rc = fn(x.data_ptr(), 1, w8.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(),
                        m, o, k, 0, ks, part.data_ptr(), cnt.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")
            row.append(f"{label} {graph_ms(call):.4f} ms")
        print(f"{name:10s} | " + "; ".join(row), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
