"""Build and bind the port's CUDA kernels.

All sources under `qwen3_tts_tpu_torch/csrc/` compile, on first use, with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC` (one nvcc
per source, run in parallel) and link into one shared library with a plain
C interface, loaded with ctypes. The
library goes to `build/kernels/` at the repository root (listed in
.gitignore), or to `$QWEN3TTS_KERNEL_BUILD_DIR`, and is rebuilt when a
source is newer. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
_LIB = None
# held by every wrapper while it adds to its launch count: the service's
# threads launch kernels side by side, and `launches += 1` is a read and a
# write
COUNT_LOCK = threading.Lock()


def build_dir() -> str:
    return os.environ.get("QWEN3TTS_KERNEL_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "kernels"
    )


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into build_dir()/libqt_kernels.so; returns its path."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libqt_kernels.so")
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (
        not force
        and os.path.exists(lib)
        and os.path.getmtime(lib) >= max(os.path.getmtime(p) for p in deps)
    ):
        return lib
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    # one nvcc per source, all started together, then one link
    objs = {src: os.path.join(out_dir, os.path.basename(src) + ".o") for src in sources()}
    procs = {
        src: subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in objs.items()
    }
    logs = {src: p.communicate()[0] for src, p in procs.items()}
    failed = [src for src, p in procs.items() if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs[s][-8000:] for s in failed))
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write("".join(logs.values()))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([nvcc, *flags, "-shared", "-o", tmp, *objs.values()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, lib)
    return lib


class GemmArgs(ctypes.Structure):
    """Mirror of QtGemmArgs in csrc/gemm.cuh."""

    _fields_ = [
        ("a", ctypes.c_void_p), ("a_bf16", ctypes.c_int), ("lda", ctypes.c_longlong),
        ("seq", ctypes.c_int), ("cin", ctypes.c_int), ("taps", ctypes.c_int),
        ("dil", ctypes.c_int),
        ("alpha", ctypes.c_void_p), ("binv", ctypes.c_void_p),
        ("w", ctypes.c_void_p), ("w_bf16", ctypes.c_int),
        ("M", ctypes.c_int), ("N", ctypes.c_int),
        ("c", ctypes.c_void_p), ("c_bf16", ctypes.c_int), ("ldc", ctypes.c_longlong),
        ("bias", ctypes.c_void_p), ("act", ctypes.c_int),
        ("res", ctypes.c_void_p), ("res_bf16", ctypes.c_int), ("ldr", ctypes.c_longlong),
        ("scale", ctypes.c_void_p), ("clip", ctypes.c_float),
    ]


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "qt_int8_matmul": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "qt_packed_matmul": [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "qt_pt_gemm": [ctypes.POINTER(GemmArgs), _P],
    "qt_pt_rmsnorm": [_P, _P, _P, _I, _I, _F, _P],
    "qt_pt_rope": [_P, _P, _I, _I, _I, _I, _P],
    "qt_pt_attention": [_P, _P, _I, _I, _I, _I, _F, _P],
    "qt_pt_silu_mul": [_P, _P, _LL, _I, _P],
    "qt_pt_head_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "qt_pt_head_store_rows": [_I],
    "qt_pt_silu_mul2": [_P, _P, _P, _LL, _P],
    "qt_pt_persistent": [_P, _I, _I, _P],
    "qt_pt_persistent_grid": [_I, _P],
    "qt_up_gemm": [ctypes.POINTER(GemmArgs), _P],
    "qt_up_dwconv_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "qt_up_persistent": [_P, _I, _I, _P],
    "qt_up_persistent_grid": [_I, _P],
    "qt_units_gemm": [ctypes.POINTER(GemmArgs), _P],
    "qt_units_conv": [_P, _I, _I, _LL, _LL, _P],
    "qt_units_snake": [_P, _I, _P, _P, _P, _LL, _I, _P],
    "qt_units_tail": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "qt_talker_step": [_P, _P],
    "qt_talker_grid": [_I, _P],
    "qt_cp_frame": [_P, _P],
    "qt_cp_grid": [_I, _P],
    "qt_grid_barrier_grid": [_I, _P],
    "qt_grid_barriers": [_I, _I, _I, _P],
    "qt_gumbel_sample": [_P, _I, _F, _P, _I, _P, _P],
    "qt_empty_launch": [_I, _I, _P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def struct_fields(fields: str) -> list[tuple[str, type]]:
    """ctypes fields from "name:kind" words (kind p = pointer, i = int,
    f = float), in the order of the C struct they mirror."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    return [(w.split(":")[0], kinds[w.split(":")[1]]) for w in fields.split()]


def is_bf16(t: torch.Tensor) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"kernel operands must be float32 or bfloat16, got {t.dtype}")


def require(t: torch.Tensor, name: str, *, dtype=None, shape=None) -> None:
    """Device / dtype / shape / contiguity checks for a kernel operand."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def gemm(
    fn: str,
    a: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    *,
    seq: int | None = None,
    taps: int = 1,
    dil: int = 1,
    alpha: torch.Tensor | None = None,
    binv: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    gelu: bool = False,
    res: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    clip: float = 0.0,
) -> torch.Tensor:
    """Launch one shared-GEMM entry `fn` (see QtGemmArgs): c = epi(A @ w)
    with a [M, cin] rows, w [taps * cin, N], c [M, N]."""
    m, cin = a.shape
    n = w.shape[1]
    for t, name in ((a, "a"), (w, "w"), (c, "c")):
        require(t, f"{fn}.{name}")
    if w.shape[0] != taps * cin or tuple(c.shape) != (m, n):
        raise ValueError(
            f"{fn}: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, c "
            f"{tuple(c.shape)} do not fit taps={taps}"
        )
    for t, name, size in ((alpha, "alpha", cin), (binv, "binv", cin),
                          (bias, "bias", n), (scale, "scale", n)):
        if t is not None:
            require(t, f"{fn}.{name}", dtype=torch.float32, shape=(size,))
    if res is not None:
        require(res, f"{fn}.res", shape=(m, n))
    args = GemmArgs(
        a=a.data_ptr(), a_bf16=is_bf16(a), lda=cin,
        seq=seq or max(m, 1), cin=cin, taps=taps, dil=dil,
        alpha=ptr(alpha), binv=ptr(binv),
        w=w.data_ptr(), w_bf16=is_bf16(w), M=m, N=n,
        c=c.data_ptr(), c_bf16=is_bf16(c), ldc=n,
        bias=ptr(bias), act=1 if gelu else 0,
        res=ptr(res), res_bf16=is_bf16(res) if res is not None else 0, ldr=n,
        scale=ptr(scale), clip=clip,
    )
    check(getattr(lib(), fn)(ctypes.byref(args), stream()), fn)
    return c
