"""K5: one ConvNeXt-upsample stage of the vocoder (CUDA kernels
csrc/upsample.cu).

Counterpart of qwen3_tts_tpu/ops/pallas/upsample_kernel.py::
upsample_stage_fused: x [B, T, C] -> [B, 2T, C] through the k=2 stride-2
causal transposed conv and a ConvNeXt block (causal depthwise k=7,
LayerNorm(1e-6), pointwise x4, exact GELU, pointwise back, gamma,
residual); with the folded SEANet initial_conv (the last stage) the output
is [B, 2T, Cic]. With bf16 weights (the pipeline's) a call is one
persistent cooperative launch on the tensor cores (bf16 operands, fp32
sums, as the JAX kernel at compute_dtype bf16); with fp32 weights it is the
exact fp32 launch sequence.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, persistent

launches = 0  # kernel-sequence launches since the last reset

# The persistent bf16 K5 (csrc/upsample.cu, qt_up_persistent_kernel): GEMM
# tiles of UP_BN columns and 64 or UP_BMAX rows, K steps of UP_BK through a
# ring of UP_STAGES slots
UP_BN, UP_BK, UP_STAGES, UP_BMAX, UP_LD = 64, 64, 4, 128, 72
SMEM = UP_STAGES * (UP_BMAX + UP_BK) * UP_LD * 2  # the A and weight rings, bf16
ITEM_STEPS = 4  # the fixed cost of an item (ring fill, partial sums), in K steps
MAX_SPLIT = 16


class UpArgs(ctypes.Structure):
    """Mirror of QtUpArgs in csrc/upsample.cu."""

    _fields_ = _build.struct_fields(
        "x:p x_bf16:i xb:p up_w:p pw1_w:p pw2_w:p ic_w:p up_b:p dw:p dw_b:p ln_w:p ln_b:p "
        "pw1_b:p pw2_b:p gamma:p ic_b:p z:p g:p a:p ob:p out:p out_bf16:i part:p cnt:p stamps:p "
        "B:i T:i C:i I:i Cic:i bm0:i bm1:i bm2:i bm3:i ks0:i ks1:i ks2:i ks3:i")


def stage_gemms(b: int, t: int, c: int, inter: int,
                cic: int | None) -> list[tuple[int, int, int]]:
    """(M, K, N) of the persistent K5's GEMM phases in launch order: up,
    pw1, pw2, and the initial conv (K = 7C) when cic is set."""
    m = 2 * b * t
    out = [(b * t, c, 2 * c), (m, c, inter), (m, inter, c)]
    return out + [(m, 7 * c, cic)] if cic else out


def tile_rows(m: int) -> int:
    return 64 if m <= 64 else UP_BMAX


def k_steps(k: int) -> int:
    return -(-k // UP_BK)


def tiles(m: int, n: int, bm: int) -> int:
    return -(-m // bm) * -(-n // UP_BN)


def split_k(n_tiles: int, steps: int, grid: int) -> int:
    """K runs a tile is cut into: the least rounds over the grid times the
    steps of an item (plus ITEM_STEPS for its fixed cost), ties to fewer
    runs."""
    def cost(ks):
        return -(-n_tiles * ks // grid) * (-(-steps // ks) + ITEM_STEPS)

    return min(range(1, min(steps, MAX_SPLIT) + 1), key=lambda ks: (cost(ks), ks))


def stage_plan(b: int, t: int, c: int, inter: int, cic: int | None,
               grid: int) -> list[tuple[int, int]]:
    """(tile rows, K runs) of each GEMM phase."""
    plan = []
    for m, k, n in stage_gemms(b, t, c, inter, cic):
        bm = tile_rows(m)
        plan.append((bm, split_k(tiles(m, n, bm), k_steps(k), grid)))
    return plan


def gemm_item(m: int, k: int, n: int, bm: int, ks: int, it: int) -> tuple[int, ...]:
    """(tile, K run, first row, first column, first K step, K steps) of
    item `it` (qt_up_item): tile it % tiles, row tile first."""
    mt, steps = -(-m // bm), k_steps(k)
    tile, split = it % tiles(m, n, bm), it // tiles(m, n, bm)
    k0 = split * steps // ks
    return tile, split, (tile % mt) * bm, (tile // mt) * UP_BN, k0, (split + 1) * steps // ks - k0


def dwln_rows(m: int, grid: int, block: int, warp: int) -> range:
    """The rows warp `warp` of block `block` normalizes (qt_up_dwln_phase)."""
    return range(block + grid * warp, m, grid * (persistent.PK_NT // 32))


def stage_phases(fold: bool, x_fp32: bool) -> list[str]:
    """The phases of one call in order, a grid barrier between each two."""
    return (["round_x"] if x_fp32 else []) + ["up", "dwln", "pw1", "pw2"] + (
        ["ic"] if fold else [])


def build_upsample_stage_params(
    stage: dict, dtype=torch.bfloat16, initial_conv: dict | None = None
) -> dict:
    """Kernel layout for one stage from the dense tree ({"tconv": k=2
    pre-flipped HIO [2, C, C], "convnext": ...}; torch tensors). GEMM
    weights are [in, out] in `dtype`; everything else fp32."""
    w = stage["tconv"]["w"]
    k, cin, cout = w.shape
    if k != 2 or cin != cout:
        raise ValueError(f"upsample kernel expects k==stride==2, C==C (got {tuple(w.shape)})")
    cn = stage["convnext"]
    dw = cn["dwconv"]["w"]
    if dw.shape[0] != 7 or dw.shape[1] != 1:
        raise ValueError(f"upsample kernel expects a depthwise k=7 conv (got {tuple(dw.shape)})")

    def f32(t):
        return t.float().contiguous()

    def wd(t):
        return t.to(dtype).contiguous()

    out = {
        # column half p = output phase p = w[stride - 1 - p]
        "up_w": wd(torch.cat([w[1], w[0]], dim=1)),
        "up_b": f32(torch.cat([stage["tconv"]["b"]] * 2)),
        "dw": f32(dw[:, 0, :]),
        "dw_b": f32(cn["dwconv"]["b"]),
        "ln_w": f32(cn["norm"]["w"]),
        "ln_b": f32(cn["norm"]["b"]),
        "pw1_w": wd(cn["pwconv1"]["w"].T),
        "pw1_b": f32(cn["pwconv1"]["b"]),
        "pw2_w": wd(cn["pwconv2"]["w"].T),
        "pw2_b": f32(cn["pwconv2"]["b"]),
        "gamma": f32(cn["gamma"]),
    }
    if initial_conv is not None:
        w_ic = initial_conv["w"]  # [7, C, Cic] HIO
        if w_ic.shape[0] != 7 or w_ic.shape[1] != cin:
            raise ValueError(f"initial_conv fold expects k=7 from C (got {tuple(w_ic.shape)})")
        out["ic_w"] = wd(w_ic.reshape(7 * cin, w_ic.shape[2]))
        out["ic_b"] = f32(initial_conv["b"])
    return out


def _causal_taps(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """sum_j x[t - (k-1-j)] @ w[j] over [B, S, C] with w [k*C, N] (zeros
    before the sequence start)."""
    b, s, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    wk = w.float().reshape(k, c, -1)
    return sum(xp[:, j:j + s] @ wk[j] for j in range(k))


def upsample_stage_plain(kp: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (fp32 arithmetic, exact erf).
    With bf16 weights it rounds to bf16 the operand of every product, where
    the JAX kernel (_stage_kernel) rounds to its compute dtype and the
    kernel feeds its tensor cores: x, the LayerNorm output, the GELU output
    and, before the initial conv's taps, the ConvNeXt output; z, the
    LayerNorm statistics and every sum stay fp32. With fp32 weights it
    rounds nothing."""
    b, t, c = x.shape
    rounds = kp["up_w"].dtype == torch.bfloat16

    def op(v):
        return v.bfloat16().float() if rounds else v

    z = (op(x.float()) @ kp["up_w"].float() + kp["up_b"]).reshape(b, 2 * t, c)
    zp = torch.nn.functional.pad(z, (0, 0, 6, 0))
    h = kp["dw_b"] + sum(zp[:, j:j + 2 * t] * kp["dw"][j] for j in range(7))
    g = op(torch.nn.functional.layer_norm(h, (c,), kp["ln_w"], kp["ln_b"], 1e-6))
    a = op(torch.nn.functional.gelu(g @ kp["pw1_w"].float() + kp["pw1_b"]))
    o = z + kp["gamma"] * (a @ kp["pw2_w"].float() + kp["pw2_b"])
    if "ic_w" in kp:
        o = _causal_taps(op(o), kp["ic_w"], 7) + kp["ic_b"]
    return o.to(x.dtype)


def _align(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=None)
def _launch_plan(device: int, b: int, t: int, c: int, inter: int, cic: int | None,
                 x_fp32: bool) -> tuple:
    """(grid, tile rows, K runs, byte offsets of the work buffers in one
    workspace, its bytes, split-K counters) of one call, cached per shape."""
    grid = persistent._grid("qt_up_persistent_grid", device, SMEM)
    plan = stage_plan(b, t, c, inter, cic, grid)
    gemms = stage_gemms(b, t, c, inter, cic)
    split = [(ks * m * n, tiles(m, n, bm)) for (bm, ks), (m, _, n) in zip(plan, gemms) if ks > 1]
    rows = 2 * b * t
    sizes = {"xb": 2 * b * t * c if x_fp32 else 0, "z": 4 * rows * c, "g": 2 * rows * c,
             "a": 2 * rows * inter, "ob": 2 * rows * c if cic else 0,
             "part": 4 * max([n for n, _ in split], default=0)}
    offsets, total = {}, 0
    for name, size in sizes.items():
        offsets[name] = total if size else None
        total += _align(size)
    bm, ks = zip(*(plan + [(0, 0)] * (4 - len(plan))))
    return grid, bm, ks, offsets, total, max([n for _, n in split], default=1)


def _stage_persistent(kp: dict, x: torch.Tensor, stamps: torch.Tensor | None) -> torch.Tensor:
    """bf16 weights: one cooperative launch of qt_up_persistent_kernel."""
    b, t, c = x.shape
    inter = kp["pw1_w"].shape[1]
    fold = "ic_w" in kp
    cic = kp["ic_w"].shape[1] if fold else None
    if c % 8 or c > 1024 or inter % 8 or (fold and cic % 8):
        raise ValueError(f"K5's bf16 kernel needs C <= 1024 and C, I, Cic % 8 == 0 "
                         f"(got {c}, {inter}, {cic})")
    shapes = {"up_w": (c, 2 * c), "pw1_w": (c, inter), "pw2_w": (inter, c)}
    vecs = {"up_b": 2 * c, "pw1_b": inter, "pw2_b": c}
    if fold:
        shapes["ic_w"], vecs["ic_b"] = (7 * c, cic), cic
    for name, shape in shapes.items():
        _build.require(kp[name], name, dtype=torch.bfloat16, shape=shape)
    for name, n in vecs.items():
        _build.require(kp[name], name, dtype=torch.float32, shape=(n,))
    if x.data_ptr() % 16:  # rows are read 16 bytes at a time
        x = x.clone()
    ptrs = {}
    for name in list(shapes) + list(vecs) + ["dw", "dw_b", "ln_w", "ln_b", "gamma"]:
        ptrs[name] = kp[name].data_ptr()
        if ptrs[name] % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = x.device
    grid, bm, ks, offsets, total, n_cnt = _launch_plan(
        persistent._index(dev), b, t, c, inter, cic, x.dtype == torch.float32)
    work = torch.empty(total, dtype=torch.uint8, device=dev)
    ptrs.update({name: None if off is None else work.data_ptr() + off
                 for name, off in offsets.items()})
    out = torch.empty((2 * b * t, cic if fold else c), dtype=x.dtype, device=dev)
    args = UpArgs(x=x.data_ptr(), x_bf16=_build.is_bf16(x), **ptrs, out=out.data_ptr(),
                  out_bf16=_build.is_bf16(out), cnt=persistent.counters(dev, n_cnt).data_ptr(),
                  stamps=_build.ptr(stamps),
                  B=b, T=t, C=c, I=inter, Cic=cic or 0,
                  **{f"bm{i}": v for i, v in enumerate(bm)},
                  **{f"ks{i}": v for i, v in enumerate(ks)})
    _build.check(_build.lib().qt_up_persistent(ctypes.addressof(args), grid, SMEM,
                                               _build.stream()), "qt_up_persistent")
    return out.reshape(b, 2 * t, -1)


def upsample_stage_kernel(kp: dict, x: torch.Tensor, *,
                          stamps: torch.Tensor | None = None) -> torch.Tensor:
    """Run K5 on a CUDA tensor x [B, T, C]: bf16 weights take the
    persistent tensor-core kernel (one launch), fp32 weights the exact
    fp32 launch sequence. `stamps`, a measurement (no model path passes
    it): an int64 CUDA tensor into which a bf16 call writes the device's
    clock (ns) at its start and after each of its phases (stage_phases)."""
    global launches
    b, t, c = x.shape
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    for name in ("dw_b", "ln_w", "ln_b", "gamma"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(c,))
    _build.require(kp["dw"], "dw", dtype=torch.float32, shape=(7, c))
    if kp["up_w"].dtype == torch.bfloat16:
        out = _stage_persistent(kp, x, stamps)
        with _build.COUNT_LOCK:
            launches += 1
        return out
    rows2 = b * 2 * t
    f32 = dict(dtype=torch.float32, device=x.device)
    g = "qt_up_gemm"
    z = torch.empty((b * t, 2 * c), **f32)  # == [B*2T, C], phases interleaved
    _build.gemm(g, x.reshape(b * t, c), kp["up_w"], z, bias=kp["up_b"])
    z = z.view(rows2, c)
    h = torch.empty((rows2, c), **f32)
    rc = _build.lib().qt_up_dwconv_layernorm(
        z.data_ptr(), kp["dw"].data_ptr(), kp["dw_b"].data_ptr(),
        kp["ln_w"].data_ptr(), kp["ln_b"].data_ptr(), h.data_ptr(),
        rows2, 2 * t, c, 7, 1e-6, _build.stream(),
    )
    _build.check(rc, "qt_up_dwconv_layernorm")
    a = torch.empty((rows2, kp["pw1_w"].shape[1]), **f32)
    _build.gemm(g, h, kp["pw1_w"], a, bias=kp["pw1_b"], gelu=True)
    fold = "ic_w" in kp
    o = torch.empty((rows2, c), dtype=torch.float32 if fold else x.dtype, device=x.device)
    _build.gemm(g, a, kp["pw2_w"], o, bias=kp["pw2_b"], res=z, scale=kp["gamma"])
    if fold:
        out = torch.empty((rows2, kp["ic_w"].shape[1]), dtype=x.dtype, device=x.device)
        _build.gemm(g, o, kp["ic_w"], out, seq=2 * t, taps=7, bias=kp["ic_b"])
        o = out
    with _build.COUNT_LOCK:
        launches += 1
    return o.reshape(b, 2 * t, -1)


def upsample_stage_fused(kp: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return upsample_stage_kernel(kp, x.contiguous())
    return upsample_stage_plain(kp, x)
