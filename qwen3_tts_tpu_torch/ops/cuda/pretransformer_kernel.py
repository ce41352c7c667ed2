"""K4 and K4a: the vocoder's causal pre-transformer (CUDA kernels
csrc/pretransformer.cu).

K4 is the counterpart of qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::
pre_transformer_packed, K4a of pre_transformer_fused: x [B, T, latent] ->
[B, T, latent] through input_proj, nl layers of RMSNorm -> RoPE attention
with LayerScale -> RMSNorm -> SwiGLU with LayerScale, the final norm and
output_proj. K4 reads fused q/k/v and gate/up weights; K4a the per-head
layout of build_pretransformer_fused_params (the JAX package's arrays).
With bf16 weights (the pipeline's) K4 and K4a are each one persistent
cooperative launch of the same kernel on the tensor cores (bf16 operands,
fp32 sums and residual stream, as the JAX kernel at compute_dtype bf16),
K4a reading its per-head arrays in place; with fp32 weights each is an
exact fp32 launch sequence.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, persistent
from .persistent import block_items  # noqa: F401  (K4's dealing, as K5's)

launches = 0  # K4 calls (kernel launches or sequences) since the last reset
fused_launches = 0  # K4a calls (kernel launches or sequences) since the last reset

# The persistent bf16 K4 (csrc/pretransformer.cu, qt_pt_persistent_kernel)
PT_WARPS = persistent.PK_NT // 32
PT_QROWS = 64  # query rows of an attention item
SMEM_OPTIN = 232448  # the most dynamic shared memory a block may opt into on sm_90


class PtArgs(ctypes.Structure):
    """Mirror of QtPtArgs in csrc/pretransformer.cu."""

    _fields_ = _build.struct_fields(
        "x:p x_bf16:i wi:p wqkv:p wo:p wgu:p wd:p wout:p wk:p wv:p wu:p bi:p ln1:p lsa:p "
        "ln2:p lsm:p "
        "fnorm:p bout:p inv_freq:p h:p qkv:p o:p mm:p out:p out_bf16:i B:i T:i lat:i hid:i "
        "nh:i hd:i inter:i nl:i eps:f scale:f wbuf:i work:i area:i kc:i")


def persistent_gemms(lat: int, hid: int, d: int, inter: int, nl: int):
    """(K, N, paired) of the persistent K4's GEMM phases in launch order:
    the input projection, per layer qkv, o, gate/up (paired: each item
    takes 8 gate and the same 8 up columns), down; the output projection."""
    layer = [(hid, 3 * d, False), (d, hid, False), (hid, 2 * inter, True), (inter, hid, False)]
    return [(lat, hid, False)] + layer * nl + [(hid, lat, False)]


def persistent_weights(nl: int, heads: bool) -> list[tuple[str, ...]]:
    """The weight tensors each GEMM phase of persistent_gemms reads: K4's
    fused q/k/v and gate/up matrices, or (heads) K4a's per-head tensors."""
    layer = [("wq", "wk", "wv") if heads else ("wqkv",), ("wo",),
             ("wg", "wu") if heads else ("wgu",), ("wd",)]
    return [("wi",)] + layer * nl + [("wout",)]


def weight_at(names: tuple[str, ...], k: int, col: int, kdim: int, n: int,
              hd: int) -> tuple[str, int]:
    """Mirror of qt_pt_w_col: (tensor, element offset in the phase's layer
    slice of it) of the weight at row k, GEMM column col of a phase of
    depth kdim and width n that reads `names` (persistent_weights). One
    [kdim, n] matrix; or q, k, v sections of d = n / 3 columns, column c of
    a section at (c // hd) * kdim * hd + k * hd + c % hd of [nh, kdim, hd];
    or gate and up halves, [kdim, n / 2] each."""
    if len(names) == 1:
        return names[0], k * n + col
    if len(names) == 2:
        half = n // 2
        return names[col // half], k * half + col % half
    s, c = divmod(col, n // 3)
    return names[s], (c // hd) * kdim * hd + k * hd + c % hd


def column_items(n: int, paired: bool) -> int:
    return n // 16 if paired else -(-n // 16)


def item_columns(n: int, paired: bool, nt: int, weights: bool = False) -> list[int]:
    """Output columns of column item nt (qt_pt_col), those past n dropped;
    a paired item gives the mm columns it writes, or with `weights` the
    GEMM columns whose weights it reads (8 gate, then the same 8 up)."""
    if paired:
        cols = [nt * 8 + j for j in range(8)]
        return cols + [n // 2 + c for c in cols] if weights else cols
    return [c for c in range(nt * 16, nt * 16 + 16) if c < n]


def item_rows(k: int, area: int) -> int:
    """Rows of a GEMM item of depth k (qt_pt_bm): 128 where their bf16 copy
    fits the work area, else 64."""
    return 128 if 128 * (k + 8) * 2 <= area else 64


def gemm_items(m: int, n: int, paired: bool, bm: int) -> int:
    return -(-m // bm) * column_items(n, paired)


def attention_items(b: int, t: int, nh: int) -> int:
    """(sequence, head, PT_QROWS query rows) items of an attention phase."""
    return b * nh * -(-t // PT_QROWS)


def persistent_layout(lat: int, hid: int, d: int, hd: int, inter: int,
                      heads: bool = False) -> tuple[int, int, int, int, int]:
    """(dynamic shared memory, bytes of one weight buffer, offset and bytes
    of the work area, keys staged per chunk): two [kmax, 16] bf16 weight
    slices, then one area that holds an item's 64 bf16 input rows of the
    greatest depth and 128 of the least (item_rows), later its
    partial sums (16 warps x 16 x 16 fp32), or attention's PT_QROWS query
    rows and kc key and value rows (fp32, hd + 1 a row). Raises where a
    width does not fit the kernel; K4a's per-head layout (`heads`) also
    needs hd % 16 == 0, so that no 16-column item straddles two heads."""
    kmax = max(lat, hid, d, inter)
    if any(k % 16 for k in (lat, hid, d, inter)) or hid > 1024 or hd % 2 or hd > 128:
        raise ValueError(f"persistent K4: widths {lat, hid, d, inter} must be multiples of 16, "
                         f"hidden <= 1024, head_dim {hd} even and <= 128")
    if heads and hd % 16:
        raise ValueError(f"persistent K4a: head_dim {hd} must be a multiple of 16")
    wbuf = kmax * 16 * 2
    kmin = min(lat, hid, d, inter)
    area = max(64 * (kmax + 8) * 2, 128 * (kmin + 8) * 2, PT_WARPS * 256 * 4,
               (PT_QROWS + 64) * (hd + 1) * 4)
    kc = min(128, ((area // 4) // (hd + 1) - PT_QROWS) // 2 // 32 * 32)
    smem = 2 * wbuf + area
    if smem > SMEM_OPTIN:
        raise ValueError(f"persistent K4 needs {smem} bytes of shared memory")
    return smem, wbuf, 2 * wbuf, area, kc


@functools.lru_cache(maxsize=None)
def _plan(device: int, lat: int, hid: int, d: int, hd: int, inter: int,
          heads: bool) -> tuple[int, ...]:
    smem, wbuf, work, area, kc = persistent_layout(lat, hid, d, hd, inter, heads)
    return persistent._grid("qt_pt_persistent_grid", device, smem), smem, wbuf, work, area, kc


def _inv_freq(dim: int, base: float) -> np.ndarray:
    return (
        1.0 / np.power(base, np.arange(0, dim, 2, dtype=np.float32) / dim)
    ).astype(np.float32)


def build_pretransformer_params(pt: dict, cfg, dtype=torch.bfloat16) -> dict:
    """Kernel layout from the dense pre_transformer tree (torch tensors,
    models/vocoder.py layout): fused q/k/v and gate/up weights, every
    weight pre-transposed to [in, out]; norms, LayerScales and biases fp32.
    Attention and MLP must be bias-free (the reference vocoder layout)."""
    L = pt["layers"]
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        if "b" in L[name]:
            raise ValueError(f"pre-transformer kernel requires bias-free {name}")

    def wt(t):  # [.., out, in] -> [.., in, out]
        return t.transpose(-1, -2).to(dtype).contiguous()

    def f32(t):
        return t.float().contiguous()

    dev = pt["norm"]["w"].device
    return {
        "wi": wt(pt["input_proj"]["w"]),
        "bi": f32(pt["input_proj"]["b"]),
        "ln1": f32(L["input_layernorm"]["w"]),
        "wqkv": wt(torch.cat([L["q_proj"]["w"], L["k_proj"]["w"], L["v_proj"]["w"]], 1)),
        "wo": wt(L["o_proj"]["w"]),
        "lsa": f32(L["self_attn_layer_scale"]["w"]),
        "ln2": f32(L["post_attention_layernorm"]["w"]),
        "wgu": wt(torch.cat([L["gate_proj"]["w"], L["up_proj"]["w"]], 1)),
        "wd": wt(L["down_proj"]["w"]),
        "lsm": f32(L["mlp_layer_scale"]["w"]),
        "fnorm": f32(pt["norm"]["w"]),
        "wout": wt(pt["output_proj"]["w"]),
        "bout": f32(pt["output_proj"]["b"]),
        "inv_freq": torch.from_numpy(
            _inv_freq(cfg.head_dim, cfg.rope_theta)
        ).to(dev),
    }


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) * w


def pre_transformer_plain(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                          eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (fp32 arithmetic). With bf16
    weights it rounds where the JAX kernel (_kernel_packed) rounds to its
    compute dtype and where the kernel feeds its tensor cores: every
    product's operands (the normed rows, q, k, v, the softmax weights, the
    attention output, SiLU(gate) * up) go to bf16, the rotate-half term of
    RoPE is taken from bf16 q / k (JAX forms it as a product with a
    permutation matrix), and q carries the 1/sqrt(hd) scale; sums, the
    residual stream and the softmax stay fp32."""
    b, t, lat = x.shape
    nl = kp["wqkv"].shape[0]
    d = nh * hd
    inter = kp["wd"].shape[1]
    rounds = kp["wqkv"].dtype == torch.bfloat16

    def op(z):
        return z.bfloat16().float() if rounds else z

    h = op(x.float()) @ kp["wi"].float() + kp["bi"]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * kp["inv_freq"]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scale = 1.0 / hd ** 0.5

    def rope(z):  # [b, nh, t, hd]
        z1, z2 = z[..., : hd // 2], z[..., hd // 2:]
        return z * cos + op(torch.cat([-z2, z1], -1)) * sin

    for l in range(nl):
        xn = op(_rms(h, kp["ln1"][l], eps))
        qkv = xn @ kp["wqkv"][l].float()
        q, k, v = (
            qkv[..., i * d:(i + 1) * d].reshape(b, t, nh, hd).transpose(1, 2)
            for i in range(3)
        )
        if rounds:
            s = op(rope(q) * scale) @ op(rope(k)).transpose(-1, -2)
            v = op(v)
        else:
            s = (rope(q) @ rope(k).transpose(-1, -2)) * scale
        p = op(torch.softmax(s.masked_fill(~causal, -1e30), dim=-1))
        o = op((p @ v).transpose(1, 2).reshape(b, t, d))
        h = h + kp["lsa"][l] * (o @ kp["wo"][l].float())
        gu = op(_rms(h, kp["ln2"][l], eps)) @ kp["wgu"][l].float()
        m = op(torch.nn.functional.silu(gu[..., :inter]) * gu[..., inter:])
        h = h + kp["lsm"][l] * (m @ kp["wd"][l].float())
    out = op(_rms(h, kp["fnorm"], eps)) @ kp["wout"].float() + kp["bout"]
    return out.to(x.dtype)


def _pre_transformer_persistent(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                                eps: float) -> torch.Tensor:
    """bf16 weights: one cooperative launch of qt_pt_persistent_kernel, over
    K4's fused layout or K4a's per-head one ("wq" in kp), read in place."""
    b, t, lat = x.shape
    heads = "wq" in kp
    nl, hid = kp["ln1"].shape[0], kp["wi"].shape[1]
    d, inter = nh * hd, kp["wd"].shape[1]
    if heads:
        mats = tuple((n, (nl, nh, hid, hd)) for n in ("wq", "wk", "wv")) + (
            ("wo", (nl, nh, hd, hid)), ("wg", (nl, hid, inter)), ("wu", (nl, hid, inter)))
    else:
        mats = (("wqkv", (nl, hid, 3 * d)), ("wo", (nl, d, hid)), ("wgu", (nl, hid, 2 * inter)))
    for name, shape in (("wi", (lat, hid)), *mats, ("wd", (nl, inter, hid)),
                        ("wout", (hid, lat))):
        _build.require(kp[name], name, dtype=torch.bfloat16, shape=shape)
    for name, n in (("bi", hid), ("fnorm", hid), ("bout", lat)):
        _build.require(kp[name], name, dtype=torch.float32, shape=(1, n) if heads else (n,))
    if x.data_ptr() % 16:  # rows are read 16 bytes at a time
        x = x.clone()
    grid, smem, wbuf, work, area, kc = _plan(persistent._index(x.device), lat, hid, d, hd, inter,
                                             heads)
    rows = b * t
    h = torch.empty((rows, hid), dtype=torch.float32, device=x.device)
    qkv = torch.empty((rows, 3 * d), dtype=torch.float32, device=x.device)
    o = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
    mm = torch.empty((rows, inter), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((rows, lat), dtype=x.dtype, device=x.device)
    names = ["wi", "wo", "wd", "wout", "bi", "ln1", "lsa", "ln2", "lsm", "fnorm", "bout",
             "inv_freq"]
    names += ["wq", "wk", "wv", "wg", "wu"] if heads else ["wqkv", "wgu"]
    w = {k: kp[k].data_ptr() for k in names}
    if heads:  # K4a: wqkv is wq and wgu is wg (QtPtArgs)
        w["wqkv"], w["wgu"] = w.pop("wq"), w.pop("wg")
    args = PtArgs(x=x.data_ptr(), x_bf16=_build.is_bf16(x), **w, h=h.data_ptr(),
                  qkv=qkv.data_ptr(), o=o.data_ptr(), mm=mm.data_ptr(), out=out.data_ptr(),
                  out_bf16=_build.is_bf16(out), B=b, T=t, lat=lat, hid=hid, nh=nh, hd=hd,
                  inter=inter, nl=nl, eps=eps, scale=1.0 / hd ** 0.5, wbuf=wbuf, work=work,
                  area=area, kc=kc)
    _build.check(_build.lib().qt_pt_persistent(ctypes.addressof(args), grid, smem,
                                               _build.stream()), "qt_pt_persistent")
    return out.reshape(b, t, lat)


def pre_transformer_kernel(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                           eps: float) -> torch.Tensor:
    """Run K4 on a CUDA tensor x [B, T, latent]: bf16 weights take the
    persistent tensor-core kernel (one launch), fp32 weights the exact
    fp32 launch sequence."""
    global launches
    b, t, lat = x.shape
    nl, hid, d3 = kp["wqkv"].shape
    d = nh * hd
    inter = kp["wd"].shape[1]
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    for name in ("ln1", "lsa", "ln2", "lsm"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(nl, hid))
    _build.require(kp["inv_freq"], "inv_freq", dtype=torch.float32, shape=(hd // 2,))
    if kp["wqkv"].dtype == torch.bfloat16:
        out = _pre_transformer_persistent(kp, x, nh=nh, hd=hd, eps=eps)
        with _build.COUNT_LOCK:
            launches += 1
        return out
    if d3 != 3 * d or hd % 32 or hd > 128:
        raise ValueError(f"pre-transformer kernel: nh={nh}, hd={hd} do not fit "
                         f"wqkv {tuple(kp['wqkv'].shape)} (hd % 32 == 0, <= 128)")
    rows = b * t
    lib, st = _build.lib(), _build.stream()
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((rows, hid), **f32)
    xn = torch.empty((rows, hid), **f32)
    qkv = torch.empty((rows, 3 * d), **f32)
    o = torch.empty((rows, d), **f32)
    gu = torch.empty((rows, 2 * inter), **f32)
    mm = torch.empty((rows, inter), **f32)
    out = torch.empty((rows, lat), dtype=x.dtype, device=x.device)
    g = "qt_pt_gemm"

    def rms(src, w):
        _build.check(lib.qt_pt_rmsnorm(src.data_ptr(), w.data_ptr(), xn.data_ptr(),
                                       rows, hid, eps, st), "qt_pt_rmsnorm")

    _build.gemm(g, x.reshape(rows, lat), kp["wi"], h, bias=kp["bi"])
    for l in range(nl):
        rms(h, kp["ln1"][l])
        _build.gemm(g, xn, kp["wqkv"][l], qkv)
        _build.check(lib.qt_pt_rope(qkv.data_ptr(), kp["inv_freq"].data_ptr(),
                                    rows, t, nh, hd, st), "qt_pt_rope")
        _build.check(lib.qt_pt_attention(qkv.data_ptr(), o.data_ptr(), b, t, nh, hd,
                                         1.0 / hd ** 0.5, st), "qt_pt_attention")
        _build.gemm(g, o, kp["wo"][l], h, res=h, scale=kp["lsa"][l])
        rms(h, kp["ln2"][l])
        _build.gemm(g, xn, kp["wgu"][l], gu)
        _build.check(lib.qt_pt_silu_mul(gu.data_ptr(), mm.data_ptr(), rows, inter, st),
                     "qt_pt_silu_mul")
        _build.gemm(g, mm, kp["wd"][l], h, res=h, scale=kp["lsm"][l])
    rms(h, kp["fnorm"])
    _build.gemm(g, xn, kp["wout"], out, bias=kp["bout"])
    with _build.COUNT_LOCK:
        launches += 1
    return out.reshape(b, t, lat)


def pre_transformer_packed(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                           eps: float) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return pre_transformer_kernel(kp, x.contiguous(), nh=nh, hd=hd, eps=eps)
    return pre_transformer_plain(kp, x, nh=nh, hd=hd, eps=eps)


# ---------------------------------------------------------------------------
# K4a: the per-head layout
# ---------------------------------------------------------------------------


def build_pretransformer_fused_params(pt: dict, cfg, dtype=torch.bfloat16) -> dict:
    """K4a's layout from the dense pre_transformer tree (torch tensors), the
    arrays of the JAX package's build_pretransformer_kernel_params_device:
    wq/wk/wv [nl, nh, H, hd] and wo [nl, nh, hd, H] per head, wg/wu [nl, H,
    I] and wd [nl, I, H] pre-transposed, wi / wout pre-transposed, in
    `dtype`; norms and LayerScales [nl, 1, H], biases [1, n], fp32; rotm
    [hd, hd] with x @ rotm == rotate_half(x). Plus inv_freq [hd/2] (the JAX
    call takes rope_theta instead). Attention and MLP must be bias-free."""
    L = pt["layers"]
    nh, hd, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        if "b" in L[name]:
            raise ValueError(f"pre-transformer kernel requires bias-free {name}")

    def heads_in(w):  # [nl, nh*hd, H] -> [nl, nh, H, hd]
        return w.reshape(w.shape[0], nh, hd, h).permute(0, 1, 3, 2).to(dtype).contiguous()

    def f32row(w):  # [nl, H] -> [nl, 1, H]
        return w[:, None, :].float().contiguous()

    def wt(w):  # [.., out, in] -> [.., in, out]
        return w.transpose(-1, -2).to(dtype).contiguous()

    dev = pt["norm"]["w"].device
    half = hd // 2
    rotm = torch.zeros(hd, hd, device=dev)
    idx = torch.arange(half, device=dev)
    rotm[idx + half, idx] = -1.0
    rotm[idx, idx + half] = 1.0
    wo = L["o_proj"]["w"]
    return {
        "wi": wt(pt["input_proj"]["w"]),
        "bi": pt["input_proj"]["b"][None].float().contiguous(),
        "ln1": f32row(L["input_layernorm"]["w"]),
        "wq": heads_in(L["q_proj"]["w"]),
        "wk": heads_in(L["k_proj"]["w"]),
        "wv": heads_in(L["v_proj"]["w"]),
        "rotm": rotm,
        "wo": wo.reshape(wo.shape[0], h, nh, hd).permute(0, 2, 3, 1).to(dtype).contiguous(),
        "lsa": f32row(L["self_attn_layer_scale"]["w"]),
        "ln2": f32row(L["post_attention_layernorm"]["w"]),
        "wg": wt(L["gate_proj"]["w"]),
        "wu": wt(L["up_proj"]["w"]),
        "wd": wt(L["down_proj"]["w"]),
        "lsm": f32row(L["mlp_layer_scale"]["w"]),
        "fnorm": pt["norm"]["w"][None].float().contiguous(),
        "wout": wt(pt["output_proj"]["w"]),
        "bout": pt["output_proj"]["b"][None].float().contiguous(),
        "inv_freq": torch.from_numpy(_inv_freq(hd, cfg.rope_theta)).to(dev),
    }


def pre_transformer_fused_plain(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                                eps: float) -> torch.Tensor:
    """Plain PyTorch version (fp32 arithmetic), head by head as the TPU
    kernel computes it, rotate-half as the product with rotm. With bf16
    weights it rounds where pre_transformer_plain does (K4's rounding
    points, which the persistent kernel shares): every product's operands
    to bf16, rotate-half from bf16 q / k, and q carrying the 1/sqrt(hd)
    scale before its rounding."""
    b, t, _ = x.shape
    nl = kp["wq"].shape[0]
    rounds = kp["wq"].dtype == torch.bfloat16

    def op(z):
        return z.bfloat16().float() if rounds else z

    h = op(x.float()) @ kp["wi"].float() + kp["bi"]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * kp["inv_freq"]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    rotm = kp["rotm"].float()
    scale = 1.0 / hd ** 0.5
    for l in range(nl):
        xin = op(_rms(h, kp["ln1"][l], eps))
        acc = torch.zeros_like(h)
        for j in range(nh):
            qh = xin @ kp["wq"][l, j].float()  # [b, t, hd]
            kh = xin @ kp["wk"][l, j].float()
            vh = op(xin @ kp["wv"][l, j].float())
            qh = qh * cos + (op(qh) @ rotm) * sin
            kh = kh * cos + (op(kh) @ rotm) * sin
            if rounds:
                s = op(qh * scale) @ op(kh).transpose(-1, -2)
            else:
                s = (qh @ kh.transpose(-1, -2)) * scale
            p = op(torch.softmax(s.masked_fill(~causal, -1e30), dim=-1))
            acc = acc + op(p @ vh) @ kp["wo"][l, j].float()
        h = h + kp["lsa"][l] * acc
        x2 = op(_rms(h, kp["ln2"][l], eps))
        m = op(torch.nn.functional.silu(x2 @ kp["wg"][l].float()) * (x2 @ kp["wu"][l].float()))
        h = h + kp["lsm"][l] * (m @ kp["wd"][l].float())
    out = op(_rms(h, kp["fnorm"], eps)) @ kp["wout"].float() + kp["bout"]
    return out.to(x.dtype)


def pre_transformer_fused_kernel(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                                 eps: float) -> torch.Tensor:
    """Run K4a on a CUDA tensor x [B, T, latent]. bf16 weights take K4's
    persistent tensor-core kernel (one launch), its GEMM phases reading
    the per-head arrays in place (hd % 16 == 0); it rounds where K4 does,
    q carrying the 1/sqrt(hd) scale before its bf16 rounding, where JAX's
    K4a scales the fp32 scores after the product: the two agree exactly
    where 1/sqrt(hd) is a power of two (hd = 16, 64) and differ by one bf16
    rounding of q at hd = 128. fp32 weights take the exact fp32 launch
    sequence around qt_head_attention_kernel (hd 64 or 128)."""
    global fused_launches
    b, t, lat = x.shape
    nl, nh_w, hid, hd_w = kp["wq"].shape
    inter = kp["wg"].shape[2]
    if (nh_w, hd_w) != (nh, hd):
        raise ValueError(f"K4a: nh={nh}, hd={hd} do not fit wq {tuple(kp['wq'].shape)}")
    _build.require(x, "x", dtype=(torch.float32, torch.bfloat16))
    _build.require(kp["wq"], "wq", dtype=(torch.float32, torch.bfloat16))
    wdt = kp["wq"].dtype
    for name, shape in (("wk", kp["wq"].shape), ("wv", kp["wq"].shape),
                        ("wo", (nl, nh, hd, hid)), ("wg", (nl, hid, inter)),
                        ("wu", (nl, hid, inter)), ("wd", (nl, inter, hid))):
        _build.require(kp[name], name, dtype=wdt, shape=shape)
    for name in ("ln1", "lsa", "ln2", "lsm"):
        _build.require(kp[name], name, dtype=torch.float32, shape=(nl, 1, hid))
    _build.require(kp["inv_freq"], "inv_freq", dtype=torch.float32, shape=(hd // 2,))
    if wdt == torch.bfloat16:
        out = _pre_transformer_persistent(kp, x, nh=nh, hd=hd, eps=eps)
        with _build.COUNT_LOCK:
            fused_launches += 1
        return out
    if hd not in (64, 128):
        raise ValueError(f"K4a with fp32 weights: hd={hd} (hd 64 or 128)")
    rows = b * t
    lib, st = _build.lib(), _build.stream()
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((rows, hid), **f32)
    xn = torch.empty((rows, hid), **f32)
    o = torch.empty((rows, nh * hd), **f32)
    g = torch.empty((rows, inter), **f32)
    u = torch.empty((rows, inter), **f32)
    mm = torch.empty((rows, inter), **f32)
    out = torch.empty((rows, lat), dtype=x.dtype, device=x.device)
    scratch = None  # q/k/v of every (row, head) when they do not fit in shared memory
    if t > lib.qt_pt_head_store_rows(hd):
        scratch = torch.empty((b, nh, 3, t, hd + 1), **f32)
    gm = "qt_pt_gemm"

    def rms(src, w):
        _build.check(lib.qt_pt_rmsnorm(src.data_ptr(), w.data_ptr(), xn.data_ptr(),
                                       rows, hid, eps, st), "qt_pt_rmsnorm")

    _build.gemm(gm, x.reshape(rows, lat), kp["wi"], h, bias=kp["bi"].reshape(-1))
    for l in range(nl):
        rms(h, kp["ln1"][l])
        _build.check(lib.qt_pt_head_attention(
            xn.data_ptr(), kp["wq"][l].data_ptr(), kp["wk"][l].data_ptr(),
            kp["wv"][l].data_ptr(), kp["inv_freq"].data_ptr(), _build.ptr(scratch),
            o.data_ptr(), b, t, hid, nh, hd, 1.0 / hd ** 0.5, st), "qt_pt_head_attention")
        # o-projection: heads side by side, summed over in order by the GEMM's K loop
        _build.gemm(gm, o, kp["wo"][l].reshape(nh * hd, hid), h, res=h,
                    scale=kp["lsa"][l].reshape(-1))
        rms(h, kp["ln2"][l])
        _build.gemm(gm, xn, kp["wg"][l], g)
        _build.gemm(gm, xn, kp["wu"][l], u)
        _build.check(lib.qt_pt_silu_mul2(g.data_ptr(), u.data_ptr(), mm.data_ptr(),
                                         rows * inter, st), "qt_pt_silu_mul2")
        _build.gemm(gm, mm, kp["wd"][l], h, res=h, scale=kp["lsm"][l].reshape(-1))
    rms(h, kp["fnorm"].reshape(-1))
    _build.gemm(gm, xn, kp["wout"], out, bias=kp["bout"].reshape(-1))
    with _build.COUNT_LOCK:
        fused_launches += 1
    return out.reshape(b, t, lat)


def pre_transformer_fused(kp: dict, x: torch.Tensor, *, nh: int, hd: int,
                          eps: float) -> torch.Tensor:
    """K4a's entry point: the kernel for a CUDA tensor, the plain version for
    a CPU tensor; any other device raises."""
    if x.is_cuda:
        return pre_transformer_fused_kernel(kp, x.contiguous(), nh=nh, hd=hd, eps=eps)
    if x.device.type == "cpu":
        return pre_transformer_fused_plain(kp, x, nh=nh, hd=hd, eps=eps)
    raise ValueError(f"pre_transformer_fused: no kernel or plain version for {x.device}")
