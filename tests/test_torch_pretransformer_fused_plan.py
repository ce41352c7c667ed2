"""K4a with bf16 weights runs K4's persistent kernel (csrc/pretransformer.cu,
qt_pt_persistent_kernel), its GEMM phases reading the per-head arrays in
place (qt_pt_w_col, mirrored by pretransformer_kernel.weight_at). Checked
on the CPU: at the 0.6B, tiny and card-test widths, for the row counts the
pipeline hands K4 and 1-132 blocks, every output element of every phase is
taken by exactly one block and every weight element read by exactly one
column item, an item never straddles two heads and its groups of 8 columns
lie side by side; each item's per-head address holds the value K4's fused
layout holds at that column (both layouts made by the JAX package's
build_pretransformer_*_params_device); a head_dim that is not a multiple of 16 raises; and K4a's bf16
plain version against the JAX package's pre_transformer_fused at
compute_dtype bf16 in interpret mode: rel RMS <= 1e-5 (fp32 sums in
another order), while the same weights widened to fp32, which round
nothing, land >= 1e-3 away.

An interpret-mode call returns before its host callbacks finish; it is
waited for at once, so no other JAX dispatch races those callbacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import TokenizerDecoderConfig as JaxDecoderConfig
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops.pallas.pretransformer_kernel import (
    build_pretransformer_kernel_params_device,
    build_pretransformer_packed_params_device,
    pre_transformer_fused as j_pre_transformer_fused,
)
from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
from qwen3_tts_tpu_torch.testing import tiny_decoder_config

torch.set_num_threads(1)
REL_RMS = 1e-5
# hd 16: 1/sqrt(hd) is a power of two, so JAX's scale after the score
# product and the kernel's scale on q before its rounding agree exactly
TINY = dict(codebook_size=32, codebook_dim=16, num_quantizers=4, num_semantic_quantizers=1,
            latent_dim=32, decoder_dim=48, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, head_dim=16, intermediate_size=48,
            upsample_rates=(4, 3), upsampling_ratios=(2, 2))
SHAPES = {
    "0.6B": TokenizerDecoderConfig(),
    "tiny": TokenizerDecoderConfig(**TINY),
    "card-test 64": TokenizerDecoderConfig(latent_dim=96, hidden_size=256,
                                           intermediate_size=192, head_dim=64,
                                           num_attention_heads=4, num_hidden_layers=2),
    "card-test 128": TokenizerDecoderConfig(latent_dim=96, hidden_size=256,
                                            intermediate_size=192, head_dim=128,
                                            num_attention_heads=2, num_hidden_layers=2),
}
ROWS = ((1, 26), (1, 110), (2, 110), (3, 110), (2, 19))
GRIDS = range(1, 133)


def dims(c):
    return (c.latent_dim, c.hidden_size, c.num_attention_heads * c.head_dim,
            c.intermediate_size, c.num_hidden_layers)


def phases(c):
    """The distinct GEMM phases (every layer repeats its four): (K, N,
    paired, weight tensors)."""
    lat, hid, d, inter, nl = dims(c)
    gemms = ptk.persistent_gemms(lat, hid, d, inter, nl)
    return list(dict.fromkeys(
        (k, n, p, w) for (k, n, p), w in zip(gemms, ptk.persistent_weights(nl, True))))


def layer_sizes(c):
    """Elements of each tensor's layer slice, K4a's per-head layout."""
    lat, hid, d, inter, _ = dims(c)
    return {"wi": lat * hid, "wq": hid * d, "wk": hid * d, "wv": hid * d, "wo": d * hid,
            "wg": hid * inter, "wu": hid * inter, "wd": inter * hid, "wout": hid * lat}


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_output_and_weight_is_taken_once(name):
    c = SHAPES[name]
    lat, hid, d, inter, _ = dims(c)
    hd = c.head_dim
    area = ptk.persistent_layout(lat, hid, d, hd, inter, heads=True)[3]
    sizes = layer_sizes(c)
    for k, n, paired, names in phases(c):
        nit = ptk.column_items(n, paired)
        read = {t: np.zeros(sizes[t], np.int64) for t in names}
        for nt in range(nit):
            cols = ptk.item_columns(n, paired, nt, weights=True)
            if len(names) == 3:  # q/k/v: one section, one head an item
                assert len({col // hd for col in cols}) == 1, (name, n, nt)
            for g in range(0, len(cols), 8):  # a group of 8 is one 16-byte copy a row
                for kk in range(k):
                    t0, o0 = ptk.weight_at(names, kk, cols[g], k, n, hd)
                    for j in range(8):
                        assert ptk.weight_at(names, kk, cols[g + j], k, n, hd) == (t0, o0 + j)
                    read[t0][o0:o0 + 8] += 1
        assert all((r == 1).all() for r in read.values()), (name, names)
        for b, t in ROWS:
            m = b * t
            bm = ptk.item_rows(k, area)
            count = np.zeros((m, n // 2 if paired else n), np.int64)
            items = ptk.gemm_items(m, n, paired, bm)
            for it in range(items):
                m0 = (it // nit) * bm
                count[m0:min(m0 + bm, m), ptk.item_columns(n, paired, it % nit)] += 1
            assert (count == 1).all(), (name, b, t, n)
            for grid in GRIDS:
                taken = np.concatenate([np.asarray(ptk.block_items(items, grid, blk), np.int64)
                                        for blk in range(grid)])
                assert np.array_equal(np.sort(taken), np.arange(items)), (name, grid)


def dense_pt() -> dict:
    """JAX random init of the tiny pre-transformer as numpy, LayerScale at
    0.5 so every branch shows in the output."""
    p = jax.tree.map(np.asarray,
                     jvoc.init_vocoder_params(JaxDecoderConfig(**TINY), jax.random.PRNGKey(0)))
    pt = p["pre_transformer"]
    for name in ("self_attn_layer_scale", "mlp_layer_scale"):
        pt["layers"][name]["w"] = np.full_like(pt["layers"][name]["w"], 0.5)
    return pt


def test_per_head_addresses_hold_k4s_values():
    cfg = JaxDecoderConfig(**TINY)
    c = SHAPES["tiny"]
    pt = jax.tree.map(jnp.asarray, dense_pt())
    heads = {k: np.asarray(v) for k, v in build_pretransformer_kernel_params_device(
        pt, cfg, weight_dtype=jnp.float32).items()}
    wide = {k: np.asarray(v) for k, v in build_pretransformer_packed_params_device(
        pt, cfg, weight_dtype=jnp.float32).items()}
    k4 = ptk.build_pretransformer_params(to_torch(jax.tree.map(np.asarray, pt)), c,
                                         torch.float32)
    lat, hid, d, inter, nl = dims(c)
    hd, hdp = c.head_dim, 2 * c.head_dim

    def k4_value(names, l, kk, col):
        """(K4's fused [K, N] layout (the port's), the JAX head-packed arrays
        (each head's q/k/v columns and o rows padded from hd to 2 hd))."""
        if names in (("wi",), ("wout",)):
            return k4[names[0]][kk, col].item(), wide[names[0]][kk, col]
        if names == ("wo",):  # rows (head, e)
            return k4["wo"][l, kk, col].item(), wide["wo"][l, kk // hd, kk % hd, col]
        if names == ("wd",):
            return k4["wd"][l, kk, col].item(), wide["wd"][l, kk, col]
        if len(names) == 2:  # gate | up
            return (k4["wgu"][l, kk, col].item(),
                    wide["wg" if col < inter else "wu"][l, kk, col % inter])
        s, cc = divmod(col, d)
        return (k4["wqkv"][l, kk, col].item(),
                wide[("wq", "wk", "wv")[s]][l, kk, (cc // hd) * hdp + cc % hd])

    gemms = ptk.persistent_gemms(lat, hid, d, inter, nl)
    for gi, ((k, n, paired), names) in enumerate(zip(gemms, ptk.persistent_weights(nl, True))):
        l = (gi - 1) // 4
        for nt in range(ptk.column_items(n, paired)):
            for col in ptk.item_columns(n, paired, nt, weights=True):
                for kk in range(k):
                    t, off = ptk.weight_at(names, kk, col, k, n, hd)
                    w = heads[t] if t in ("wi", "wout") else heads[t][l]
                    got = w.reshape(-1)[off]
                    want_port, want_jax = k4_value(names, l, kk, col)
                    assert got == want_port == want_jax, (gi, names, nt, col, kk)


def test_head_dim_must_be_a_multiple_of_16():
    for hd in (16, 32, 64, 128):
        ptk.persistent_layout(512, 512, 1024, hd, 1024, heads=True)
    for hd in (8, 24, 40):
        with pytest.raises(ValueError, match="multiple of 16"):
            ptk.persistent_layout(512, 512, 960, hd, 1024, heads=True)
        ptk.persistent_layout(512, 512, 960, hd, 1024)  # K4's fused layout takes it
    tiny = tiny_decoder_config()  # head_dim 8
    with pytest.raises(ValueError, match="multiple of 16"):
        ptk.persistent_layout(*dims(tiny)[:3], tiny.head_dim, dims(tiny)[3], heads=True)


def rel_rms(got, ref) -> float:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def test_bf16_plain_matches_the_pallas_kernel_in_interpret_mode():
    cfg, c = JaxDecoderConfig(**TINY), SHAPES["tiny"]
    pt = dense_pt()
    b, t = 2, 13
    x = np.random.default_rng(t).standard_normal((b, t, c.latent_dim)).astype(np.float32)
    kp_j = build_pretransformer_kernel_params_device(
        jax.tree.map(jnp.asarray, pt), cfg, weight_dtype=jnp.bfloat16)
    ref = jax.block_until_ready(j_pre_transformer_fused(
        kp_j, jnp.asarray(x), nl=c.num_hidden_layers, nh=c.num_attention_heads,
        hd=c.head_dim, eps=c.rms_norm_eps, rope_theta=c.rope_theta,
        compute_dtype=jnp.bfloat16, interpret=True,
    ))
    kp = ptk.build_pretransformer_fused_params(to_torch(pt), c, torch.bfloat16)
    kw = dict(nh=c.num_attention_heads, hd=c.head_dim, eps=c.rms_norm_eps)
    assert rel_rms(ptk.pre_transformer_fused_plain(kp, torch.from_numpy(x), **kw),
                   ref) <= REL_RMS
    widened = {k: v.float() for k, v in kp.items()}
    assert rel_rms(ptk.pre_transformer_fused_plain(widened, torch.from_numpy(x), **kw),
                   ref) >= 1e-3
