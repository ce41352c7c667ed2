"""The plan of the persistent bf16 K4 (csrc/pretransformer.cu,
qt_pt_persistent_kernel), checked on the CPU as the card would run it: at
the 0.6B vocoder's widths and the tiny test widths, for 1-132 blocks and
the row counts the pipeline hands it (a 26-row stream window, a 110-row
generate window, batches of 110-row long-text windows), every output
element of every GEMM phase and every (sequence, head) of attention is
taken by exactly one block, each block's prefetched weight slice is the
one its first item of the next phase reads, the barriers number 1 + 5 nl,
and the shared-memory layout fits."""

import numpy as np
import pytest

from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.ops.cuda import pretransformer_kernel as ptk
from qwen3_tts_tpu_torch.testing import tiny_decoder_config

SHAPES = {
    "0.6B": TokenizerDecoderConfig(),
    "tiny": tiny_decoder_config(),
    "card-test": TokenizerDecoderConfig(
        latent_dim=96, hidden_size=128, intermediate_size=192, head_dim=64,
        num_attention_heads=2, num_hidden_layers=2),
}
ROWS = ((1, 26), (1, 110), (2, 110), (3, 110), (2, 19))
GRIDS = range(1, 133)


def dims(c):
    return (c.latent_dim, c.hidden_size, c.num_attention_heads * c.head_dim,
            c.intermediate_size, c.num_hidden_layers)


@pytest.mark.parametrize("names", [("0.6B",), ("tiny", "card-test")])
def test_every_output_is_computed_once(names):
    for name in names:
        check_cover(name)


def area(c):
    return ptk.persistent_layout(*dims(c)[:3], c.head_dim, dims(c)[3])[3]


def check_cover(name):
    c = SHAPES[name]
    lat, hid, d, inter, nl = dims(c)
    for b, t in ROWS:
        m = b * t
        for k, n, paired in ptk.persistent_gemms(lat, hid, d, inter, nl):
            assert k % 16 == 0 and n % 8 == 0
            bm = ptk.item_rows(k, area(c))
            width = n // 2 if paired else n  # a paired phase writes SiLU(g) * u
            count = np.zeros((m, width), np.int64)
            items = ptk.gemm_items(m, n, paired, bm)
            nit = ptk.column_items(n, paired)
            for it in range(items):
                m0 = (it // nit) * bm
                cols = ptk.item_columns(n, paired, it % nit)
                count[m0:min(m0 + bm, m), cols] += 1
            assert (count == 1).all(), (name, b, t, k, n)
            for grid in GRIDS:
                taken = np.concatenate(
                    [np.asarray(ptk.block_items(items, grid, blk), np.int64)
                     for blk in range(grid)])
                assert np.array_equal(np.sort(taken), np.arange(items))
        nh, seen = c.num_attention_heads, np.zeros((b, c.num_attention_heads, t), np.int64)
        items = ptk.attention_items(b, t, nh)
        nq = items // (b * nh)
        for it in range(items):  # (sequence, head, PT_QROWS query rows)
            q0 = (it % nq) * ptk.PT_QROWS
            seen[it // (nh * nq), (it // nq) % nh, q0:q0 + ptk.PT_QROWS] += 1
        assert (seen == 1).all()
        for grid in (1, 7, 16, 132):
            taken = sorted(i for blk in range(grid) for i in ptk.block_items(items, grid, blk))
            assert taken == list(range(items))


def test_prefetch_and_barriers():
    """A block requests, during its last item of one GEMM phase, the slice
    of column item (block % column items) of the next; its first item
    there is item `block`, whose column item is the same. The call has
    2 + 4 nl GEMM phases and nl attention phases, a barrier between each
    two: 1 + 5 nl, 41 at the 0.6B depth."""
    for c in SHAPES.values():
        lat, hid, d, inter, nl = dims(c)
        gemms = ptk.persistent_gemms(lat, hid, d, inter, nl)
        assert len(gemms) == 2 + 4 * nl  # barriers: between each two of the phases
        assert len(gemms) + nl - 1 == 1 + 5 * nl
        for b, t in ROWS:
            for k, n, paired in gemms:
                nit = ptk.column_items(n, paired)
                items = ptk.gemm_items(b * t, n, paired, ptk.item_rows(k, area(c)))
                for grid in GRIDS:
                    for blk in range(min(grid, items)):
                        first = next(iter(ptk.block_items(items, grid, blk)))
                        assert first % nit == blk % nit
    assert 1 + 5 * TokenizerDecoderConfig().num_hidden_layers == 41


def test_shared_memory_layout_fits():
    for c in SHAPES.values():
        lat, hid, d, inter, _ = dims(c)
        hd = c.head_dim
        smem, wbuf, work, room, kc = ptk.persistent_layout(lat, hid, d, hd, inter)
        kmax = max(lat, hid, d, inter)
        assert work == 2 * wbuf and wbuf == kmax * 16 * 2 and smem == work + room
        for k in (lat, hid, d, inter):  # an item's input rows
            assert ptk.item_rows(k, room) * (k + 8) * 2 <= room
        assert room >= ptk.PT_WARPS * 16 * 16 * 4  # its partial sums
        assert 32 <= kc <= 128 and kc % 32 == 0
        assert room >= (ptk.PT_QROWS + 2 * kc) * (hd + 1) * 4  # attention
        assert smem <= ptk.SMEM_OPTIN
    assert ptk.persistent_layout(1024, 512, 1024, 64, 1024)[0] == 198656
    for bad in ((1024, 520, 1024, 64, 1024), (1024, 2048, 1024, 64, 1024),
                (1024, 512, 1024, 256, 1024)):
        with pytest.raises(ValueError):
            ptk.persistent_layout(*bad)
