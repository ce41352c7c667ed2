"""The launch plan of the persistent megakernels K1 and K2
(qwen3_tts_tpu_torch/ops/cuda/persistent.py), on the CPU: the row partition
of every GEMV phase, the shared-memory layout and the attention split, at
the 0.6B and 1.7B shapes and at the tiny test widths, for grids of 1 to 132
blocks. The kernel (csrc/w8a8.cuh::qt_span) computes the same spans; these
checks are what its bulk copies and its barriers rely on."""

from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.ops.cuda import persistent as ps
from qwen3_tts_tpu_torch.testing import tiny_talker_config

CONFIGS = {
    "0.6B": Qwen3TTSConfig.standard(),
    "1.7B": Qwen3TTSConfig.standard_1_7b(),
    "tiny": tiny_talker_config(),
    "tiny-256": tiny_talker_config(hidden_size=256, num_attention_heads=4,
                                   num_key_value_heads=2, head_dim=64, intermediate_size=512,
                                   mrope_section=None),
}
# the dynamic shared memory an H100 block may opt into (227 KB), less 1 KB
# for the kernels' static shared memory; the card's own query holds the
# launch to its limit
H100_SMEM = 227 * 1024 - 1024


def _kernels(cfg):
    """(label, GEMV phases [(K, O)], hc, nkv, group, hd) of K1 and K2."""
    out = []
    for label, c in (("talker", cfg), ("cp", cfg.code_predictor_config)):
        phases = ps.layer_phases(c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
                                 c.head_dim, c.intermediate_size)
        out.append((label, phases + [(c.hidden_size, c.vocab_size)], c.hidden_size,
                    c.num_key_value_heads, c.num_attention_heads // c.num_key_value_heads,
                    c.head_dim))
    return out


def test_every_row_owned_once_in_even_aligned_spans():
    for cfg in CONFIGS.values():
        for _, phases, *_ in _kernels(cfg):
            for k, o in phases:
                for grid in range(1, 133):
                    spans = [ps.row_span(o, grid, b) for b in range(grid)]
                    assert spans[0][0] == 0 and spans[-1][1] == o
                    assert all(spans[b][1] == spans[b + 1][0] for b in range(grid - 1))
                    sizes = [hi - lo for lo, hi in spans]
                    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
                    # a bulk copy moves whole rows of K int8 bytes: 16-byte
                    # offsets and lengths
                    assert all(lo * k % 16 == 0 and (hi - lo) * k % 16 == 0
                               for lo, hi in spans)


def test_shared_memory_plan_fits_and_holds_every_tile():
    for name, cfg in CONFIGS.items():
        for label, phases, hc, nkv, group, hd in _kernels(cfg):
            for grid in (1, 7, 64, 132):
                nch, slots = (1, 16) if label == "cp" else ps.attention_split(260, nkv, grid)
                plan = ps.make_plan(phases, grid, hc, group, hd, nch, slots)
                assert plan.smem <= H100_SMEM and (plan.nch, plan.S) == (nch, slots)
                offsets = [0, plan.buf, plan.xf, plan.lnf, plan.xq, plan.xrow, plan.att]
                assert all(x % ps.ALIGN == 0 for x in offsets) and offsets == sorted(offsets)
                kmax = max(k for k, _ in phases)
                assert plan.lnf - plan.xf >= 4 * kmax and plan.xq - plan.lnf >= 4 * kmax
                assert plan.xrow - plan.xq >= kmax
                assert plan.att - plan.xrow >= 4 * hc
                assert plan.smem - plan.att == 4 * ps.att_floats(group, hd, slots)
                assert plan.xf == 2 * plan.buf <= 2 * ps.BUF_CAP
                for k, o in phases:
                    rows = plan.buf // k
                    assert rows >= 1 and rows * k <= plan.buf  # a tile is whole rows
                    if grid == 132 and name == "0.6B":
                        assert -(-o // grid) <= rows  # every span is one tile


def test_attention_split_covers_the_ring():
    for grid in (1, 8, 64, 132):
        for nkv in (1, 2, 8):
            for c_len in (1, 3, 16, 17, 96, 260, 641, 4096):
                nch, slots = ps.attention_split(c_len, nkv, grid)
                assert nch >= 1 and 1 <= slots <= ps.MAX_SLOTS
                assert nch * slots >= c_len  # every slot in a chunk
                if grid >= nkv * 16 and c_len >= 256:
                    assert nch >= 16  # the chunks spread over the blocks


def test_plan_at_0_6b_matches_the_kernel_design():
    cfg = CONFIGS["0.6B"]
    (_, tp, hc, nkv, group, hd), (_, cpp, chc, _, cgroup, chd) = _kernels(cfg)
    nch, slots = ps.attention_split(260, nkv, 132)
    assert (nch, slots) == (16, 17)
    plan = ps.make_plan(tp, 132, hc, group, hd, nch, slots)
    # the gate/up span, 47 rows of 1024 bytes, sizes both buffers
    assert plan.buf == 47 * 1024 and plan.smem < 160 * 1024
    cplan = ps.make_plan(cpp, 132, chc, cgroup, chd, 1, cfg.code_predictor_config.num_code_groups)
    assert cplan.buf == 47 * 1024 and cplan.S == 16
