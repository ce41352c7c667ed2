"""K2g's grouping (csrc/cp_frame.cu, qt_gumbel_pick), checked on the CPU:
one Philox4x32-10 call per counter c gives the four words of logits
4c .. 4c + 3, the words the plain version takes one logit at a time; and a
pick made in the kernel's order (a thread owns whole groups of four, one
Philox call each, compares its scores in increasing v, the threads' bests
meet with the first index winning a tie) draws exactly the plain version's
codes, with V a multiple of 4 or not, on tied logits, greedy, and with the
repetition penalty."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs

torch.set_num_threads(1)
# 64-bit keys with their high bits set, as int64 (the device seed's type)
SEEDS = (0, 20240607, 2 ** 63 - 1, -1, -(2 ** 62) - 12345, 0x923456789ABCDEF0 - 2 ** 64)


def test_one_philox_call_gives_the_four_words_of_its_counter():
    # Random123's known answer for key 0, counter 0
    assert gs.philox4(0, 0, 0) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    v = 2050
    for seed in SEEDS:
        words = gs.philox_words(torch.tensor(seed), 15, v)
        for row in (0, 3, 14):
            got = [w for c in range(-(-v // 4)) for w in gs.philox4(seed, c, row)][:v]
            assert got == words[row].tolist(), (seed, row)


def logits(v: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(v) * 2.0).astype(np.float32))


@pytest.mark.parametrize("v", [2048, 2047, 2050])
def test_grouped_pick_draws_the_plain_codes(v):
    lg = logits(v, v)
    for seed in SEEDS[1:4]:
        plain = gs.gumbel_sample_plain(lg, torch.tensor(seed), 0.85, 4)
        for threads in (256, 512):  # K2g's blocks, K2's
            got = [gs.gumbel_pick_grouped(lg, seed, 0.85, r, threads=threads) for r in range(4)]
            assert got == plain.tolist(), (seed, threads)
    greedy = gs.gumbel_sample_plain(lg, torch.tensor(7), 0.0, 1)
    assert gs.gumbel_pick_grouped(lg, 7, 0.0, 0) == int(greedy[0]) == int(torch.argmax(lg))
    # the repetition penalty divides the seen logits first
    seen = torch.from_numpy(np.random.default_rng(1).random(v) < 0.3)
    noise = gs.gumbel_noise(torch.tensor(SEEDS[2]), 2, v)
    want = gs.gumbel_pick(lg / torch.where(seen, 1.05, 1.0), 0.85, noise[1])
    assert gs.gumbel_pick_grouped(lg, SEEDS[2], 0.85, 1, seen=seen, penalty=1.05) == int(want)


def test_grouped_pick_takes_the_first_index_on_ties():
    v = 2050
    lg = torch.zeros(v)
    for top in ((5, 700, 2046), (2049, 1), (2048, 2049), (3, 2)):
        lg.zero_()
        lg[list(top)] = 4.0
        assert gs.gumbel_pick_grouped(lg, 3, 0.0, 0) == min(top)
        assert int(gs.gumbel_sample_plain(lg, torch.tensor(3), 0.0, 1)[0]) == min(top)
    # scores tied across threads and inside a group: equal logits, a few
    # distinct values, greedy and sampled
    lg = torch.from_numpy(np.random.default_rng(2).integers(0, 3, v).astype(np.float32))
    for temp in (0.0, 0.85):
        plain = gs.gumbel_sample_plain(lg, torch.tensor(11), temp, 3).tolist()
        assert [gs.gumbel_pick_grouped(lg, 11, temp, r) for r in range(3)] == plain
