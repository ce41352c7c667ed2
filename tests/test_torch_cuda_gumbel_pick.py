"""K2g's pick (csrc/cp_frame.cu, qt_gumbel_pick: a thread owns groups of four
logits, one Philox call, one 16-byte load of logits each) against its plain
version on the card (marked `cuda`; skipped where there is no GPU, since a
CUDA kernel has no CPU mode): bit for bit at a vocabulary that is not a
multiple of 4 (the tail group read one logit at a time), from a row 4 bytes
off 16-byte alignment (every group read one logit at a time), and greedy on
tied logits (the first index wins). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_gumbel_pick.py -q"""

import pytest
import torch

from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("v", [2047, 2050])
def test_pick_at_a_vocabulary_not_a_multiple_of_4(dev, v):
    g = torch.Generator(device=dev).manual_seed(v)
    lg = torch.randn(v, generator=g, device=dev) * 2.0
    for seed in (5, -(2 ** 62) - 3):
        s = torch.tensor([seed], device=dev)
        for temp in (0.85, 0.0):
            got = gs.gumbel_sample_kernel(lg, s, temp, 256)
            assert torch.equal(got, gs.gumbel_sample_plain(lg, s, temp, 256)), (seed, temp)
    # the last logits can win: the tail group is read
    lg[-1] = 100.0
    assert torch.equal(gs.gumbel_sample_kernel(lg, torch.tensor([5], device=dev), 0.85, 8),
                       torch.full((8,), v - 1, device=dev))


def test_pick_from_an_unaligned_row(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn(2049, generator=g, device=dev) * 2.0
    lg = buf[1:]
    assert lg.data_ptr() % 16 == 4
    s = torch.tensor([9], device=dev)
    for temp in (0.85, 0.0):
        got = gs.gumbel_sample(lg, s, temp, 512)
        assert torch.equal(got, gs.gumbel_sample_plain(lg, s, temp, 512)), temp


def test_greedy_pick_on_ties_takes_the_first_index(dev):
    s = torch.tensor([3], device=dev)
    for v, top in ((2048, (5, 700, 2046)), (2050, (2049, 1)), (2048, (3, 2)), (2047, (2046,))):
        lg = torch.zeros(v, device=dev)
        lg[list(top)] = 4.0
        got = gs.gumbel_sample_kernel(lg, s, 0.0, 4)
        assert torch.equal(got, torch.full((4,), min(top), device=dev)), (v, top)
        assert torch.equal(got, gs.gumbel_sample_plain(lg, s, 0.0, 4))
    lg = torch.randint(0, 3, (2048,), device=dev).float()  # many equal logits
    for temp in (0.0, 0.85):
        assert torch.equal(gs.gumbel_sample_kernel(lg, s, temp, 64),
                           gs.gumbel_sample_plain(lg, s, temp, 64)), temp
