"""K2g: the code predictor's Gumbel-argmax sampler (CUDA kernel
qt_sample_kernel in csrc/cp_frame.cu), and its test harness.

Counterpart of qwen3_tts_tpu/ops/pallas/cp_megakernel.py::_gumbel_pick and
gumbel_sample_kernel. K2 (ops/cuda/cp_megakernel.py) makes each draw of a
frame with the same device function, qt_gumbel_pick, so the formula this
harness draws with is the one the frame ships:

  bits = Philox4x32-10(key = seed, counter = (v // 4, row, 0, 0))[v % 4]
  u = ((bits >> 8) + 0.5) / 2^24,  g = -log(-log(u))
  code = argmax(temp > 0 ? lg + temp * g : lg)   (first index on ties)

`row` is the draw (the group index inside a frame). The plain version
computes the same bits with int64 tensor arithmetic, so kernel and plain
draw the same codes from the same seed.
"""

from __future__ import annotations

import torch

from . import _build

# launches of K2g's kernel since the last reset. K2 makes a frame's draws
# with the same device function inside its own launch, which counts here
# no launch.
launches = 0

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * a for 32-bit a, in int64 without
    overflow: a is split into 16-bit halves."""
    p1 = (a & 0xFFFF) * m
    p2 = (a >> 16) * m
    r = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (r >> 32), r & _MASK


def philox_words(seed: torch.Tensor, rows: int, vocab: int) -> torch.Tensor:
    """The 32-bit word for logit v of draw r, [rows, vocab] int64."""
    dev = seed.device
    v = torch.arange(vocab, device=dev)
    c0 = (v >> 2)[None, :].expand(rows, vocab)
    c1 = torch.arange(rows, device=dev)[:, None].expand(rows, vocab)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    s = seed.reshape(()).long()
    k0, k1 = s & _MASK, (s >> 32) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    words = torch.stack([c0, c1, c2, c3], dim=-1)
    return words.gather(-1, (v & 3)[None, :, None].expand(rows, vocab, 1))[..., 0]


def gumbel_noise(seed: torch.Tensor, rows: int, vocab: int) -> torch.Tensor:
    """g = -log(-log(u)) from the 24-bit uniforms, [rows, vocab] fp32."""
    u24 = (philox_words(seed, rows, vocab) >> 8).float()
    u = (u24 + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))


def gumbel_pick(lg: torch.Tensor, temperature: float, noise: torch.Tensor | None) -> torch.Tensor:
    """argmax of the Gumbel-perturbed scores (exact greedy at temperature 0,
    where `noise` may be None)."""
    score = lg + temperature * noise if temperature > 0 else lg
    return torch.argmax(score, dim=-1)


def gumbel_sample_plain(logits: torch.Tensor, seed: torch.Tensor, temperature: float,
                        n_draws: int) -> torch.Tensor:
    """Plain PyTorch version: n_draws codes [n] int64 from logits [V]."""
    v = logits.shape[-1]
    noise = gumbel_noise(seed, n_draws, v) if temperature > 0 else None
    return gumbel_pick(logits.float()[None, :].expand(n_draws, v), temperature, noise)


def gumbel_sample_kernel(logits: torch.Tensor, seed: torch.Tensor, temperature: float,
                         n_draws: int) -> torch.Tensor:
    """Launch the sampler kernel: one block per draw."""
    global launches
    v = logits.shape[-1]
    _build.require(logits, "logits", dtype=torch.float32, shape=(v,))
    _build.require(seed, "seed", dtype=torch.int64)
    codes = torch.empty(n_draws, dtype=torch.int64, device=logits.device)
    rc = _build.lib().qt_gumbel_sample(
        logits.data_ptr(), v, float(temperature), seed.data_ptr(), n_draws,
        codes.data_ptr(), _build.stream(),
    )
    _build.check(rc, "qt_gumbel_sample")
    launches += 1
    return codes


def gumbel_sample(logits: torch.Tensor, seed: torch.Tensor, temperature: float,
                  n_draws: int) -> torch.Tensor:
    """n_draws independent draws from fixed logits [V] with one seeded
    stream: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if logits.is_cuda:
        return gumbel_sample_kernel(logits.float().contiguous(), seed, temperature, n_draws)
    return gumbel_sample_plain(logits, seed, temperature, n_draws)
