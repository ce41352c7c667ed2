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
draw the same codes from the same seed. The kernel makes the four words of
a counter in one Philox call, for the four logits 4c .. 4c + 3 that one
thread owns; philox4 and gumbel_pick_grouped mirror that order on the CPU.
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


def _rounds(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10's ten rounds on int64 tensors holding 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_words(seed: torch.Tensor, rows: int, vocab: int) -> torch.Tensor:
    """The 32-bit word for logit v of draw r, [rows, vocab] int64."""
    dev = seed.device
    v = torch.arange(vocab, device=dev)
    c0 = (v >> 2)[None, :].expand(rows, vocab)
    c1 = torch.arange(rows, device=dev)[:, None].expand(rows, vocab)
    s = seed.reshape(()).long()
    words = torch.stack(_rounds(c0, c1, torch.zeros_like(c0), torch.zeros_like(c0),
                                s & _MASK, (s >> 32) & _MASK), dim=-1)
    return words.gather(-1, (v & 3)[None, :, None].expand(rows, vocab, 1))[..., 0]


def philox_words_streams(seeds: torch.Tensor, steps: torch.Tensor, rows: int,
                         vocab: int) -> torch.Tensor:
    """philox_words widened to B streams, [B, rows, vocab] int64: stream b's
    key is seeds[b] and its counter (v // 4, r, steps[b], 0), so its words
    depend on its own seed and step only. At step 0 they are
    philox_words(seeds[b], rows, vocab)'s. One Philox call per counter gives
    the words of four logits, as in the kernel."""
    dev = seeds.device
    b, groups = seeds.shape[0], -(-vocab // 4)
    c0 = torch.arange(groups, device=dev)[None, None, :].expand(b, rows, groups)
    c1 = torch.arange(rows, device=dev)[None, :, None].expand(b, rows, groups)
    c2 = steps.long()[:, None, None].expand(b, rows, groups)
    s = seeds.long()[:, None, None]
    words = torch.stack(_rounds(c0, c1, c2, torch.zeros_like(c0), s & _MASK,
                                (s >> 32) & _MASK), dim=-1)
    return words.reshape(b, rows, 4 * groups)[..., :vocab]


def philox4(seed: int, c0: int, c1: int) -> tuple[int, int, int, int]:
    """One Philox4x32-10 call in Python integers: the four words of counter
    (c0, c1, 0, 0) under the 64-bit key `seed` (qt_philox4)."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    c2 = c3 = 0
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & _MASK, (p0 >> 32) ^ c3 ^ k1, p0 & _MASK
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def gumbel_pick_grouped(lg: torch.Tensor, seed: int, temperature: float, row: int, *,
                        threads: int = 256, seen: torch.Tensor | None = None,
                        penalty: float = 1.0) -> int:
    """CPU mirror of qt_gumbel_pick's order for one draw from lg [V]: thread
    i owns the groups c = i, i + threads, ... of logits 4c .. 4c + 3, takes
    their four words from one philox4 call and keeps its best score,
    compared in increasing v; the threads' bests then meet, the first
    index winning a tie. Seen logits are divided by `penalty` first."""
    lg = lg.float().cpu()
    v = lg.shape[0]
    groups = -(-v // 4)
    if seen is not None:
        lg = lg / torch.where(seen.cpu().bool(), penalty, 1.0)
    score = lg
    if temperature > 0:
        words = torch.tensor([philox4(seed, c, row) for c in range(groups)],
                             dtype=torch.int64).reshape(-1)[:v]
        u = ((words >> 8).float() + 0.5) * (1.0 / 16777216.0)
        score = lg + temperature * -torch.log(-torch.log(u))
    score = score.tolist()
    best = []  # (score, index) of each thread
    for i in range(threads):
        bv, bi = float("-inf"), None
        for c in range(i, groups, threads):
            for j in range(4 * c, min(4 * c + 4, v)):
                if bi is None or score[j] > bv:
                    bv, bi = score[j], j
        if bi is not None:
            best.append((bv, bi))
    return min(best, key=lambda b: (-b[0], b[1]))[1]


def _gumbel(words: torch.Tensor) -> torch.Tensor:
    """g = -log(-log(u)) from the words' 24-bit uniforms, fp32."""
    u = ((words >> 8).float() + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))


def gumbel_noise(seed: torch.Tensor, rows: int, vocab: int) -> torch.Tensor:
    """g = -log(-log(u)) from the 24-bit uniforms, [rows, vocab] fp32."""
    return _gumbel(philox_words(seed, rows, vocab))


def gumbel_noise_streams(seeds: torch.Tensor, steps: torch.Tensor, rows: int,
                         vocab: int) -> torch.Tensor:
    """The same noise for B streams from philox_words_streams, [B, rows,
    vocab] fp32: the batched serving path's draws."""
    return _gumbel(philox_words_streams(seeds, steps, rows, vocab))


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
    with _build.COUNT_LOCK:
        launches += 1
    return codes


def gumbel_sample(logits: torch.Tensor, seed: torch.Tensor, temperature: float,
                  n_draws: int) -> torch.Tensor:
    """n_draws independent draws from fixed logits [V] with one seeded
    stream: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if logits.is_cuda:
        return gumbel_sample_kernel(logits.float().contiguous(), seed, temperature, n_draws)
    return gumbel_sample_plain(logits, seed, temperature, n_draws)
