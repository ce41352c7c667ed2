"""The `w8r` product (qwen3_tts_tpu_torch/ops/linear.py::_w8r_linear) under
threads, on the CPU: it reads and writes no process-wide precision flag, so
two threads running linears while a third watches
torch.backends.cuda.matmul.allow_tf32 (set True, as a user may) never see
it change, and every result equals the single-thread one bit for bit. And
the product itself: fp32 x splits into three bf16-valued parts that sum to
it exactly, and the product matches a float64 reference to fp32 rounding
(rel RMS <= 1e-6) for bf16 and fp32 x."""

import sys
import threading

import numpy as np
import torch

from qwen3_tts_tpu_torch.ops import linear as L

torch.set_num_threads(1)


def w8r_tree(rng, o: int, k: int) -> dict:
    return {"w8r": torch.from_numpy(rng.integers(-128, 128, (o, k)).astype(np.int8)),
            "s": torch.from_numpy(rng.uniform(1e-3, 2e-2, (1, o)).astype(np.float32)),
            "m": torch.from_numpy(rng.normal(0, 1e-3, (1, o)).astype(np.float32))}


def reference(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x.double() @ p["w8r"].double().t()
    return y * p["s"][0].double() + p["m"][0].double() * x.double().sum(-1, keepdim=True)


def test_w8r_product_is_exact_fp32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((4, 96)) * np.exp(rng.uniform(-8, 8, (4, 96))))
                         .astype(np.float32))
    parts = L._bf16_parts(x)
    assert parts.shape == (3, 4, 96) and torch.equal(parts, parts.bfloat16().float())
    assert torch.equal(parts.sum(0), x)
    p = w8r_tree(rng, 40, 96)
    for dt in (torch.float32, torch.bfloat16):
        xs = x.to(dt)
        got = L.linear(p, xs[:, None])  # [M, 1, K], as a lockstep step hands it
        assert got.dtype == dt and got.shape == (4, 1, 40)
        ref = reference(p, xs)[:, None]
        if dt == torch.float32:
            err = ((got.double() - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt()
            assert float(err) <= 1e-6
        else:  # the fp32 result, rounded once to bf16
            assert torch.equal(got, L._w8r_linear(p, xs[:, None].float()).bfloat16())


def test_w8r_linear_leaves_the_tf32_flag_alone_under_threads():
    rng = np.random.default_rng(1)
    trees = [w8r_tree(rng, 64, 128), w8r_tree(rng, 32, 128)]
    xs = [torch.from_numpy(rng.standard_normal((8, 1, 128)).astype(np.float32)).to(dt)
          for dt in (torch.float32, torch.bfloat16)]
    want = [[L.linear(p, x) for x in xs] for p in trees]
    flag = torch.backends.cuda.matmul.allow_tf32
    interval = sys.getswitchinterval()
    seen, bad, errors = set(), [], []
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            seen.add(torch.backends.cuda.matmul.allow_tf32)

    def work(i: int):
        try:
            for _ in range(200):
                for j, x in enumerate(xs):
                    if not torch.equal(L.linear(trees[i], x), want[i][j]):
                        bad.append((i, j))
        except Exception as e:  # surfaced below
            errors.append(e)

    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    try:
        watcher = threading.Thread(target=watch)
        watcher.start()
        workers = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
        stop.set()
        watcher.join(timeout=10)
        assert not any(t.is_alive() for t in workers + [watcher])
        after = torch.backends.cuda.matmul.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert not errors, errors
    assert not bad, bad[:5]
    assert seen == {True} and after
