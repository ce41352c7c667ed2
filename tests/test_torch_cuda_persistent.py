"""The persistent megakernels K1 (talker step) and K2 (code-predictor frame)
on the card (marked `cuda`; skipped where there is no GPU, since a CUDA
kernel has no CPU mode): at the tiny test width, where most GEMV phases have
fewer rows than the grid has blocks, against their plain versions; two runs
bit for bit alike; and one device kernel per call. Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_persistent.py -q

Tolerances as in test_torch_cuda_megakernels.py: rel RMS 1e-2 in fp32 (both
sides do the same W8A8 arithmetic with exact integer dots; fp32 sums in
another order can put one activation a quantization step apart), codes
equal except at near ties."""

import pytest
import torch

from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import talker as talker_mod
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
from qwen3_tts_tpu_torch.ops.cuda import persistent as ps
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk
from qwen3_tts_tpu_torch.testing import (
    random_host_cp_params,
    random_host_talker_params,
    tiny_talker_config,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
TINY = tiny_talker_config()  # hidden 64, 4 x 16 heads: fewer rows than blocks
WIDE = tiny_talker_config(  # ring of 96 slots in 6 chunks per kv head
    hidden_size=256, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    intermediate_size=512, mrope_section=None,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


def talker_inputs(cfg, dev, c_len=96, position=130, window=60):
    tkp = to_torch(tmk.build_talker_kernel_params(random_host_talker_params(cfg, 3), cfg), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    nl, kvw = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim
    slots = torch.arange(c_len, device=dev)
    cache = {"k2": torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3,
             "v2": torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3,
             "pos": torch.where(slots < position % c_len, slots + c_len, slots)}
    embed = torch.randn(1, 1, cfg.hidden_size, generator=g, device=dev) * 0.5
    cos, sin = talker_mod.rope_cos_sin(cfg, torch.full((1, 1), position, device=dev))
    args = (torch.tensor(position, device=dev), torch.tensor(position - window, device=dev),
            cos[0, 0].contiguous(), sin[0, 0].contiguous(), cfg)
    return tkp, cache, embed, args


def cp_inputs(cfg, dev):
    cc = cfg.code_predictor_config
    kp = to_torch(cpk.build_cp_kernel_params(random_host_cp_params(cfg, 4), cc), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = torch.randn(1, 1, cfg.hidden_size, generator=g, device=dev)
    code0 = torch.randn(1, 1, cfg.hidden_size, generator=g, device=dev) * 0.5
    seen = torch.rand(cc.num_code_groups - 1, cc.vocab_size, generator=g, device=dev) < 0.3
    return kp, hidden, code0, seen, torch.tensor([987654321], device=dev)


def test_persistent_kernels_at_the_tiny_width(dev):
    tkp, cache, embed, args = talker_inputs(TINY, dev)
    plan = ps.talker_plan(TINY, 96, dev)
    assert TINY.hidden_size < plan.grid  # the o / down phases leave blocks without rows
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    hk, lk, ck = tmk.talker_step_kernel(tkp, embed, ck, *args)
    hp, lp, cp = tmk.talker_step_plain(tkp, embed, cp, *args)
    torch.cuda.synchronize()
    assert rel_rms(hk, hp) <= 1e-2 and rel_rms(lk, lp) <= 1e-2
    slot = 130 % 96
    for name in ("k2", "v2"):
        assert rel_rms(ck[name][:, slot], cp[name][:, slot]) <= 1e-2
    assert torch.equal(ck["pos"], cp["pos"])

    cc = TINY.code_predictor_config
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    kp, hidden, code0, seen, seed = cp_inputs(TINY, dev)
    for temperature in (0.0, 0.85):
        lk, lp = torch.empty(ng, v, device=dev), torch.empty(ng, v, device=dev)
        codes, esum, sk = cpk.predict_frame_kernel(kp, hidden, code0, seed, temperature,
                                                   seen.clone(), cc, logits_out=lk)
        _, pesum, sp = cpk.predict_frame_plain(kp, hidden, code0, seed, temperature,
                                               seen.clone(), cc, forced_codes=codes,
                                               logits_out=lp)
        torch.cuda.synchronize()
        assert rel_rms(lk, lp) <= 1e-2
        noise = temperature * gs.gumbel_noise(seed, ng, v) if temperature > 0 else 0.0
        for k in range(ng):
            score = lp[k] / torch.where(seen[k], 1.05, 1.0) + (noise[k] if temperature else 0)
            pick, want = int(torch.argmax(score)), int(codes[k])
            assert pick == want or float(score[pick] - score[want]) <= 1e-2 * float(
                score.abs().max())
        assert torch.equal(sk, sp) and torch.equal(esum, pesum)


def test_two_runs_are_bit_identical(dev):
    for cfg in (TINY, WIDE):
        tkp, cache, embed, args = talker_inputs(cfg, dev)
        outs = []
        for run in range(2):
            c = {k: v.clone() for k, v in cache.items()}
            h, lg, c = tmk.talker_step_kernel(tkp, embed, c, *args)
            outs.append((h, lg, c["k2"], c["v2"], c["pos"]))
            if run == 0:  # a ring of another length between them: another plan
                tkp2, cache2, embed2, args2 = talker_inputs(cfg, dev, c_len=300, position=310)
                tmk.talker_step_kernel(tkp2, embed2, cache2, *args2)
        assert all(torch.equal(a, b) for a, b in zip(*outs))

        cc = cfg.code_predictor_config
        kp, hidden, code0, seen, seed = cp_inputs(cfg, dev)
        outs = []
        for _ in range(2):
            lg = torch.empty(cc.num_code_groups - 1, cc.vocab_size, device=dev)
            codes, esum, s = cpk.predict_frame_kernel(kp, hidden, code0, seed, 0.85,
                                                      seen.clone(), cc, logits_out=lg)
            outs.append((codes, esum, s, lg))
        assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_one_device_kernel_per_call(dev):
    tkp, cache, embed, args = talker_inputs(TINY, dev)
    cc = TINY.code_predictor_config  # no projection: the kernel reads the rows as they are
    kp, hidden, code0, seen, seed = cp_inputs(TINY, dev)
    tmk.talker_step_kernel(tkp, embed, cache, *args)  # plans, counters: first-call set-up
    cpk.predict_frame_kernel(kp, hidden, code0, seed, 0.85, seen, cc)
    torch.cuda.synchronize()
    for name, call in (("talker", lambda: tmk.talker_step_kernel(tkp, embed, cache, *args)),
                       ("cp", lambda: cpk.predict_frame_kernel(kp, hidden, code0, seed, 0.85,
                                                               seen, cc))):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 3 and len(set(kernels)) == 1, (name, kernels)
