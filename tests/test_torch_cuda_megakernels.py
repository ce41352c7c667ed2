"""K1 (talker step), K2 (code-predictor frame) and K2g (Gumbel sampler)
against their plain PyTorch versions on the card, at a small width (marked
`cuda`; skipped where there is no GPU, since a CUDA kernel has no CPU
mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_megakernels.py -q

Tolerances: logits and hidden states rel RMS 1e-2 in fp32. Both sides do
the same W8A8 arithmetic with exact integer dots, but their fp32 sums run
in another order, so an activation sitting on a rounding boundary can
quantize one step apart, which moves a whole GEMV output by ~1e-3
relative; codes must agree except at near ties (score gap within 1e-2 of
the largest score). K2g draws the same codes as its plain version (same
Philox bits, same formula)."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as cpk
from qwen3_tts_tpu_torch.ops.cuda import gumbel_sampler as gs
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as tmk
from qwen3_tts_tpu_torch.ops.rope import inv_freq
from qwen3_tts_tpu_torch.testing import (
    random_host_cp_params,
    random_host_talker_params,
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
CFG = tiny_talker_config(
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


def picks_agree(codes, logits, seen, penalty, temp_noise=None):
    """Each group's pick from `logits` is `codes`' code, or within a near tie."""
    for k in range(len(codes)):
        score = logits[k] / torch.where(seen[k], penalty, 1.0) if seen is not None else logits[k]
        if temp_noise is not None:
            score = score + temp_noise[k]
        pick, want = int(torch.argmax(score)), int(codes[k])
        if pick != want:
            assert float(score[pick] - score[want]) <= 1e-2 * float(score.abs().max()), k


def test_talker_step_kernel(dev):
    tkp = to_torch(tmk.build_talker_kernel_params(random_host_talker_params(CFG, 3), CFG), dev)
    c_len, position = 96, 130  # wrapped ring (slot 34) with a trimmed window
    g = torch.Generator(device=dev).manual_seed(0)
    nl, kvw = CFG.num_hidden_layers, CFG.num_key_value_heads * CFG.head_dim
    slots = torch.arange(c_len, device=dev)
    pos = torch.where(slots < position % c_len, slots + c_len, slots)
    cache = {"k2": torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3,
             "v2": torch.randn(nl, c_len, kvw, generator=g, device=dev) * 0.3, "pos": pos}
    embed = torch.randn(1, 1, CFG.hidden_size, generator=g, device=dev) * 0.5
    ang = position * torch.from_numpy(inv_freq(CFG.head_dim, CFG.rope_theta)).to(dev)
    cos, sin = torch.cat([ang.cos()] * 2), torch.cat([ang.sin()] * 2)
    args = (embed, torch.tensor(position, device=dev), torch.tensor(position - 60, device=dev),
            cos, sin, CFG)
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    before = tmk.launches
    hk, lk, ck = tmk.talker_step(tkp, args[0], ck, *args[1:])
    assert tmk.launches == before + 1
    hp, lp, cp = tmk.talker_step_plain(tkp, args[0], cp, *args[1:])
    torch.cuda.synchronize()
    assert rel_rms(hk, hp) <= 1e-2 and rel_rms(lk, lp) <= 1e-2
    slot = position % c_len
    for name in ("k2", "v2"):
        assert rel_rms(ck[name][:, slot], cp[name][:, slot]) <= 1e-2
        other = torch.ones(c_len, dtype=torch.bool, device=dev)
        other[slot] = False
        assert torch.equal(ck[name][:, other], cache[name][:, other])
    assert torch.equal(ck["pos"], cp["pos"]) and int(ck["pos"][slot]) == position


def test_cp_frame_kernel(dev):
    cfg = tiny_talker_config(hidden_size=128)
    cc = cfg.code_predictor_config
    ng, v = cc.num_code_groups - 1, cc.vocab_size
    kp = to_torch(cpk.build_cp_kernel_params(random_host_cp_params(cfg, 4), cc), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = torch.randn(1, 1, 128, generator=g, device=dev)
    code0 = torch.randn(1, 1, 128, generator=g, device=dev) * 0.5
    seen = torch.rand(ng, v, generator=g, device=dev) < 0.3
    seed = torch.tensor([987654321], device=dev)
    for temperature in (0.0, 0.85):
        lk = torch.empty(ng, v, device=dev)
        sk = seen.clone()
        before = (cpk.launches, gs.launches)
        codes, esum, sk = cpk.predict_frame(kp, hidden, code0, seed, temperature, sk, cc,
                                            logits_out=lk)
        assert (cpk.launches, gs.launches) == (before[0] + 1, before[1] + ng)
        lp = torch.empty(ng, v, device=dev)
        sp = seen.clone()
        _, pesum, sp = cpk.predict_frame_plain(kp, hidden, code0, seed, temperature, sp, cc,
                                               forced_codes=codes, logits_out=lp)
        torch.cuda.synchronize()
        assert rel_rms(lk, lp) <= 1e-2
        noise = temperature * gs.gumbel_noise(seed, ng, v) if temperature > 0 else None
        picks_agree(codes, lp, seen, 1.05, noise)
        assert torch.equal(sk, sp) and torch.equal(esum, pesum)


def test_gumbel_sampler_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    logits = torch.randn(2048, generator=g, device=dev) * 2.0
    seed = torch.tensor([12345], device=dev)
    before = gs.launches
    got = gs.gumbel_sample(logits, seed, 0.85, 512)
    assert gs.launches == before + 1
    assert torch.equal(got, gs.gumbel_sample_plain(logits, seed, 0.85, 512))
    assert (gs.gumbel_sample(logits, seed, 0.0, 8) == torch.argmax(logits)).all()


def test_megakernel_pipeline_runs_the_kernels(dev, tmp_path):
    write_model_dir(tmp_path, tiny_talker_config(), tiny_decoder_config(),
                    weight_dtype=torch.float32)
    # the tiny vocoder's heads are too narrow for K4; this test is about K1/K2
    pl = tpipe.Qwen3TTSPipeline(
        tmp_path, tpipe.Qwen3TTSPipelineConfiguration(use_vocoder_kernels=False), device="cuda")
    assert "kernel" in pl.params and "kernel" in pl.cp_params
    before = (tmk.launches, cpk.launches)
    audio = pl.generate("Hello there, this is a test of the card.", "aiden", max_tokens=12)
    assert np.isfinite(audio).all() and len(audio) > 0
    assert tmk.launches > before[0] and cpk.launches > before[1]
