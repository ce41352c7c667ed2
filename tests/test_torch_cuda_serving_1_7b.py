"""Batched lockstep serving at the 1.7B widths on the card
(Qwen3TTSConfig.standard_1_7b(): talker hidden 2048, intermediate 6144,
the 1024-wide code predictor reached through small_to_mtp_projection; depth
cut to 2 talker and 2 code-predictor layers, every width the published
one; marked `cuda`, skipped where there is no GPU, since a CUDA kernel has
no CPU mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_serving_1_7b.py -q --noconftest

The lockstep graph on the megakernel configuration's weights (the `w8r`
product, the projection on K3: 15 launches a step) equals the eager step
bit for bit; K3 at the projection's shape (K = 2,048, O = 1,024) at M = 8,
16 (the GEMV) and 32 (the tile) against its plain version at rel RMS 1e-4
in fp32 and 2e-2 in bf16 (sums in another order; bf16 output rounding);
and the K3 configuration's step at B = 8 against B = 1, teacher-forced,
under chip_smoke.py's BATCH_ROUNDING rule: on an fp32 model the two widths
agree to 1e-4 (only the sum order differs), and in bf16 they lie within
the larger of 2e-2 and sqrt(2) times the B = 1 bf16 step's distance from
the B = 1 fp32 step on the same frames, with no code-0 flip."""

import dataclasses

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, write_model_dir

pytestmark = pytest.mark.cuda
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=2, text_vocab_size=4096, tts_bos_token_id=4000,
    tts_eos_token_id=4001, tts_pad_token_id=4002,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2))
TEXTS = ["Good morning.", "The train leaves at half past nine.",
         "Please water the plants tonight.", "A short one.",
         "The quick brown fox jumps over the dog.", "Numbers like twelve are read in full.",
         "The museum opens its new wing next week.", "Thank you, we will be with you."]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_BATCH = 2e-2


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    d = tmp_path_factory.mktemp("cuda_serving_1_7b") / "model"
    # bf16 weights: the fp32 and bf16 models below hold the same values
    write_model_dir(d, CFG, tiny_decoder_config(), weight_dtype=torch.bfloat16)
    return d


def pipeline(model_dir, megakernels: bool, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tpipe.Qwen3TTSPipelineConfiguration(use_talker_megakernel=megakernels,
                                              use_cp_megakernel=megakernels)
    return tpipe.Qwen3TTSPipeline(model_dir, cfg, device="cuda", dtype=dtype)


def state_of(pl, texts, chunk):
    statics = tgen.GenStatics(config=pl.config, capacity=64 + tgen.RING_SLACK,
                              chunk_steps=chunk, track_cp_penalty=False)
    pds = [pl._assemble(t, "aiden") for t in texts]
    e, tr, lengths, totals = tsrv._pad_prompts(pds, 64, 64)
    state = tsrv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                 tsrv._device_ints(range(len(texts)), e.device), statics)
    return state, statics


def rel_rms(got, ref):
    return float(((got.double() - ref.double()) ** 2).mean().sqrt()
                 / (ref.double() ** 2).mean().sqrt())


def assert_equal_state(a, b):
    for k, v in a.items():
        if isinstance(v, dict):
            assert_equal_state(v, b[k])
        else:
            assert torch.equal(v, b[k]), k


def test_graph_replay_equals_eager_step_with_the_projection_on_k3(model_dir):
    """B = 8, bf16, megakernel configuration's weights: 6 graph replays at
    temperature 0 and at 0.9 against the same steps run eagerly from a copy
    of the state: equal frames and state bit for bit; the capture recorded
    the projection's 15 K3 launches (M = 16 once, then 8)."""
    pl = pipeline(model_dir, True, torch.bfloat16)
    assert "w8" in pl.cp_params["small_to_mtp_projection"]
    p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    for temperature in (0.0, 0.9):
        state, statics = state_of(pl, TEXTS, 6)
        eager = tsrv._clone(state)
        ms, fn = [], qm.int8_matmul_kernel

        def recording(x, *args):
            ms.append(x.shape[0])
            return fn(x, *args)

        qm.int8_matmul_kernel = recording
        try:
            frames, counts, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state,
                                                                 temperature, statics)
        finally:
            qm.int8_matmul_kernel = fn
        temps = torch.full((8,), temperature, device="cuda")
        ref = []
        for _ in range(6):
            tsrv.lockstep_step(p, cp, eager, temps, statics, temperature > 0)
            ref.append(eager["frame"].clone())
        torch.cuda.synchronize()
        assert torch.equal(frames, torch.stack(ref, dim=1)) and bool((counts == 6).all())
        assert_equal_state(state, eager)
        assert state.graph.step_launches[tsrv._COUNTED.index(qm)] == 15
        assert sorted(set(ms)) == [8, 16] and ms.count(16) == 2  # warm-up and capture


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_at_the_projection(dtype):
    """K3 at small_to_mtp_projection's shape, M = 8, 16 and 32: one launch
    a call, against its plain version, two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    k, o = 2048, 1024
    w = torch.randint(0, 256, (o, k), generator=g, device="cuda", dtype=torch.uint8)
    s = torch.rand(o, k // 64, generator=g, device="cuda") * 1e-3
    b = torch.randn(o, k // 64, generator=g, device="cuda") * 0.02
    for m in (8, 16, 32):
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        before = qm.launches
        got = qm.int8_matmul_kernel(x, w, s, b)
        assert qm.launches == before + 1
        ref = qm.int8_matmul_plain(x, w, s, b)
        assert got.dtype == dtype and got.shape == (m, o)
        assert rel_rms(got.float(), ref.float()) <= TOL[dtype], m
        assert torch.equal(qm.int8_matmul_kernel(x, w, s, b), got), m


def test_k3_configuration_batch_against_single(model_dir):
    """The K3 configuration (every linear on K3, at M = 8 and 16 for B = 8,
    1 and 2 for B = 1): greedy frames of a B = 8 chunk, then B = 8 and B = 1
    (streams 0 and 6) teacher-forced over them, in an fp32 and a bf16 model
    of the same weights: the talker logits after every step."""
    pls = {dt: pipeline(model_dir, False, dt) for dt in (torch.float32, torch.bfloat16)}
    state, statics = state_of(pls[torch.bfloat16], TEXTS, 8)
    frames, _, _, _ = tsrv.decode_chunk_serving(pls[torch.bfloat16].params,
                                                pls[torch.bfloat16].cp_params, state, 0.0,
                                                statics)
    assert bool((frames[..., 0] >= 0).all())
    logits = {}
    for dt, pl in pls.items():
        p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
        wide, st = state_of(pl, TEXTS, 8)
        singles = {j: state_of(pl, TEXTS[j:j + 1], 8)[0] for j in (0, 6)}
        for i in range(8):
            tsrv.lockstep_step(p, cp, wide, torch.zeros(8, device="cuda"), st, False,
                               forced=frames[:, i])
            for j, one in singles.items():
                tsrv.lockstep_step(p, cp, one, torch.zeros(1, device="cuda"), st, False,
                                   forced=frames[j:j + 1, i])
                logits[dt, j, i] = (one["logits"][0].float(), wide["logits"][j].float())
    batch32 = max(rel_rms(a, b) for (dt, _, _), (a, b) in logits.items()
                  if dt == torch.float32)
    assert batch32 <= TOL[torch.float32]
    rounding = max(rel_rms(logits[torch.bfloat16, j, i][0], logits[torch.float32, j, i][0])
                   for j in (0, 6) for i in range(8))
    bound = max(TOL_BATCH, 2 ** 0.5 * rounding)
    for j in (0, 6):
        for i in range(8):
            one, wide = logits[torch.bfloat16, j, i]
            assert rel_rms(one, wide) <= bound, (j, i)
            a, w = int(torch.argmax(one)), int(torch.argmax(wide))
            # a flip only at a near tie: the two scores within 1e-2 of the largest
            assert a == w or float(one[a] - one[w]) <= 1e-2 * float(one.abs().max()), (j, i)
