"""Batched lockstep serving on a mixed 4/6-bit tree at the 1.7B widths on
the card (Qwen3TTSConfig.standard_1_7b(): talker hidden 2048, intermediate
6144, the 1024-wide code predictor reached through small_to_mtp_projection;
depth cut to 2 talker and 2 code-predictor layers, every width the
published one; runtime_quantization_mode="mixed_4_6" with the megakernels
off, so every talker and code-predictor linear runs K7, the projection at
4 bits; marked `cuda`, skipped where there is no GPU, since a CUDA kernel
has no CPU mode). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_packed_serving.py -q --noconftest

The lockstep graph equals the eager step bit for bit, its capture records
K7 once for every packed linear a step; K7 at the projection's shape (K =
2,048, O = 1,024, 4 bits, group 64) at M = 1, 2, 8, 16 (the GEMV) and 32
(the tile) against its plain version at rel RMS 1e-4 in fp32 and 2e-2 in
bf16 (sums in another order; bf16 output rounding); and a profile of the
graph's replays holds K7's device kernels, counted by name at every width,
to the capture's launches."""

import dataclasses
import re

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as pm
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
# every packed linear a step: the talker's 4 a layer and its codec head; on
# each of the 15 code-predictor passes its 4 a layer, the lm head and the
# projection
STEP_LAUNCHES = 4 * 2 + 1 + 15 * (4 * 2 + 1 + 1)
K7_NAMES = re.compile(r"qt_qmm_(gemv|tile)_kernel<[2346],")


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    needs_cuda()
    d = tmp_path_factory.mktemp("cuda_packed_serving") / "model"
    write_model_dir(d, CFG, tiny_decoder_config(), weight_dtype=torch.bfloat16)
    return tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        runtime_quantization_mode="mixed_4_6", use_talker_megakernel=False,
        use_cp_megakernel=False), device="cuda", dtype=torch.bfloat16)


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


def test_mixed_graph_replay_equals_eager_step(mixed):
    """B = 8, bf16: 6 graph replays at temperature 0 and at 0.9 against the
    same steps run eagerly from a copy of the state: equal frames and state
    bit for bit; the capture recorded K7 STEP_LAUNCHES times, the
    projection at M = 16 once and then 8."""
    pl = mixed
    proj = pl.cp_params["small_to_mtp_projection"]["wq"]
    assert proj.shape == (1024, 2048 * 4 // 32)
    p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    for temperature in (0.0, 0.9):
        state, statics = state_of(pl, TEXTS, 6)
        eager = tsrv._clone(state)
        ms, fn = [], pm.packed_matmul_kernel

        def recording(x, w, *args):
            if w.data_ptr() == proj.data_ptr():
                ms.append(x.shape[0])
            return fn(x, w, *args)

        pm.packed_matmul_kernel = recording
        try:
            frames, counts, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state,
                                                                 temperature, statics)
        finally:
            pm.packed_matmul_kernel = fn
        temps = torch.full((8,), temperature, device="cuda")
        ref = []
        for _ in range(6):
            tsrv.lockstep_step(p, cp, eager, temps, statics, temperature > 0)
            ref.append(eager["frame"].clone())
        torch.cuda.synchronize()
        assert torch.equal(frames, torch.stack(ref, dim=1)) and bool((counts == 6).all())
        assert_equal_state(state, eager)
        assert state.graph.step_launches[tsrv._COUNTED.index(pm)] == STEP_LAUNCHES
        # warm-up and capture: M = 16 (the first pass's two rows) once each
        assert ms.count(16) == 2 and ms.count(8) == 2 * 14 and len(ms) == 30


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k7_at_the_projection(dtype):
    """K7 (4 bits, group 64) at small_to_mtp_projection's shape, M = 1, 2,
    8, 16 and 32: one launch a call, against its plain version, two calls
    bit-identical."""
    needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    k, o = 2048, 1024
    wq = torch.randint(-2 ** 31, 2 ** 31, (o, k * 4 // 32), generator=g, device="cuda",
                       dtype=torch.int64).to(torch.int32)
    s = torch.rand(o, k // 64, generator=g, device="cuda") * (2e-2 / 16)
    b = torch.randn(o, k // 64, generator=g, device="cuda") * 0.01
    for m in (1, 2, 8, 16, 32):
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        before = pm.launches
        got = pm.packed_matmul_kernel(x, wq, s, b, 4, 64)
        assert pm.launches == before + 1
        ref = pm.packed_matmul_plain(x, wq, s, b, 4, 64)
        assert got.dtype == dtype and got.shape == (m, o)
        assert rel_rms(got.float(), ref.float()) <= TOL[dtype], m
        assert torch.equal(pm.packed_matmul_kernel(x, wq, s, b, 4, 64), got), m


def test_k7_replayed_kernels_counted_by_name(mixed):
    """A profile of 5 replays of the mixed B = 8 graph: K7's device kernels
    by name (the GEMV and the tile at 4 and 6 bits) are the capture's
    launches five times over; a window short of them is taken again, up to
    five windows (a profiler window can lose records)."""
    pl = mixed
    state, statics = state_of(pl, TEXTS, 1)
    state = tsrv.bind(pl.params, pl.cp_params, state, statics, True)
    g = state.graph
    want = 5 * g.step_launches[tsrv._COUNTED.index(pm)]
    assert want == 5 * STEP_LAUNCHES
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                g.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and K7_NAMES.search(e.name)]
        if len(names) >= want:
            break
    assert len(names) == want
    assert any("<4," in n for n in names) and any("<6," in n for n in names)
