"""The lockstep serving step's CUDA graph (models/serving.py LockstepGraph)
on the card, at the tiny widths of qwen3_tts_tpu_torch/testing.py in fp32
(marked `cuda`; skipped where there is no GPU). Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_serving.py -q --noconftest

The graph's replays against the same steps run eagerly from a copy of the
state, in the K3 configuration (every linear on K3, at B = 4 its GEMV) and
the megakernel one (the `w8r` product): the same frames
at temperature 0 and 0.9, the same integer state, float state within 1e-5
(the same kernels on the same inputs); an admission into a running graph;
and the graph's nodes counted by libcuda's cuGraphGetNodes."""

import ctypes

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as qm
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

pytestmark = pytest.mark.cuda
TEXTS = ["First stream text for batched serving.",
         "A different and somewhat longer second stream with extra words at the end.",
         "Short third one here.", "The fourth stream reads this sentence."]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cuda_serving") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return d


def pipeline(model_dir, megakernels: bool):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tpipe.Qwen3TTSPipelineConfiguration(use_talker_megakernel=megakernels,
                                              use_cp_megakernel=megakernels)
    return tpipe.Qwen3TTSPipeline(model_dir, cfg, device="cuda", dtype=torch.float32)


def state_of(pl, texts, chunk):
    statics = tgen.GenStatics(config=pl.config, capacity=64 + tgen.RING_SLACK,
                              chunk_steps=chunk, track_cp_penalty=False)
    pds = [pl._assemble(t, "aiden") for t in texts]
    e, tr, lengths, totals = tsrv._pad_prompts(pds, 64, 128)
    state = tsrv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                 tsrv._device_ints(range(len(texts)), e.device), statics)
    return state, statics


def eager_chunk(pl, state, statics, temperature):
    b = state["logits"].shape[0]
    temps = torch.full((b,), float(temperature), device="cuda")
    frames = []
    for _ in range(statics.chunk_steps):
        tsrv.lockstep_step(tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params),
                           state, temps, statics, temperature > 0)
        frames.append(state["frame"].clone())
    return torch.stack(frames, dim=1)


def assert_same_state(a, b):
    for k, v in a.items():
        if isinstance(v, dict):
            assert_same_state(v, b[k])
        elif v.is_floating_point():
            assert float((v - b[k]).abs().max()) <= 1e-5 * max(float(v.abs().max()), 1.0), k
        else:
            assert torch.equal(v, b[k]), k


@pytest.mark.parametrize("megakernels", [False, True])
def test_graph_replay_matches_eager_step(model_dir, megakernels):
    pl = pipeline(model_dir, megakernels)
    for temperature in (0.0, 0.9):
        state, statics = state_of(pl, TEXTS, 6)
        eager = tsrv._clone(state)
        before = qm.launches
        frames, counts, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state,
                                                             temperature, statics)
        assert state.graph is not None
        ref = eager_chunk(pl, eager, statics, temperature)
        torch.cuda.synchronize()
        assert torch.equal(frames, ref) and bool((counts == 6).all())
        assert_same_state(state, eager)
        if not megakernels:  # K3 counts the warm-up, the capture and the 6 eager steps:
            # a replay launches the recorded kernels without the wrapper
            assert qm.launches - before == 8 * state.graph.step_launches[0] > 0


def test_admission_into_running_graph(model_dir):
    """Slot 1 of a running B = 4 graph takes row 2 of a burst prefill at step
    5 (in place, no second capture); the next chunk matches the same
    admission run eagerly."""
    pl = pipeline(model_dir, False)
    state, statics = state_of(pl, TEXTS, 5)
    eager = tsrv._clone(state)
    _, _, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0, statics)
    eager_chunk(pl, eager, statics, 0.0)
    graph = state.graph
    fresh, _ = state_of(pl, TEXTS[::-1], 5)
    tsrv.admit_stream(state, 1, fresh, statics, src=2)
    tsrv.admit_stream(eager, 1, fresh, statics, src=2)
    frames, _, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0,
                                                    statics)
    ref = eager_chunk(pl, eager, statics, 0.0)
    assert state.graph is graph
    assert torch.equal(frames, ref) and bool((frames[1, :, 0] >= 0).all())
    assert_same_state(state, eager)
    assert int(state["start_step"][1]) == 5


def test_step_graph_nodes_and_one_graph_per_key(model_dir):
    """A lockstep step captured with keep_graph: every node a kernel,
    memset or memcpy node (no host node), the K3 launches among them; and
    serving three chunks with an admission and a park makes one graph of
    the key."""
    pl = pipeline(model_dir, False)
    state, statics = state_of(pl, TEXTS, 3)
    p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    temps = torch.zeros(4, device="cuda")
    side = torch.cuda.Stream()  # warm up where the capture runs: K3's counters exist
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsrv.lockstep_step(p, cp, state, temps, statics, False)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = qm.launches
    with torch.cuda.graph(graph, stream=side):
        tsrv.lockstep_step(p, cp, state, temps, statics, False)
    k3 = qm.launches - before
    drv = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert set(kinds) <= {0, 1, 2} and kinds.count(0) >= k3 > 0, (set(kinds), k3)

    state, statics = state_of(pl, TEXTS, 3)
    fresh, _ = state_of(pl, TEXTS[:1], 3)
    for i in range(3):
        _, _, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.9, statics)
        if i == 0:
            tsrv.admit_stream(state, 3, fresh, statics)
            tsrv.park_slot(state, 0)
    torch.cuda.synchronize()
    key = tsrv.graph_key(tsrv._drop_kernel(pl.cp_params), state, statics, True)
    assert len(tsrv.graphs(pl.params)[key]) == 1
    assert bool(state["eos"][0]) and not np.isnan(state["logits"].cpu().numpy()).any()
