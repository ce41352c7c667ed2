"""The lockstep graphs' lease under threads, and the service, on the card
(marked `cuda`; skipped where there is no GPU), at the tiny widths of
qwen3_tts_tpu_torch/testing.py in fp32. Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_service.py -q --noconftest

serving.bind from two threads at once, over several rounds with a short
switch interval: each state gets a graph of its own, and a key is captured
only when none of its graphs is free (one graph leased and released, one
more for the second of two live states, none after; serving.capture then
finds the key captured), and a bind of a captured key does not wait while
a capture holds the capture lock. Then a 2-slot
TTSService: warmup() captures its greedy and sampled keys, and a greedy
and a sampled request served beside each other capture nothing more."""

import sys
import threading

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

pytestmark = pytest.mark.cuda
TEXTS = ["First stream text for batched serving.",
         "A different and somewhat longer second stream with extra words at the end."]


@pytest.fixture(scope="module")
def pl(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    d = tmp_path_factory.mktemp("cuda_service") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    # the dense vocoder: the tiny decoder's head_dim (8) is no K4 width
    return tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        use_vocoder_kernels=False), device="cuda", dtype=torch.float32)


def snapshot(pool: dict, statics) -> dict:
    return {k: [(id(g), g.capture_s) for g in gs] for k, gs in pool.items() if k[4] == statics}


def test_concurrent_binds_lease_distinct_graphs(pl):
    statics = tgen.GenStatics(config=pl.config, capacity=64 + tgen.RING_SLACK, chunk_steps=3,
                              track_cp_penalty=False)
    pds = [pl._assemble(t, "aiden") for t in TEXTS]
    e, tr, lengths, totals = tsrv._pad_prompts(pds, 64, 128)
    state = tsrv.prefill_batched(pl.params, e, lengths, tr, totals, pds[0].tts_pad_embed,
                                 tsrv._device_ints(range(2), e.device), statics)
    lease = tsrv.bind(pl.params, pl.cp_params, tsrv._clone(state), statics, False)
    first = lease.graph
    pool = tsrv.graphs(tsrv._drop_kernel(pl.params))[first.key]
    del lease  # dropped: its graph is free for the next state
    assert pool == [first] and first.free
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(6):
            got, errors = [None, None], []
            gate = threading.Barrier(2)

            def bind(i):
                try:
                    gate.wait(timeout=30)
                    got[i] = tsrv.bind(pl.params, pl.cp_params, tsrv._clone(state), statics,
                                       False)
                except Exception as err:  # surfaced below
                    errors.append(err)

            threads = [threading.Thread(target=bind, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors and not any(t.is_alive() for t in threads), errors
            assert got[0].graph is not got[1].graph
            assert len(pool) == 2 and not any(g.free for g in pool)
            got = None  # both states dropped: both graphs free again
            assert all(g.free for g in pool)
    finally:
        sys.setswitchinterval(interval)
    assert tsrv.capture(pl.params, pl.cp_params, state, statics, False) is first
    leased = []
    with tsrv._CAPTURE_LOCK:  # as while another thread captures
        t = threading.Thread(target=lambda: leased.append(
            tsrv.bind(pl.params, pl.cp_params, tsrv._clone(state), statics, False)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and leased[0].graph in pool


def test_service_captures_nothing_after_warmup(pl):
    svc = tservice.TTSService(pl, batch_size=2, chunk_steps=5, decode_chunk=6, left_context=3,
                              trailing_bucket=128)
    pool = tsrv.graphs(tsrv._drop_kernel(pl.params))
    try:
        svc.warmup(max_tokens=12)
        before = snapshot(pool, svc.statics)
        assert sorted(k[5] for k in before) == [False, True]  # greedy and sampled
        assert all(len(v) == 1 for v in before.values())
        reqs = [svc.submit(TEXTS[0], "aiden", temperature=0.0, max_tokens=16),
                svc.submit(TEXTS[1], "aiden", temperature=0.9, max_tokens=16, seed=5)]
        audio = [r.audio() for r in reqs]
        svc.close(drain=True)
        assert snapshot(pool, svc.statics) == before
        assert all(len(a) > 0 and np.isfinite(a).all() for a in audio)
        s = svc.stats()
        assert s["requests_submitted"] == s["requests_completed"] == 5
        assert s["worker_restarts"] == 0
    finally:
        svc.close()
