"""The voice modes through the lockstep service on the card (marked `cuda`;
skipped where there is no GPU), at the tiny widths of
qwen3_tts_tpu_torch/testing.py with both encoders, in fp32 (TF32 off).
Run on a GPU host with:

    python -m pytest tests/test_torch_cuda_service_modes.py -q --noconftest

The burst is testing.MODE_BURST, as in tests/test_torch_service_modes.py:
two VoiceDesign descriptions, two CustomVoice requests, a speaker-embedding
clone and an ICL request from one reference clip, an OpenAI-route
CustomVoice prompt and a built-in speaker, greedy.
- A B = 8 service after warmup() serves the burst with no further capture,
  each request's audio equal in length to the same request served alone
  (a B = 1 service) and within rel RMS 1e-4 of it (fp32 sums at M = 8
  and M = 1);
- the burst's bootstrap state, a chunk of graph replays against the same
  steps run eagerly: frames and state bit for bit;
- the long-reference ICL request: refused by the default service, served
  by one at the first prompt bucket that holds it."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import service as tservice
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.models import serving as tsrv

pytestmark = pytest.mark.cuda
FRAMES = 12
REF_CODES, LONG_CODES = 63, 113  # as tests/test_torch_service_modes.py's
LONG_TEXT = "A long reference clip to clone."


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(np.mean(ref ** 2), 1e-30)))


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = tmp_path_factory.mktemp("cuda_service_modes") / "model"
    enc = ttesting.tiny_encoder_config()
    ttesting.write_model_dir(d, ttesting.tiny_talker_config(), ttesting.tiny_decoder_config(),
                             seed=0, weight_dtype=torch.float32, with_encoders=True,
                             speaker_config=ttesting.tiny_speaker_config(), encoder_config=enc,
                             tts_model_type="base")
    # the dense vocoder: the tiny decoder's head_dim (8) is no K4 width
    pl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        use_vocoder_kernels=False), device="cuda", dtype=torch.float32)
    ref = ttesting.reference_clip(REF_CODES, enc)
    burst = ttesting.mode_burst(pl.extract_speaker_embedding(ref),
                                pl.encode_reference_audio(ref))
    long_kw = {"reference_transcript": ttesting.REFERENCE_TRANSCRIPT, "reference_audio_codes":
               pl.encode_reference_audio(ttesting.reference_clip(LONG_CODES, enc))}
    return SimpleNamespace(pl=pl, burst=burst, long_kw=long_kw)


def serve(svc, reqs):
    held: list = []
    for i, (text, spk, kw) in enumerate(reqs):
        svc.submit(text, spk, temperature=0.0, max_tokens=FRAMES, seed=i, _hold=held, **kw)
    svc._enqueue(held)
    return [r.audio() for r in held]


def test_mode_burst_after_warmup_matches_single_requests(card):
    pl = card.pl
    pool = tsrv.graphs(tsrv._drop_kernel(pl.params))
    svc = tservice.TTSService(pl, batch_size=8)
    try:
        svc.warmup(max_tokens=12)
        before = {k: [id(g) for g in gs] for k, gs in pool.items() if k[4] == svc.statics}
        assert sorted(k[5] for k in before) == [False, True]
        got = serve(svc, card.burst)
        after = {k: [id(g) for g in gs] for k, gs in pool.items() if k[4] == svc.statics}
        assert after == before  # the mixed layouts captured nothing more
    finally:
        svc.close()
    one = tservice.TTSService(pl, batch_size=1)
    try:
        for i, req in enumerate(card.burst):
            ref = serve(one, [req])[0]
            assert len(got[i]) == len(ref) > 0 and np.isfinite(got[i]).all(), i
            assert rel_rms(got[i], ref) <= 1e-4, i
    finally:
        one.close()


def test_mixed_batch_graph_is_bit_for_bit_the_eager_step(card):
    pl = card.pl
    svc = tservice.TTSService(pl, batch_size=8)
    try:
        held: list = []
        for i, (text, spk, kw) in enumerate(card.burst):
            svc.submit(text, spk, seed=i, _hold=held, **kw)
        state = svc._prefill_bootstrap(dict(enumerate(held)))
        statics = svc.statics
    finally:
        svc.close()
    assert len({tprompt.pd_lengths(r.pd)[0] for r in held}) >= 6
    eager = tsrv._clone(state)
    frames, _, _, state = tsrv.decode_chunk_serving(pl.params, pl.cp_params, state, 0.0,
                                                    statics)
    assert state.graph is not None
    p, cp = tsrv._drop_kernel(pl.params), tsrv._drop_kernel(pl.cp_params)
    ref = []
    for _ in range(statics.chunk_steps):
        tsrv.lockstep_step(p, cp, eager, torch.zeros(8, device="cuda"), statics, False)
        ref.append(eager["frame"].clone())
    assert torch.equal(frames, torch.stack(ref, dim=1))
    for k, v in eager.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert torch.equal(state[k][kk], vv), (k, kk)
        else:
            assert torch.equal(state[k], v), k


def test_long_reference_refused_then_served_at_a_larger_bucket(card):
    pl = card.pl
    pd = tprompt.assemble_prompt(pl.params, pl.config, pl.tokenizer, LONG_TEXT,
                                 **card.long_kw)
    p, t = tprompt.pd_lengths(pd)
    svc = tservice.TTSService(pl, batch_size=8)
    try:
        with pytest.raises(ValueError, match=rf"prompt \({p} embeds / {t} trailing\) exceeds "
                                             r"service buckets \(128/64\)"):
            svc.submit(LONG_TEXT, **card.long_kw)
    finally:
        svc.close()
    bucket = tgen.pick_bucket(p)
    wide = tservice.TTSService(pl, batch_size=2, prompt_bucket=bucket)
    try:
        assert wide.statics.capacity == bucket + tgen.RING_SLACK
        audio = serve(wide, [(LONG_TEXT, "", card.long_kw), card.burst[7]])
    finally:
        wide.close()
    spf = pl._samples_per_frame
    assert all(len(a) > 0 and len(a) % spf == 0 and np.isfinite(a).all() for a in audio)
