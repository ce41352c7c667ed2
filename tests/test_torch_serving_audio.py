"""The port's streaming continuous serving (ContinuousServer.serve_audio,
_RowPacker, generate_many_stream) on the CPU at tiny widths in fp32: the row
packer against the JAX package's on the same feeds; serve_audio's chunks,
joined per request, equal the canonical stream decode of the same codes
(the fixed-width zero-padded vocoder rows are transparent because the
vocoder is causal; rtol 1e-4, atol 1e-5 as tests/test_serving_audio.py);
the port's flush of a deferred boundary on an empty one, pinned against the
JAX package's behaviour it departs from; and every request of a
generate_many_stream with more texts than slots ends with one is_final
chunk."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.testing import (
    config_to_json_dict,
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
)

torch.set_num_threads(1)
TEXTS = [
    "Streaming audio request number one.",
    "The second request has different words in it.",
    "Third request queued behind the first two slots.",
]
DC, CTX = 6, 3  # a small decode chunk and left context, so tiny runs cross rows


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_audio_dir") / "model"
    write_model_dir(d, tiny_talker_config(), tiny_decoder_config(), weight_dtype=torch.float32)
    return tpipe.Qwen3TTSPipeline(d, device="cpu", dtype=torch.float32)


def test_row_packer_matches_jax():
    """Three keys fed ragged frame runs, some ending with nothing buffered,
    without and with an early first row: every row (key, row, context,
    frames, token range, final) and every empty-final flag as JAX's packer
    gives them."""
    for first_chunk in (None, 2):
        _packer_run(first_chunk)


def _packer_run(first_chunk):
    rng = np.random.default_rng(first_chunk or 0)
    ng = 4
    port = tsrv._RowPacker(ng, DC, CTX, first_chunk)
    ref = jsrv._RowPacker(ng, DC, CTX, first_chunk)
    live = {"a", "b", "c"}
    while live:
        key = sorted(live)[int(rng.integers(len(live)))]
        frames = rng.integers(0, 2048, (int(rng.integers(0, 9)), ng)).astype(np.int32)
        done = bool(rng.random() < 0.15)
        (rows, empty), (jrows, jempty) = port.feed(key, frames, done), ref.feed(key, frames, done)
        assert empty == jempty and len(rows) == len(jrows)
        for row, jrow in zip(rows, jrows):
            assert row[0] == jrow[0] and row[2:] == jrow[2:]
            np.testing.assert_array_equal(row[1], jrow[1])
        assert port.sent(key) == ref.sent(key)
        if done:
            port.release(key)
            ref.release(key)
            live.discard(key)


def test_serve_audio_matches_canonical_stream_decode(tpl):
    pds = [tpl._assemble(t, "aiden") for t in TEXTS]
    dec = tpl.speech_config.decoder_config
    spf = dec.total_upsample

    def server():
        return tsrv.ContinuousServer(tpl.params, tpl.cp_params, tpl.config, batch_size=2,
                                     chunk_steps=5, seed=0)

    codes = server().run(pds, temperature=0.0, max_tokens=14)
    got = {i: [] for i in range(len(pds))}
    ranges = {i: [] for i in range(len(pds))}
    finals = {i: 0 for i in range(len(pds))}
    for ch in server().serve_audio(pds, tpl.vocoder_params, dec, temperature=0.0,
                                   max_tokens=14, decode_chunk=DC, left_context=CTX):
        got[ch.request].append(ch.samples)
        ranges[ch.request].append(ch.token_range)
        finals[ch.request] += int(ch.is_final)
    for i in range(len(pds)):
        frames = tgen.filter_valid_frames(codes[i])
        assert len(frames) == 14
        expected, ctx = [], None
        for pos in range(0, len(frames), DC):
            batch = frames[pos: pos + DC]
            inp = batch if ctx is None else np.concatenate([ctx, batch])
            wav = tvoc.decode_frames(tpl.vocoder_params,
                                     torch.from_numpy(inp.T[None].astype(np.int64)), dec)[0]
            expected.append(wav.numpy()[(len(inp) - len(batch)) * spf:])
            ctx = inp[-CTX:]
        np.testing.assert_allclose(np.concatenate(got[i]), np.concatenate(expected),
                                   rtol=1e-4, atol=1e-5, err_msg=f"request {i}")
        assert finals[i] == 1
        spans = [r for r in ranges[i] if r[1] > r[0]]
        assert [a for a, _ in spans] == [0] + [b for _, b in spans][:-1]
        assert spans[-1][1] == 14


def test_empty_boundary_flushes_the_deferred_chunk(monkeypatch):
    """A boundary whose events carry no frame still ships the chunk deferred
    at the boundary before it. The JAX package's serve_audio (serving.py:1118)
    holds that chunk until the next boundary with rows; the port departs
    from it on purpose. Scripted events for one request, the vocoder
    replaced by zeros in both packages."""
    jcfg = JConfig.from_json(config_to_json_dict(tiny_talker_config()))
    ng = jcfg.code_predictor_config.num_code_groups
    frames = np.arange(10 * ng, dtype=np.int32).reshape(10, ng) % 2048
    script = [(frames[0:4], False), (frames[4:8], False), (frames[:0], False),
              (frames[8:10], True)]

    def run(mod, server, wrap):
        log = []

        def events(*_args, **_kwargs):
            for i, (valid, done) in enumerate(script):
                log.append(f"E{i}")
                yield [(0, valid, done)]

        def dispatch(rows, batch_size, _params, cfg, _ng, width):
            return [(wrap(np.zeros((batch_size, width * cfg.total_upsample), np.float32)),
                     rows[g: g + batch_size]) for g in range(0, len(rows), batch_size)]

        monkeypatch.setattr(server, "_event_stream", events)
        monkeypatch.setattr(mod, "vocode_rows_dispatch", dispatch)
        for ch in server.serve_audio([None], None, tiny_decoder_config(), decode_chunk=4,
                                     left_context=2):
            log.append(ch.token_range)
        return log

    jserver = jsrv.ContinuousServer(None, None, jcfg, batch_size=2)
    tserver = tsrv.ContinuousServer({}, {}, tiny_talker_config(), batch_size=2)
    assert run(jsrv, jserver, lambda wav: wav) == [
        "E0", (0, 4), "E1", "E2", "E3", (4, 8), (8, 10)]
    assert run(tsrv, tserver, lambda wav: lambda: wav) == [
        "E0", (0, 4), "E1", "E2", (4, 8), "E3", (8, 10)]


def test_generate_many_stream_more_texts_than_slots(tpl):
    """Five texts through two slots (three admitted mid-flight), sampled:
    each text's chunks tile its frames in order, the audio is finite, and
    each ends with exactly one is_final chunk."""
    texts = TEXTS + ["Fourth request appears after a slot frees.",
                     "Fifth request drains the queue at the end."]
    spf = tpl._samples_per_frame
    chunks = {i: [] for i in range(len(texts))}
    for i, ch in tpl.generate_many_stream(texts, "aiden", temperature=0.9, max_tokens=24,
                                          batch_size=2, chunk_steps=4, seed=2):
        chunks[i].append(ch)
    for i, cs in chunks.items():
        assert sum(c.is_final for c in cs) == 1 and cs[-1].is_final, i
        pos = 0
        for c in cs:
            assert c.token_range[0] == pos and np.isfinite(c.samples).all()
            assert len(c.samples) == (c.token_range[1] - pos) * spf
            pos = c.token_range[1]
        assert pos == 24
