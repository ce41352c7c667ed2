"""The port's speech_tokenizer_decode (models/vocoder.py) against the JAX
package's, and its stack_states / decode_chunk_batched (models/generate.py)
against B single-stream decode_chunk calls, on the CPU in fp32:

- speech_tokenizer_decode at B = 2 with one stream padded (its last frames'
  code 0 is 0), through the dense torch vocoder and through the K4 / K5 / K6
  plain versions, with chunking set by argument and by the
  QWEN3TTS_DECODE_* overrides: waveform rel RMS <= 1e-5 against JAX's,
  lengths exact;
- decode_chunk_batched at B = 3 (prompts of three lengths, one stream
  stopped by EOS on its first step and parked): the same frames, counts and
  EOS flags as three decode_chunk calls, greedy and sampled (each stream's
  generator drawn in decode_step's order), the talker logits after the
  chunk within 1e-5, on fp32, int8 (K3's plain version at M = B) and
  packed (K7's) weights;
- decode_chunk_batched at B = 3, greedy, against the JAX package's
  stack_states / decode_chunk_batched on the same fp32 weights and prompts
  (stream 1 stopped at once in both): teacher-forced, with JAX's frames fed
  through decode_step on the stacked state (decode_chunk_batched's body),
  talker logits rel RMS <= 1e-4 a step and the port's own greedy picks
  JAX's except at a near tie (the two codes' scores within 5e-3 of the
  largest, at most twice, as in test_torch_megakernel_pipeline.py); then
  free-running, counts and EOS flags JAX's, and the frames too when no near
  tie came;
- states in K1's cache layout are converted by stack_states(config=) and
  refused unconverted; stacking needs one ring capacity."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.config import TokenizerDecoderConfig as JDecConfig
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu_torch import Qwen3TTSPipeline, Qwen3TTSPipelineConfiguration
from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import vocoder_params
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as gen
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.testing import (
    tiny_decoder_config,
    tiny_talker_config,
    write_model_dir,
    write_prequantized_model_dir,
)

torch.set_num_threads(1)
DEC = dict(latent_dim=32, codebook_dim=16, codebook_size=64, decoder_dim=48,
           hidden_size=32, intermediate_size=48, head_dim=16, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2, upsample_rates=(4, 3),
           upsampling_ratios=(2, 2))
TEXTS = ("Hello there, this is a test.", "A second text.",
         "The third text is a little longer than the other two.")
LOGITS_TOL = 1e-5
NEAR_TIE = 5e-3


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel_plain"])
def test_speech_tokenizer_decode_matches_jax(kernels, monkeypatch):
    jd, td = JDecConfig(**DEC), TokenizerDecoderConfig(**DEC)
    p = jax.tree.map(np.asarray, jvoc.init_vocoder_params(jd, jax.random.PRNGKey(2)))
    codes = np.random.default_rng(3).integers(1, 64, (2, 13, 16))
    codes[1, 9:] = 0  # stream 1 padded: frames 9.. do not count
    jp = jax.tree.map(jnp.asarray, p)
    tp = vocoder_params(p, td, kernel_dtype=torch.float32 if kernels else None)
    for chunk, ctx, env in ((5, 2, False), (None, None, True)):
        if env:
            monkeypatch.setenv("QWEN3TTS_DECODE_CHUNK_SIZE", "4")
            monkeypatch.setenv("QWEN3TTS_DECODE_LEFT_CONTEXT", "3")
        jwav, jlen = jvoc.speech_tokenizer_decode(jp, codes, jd, chunk_size=chunk,
                                                  left_context=ctx)
        wav, lengths = tvoc.speech_tokenizer_decode(tp, codes, td, device="cpu",
                                                    chunk_size=chunk, left_context=ctx)
        assert wav.shape == (2, 13 * td.total_upsample) and wav.dtype == np.float32
        assert rel_rms(wav, jwav) <= 1e-5
        assert lengths.tolist() == np.asarray(jlen).tolist() == [
            13 * td.total_upsample, 9 * td.total_upsample]


@pytest.fixture(scope="module")
def dirs():
    with tempfile.TemporaryDirectory() as root:
        dense, packed = os.path.join(root, "dense"), os.path.join(root, "packed")
        write_model_dir(dense, tiny_talker_config(), tiny_decoder_config(),
                        weight_dtype=torch.float32)
        write_prequantized_model_dir(packed, tiny_talker_config(), tiny_decoder_config(),
                                     widths=(4, 8))
        yield {"dense": dense, "packed": packed}


def prefilled(pl, capacity: int, params=None) -> list[dict]:
    """One state a text, all with `capacity` ring slots; stream 1 has no
    text left and its EOS logit raised, so it stops on its first step."""
    states = []
    for i, text in enumerate(TEXTS):
        st = gen.prefill(pl.params if params is None else params,
                         pl._assemble(text, "aiden"), pl.config, capacity=capacity)
        if i == 1:
            st["trailing_idx"].copy_(st["total_text"])
            st["logits"][pl.config.codec_eos_token_id] = 100.0
        states.append(st)
    return states


def capacity(pl) -> int:
    return max(pl._assemble(t, "aiden").input_embeds.shape[1] for t in TEXTS) + gen.RING_SLACK


@pytest.mark.parametrize("weights", ["fp32", "int8", "packed"])
def test_batched_chunk_equals_single_streams(dirs, weights):
    cfg = Qwen3TTSPipelineConfiguration(apply_runtime_quantization=weights == "int8")
    pl = Qwen3TTSPipeline(dirs["packed" if weights == "packed" else "dense"], cfg,
                          device="cpu", dtype=torch.float32)
    cap = capacity(pl)
    for temp in (0.0, 0.9):
        singles = []
        for i, st in enumerate(prefilled(pl, cap)):
            out = gen.decode_chunk(pl.params, pl.cp_params, st, pl.config, steps=10,
                                   temperature=temp,
                                   generator=torch.Generator().manual_seed(i),
                                   track_cp_penalty=True)
            singles.append((*out, st["logits"]))
        states = gen.stack_states(prefilled(pl, cap))
        frames, counts, eos = gen.decode_chunk_batched(
            pl.params, pl.cp_params, states, pl.config, steps=10, temperature=temp,
            generators=[torch.Generator().manual_seed(i) for i in range(3)] if temp else None,
            track_cp_penalty=True)
        assert frames.shape == (3, 10, 16)
        for i, (f, c, e, lg) in enumerate(singles):
            assert torch.equal(frames[i], f), (weights, temp, i)
            assert int(counts[i]) == int(c) and bool(eos[i]) == bool(e)
            assert float((states["logits"][i] - lg).abs().max()) <= LOGITS_TOL * float(
                lg.abs().max())
        assert int(counts[1]) == 0 and bool(eos[1])  # stopped at once, parked
        assert int(counts[0]) == 10 and int(counts[2]) == 10


def jax_batched_greedy(d: str, steps: int):
    """JAX's stack_states / decode_chunk_batched on the TEXTS prompts (stream
    1 stopped as in prefilled()), one frame a chunk: per step the frames
    [B, 16], counts [B], eos [B] and the talker logits after it [B, V]."""
    jpl = jpipe.Qwen3TTSPipeline(d, jpipe.Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False, use_cp_megakernel=False,
        use_talker_megakernel=False, use_vocoder_kernels=False), dtype=jnp.float32)
    cfg = jpl.config
    pds = [jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, t, speaker="aiden")
           for t in TEXTS]
    pb = jgen.pick_bucket(max(pd.input_embeds.shape[1] for pd in pds))
    tb = jgen.pick_bucket(max(pd.trailing_hidden.shape[1] for pd in pds),
                          jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True)
    states = []
    for i, pd in enumerate(pds):
        p, t = pd.input_embeds.shape[1], pd.trailing_hidden.shape[1]
        emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(pd.input_embeds)
        trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(pd.trailing_hidden)
        st = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                          pd.tts_pad_embed, jax.random.PRNGKey(i), statics)
        if i == 1:
            st = dict(st, trailing_idx=st["total_text"],
                      logits=st["logits"].at[cfg.codec_eos_token_id].set(100.0))
        states.append(st)
    state = jgen.stack_states(states)
    out = []
    for _ in range(steps):
        f, c, e, state = jgen.decode_chunk_batched(jpl.params, jpl.cp_params, state,
                                                   jnp.float32(0.0), statics)
        out.append((np.asarray(f[:, 0]), np.asarray(c), np.asarray(e),
                    np.asarray(state["logits"])))
    return out


def test_batched_chunk_matches_jax_batched(dirs):
    steps = 10
    ref = jax_batched_greedy(dirs["dense"], steps)
    cfg = Qwen3TTSPipelineConfiguration(apply_runtime_quantization=False)
    pl = Qwen3TTSPipeline(dirs["dense"], cfg, device="cpu", dtype=torch.float32)
    cc = pl.config.code_predictor_config
    cap = capacity(pl)
    greedy = dict(temperature=0.0, generator=None, track_cp_penalty=True)

    st = gen.stack_states(prefilled(pl, cap))
    near_ties = 0
    for i, (jf, jc, je, jlg) in enumerate(ref):
        jf = jf.astype(np.int64)
        emits = np.flatnonzero(jc)  # JAX returns a frame where it emitted one
        free, _ = gen.decode_step(pl.params, pl.cp_params, clone(st), pl.config, **greedy)
        for s in emits:  # the port's own picks from JAX's state
            assert int(free[s, 0]) == jf[s, 0], (i, s)
            cp_logits = []
            tcp.predict_frame(pl.cp_params, st["h_last"][s:s + 1],
                              ttalker.encode_audio(pl.params, torch.tensor([[int(jf[s, 0])]])),
                              None, 0.0, st["seen_cp"][s].clone(), cc,
                              forced_codes=torch.from_numpy(jf[s, 1:]), logits_out=cp_logits)
            pen = torch.where(st["seen_cp"][s], 1.05, 1.0)
            for k, lg in enumerate(cp_logits):
                score = lg / pen[k]
                pick, want = int(free[s, k + 1]), int(jf[s, k + 1])
                if pick != want:
                    near_ties += 1
                    assert float(score[pick] - score[want]) <= NEAR_TIE * float(
                        score.abs().max()), (i, s, k)
        forced = torch.where(torch.from_numpy(jc > 0)[:, None], torch.from_numpy(jf), free)
        frame, emitted = gen.decode_step(pl.params, pl.cp_params, st, pl.config,
                                         forced_frame=forced, **greedy)
        assert emitted.long().tolist() == jc.tolist(), i
        assert st["eos"].tolist() == je.tolist(), i
        for s in emits:
            np.testing.assert_array_equal(frame[s].numpy(), jf[s])
            assert rel_rms(st["logits"][s].numpy(), jlg[s]) <= 1e-4, (i, s)
    assert near_ties <= 2

    st = gen.stack_states(prefilled(pl, cap))
    frames, got_counts, eos = gen.decode_chunk_batched(
        pl.params, pl.cp_params, st, pl.config, steps=steps, temperature=0.0,
        track_cp_penalty=True)
    want_counts = np.sum([c for _, c, _, _ in ref], axis=0)
    assert got_counts.tolist() == want_counts.tolist() == [steps, 0, steps]
    assert eos.tolist() == ref[-1][2].tolist() == [False, True, False]
    if near_ties == 0:
        want = np.stack([f for f, _, _, _ in ref], axis=1)
        for s in (0, 2):
            np.testing.assert_array_equal(frames[s].numpy(), want[s])


def clone(state: dict) -> dict:
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def test_stack_states_converts_the_megakernel_layout(dirs):
    mk = Qwen3TTSPipelineConfiguration(use_talker_megakernel=True, use_cp_megakernel=True)
    pl = Qwen3TTSPipeline(dirs["dense"], mk, device="cpu", dtype=torch.float32)
    cap = capacity(pl)
    states = prefilled(pl, cap)
    assert "k2" in states[0]["cache"]
    with pytest.raises(ValueError, match="config"):
        gen.stack_states(states)
    stacked = gen.stack_states(states, pl.config)
    assert set(stacked["cache"]) == {"k", "v", "pos"}
    bad = dict(stacked, cache=dict(stacked["cache"], k2=stacked["cache"]["k"]))
    with pytest.raises(ValueError, match="stack_states"):
        gen.decode_chunk_batched(pl.params, pl.cp_params, bad, pl.config, steps=1,
                                 temperature=0.0, track_cp_penalty=True)
    with pytest.raises(ValueError, match="capacity"):
        gen.stack_states([prefilled(pl, cap)[0], prefilled(pl, cap + 1)[0]], pl.config)
    with pytest.raises(ValueError, match="capacity"):
        gen.prefill(pl.params, pl._assemble(TEXTS[0], "aiden"), pl.config, capacity=10)

    # the batched decode drops the megakernels and reads their rowwise int8
    # weights through `w8r` views; singles decoded on the same views from
    # plain-layout prefills give the same frames
    plain = {k: v for k, v in pl.params.items() if k != "kernel"}
    plain_cp = {k: v for k, v in pl.cp_params.items() if k != "kernel"}
    singles = []
    for st in prefilled(pl, cap, params=plain):
        singles.append(gen.decode_chunk(plain, plain_cp, st, pl.config, steps=6,
                                        temperature=0.0, generator=None,
                                        track_cp_penalty=True))
    frames, counts, eos = gen.decode_chunk_batched(pl.params, pl.cp_params, stacked,
                                                   pl.config, steps=6, temperature=0.0,
                                                   track_cp_penalty=True)
    for i, (f, c, e) in enumerate(singles):
        assert torch.equal(frames[i], f) and int(counts[i]) == int(c)
        assert bool(eos[i]) == bool(e)
