"""The port's generation modes against the JAX pipeline on the CPU in fp32,
both loading one tiny model directory with both encoders (speaker encoder
in the main file, audio encoder in the vocoder file, in the reference's
key layout), with runtime quantization off on both. The directory comes
from the port's numpy writer, testing.write_model_dir(with_encoders=True),
which the JAX loaders read here: JAX's own writer draws every array with
jax.random and costs more CPU than the rest of this file.

- an ICL prompt built from the JAX encoder's reference codes, decoded
  teacher-forced (JAX's 40 greedy frames fed into the port): talker logits
  at every step within rel RMS 1e-4;
- extract_speaker_embedding (rel max 1e-5) and encode_reference_audio
  (equal codes) against JAX's, and the capability surface;
- generate_batch, generate_to_file and _decode_chunked on those JAX frames
  (each pipeline's _generate_codes replaced by one that hands out the same
  frames): waveforms within rel RMS 1e-4, WAV header and length equal.

The port runs its vocoder through the K4/K5/K6 plain versions, the JAX
pipeline through its plain jnp vocoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.io.wav import parse_wav
from qwen3_tts_tpu_torch.models import generate as tgen

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the cloning modes end to end."
LONG = ("The first sentence of this long text talks about the weather, which was calm "
        "and bright all through the quiet morning hours before anyone in the small town "
        "woke up. The second sentence moves on to the busy market, where people bought "
        "bread and fruit and talked with their neighbours for a long while in the sun. "
        "The third sentence ends the story as the sun goes down slowly over the hills and "
        "the children walk home along the river for their supper.")
TRANSCRIPT = "The words spoken in the reference clip."


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def clip(seconds: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(7)
    t = np.arange(int(24000 * seconds)) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(len(t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("modes") / "model")
    ttesting.write_model_dir(
        d, ttesting.tiny_talker_config(), ttesting.tiny_decoder_config(), seed=0,
        weight_dtype=torch.float32, with_encoders=True,
        speaker_config=ttesting.tiny_speaker_config(),
        encoder_config=ttesting.tiny_encoder_config(), tts_model_type="base")
    jpl = jpipe.Qwen3TTSPipeline(d, jpipe.Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False, use_cp_megakernel=False,
        use_talker_megakernel=False, use_vocoder_kernels=False), dtype=jnp.float32)
    tpl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False), device="cpu", dtype=torch.float32)
    return jpl, tpl


@pytest.fixture(scope="module")
def icl(pipes):
    """JAX's ICL prompt (reference codes from JAX's encoder) and its greedy
    decode, one frame per chunk: (prompt, logits after prefill and each
    step, frames)."""
    jpl, _ = pipes
    codes = jpl.encode_reference_audio(clip())
    jpd = jprompt.assemble_prompt(jpl.params, jpl.config, jpl.tokenizer, TEXT,
                                  reference_transcript=TRANSCRIPT, reference_audio_codes=codes)
    cfg = jpl.config
    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    logits, frames = [np.asarray(state["logits"])], []
    for _ in range(40):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))
    return codes, jpd, logits, np.stack(frames)


def test_icl_prompt_teacher_forced_logits_match(pipes, icl):
    _, tpl = pipes
    codes, jpd, logits, frames = icl
    tpd = tpl._assemble(TEXT, "", reference_transcript=TRANSCRIPT, reference_audio_codes=codes)
    assert rel_rms(tpd.input_embeds, jpd.input_embeds) <= 1e-5
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert rel_rms(ts["logits"], logits[0]) <= 1e-4
    for i, frame in enumerate(frames):
        tgen.decode_step(tpl.params, tpl.cp_params, ts, tpl.config, temperature=0.0,
                         generator=None, track_cp_penalty=True,
                         forced_frame=torch.from_numpy(frame).long())
        assert rel_rms(ts["logits"], logits[i + 1]) <= 1e-4, i


def test_encoders_and_capabilities_match_jax(pipes):
    jpl, tpl = pipes
    for name in ("supports_voice_cloning", "supports_icl", "model_type",
                 "supports_voice_design", "supports_custom_voice", "available_speakers"):
        assert getattr(tpl, name) == getattr(jpl, name), name
    assert tpl.supports_voice_cloning and tpl.supports_icl and tpl.model_type == "base"
    x = clip(0.7)
    ref = jpl.extract_speaker_embedding(x)
    got = tpl.extract_speaker_embedding(x)
    assert got.shape == ref.shape == (tpl.config.hidden_size,)
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= 1e-5
    jc, tc = jpl.encode_reference_audio(x), tpl.encode_reference_audio(x)
    assert len(tc) == len(jc) == tpl.speech_config.encoder_valid_num_quantizers
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)
    enc = tpipe.resident_bytes(tpl.speaker_encoder.params, tpl.audio_encoder.params)
    bare = tpipe.resident_bytes(tpl.params, tpl.cp_params, tpl.vocoder_params)
    assert enc > 0 and tpl.model_resident_bytes() == bare + enc


def fake_codes(frames, lengths, calls):
    """A _generate_codes stand-in: call k hands out frames[:lengths[k]] and
    records the chunk's text, max_tokens and seed."""

    def gen(text, speaker="", **kw):
        calls.append((text, kw.get("max_tokens"), kw.get("seed")))
        return frames[: lengths[(len(calls) - 1) % len(lengths)]]

    return gen


def test_generate_batch_matches_jax_on_the_same_frames(pipes, icl, monkeypatch):
    jpl, tpl = pipes
    frames = icl[3]
    out = {}
    for name, pl in (("jax", jpl), ("port", tpl)):
        calls: list = []
        monkeypatch.setattr(pl, "_generate_codes", fake_codes(frames, [31, 0, 17], calls))
        out[name] = (pl.generate_batch(LONG, "aiden", seed=3), calls)
        out[name + "_one"] = pl.generate_batch(TEXT, "aiden", instruct="Calm.", seed=3)
        assert calls[3] == (TEXT, None, 3)  # one chunk: the whole prompt, default length
    (ref, jcalls), (got, tcalls) = out["jax"], out["port"]
    assert tcalls == jcalls and [c[1:] for c in tcalls[:3]] == [(600, 3), (600, 4), (600, 5)]
    spf = tpl._samples_per_frame
    assert got.shape == ref.shape == ((31 + 17) * spf - 480,)  # chunk 2 yields nothing
    assert rel_rms(got, ref) <= 1e-4
    assert out["port_one"].shape == out["jax_one"].shape == (31 * spf,)
    assert rel_rms(out["port_one"], out["jax_one"]) <= 1e-4


def test_generate_to_file_and_decode_chunked_match_jax(pipes, icl, monkeypatch, tmp_path):
    jpl, tpl = pipes
    frames = icl[3]
    data = {}
    for name, pl in (("jax", jpl), ("port", tpl)):
        monkeypatch.setattr(pl, "_generate_codes", fake_codes(frames, [23, 0, 14], []))
        path = tmp_path / f"{name}.wav"
        count = pl.generate_to_file(LONG, path, "aiden", seed=1)
        data[name] = (count, path.read_bytes())
    (jn, jb), (tn, tb) = data["jax"], data["port"]
    spf = tpl._samples_per_frame
    assert tn == jn == (23 + 14) * spf and len(tb) == len(jb) == 44 + 2 * tn
    assert tb[:44] == jb[:44]
    tw, rate, _ = parse_wav(tb)
    jw, _, _ = parse_wav(jb)
    assert rate == 24000 and rel_rms(tw, jw) <= 1e-3  # 16-bit PCM: one LSB apart at most
    for size in (5, 16, 24):  # below and above the 8 frames of context
        ref = jpl._decode_chunked(frames[:37], decode_chunk_size=size)
        got = tpl._decode_chunked(frames[:37], decode_chunk_size=size)
        assert got.shape == ref.shape == (37 * spf,)
        assert rel_rms(got, ref) <= 1e-4, size
