"""Every generation mode at the 1.7B widths, the port against the JAX package
on the CPU in fp32: talker hidden 2048, intermediate 6144, codec vocab
3072, the 1024-wide code predictor through small_to_mtp_projection
(Qwen3TTSConfig.standard_1_7b()), depth cut to 2 talker and 2
code-predictor layers and the text vocabulary to 4096 rows, as in
tests/test_torch_1_7b.py. The speaker encoder is the published ECAPA
(SpeakerEncoderConfig() at its full channel widths) with enc_dim 2048, the
1.7B talker's hidden width, read from its fc weight, so its x-vector joins
the 2048-wide codec stream unprojected; the audio encoder is the tiny one
(its codes, not its widths, reach the talker). Both pipelines load one
directory written by testing.write_model_dir, runtime quantization off on
both (the modes differ only in their prompts; the kernels' plain versions
are held at these widths by tests/test_torch_1_7b.py).

- the x-vector of a 1 s clip against JAX's: max error <= 1e-5 of the
  largest value;
- per mode (VoiceDesign, CustomVoice, a speaker-embedding clone with that
  x-vector, ICL from a 5 s clip's worth of codes): the prompt against
  JAX's (rel RMS <= 1e-5), then the single stream's prefill and its first
  2 frames teacher-forced on JAX's greedy frames: talker logits rel RMS <=
  1e-4 after the prefill and each step, and the port's greedy code 0 from
  each state JAX's;
- the four modes and a built-in speaker in one lockstep batch (the service
  burst at 1.7B, its prompts padded to the service's buckets): the
  bootstrap prefill and 8 steps teacher-forced, every row's (every mode's)
  talker logits rel RMS <= 1e-4. The batched step costs a single stream's
  on the CPU (its weights read once for the 5 rows), so each mode's 8
  frames are taken here."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import serving as jsrv
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.models import serving as tsrv
from qwen3_tts_tpu_torch.ops.sampling import sample_token

torch.set_num_threads(1)
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=2, text_vocab_size=4096, tts_bos_token_id=4000,
    tts_eos_token_id=4001, tts_pad_token_id=4002,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2),
)
TEXT = "Hello there, this checks the wide modes."
TRANSCRIPT = ttesting.REFERENCE_TRANSCRIPT
FRAMES = 8  # teacher-forced steps of the batch
SINGLE_FRAMES = 2  # of each single stream, past its prefill
REF_CODES = 63  # the ICL reference: a 5 s clip's codes at 12.5 Hz
PB, TB = 128, 64  # the service's default buckets: one compiled prefill for every mode
# mode -> (speaker, prompt kwargs); "emb" / "codes": the clip's x-vector / codes
MODES = {
    "voice_design": ("", {"instruct": "A deep, calm narrator voice."}),
    "custom_voice": ("aiden", {"instruct": "Speak cheerfully."}),
    "speaker_embedding": ("", {"speaker_embedding": "emb"}),
    "icl": ("", {"reference_transcript": TRANSCRIPT, "reference_audio_codes": "codes"}),
}


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / np.mean(ref.astype(np.float64) ** 2)))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("modes_1_7b") / "model")
    ttesting.write_model_dir(d, CFG, ttesting.tiny_decoder_config(), seed=0,
                             weight_dtype=torch.float32, with_encoders=True,
                             encoder_config=ttesting.tiny_encoder_config(),  # its codes reach
                             # the talker, not its widths
                             tts_model_type="base")
    jpl = jpipe.Qwen3TTSPipeline(d, jpipe.Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False, use_cp_megakernel=False,
        use_talker_megakernel=False, use_vocoder_kernels=False), dtype=jnp.float32)
    tpl = tpipe.Qwen3TTSPipeline(d, tpipe.Qwen3TTSPipelineConfiguration(
        apply_runtime_quantization=False), device="cpu", dtype=torch.float32)
    enc = ttesting.tiny_encoder_config()  # 24 samples a code, not 1,920
    x = ttesting.reference_clip(1000, enc)  # 1 s
    emb, jemb = tpl.extract_speaker_embedding(x), jpl.extract_speaker_embedding(x)
    codes = tpl.encode_reference_audio(x[:REF_CODES * int(np.prod(enc.upsampling_ratios))
                                         * enc.compress])
    assert len(codes[0]) == REF_CODES
    extras = {"emb": emb, "codes": codes}
    modes = {name: (spk, {k: extras.get(v, v) if isinstance(v, str) else v
                          for k, v in kw.items()}) for name, (spk, kw) in MODES.items()}
    return SimpleNamespace(jpl=jpl, tpl=tpl, emb=emb, jemb=np.asarray(jemb), modes=modes)


def test_xvector_at_2048_matches_jax(pipes):
    jpl, tpl = pipes.jpl, pipes.tpl
    assert tpl.speaker_encoder.config.enc_dim == jpl.speaker_encoder.config.enc_dim == 2048
    assert pipes.emb.shape == pipes.jemb.shape == (2048,)
    assert np.abs(pipes.emb - pipes.jemb).max() <= 1e-5 * np.abs(pipes.jemb).max()
    for name in ("supports_voice_cloning", "supports_icl", "model_type"):
        assert getattr(tpl, name) == getattr(jpl, name), name
    assert tpl.supports_voice_cloning and tpl.supports_icl


def _padded(pd, h: int):
    p, t = pd.input_embeds.shape[1], pd.trailing_hidden.shape[1]
    assert p <= PB and t <= TB, (p, t)
    emb = jnp.zeros((1, PB, h)).at[:, :p].set(pd.input_embeds)
    trail = jnp.zeros((1, TB, h)).at[:, :t].set(pd.trailing_hidden)
    return emb, trail, p, t


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prompt_and_teacher_forced_frames_match_jax(pipes, mode):
    jpl, tpl = pipes.jpl, pipes.tpl
    spk, kw = pipes.modes[mode]
    jpd = jprompt.assemble_prompt(jpl.params, jpl.config, jpl.tokenizer, TEXT, speaker=spk, **kw)
    tpd = tpl._assemble(TEXT, spk, **kw)
    for name in ("input_embeds", "trailing_hidden", "tts_pad_embed"):
        assert rel_rms(getattr(tpd, name), getattr(jpd, name)) <= 1e-5, name
    emb, trail, p, t = _padded(jpd, CFG.hidden_size)
    statics = jgen.GenStatics(config=jpl.config, capacity=PB + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=True)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert rel_rms(ts["logits"], jax.block_until_ready(state["logits"])) <= 1e-4
    eos_pad, valid = ts["masks"]
    for i in range(SINGLE_FRAMES):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frame = np.array(out[0])
        lg = ts["logits"] + torch.where(ts["trailing_idx"] < ts["total_text"], eos_pad, 0.0)
        pick = sample_token(lg, None, 0.0, seen_mask=ts["seen_code0"], valid_mask=valid)
        assert int(pick) == frame[0], (mode, i)
        tgen.decode_step(tpl.params, tpl.cp_params, ts, tpl.config, temperature=0.0,
                         generator=None, track_cp_penalty=True,
                         forced_frame=torch.from_numpy(frame).long())
        assert rel_rms(ts["logits"], state["logits"]) <= 1e-4, (mode, i)


def test_mixed_modes_batched_match_jax(pipes):
    """The four modes and a built-in speaker padded to the service's
    buckets in one lockstep batch: prefill_batched, then 8 steps, the port
    forced onto JAX's greedy frames."""
    jpl, tpl = pipes.jpl, pipes.tpl
    reqs = list(pipes.modes.values()) + [("aiden", {})]
    b = len(reqs)
    jpds = [jprompt.assemble_prompt_padded(jpl.params, jpl.config, jpl.tokenizer, TEXT,
                                           speaker=spk, prompt_bucket=PB, trailing_bucket=TB,
                                           **kw) for spk, kw in reqs]
    tpds = [tprompt.assemble_prompt_padded(tpl.params, tpl.config, tpl.tokenizer, TEXT,
                                           speaker=spk, prompt_bucket=PB, trailing_bucket=TB,
                                           **kw) for spk, kw in reqs]
    lengths, totals = zip(*(jprompt.pd_lengths(pd) for pd in jpds))
    assert [tprompt.pd_lengths(pd) for pd in tpds] == list(zip(lengths, totals))
    assert len(set(lengths)) == b - 1, lengths  # an x-vector row stands where a speaker's does
    statics = jgen.GenStatics(config=jpl.config, capacity=PB + jgen.RING_SLACK, chunk_steps=1,
                              track_cp_penalty=False)
    jstate = jsrv.prefill_batched(
        jpl.params, jnp.concatenate([pd.input_embeds for pd in jpds]), jnp.asarray(lengths),
        jnp.concatenate([pd.trailing_hidden for pd in jpds]), jnp.asarray(totals),
        jpds[0].tts_pad_embed, jax.vmap(jax.random.PRNGKey)(jnp.arange(b)), statics)
    tstatics = tgen.GenStatics(config=tpl.config, capacity=PB + tgen.RING_SLACK,
                               chunk_steps=1, track_cp_penalty=False)
    tstate = tsrv.prefill_batched(
        tpl.params, torch.cat([pd.input_embeds for pd in tpds]), torch.tensor(lengths),
        torch.cat([pd.trailing_hidden for pd in tpds]), torch.tensor(totals),
        tpds[0].tts_pad_embed, torch.arange(b), tstatics)
    assert rel_rms(tstate["logits"], jax.block_until_ready(jstate["logits"])) <= 1e-4
    params, cp = tsrv._drop_kernel(tpl.params), tsrv._drop_kernel(tpl.cp_params)
    for i in range(FRAMES):
        frames, _, _, jstate = jsrv.decode_chunk_serving(
            jpl.params, jpl.cp_params, jstate, jnp.float32(0.0), statics)
        frame = np.asarray(jax.block_until_ready(frames))[:, 0]
        assert (frame[:, 0] >= 0).all(), i
        tsrv.lockstep_step(params, cp, tstate, torch.zeros(b), tstatics, False,
                           forced=torch.from_numpy(frame.astype(np.int64)))
        for j in range(b):
            assert rel_rms(tstate["logits"][j], jstate["logits"][j]) <= 1e-4, (i, j)
