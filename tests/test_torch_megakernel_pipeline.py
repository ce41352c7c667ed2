"""The port's megakernel configuration against the JAX pipeline's, both
loading one tiny model directory with use_talker_megakernel and
use_cp_megakernel on, on the CPU in fp32. The port runs K1's and K2's plain
versions; JAX runs its kernels' jnp mirrors (decode_chunk with
GenStatics(kernel_mirror=True)), which its own tests pin to the kernels.

Tolerances: logits rel RMS 1e-4 per step (fp32 through several layers,
sums in another order). Greedy codes are compared teacher-forced: from the
same state, the port's pick must be JAX's, except at a near tie. W8A8 makes
codes sensitive to fp32 noise: a 1e-7 change of an input can move one
activation across a rounding boundary, and one int8 step moves a logit by
up to max|x| * s, a few 1e-4 here; so a pick may differ only where the two
codes' scores are within 5e-3 of the largest score, at most twice in the
run (one such tie occurs in these 24 frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.testing import tiny_decoder_config, tiny_talker_config, write_model_dir

torch.set_num_threads(1)
TEXT = "Hello there, this sentence checks the megakernel path end to end."


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = tmp_path_factory.mktemp("mk") / "model"
    # talker hidden 128 != cp hidden 64: the cp embeddings are projected
    write_model_dir(d, tiny_talker_config(hidden_size=128), tiny_decoder_config(),
                    weight_dtype=torch.float32)
    jpl = jpipe.Qwen3TTSPipeline(
        str(d), jpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=True, use_talker_megakernel=True, use_vocoder_kernels=False,
        ), dtype=jnp.float32,
    )
    tpl = tpipe.Qwen3TTSPipeline(
        d, tpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=True, use_talker_megakernel=True,
        ), device="cpu", dtype=torch.float32,
    )
    return jpl, tpl


def test_kernel_trees_are_the_only_copy_of_shared_weights(pipes):
    _, tpl = pipes
    tk, ck = tpl.params["kernel"], tpl.cp_params["kernel"]
    for tree, k in ((tpl.params, tk), (tpl.cp_params, ck)):
        for name, pre in (("qkv_proj", "qkv"), ("o_proj", "o"), ("gateup_proj", "gu"),
                          ("down_proj", "dn")):
            entry = tree["layers"][name]
            assert sorted(entry) == ["m", "s", "w8r"], name
            assert entry["w8r"] is k[f"{pre}_q"] and entry["s"] is k[f"{pre}_s"]
    assert tpl.params["codec_head"]["w8r"] is tk["ch_q"]
    assert tpl.cp_params["lm_head"]["w8r"] is ck["head_q"]
    assert tpl.cp_params["codec_embedding"]["w8r"] is ck["embr_q"]
    assert "w8" in tpl.params["text_projection"]["fc1"]  # K3 keeps the rest

    tensors = []

    def walk(node):
        if isinstance(node, (dict, list, tuple)):
            for v in (node.values() if isinstance(node, dict) else node):
                walk(v)
        elif isinstance(node, torch.Tensor):
            tensors.append(node)

    for tree in (tpl.params, tpl.cp_params, tpl.vocoder_params):
        walk(tree)
    unique = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    assert tpl.model_resident_bytes() == sum(unique.values())
    assert tpl.model_resident_bytes() < sum(t.untyped_storage().nbytes() for t in tensors)


def jax_prefill(jpl, statics_kw):
    cfg = jpl.config
    jpd = jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, TEXT, speaker="aiden")
    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, **statics_kw)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    return state, statics, p


def test_prefill_logits_match(pipes):
    jpl, tpl = pipes
    jstate, _, _ = jax_prefill(jpl, dict(chunk_steps=1, track_cp_penalty=True))
    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert sorted(ts["cache"]) == ["k2", "pos", "v2"]
    assert rel_rms(ts["logits"], jstate["logits"]) <= 1e-4


def clone_state(state: dict) -> dict:
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def test_teacher_forced_decode_matches_the_jax_mirrors(pipes):
    """24 greedy frames (past the step-15 window trim): JAX decodes one frame
    per chunk through its kernels' mirrors; the port replays JAX's frames.
    At every step the port's talker logits match, its own greedy code 0 is
    JAX's, and its code-predictor picks from the same inputs are JAX's
    except at near ties."""
    jpl, tpl = pipes
    cc = tpl.config.code_predictor_config
    state, statics, p = jax_prefill(
        jpl, dict(chunk_steps=1, track_cp_penalty=True, kernel_mirror=True))
    frames, logits = [], []
    for _ in range(24):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))
    assert int(state["step"]) == 24

    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    near_ties = 0
    for i, frame in enumerate(frames):
        free, _ = tgen.decode_step(tpl.params, tpl.cp_params, clone_state(ts), tpl.config,
                                   temperature=0.0, generator=None, track_cp_penalty=True)
        assert int(free[0]) == frame[0], i
        code0_embed = ttalker.encode_audio(tpl.params, torch.tensor([[int(frame[0])]]))
        cp_logits = []
        tcp.predict_frame(tpl.cp_params, ts["h_last"], code0_embed, None, 0.0,
                          ts["seen_cp"].clone(), cc,
                          forced_codes=torch.from_numpy(frame[1:]).long(), logits_out=cp_logits)
        pen = torch.where(ts["seen_cp"], 1.05, 1.0)
        for k, lg in enumerate(cp_logits):
            score = lg / pen[k]
            pick, want = int(torch.argmax(score)), int(frame[k + 1])
            if pick != want:
                near_ties += 1
                assert float(score[pick] - score[want]) <= 5e-3 * float(score.abs().max()), (i, k)
        out, emitted = tgen.decode_step(tpl.params, tpl.cp_params, ts, tpl.config,
                                        temperature=0.0, generator=None, track_cp_penalty=True,
                                        forced_frame=torch.from_numpy(frame).long())
        assert bool(emitted)
        np.testing.assert_array_equal(out.numpy(), frame)
        assert rel_rms(ts["logits"], logits[i]) <= 1e-4, i
    assert near_ties <= 2
    assert int(ts["step"]) == 24 and int(ts["total_len"]) == p + 24
    assert int(ts["window_start"]) == 0


def test_generate_and_stream_run_end_to_end(pipes):
    _, tpl = pipes
    spf = tpl._samples_per_frame
    audio = tpl.generate(TEXT, "aiden", max_tokens=20, seed=0)
    assert audio.dtype == np.float32 and np.isfinite(audio).all()
    assert 0 < len(audio) <= 20 * spf and len(audio) % spf == 0
    np.testing.assert_array_equal(audio, tpl.generate(TEXT, "aiden", max_tokens=20, seed=0))
    chunks = list(tpl.generate_stream(TEXT, "aiden", max_tokens=30, seed=1))
    pos = 0
    for ch in chunks:
        assert ch.token_range[0] == pos and len(ch.samples) == (ch.token_range[1] - pos) * spf
        pos = ch.token_range[1]
    assert pos > 0 and chunks[-1].is_final and len(chunks[-1].samples) == 0
