"""The port against the JAX package at the 1.7B widths on the CPU, in fp32:
talker hidden 2048, intermediate 6144, 16 / 8 heads of 128, codec vocab
3072, and the 1024-wide code predictor reached through
small_to_mtp_projection (Qwen3TTSConfig.standard_1_7b()). Depth is cut to
2 talker and 2 code-predictor layers and the text vocabulary to 4096 rows
(the tokenizer's ids and the tts special tokens fit in it); every width is
the published one. K1 and K2 are held through their plain versions against
the JAX package's jnp mirrors (talker_step_w8a8_ref, predict_frame_w8a8_ref,
which its own tests pin to the Pallas kernels), K3 and K7 through theirs
against the JAX package's plain paths; the card's kernels are held against
these plain versions by tests/test_torch_cuda_1_7b.py and chip_smoke.py.

Tolerances (fp32, sums in another order; the W8A8 integer dots are exact
on both sides): logits and hidden states rel RMS 1e-4; K/V rows written by
a step to 1e-5 of their largest value (fp32 rounding of the same
arithmetic); the embedding sum 1e-4; K3 / K7 1e-5. Codes are compared
teacher-forced: a pick may differ from JAX's only where the two codes'
scores are within 5e-3 of the largest score (W8A8 near ties, see
tests/test_torch_megakernel_pipeline.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as jpipe
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.config import Qwen3TTSConfig as JConfig
from qwen3_tts_tpu.models import generate as jgen
from qwen3_tts_tpu.models import prompt as jprompt
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import cp_megakernel as jcpk
from qwen3_tts_tpu.ops.pallas import quant_matmul as jqm
from qwen3_tts_tpu.ops.pallas import talker_megakernel as jtk
from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.config import Qwen3TTSConfig
from qwen3_tts_tpu_torch.convert import to_torch
from qwen3_tts_tpu_torch.models import generate as tgen
from qwen3_tts_tpu_torch.models import prompt as tprompt
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as tcpk
from qwen3_tts_tpu_torch.ops.cuda import packed_matmul as tpm
from qwen3_tts_tpu_torch.ops.cuda import quant_matmul as tqm
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as ttk
from qwen3_tts_tpu_torch.ops.sampling import sample_token
from qwen3_tts_tpu_torch.testing import (
    random_host_cp_params,
    random_host_talker_params,
    tiny_decoder_config,
    write_model_dir,
)

torch.set_num_threads(1)
_FULL = Qwen3TTSConfig.standard_1_7b()
CFG = dataclasses.replace(
    _FULL, num_hidden_layers=2, text_vocab_size=4096, tts_bos_token_id=4000,
    tts_eos_token_id=4001, tts_pad_token_id=4002,
    code_predictor_config=dataclasses.replace(_FULL.code_predictor_config,
                                              num_hidden_layers=2),
)
JCFG = JConfig.from_json(jtesting.config_to_json_dict(CFG))
CAP = 64  # ring slots of the K1 cases
TEXT = "Hello there, this sentence checks the wide model."
# (K, O) of the 1.7B linears: qkv, o (and the text projection's fc1, fc2),
# gate/up, down, codec head
LINEARS = ((2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048), (2048, 3072))


def rel_rms(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)
                         / np.mean(ref.astype(np.float64) ** 2)))


@pytest.mark.parametrize("window", ["trimmed", "three_slots"])
def test_talker_step_plain_matches_jax(window):
    """K1's plain version against talker_step_w8a8_ref on a wrapped ring:
    slots 0..9 hold positions C..C+9 and the token at C+10 goes to slot
    10; the window starts 40 back (trimmed) or 3 back (three valid slots,
    so the token's own term carries a large share of each head)."""
    params = random_host_talker_params(CFG, seed=3)
    jtree = jtk.build_talker_kernel_params(params, JCFG)
    ttree = to_torch(ttk.build_talker_kernel_params(params, CFG))
    del params
    for k, v in jtree.items():
        np.testing.assert_array_equal(ttree[k].numpy(), np.asarray(v), err_msg=k)
    position = CAP + 10
    ws = position - (40 if window == "trimmed" else 3)
    slots = np.arange(CAP)
    pos = np.where(slots < 10, slots + CAP, slots).astype(np.int64)
    rng = np.random.default_rng(0)
    shape = (CFG.num_hidden_layers, 1, CFG.num_key_value_heads, CAP, CFG.head_dim)
    cache = {"k": (rng.standard_normal(shape) * 0.3).astype(np.float32),
             "v": (rng.standard_normal(shape) * 0.3).astype(np.float32), "pos": pos}
    embed = (rng.standard_normal((1, 1, CFG.hidden_size)) * 0.5).astype(np.float32)
    cos, sin = jtalker._rope_cos_sin(JCFG, jnp.full((1, 1), position, jnp.int32))
    jc2 = jtk.cache_to_kernel_layout({k: jnp.asarray(v) for k, v in cache.items()}, JCFG)
    jh, jlg, jnew = jax.block_until_ready(jtk.talker_step_w8a8_ref(
        jtree, jnp.asarray(embed), jc2, jnp.int32(position), jnp.int32(ws), cos[0], sin[0],
        JCFG))
    tc2 = ttk.cache_to_kernel_layout({k: torch.from_numpy(np.array(v))
                                      for k, v in cache.items()})
    th, tlg, tnew = ttk.talker_step(
        ttree, torch.from_numpy(embed), tc2, torch.tensor(position), torch.tensor(ws),
        torch.from_numpy(np.array(cos[0, 0])), torch.from_numpy(np.array(sin[0, 0])), CFG)
    assert rel_rms(th, jh) <= 1e-4
    assert rel_rms(tlg, jlg) <= 1e-4
    for name in ("k2", "v2"):
        nl, c, w = tnew[name].shape
        got = tnew[name].permute(1, 0, 2).reshape(c, nl * w).numpy()
        ref = np.asarray(jnew[name])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), name
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    assert int(tnew["pos"][position % CAP]) == position


def test_cp_frame_plain_matches_jax_through_the_projection():
    """K2's tree at the projection equals JAX's bit for bit; a greedy frame
    of its plain version (penalty on) picks JAX's codes except at near
    ties, and the 2048-wide embedding sum of those codes agrees."""
    cc, jcc = CFG.code_predictor_config, JCFG.code_predictor_config
    assert (CFG.hidden_size, CFG.intermediate_size, CFG.vocab_size, cc.hidden_size) == (
        2048, 6144, 3072, 1024)
    params = random_host_cp_params(CFG, seed=4)
    assert "small_to_mtp_projection" in params
    ref = jcpk.build_cp_kernel_params(params, jcc)
    kp = tcpk.build_cp_kernel_params(params, cc)
    del params
    assert sorted(kp) == sorted(ref)
    for k, v in ref.items():
        assert kp[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(kp[k], np.asarray(v), err_msg=k)
    assert kp["embr_q"].shape[-1] == 2048 and kp["emb_q"].shape[-1] == 1024
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((1, 1, CFG.hidden_size)).astype(np.float32)
    code0 = (rng.standard_normal((1, 1, CFG.hidden_size)) * 0.5).astype(np.float32)
    seen = rng.random((cc.num_code_groups - 1, cc.vocab_size)) < 0.3
    jcodes, jsum, _ = jax.block_until_ready(jcpk.predict_frame_w8a8_ref(
        jax.tree.map(jnp.asarray, ref), jnp.asarray(hidden), jnp.asarray(code0),
        jax.random.PRNGKey(0), jnp.float32(0.0), jnp.asarray(seen), jcc, 1.05))
    del ref
    tkp = to_torch(kp)
    jcodes = np.asarray(jcodes)
    logits = torch.empty(cc.num_code_groups - 1, cc.vocab_size)
    codes, esum, _ = tcpk.predict_frame_plain(
        tkp, torch.from_numpy(hidden), torch.from_numpy(code0),
        torch.zeros(1, dtype=torch.int64), 0.0, torch.from_numpy(seen.copy()), cc, 1.05,
        forced_codes=torch.from_numpy(jcodes).long(), logits_out=logits)
    ties = 0
    for k in range(len(jcodes)):
        score = logits[k] / torch.where(torch.from_numpy(seen[k]), 1.05, 1.0)
        pick = int(torch.argmax(score))
        if pick != jcodes[k]:
            ties += 1
            assert float(score[pick] - score[jcodes[k]]) <= 5e-3 * float(score.abs().max()), k
    assert ties <= 2
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    assert esum.shape == (1, 1, 2048)
    assert rel_rms(esum, jsum) <= 1e-4


def _jax_prefill(jpl, statics_kw):
    cfg = jpl.config
    jpd = jprompt.assemble_prompt(jpl.params, cfg, jpl.tokenizer, TEXT, speaker="aiden")
    p, t = jpd.input_embeds.shape[1], jpd.trailing_hidden.shape[1]
    pb, tb = jgen.pick_bucket(p), jgen.pick_bucket(t, jgen.TRAILING_BUCKETS)
    statics = jgen.GenStatics(config=cfg, capacity=pb + jgen.RING_SLACK, **statics_kw)
    emb = jnp.zeros((1, pb, cfg.hidden_size)).at[:, :p].set(jpd.input_embeds)
    trail = jnp.zeros((1, tb, cfg.hidden_size)).at[:, :t].set(jpd.trailing_hidden)
    state = jgen.prefill(jpl.params, emb, jnp.int32(p), trail, jnp.int32(t),
                         jpd.tts_pad_embed, jax.random.PRNGKey(0), statics)
    return jax.block_until_ready(state), statics


def test_megakernel_pipeline_prefill_and_frames_match_jax(tmp_path):
    """Both pipelines load one model dir at these widths with the
    megakernels on (JAX: GenStatics(kernel_mirror=True)): the prefill
    logits agree, and over 8 greedy frames that JAX decodes the port,
    forced onto JAX's frames, picks JAX's code 0 and its talker logits
    agree after every step."""
    write_model_dir(tmp_path, CFG, tiny_decoder_config(), weight_dtype=torch.float32)
    jpl = jpipe.Qwen3TTSPipeline(
        str(tmp_path), jpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=True, use_talker_megakernel=True, use_vocoder_kernels=False),
        dtype=jnp.float32)
    state, statics = _jax_prefill(jpl, dict(chunk_steps=1, track_cp_penalty=True,
                                            kernel_mirror=True))
    prefill_logits = np.asarray(state["logits"])
    frames, logits = [], []
    for _ in range(8):
        out, count, _, state = jgen.decode_chunk(jpl.params, jpl.cp_params, state,
                                                 jnp.float32(0.0), statics)
        assert int(count) == 1
        frames.append(np.array(out[0]))
        logits.append(np.asarray(state["logits"]))
    del jpl, state

    tpl = tpipe.Qwen3TTSPipeline(
        tmp_path, tpipe.Qwen3TTSPipelineConfiguration(
            use_cp_megakernel=True, use_talker_megakernel=True),
        device="cpu", dtype=torch.float32)
    assert tpl.cp_params["kernel"]["proj_w"].shape == (1024, 2048)
    tpd = tprompt.assemble_prompt(tpl.params, tpl.config, tpl.tokenizer, TEXT, speaker="aiden")
    ts = tgen.prefill(tpl.params, tpd, tpl.config)
    assert rel_rms(ts["logits"], prefill_logits) <= 1e-4
    eos_pad, valid = ts["masks"]
    for i, frame in enumerate(frames):
        # the port's own greedy code 0 from this state, as decode_step draws it
        lg = ts["logits"] + torch.where(ts["trailing_idx"] < ts["total_text"], eos_pad, 0.0)
        pick = sample_token(lg, None, 0.0, seen_mask=ts["seen_code0"], valid_mask=valid)
        assert int(pick) == frame[0], i
        out, emitted = tgen.decode_step(tpl.params, tpl.cp_params, ts, tpl.config,
                                        temperature=0.0, generator=None, track_cp_penalty=True,
                                        forced_frame=torch.from_numpy(frame).long())
        assert bool(emitted)
        np.testing.assert_array_equal(out.numpy(), frame)
        assert rel_rms(ts["logits"], logits[i]) <= 1e-4, i


@pytest.mark.parametrize("bits", [8, 4, 6], ids=["int8", "4bit", "6bit"])
def test_qmm_plain_matches_jax_at_the_wide_linears(bits):
    """K3's plain version (bits 8: uint8 rows) against the JAX package's
    int8_matmul on its plain path, and K7's (4 and 6 bits, MLX words)
    against quantized_matmul_ref, at every 1.7B linear shape (K = 6144 and
    O = 12288 among them), group 64, M = 3."""
    rng = np.random.default_rng(bits)
    for k, o in LINEARS:
        x = rng.standard_normal((3, k)).astype(np.float32)
        s = (rng.random((o, k // 64)) * 1e-3).astype(np.float32)
        b = (rng.standard_normal((o, k // 64)) * 0.02).astype(np.float32)
        if bits == 8:
            w = rng.integers(0, 256, (o, k), dtype=np.uint8)
            ref = jqm.int8_matmul(jnp.asarray(x), {"w8": jnp.asarray(w), "scales": jnp.asarray(s),
                                                   "biases": jnp.asarray(b)})
            got = tqm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(s), torch.from_numpy(b))
        else:
            w = rng.integers(0, 2 ** 32, (o, k * bits // 32), dtype=np.uint32)
            ref = jquant.quantized_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                              jnp.asarray(b), bits=bits, group_size=64)
            got = tpm.packed_matmul_plain(torch.from_numpy(x), torch.from_numpy(w.view(np.int32)),
                                          torch.from_numpy(s), torch.from_numpy(b), bits, 64)
        assert rel_rms(got, jax.block_until_ready(ref)) <= 1e-5, (k, o)
