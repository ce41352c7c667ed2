"""tp-sharded inference on one card (marked `cuda`; skipped where there is
no GPU): two gloo ranks share the card at tp = 2 (parallel/dryrun.py
run_inference, device="cuda"), on the tiny talker and code predictor in
bf16 with K2's tree, and the default vocoder with K4-K6's. Run on a GPU
host with:

    python -m pytest tests/test_torch_cuda_tp_inference.py -q --noconftest

- the sharded single stream launches K2 once a frame on every rank's
  decode, and its frames through the vocoder launch K4, K5, K6 and the
  blocks' upsample; the talker logits teacher-forced on the plain tree's
  frames agree with the plain tree's at bf16 (TOL);
- the eager lockstep step of the sharded tree at B = 2, teacher-forced on
  the plain tree's frames, agrees with the plain tree's eager step at
  TOL; each rank holds its local KV heads and no placed tree reaches
  serving.bind;
- the dp-placed vocode (2 rows, one a rank) agrees with the plain decode
  of both rows at bf16 kernel weights (TOL_VOCODER)."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.config import TokenizerDecoderConfig
from qwen3_tts_tpu_torch.convert import vocoder_params
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.parallel import dryrun

pytestmark = pytest.mark.cuda
# bf16: each rank's row-parallel partial sums are rounded to bf16 before
# the fp32 all-reduce, where the plain product rounds once; the tiny
# model's two layers carry that as B = 8 against B = 1 does (TOL_BATCH in
# chip_smoke.py)
TOL = 2e-2
# the same bf16 kernels on the same rows, at B = 1 a rank against B = 2:
# their tiles split the rows otherwise and sum in another order (1.5e-2 on
# the card); chip_smoke's TOL_VOCODER_BF16
TOL_VOCODER = 5e-2


def rel_rms(got, ref) -> float:
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30))


@pytest.fixture(scope="module")
def run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from qwen3_tts_tpu_torch.ops.cuda import _build

    _build.lib()  # built once here; the two ranks load it
    problem = dryrun.inference_problem(decoder=TokenizerDecoderConfig())
    out = dryrun.run_inference(problem, cases=("single", "serving", "vocode"), device="cuda",
                               dtype=torch.bfloat16, kernels=True, timeout_s=600.0)
    return problem, out


def test_sharded_single_stream_runs_the_kernels(run):
    problem, out = run
    assert out["backend"] == "gloo" and out["mesh"]["tp"] == {"dp": 1, "tp": 2}
    single = out["single"]
    n = len(single["sharded"]["tf"]["picks"])
    launches = single["launches"]
    # K2 a frame: the plain and sharded decodes (STEPS each), the
    # teacher-forced passes' free and forced steps (2n each, two trees)
    assert launches["cp_frame"] == 2 * dryrun.STEPS + 4 * n, launches
    for k in ("pre_transformer", "upsample_stage", "residual_units", "block_upsample"):
        assert launches[k] > 0, (k, launches)
    err = rel_rms(single["sharded"]["tf"]["logits"], single["plain"]["tf"]["logits"])
    assert err <= TOL, err
    assert single["reduces"] > 0
    kv = problem["config"].num_key_value_heads
    assert single["sharded"]["kv_heads"] == kv // 2 and single["plain"]["kv_heads"] == kv


def test_sharded_eager_step_matches_plain_eager_step(run):
    problem, out = run
    serving = out["serving"]
    sharded, plain = serving["sharded"]["tf"], serving["plain"]["tf"]
    assert len(sharded["logits"]) > 1
    err = rel_rms(sharded["logits"], plain["logits"])
    assert err <= TOL, err
    assert serving["sharded"]["kv_heads"] == problem["config"].num_key_value_heads // 2
    assert out["sharded_binds"] == 0 and out["bind_refuses_placed"]


def test_dp_vocode_matches_plain(run):
    problem, out = run
    vocode = out["vocode"]
    assert vocode["local_rows"] == 1 and vocode["placements"] == ["S(0)", "R"]
    vp = vocoder_params(problem["vocoder"], problem["decoder"], "cuda",
                        kernel_dtype=torch.bfloat16)
    ref = voc.decode_frames(vp, torch.from_numpy(np.asarray(problem["codes"])).cuda(),
                            problem["decoder"]).cpu()
    assert vocode["launches"]["residual_units"] > 0
    assert rel_rms(vocode["wav"], ref) <= TOL_VOCODER
