"""Unported pipeline configurations raise NotImplementedError naming their
ROADMAP item, before any model file is read: the talker and code-predictor
megakernels (K1, K2) and the mixed 4/6-bit mode (K7)."""

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe

torch.set_num_threads(1)


@pytest.mark.parametrize("kwargs", [
    {"use_talker_megakernel": True}, {"use_cp_megakernel": True},
    {"runtime_quantization_mode": "mixed_4_6"},
])
def test_unported_configurations_raise(tmp_path, kwargs):
    cfg = tpipe.Qwen3TTSPipelineConfiguration(**kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.Qwen3TTSPipeline(str(tmp_path), cfg, device="cpu", dtype=torch.float32)
