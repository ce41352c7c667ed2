"""Every pipeline configuration of the port is accepted: the talker and
code-predictor megakernels (K1, K2) and the mixed 4/6-bit mode (K7), which
was refused before K7, so loading goes on to the (here missing) model
files."""

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe

torch.set_num_threads(1)


@pytest.mark.parametrize("kwargs, error, match", [
    ({"use_talker_megakernel": True}, tpipe.Qwen3TTSError, "Required file not found"),
    ({"use_cp_megakernel": True}, tpipe.Qwen3TTSError, "Required file not found"),
    ({"runtime_quantization_mode": "mixed_4_6"}, tpipe.Qwen3TTSError, "Required file not found"),
], ids=["kwargs0", "kwargs1", "kwargs2"])
def test_unported_configurations_raise(tmp_path, kwargs, error, match):
    cfg = tpipe.Qwen3TTSPipelineConfiguration(**kwargs)
    with pytest.raises(error, match=match):
        tpipe.Qwen3TTSPipeline(str(tmp_path), cfg, device="cpu", dtype=torch.float32)
