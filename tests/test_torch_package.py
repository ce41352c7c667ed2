"""The port's package rules, checked without a model: it imports with jax
and the JAX package made unimportable, and CUDA asked for on a host without
it raises before any model file is read."""

import os
import subprocess
import sys

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['qwen3_tts_tpu'] = None\n"
        "import qwen3_tts_tpu_torch\n"
        "from qwen3_tts_tpu_torch import cli, convert, pipeline, server, service, testing\n"
        "from qwen3_tts_tpu_torch.models import prompt, serving\n"
        "from qwen3_tts_tpu_torch.ops.cuda import _build, pretransformer_kernel, "
        "quant_matmul, upsample_kernel, vocoder_kernels\n"
        "import chip_smoke\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = str(tmp_path)  # the device is checked before any file is read
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.Qwen3TTSPipeline(d, device="cuda")
    monkeypatch.delenv("QWEN3TTS_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.Qwen3TTSPipeline(d)  # the default device is cuda
