"""The port's package rules, checked without a model: it imports with jax,
optax, orbax and the JAX package made unimportable (the checkpoint tools,
the native BPE binding, profiling and their two scripts, and the
tp-sharded inference entry points included), and CUDA
asked for on a
host without it raises before any model file is read or any process group
is joined."""

import os
import subprocess
import sys

import pytest
import torch

from qwen3_tts_tpu_torch import pipeline as tpipe
from qwen3_tts_tpu_torch.parallel import sharding

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'qwen3_tts_tpu', 'optax', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[name] = None\n"
        "import qwen3_tts_tpu_torch\n"
        "from qwen3_tts_tpu_torch import cli, convert, pipeline, server, service, testing\n"
        "from qwen3_tts_tpu_torch.models import generate, prompt, serving, vocoder\n"
        "from qwen3_tts_tpu_torch.io import audit, verify\n"
        "from qwen3_tts_tpu_torch.frontend import native_bpe\n"
        "from qwen3_tts_tpu_torch.utils import profiling\n"
        "assert generate.stack_states and generate.decode_chunk_batched\n"
        "assert vocoder.speech_tokenizer_decode and testing.write_golden_model_dir\n"
        "import runpy\n"
        "for s in ('torch_audit_checkpoint', 'torch_verify_checkpoint'):\n"
        "    runpy.run_path(f'scripts/{s}.py', run_name='not_main')\n"
        "from qwen3_tts_tpu_torch.parallel import checkpoint, dryrun, sharding, train\n"
        "assert dryrun.run_inference and dryrun.main_inference and sharding.local_params\n"
        "assert sharding.gather_rows and sharding.Parallel.of_params\n"
        "assert service.TTSService.follow and testing.FakeByteTokenizer\n"
        "from qwen3_tts_tpu_torch.models import talker\n"
        "assert talker.decoder_layers and talker.kv_heads\n"
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
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.init_process_group("cuda", init_method=f"file://{tmp_path}/rendezvous")
