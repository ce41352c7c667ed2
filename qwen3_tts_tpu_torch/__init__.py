"""qwen3_tts_tpu_torch: the PyTorch/CUDA port of qwen3_tts_tpu for NVIDIA
Hopper GPUs.

It runs the single-stream TTS path (tokenizer -> prompt -> talker prefill ->
chunked decode with the code predictor -> vocoder) on an explicit device,
with hand-written sm_90a CUDA kernels for the int8 matmul and the three
vocoder stages (ops/cuda/, csrc/). It imports neither jax nor the JAX
package; the JAX package is the reference its tests hold it against.
"""

from .config import (
    CodePredictorConfig,
    Qwen3TTSConfig,
    QuantizationSettings,
    SpeechTokenizerConfig,
    TokenizerDecoderConfig,
)
from .frontend.tokenizer import Qwen3Tokenizer
from .pipeline import (
    AudioChunk,
    Qwen3TTSError,
    Qwen3TTSPipeline,
    Qwen3TTSPipelineConfiguration,
)

__version__ = "0.1.0"

__all__ = [
    "AudioChunk",
    "CodePredictorConfig",
    "Qwen3TTSConfig",
    "Qwen3TTSError",
    "Qwen3TTSPipeline",
    "Qwen3TTSPipelineConfiguration",
    "QuantizationSettings",
    "SpeechTokenizerConfig",
    "TokenizerDecoderConfig",
    "Qwen3Tokenizer",
    "__version__",
]
