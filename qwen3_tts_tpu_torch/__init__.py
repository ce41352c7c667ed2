"""qwen3_tts_tpu_torch: the PyTorch/CUDA port of qwen3_tts_tpu for NVIDIA
Hopper GPUs.

It runs single-stream TTS (tokenizer -> prompt -> talker prefill -> chunked
decode with the code predictor -> vocoder) on an explicit device in every
generation mode: built-in speakers, VoiceDesign and CustomVoice instructs,
speaker-embedding and ICL voice cloning with the speaker and audio
encoders, long text. Every Pallas TPU kernel of the JAX package has a
hand-written sm_90a CUDA counterpart (ops/cuda/, csrc/). It imports neither
jax nor the JAX package; the JAX package is the reference its tests hold
it against.
"""

from .config import (
    CodePredictorConfig,
    Qwen3TTSConfig,
    QuantizationSettings,
    SpeakerEncoderConfig,
    SpeechTokenizerConfig,
    TokenizerDecoderConfig,
    TokenizerEncoderConfig,
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
    "SpeakerEncoderConfig",
    "SpeechTokenizerConfig",
    "TokenizerDecoderConfig",
    "TokenizerEncoderConfig",
    "Qwen3Tokenizer",
    "__version__",
]
