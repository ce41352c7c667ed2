"""High-level TTS pipeline of the PyTorch port: load a model directory and
synthesize with a built-in speaker, blocking or streaming (counterpart of
qwen3_tts_tpu/pipeline.py's single-stream main path).

Model directory layout (the reference's):
  config.json            talker config (flat or nested talker_config)
  model.safetensors      talker + code predictor
  tokenizer.json         BPE tokenizer
  speech_tokenizer/      vocoder config.json + model.safetensors

Loading quantizes every talker and code-predictor linear and table to int8
group-64 affine (runtime_quantization_mode="int8"); those linears run the
K3 kernel, and the vocoder runs K4/K5/K6 when use_vocoder_kernels is set.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .config import Qwen3TTSConfig, SpeechTokenizerConfig
from .convert import to_torch
from .frontend.tokenizer import Qwen3Tokenizer
from .io import checkpoint as ckpt
from .io import safetensors_io
from .models import generate as gen_mod
from .models import prompt as prompt_mod
from .models import vocoder as voc
from .ops.quant import apply_int8_quantization
from .utils.device import resolve_device
from .utils.postprocess import sanitize_samples

SAMPLE_RATE = 24000
DECODE_CHUNK_SIZE = 18
LEFT_CONTEXT_SIZE = 8


@dataclass
class AudioChunk:
    """A chunk of generated audio for streaming playback."""

    samples: np.ndarray
    token_range: tuple[int, int]
    is_final: bool


@dataclass(frozen=True)
class Qwen3TTSPipelineConfiguration:
    """Pipeline options. The megakernels (K1, K2) and the mixed 4/6-bit mode
    (K7) are not ported: asking for them raises NotImplementedError."""

    runtime_quantization_mode: str = "int8"
    default_temperature: float = 0.85
    default_max_tokens: int = 2400
    default_streaming_chunk_size: int = 12
    use_cp_megakernel: bool = False
    use_talker_megakernel: bool = False
    use_vocoder_kernels: bool = True


class Qwen3TTSError(Exception):
    """Load-time errors."""


def _check_configuration(pc: Qwen3TTSPipelineConfiguration) -> None:
    if pc.use_talker_megakernel:
        raise NotImplementedError(
            "use_talker_megakernel: the talker megakernel (K1, "
            "talker_megakernel.py::_talker_kernel) is not ported yet; ROADMAP "
            "Queue 2, item K1"
        )
    if pc.use_cp_megakernel:
        raise NotImplementedError(
            "use_cp_megakernel: the code-predictor megakernel (K2, "
            "cp_megakernel.py::_cp_kernel) is not ported yet; ROADMAP Queue 2, "
            "item K2"
        )
    if pc.runtime_quantization_mode != "int8":
        raise NotImplementedError(
            f"runtime_quantization_mode={pc.runtime_quantization_mode!r}: packed "
            "sub-byte weights need kernel K7 (quant_matmul.py::_kernel); ROADMAP "
            "Queue 2, item K7"
        )


class Qwen3TTSPipeline:
    sample_rate = SAMPLE_RATE

    def __init__(
        self,
        model_path: str | os.PathLike,
        configuration: Qwen3TTSPipelineConfiguration | None = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ):
        self.pipeline_config = configuration or Qwen3TTSPipelineConfiguration()
        _check_configuration(self.pipeline_config)
        self.device = resolve_device(device)
        self._dtype = dtype
        model_path = os.fspath(model_path)
        self.model_path = model_path
        cfg_path = os.path.join(model_path, "config.json")
        weights_path = os.path.join(model_path, "model.safetensors")
        st_dir = os.path.join(model_path, "speech_tokenizer")
        for p in (cfg_path, weights_path):
            if not os.path.exists(p):
                raise Qwen3TTSError(f"Required file not found: {p}")
        with open(cfg_path, "r", encoding="utf-8") as f:
            self.config = Qwen3TTSConfig.from_json(f.read())
        self.tokenizer = Qwen3Tokenizer(model_path)

        params, cp_params = ckpt.load_talker_checkpoint(
            safetensors_io.load_file(weights_path), self.config, dtype=np.float32
        )
        self.params = to_torch(apply_int8_quantization(params), self.device, dtype)
        self.cp_params = to_torch(apply_int8_quantization(cp_params), self.device, dtype)
        del params, cp_params

        st_cfg_path = os.path.join(st_dir, "config.json")
        st_weights_path = os.path.join(st_dir, "model.safetensors")
        if not (os.path.exists(st_cfg_path) and os.path.exists(st_weights_path)):
            raise Qwen3TTSError(f"Required file not found: {st_dir}")
        with open(st_cfg_path, "r", encoding="utf-8") as f:
            self.speech_config = SpeechTokenizerConfig.from_json(f.read())
        dec_cfg = self.speech_config.decoder_config
        # the dense vocoder tree stays fp32 (as in the JAX pipeline); the
        # kernels' GEMM weights take the pipeline dtype
        self.vocoder_params = to_torch(
            ckpt.load_vocoder_checkpoint(
                safetensors_io.load_file(st_weights_path), dec_cfg, dtype=np.float32
            ),
            self.device, torch.float32,
        )
        if self.pipeline_config.use_vocoder_kernels:
            self.vocoder_params["kernel"] = voc.build_vocoder_kernel_params(
                self.vocoder_params, dec_cfg, dtype
            )
        self._samples_per_frame = dec_cfg.total_upsample

    @property
    def available_speakers(self) -> list[str]:
        return sorted(self.config.spk_id.keys())

    def _assemble(self, text: str, speaker: str, **prompt_kwargs):
        return prompt_mod.assemble_prompt(
            self.params, self.config, self.tokenizer, text, speaker=speaker, **prompt_kwargs
        )

    def _generate_codes(self, text, speaker="", *, temperature=None, max_tokens=None,
                        seed=0, **prompt_kwargs) -> np.ndarray:
        pd = self._assemble(text, speaker, **prompt_kwargs)
        if pd is None:
            return np.zeros((0, self.config.code_predictor_config.num_code_groups), np.int32)
        frames = gen_mod.generate_codes(
            self.params, self.cp_params, self.config, pd,
            temperature=(temperature if temperature is not None
                         else self.pipeline_config.default_temperature),
            max_tokens=(max_tokens if max_tokens is not None
                        else self.pipeline_config.default_max_tokens),
            seed=seed,
        )
        return gen_mod.filter_valid_frames(frames)

    def _decode_to_audio(self, frames: np.ndarray) -> np.ndarray:
        """codes [T, 16] -> cleaned float32 samples [T * samples_per_frame],
        in 100-frame rows with 10 frames of context (env overrides
        QWEN3TTS_DECODE_CHUNK_SIZE / QWEN3TTS_DECODE_LEFT_CONTEXT)."""
        if len(frames) == 0:
            return np.zeros(0, np.float32)
        wav = voc.chunked_decode(
            self.vocoder_params, frames.T[None], self.speech_config.decoder_config,
            device=self.device,
            chunk_size=int(os.environ.get("QWEN3TTS_DECODE_CHUNK_SIZE", "100")),
            left_context=int(os.environ.get("QWEN3TTS_DECODE_LEFT_CONTEXT", "10")),
        )
        return sanitize_samples(wav[0])

    def generate(self, text: str, speaker: str = "", *, temperature: float | None = None,
                 max_tokens: int | None = None, seed: int = 0, **prompt_kwargs) -> np.ndarray:
        """Blocking synthesis with a built-in speaker: float32 PCM at 24 kHz."""
        frames = self._generate_codes(
            text, speaker, temperature=temperature, max_tokens=max_tokens, seed=seed,
            **prompt_kwargs,
        )
        return self._decode_to_audio(frames)

    def generate_stream(
        self,
        text: str,
        speaker: str = "",
        *,
        temperature: float | None = None,
        max_tokens: int | None = None,
        chunk_size: int | None = None,
        first_decode_chunk: int | None = None,
        seed: int = 0,
        **prompt_kwargs,
    ) -> Iterator[AudioChunk]:
        """Buffer-and-batch streaming: decode every 18 valid frames with 8
        frames of re-decoded left context, flush the remainder, then an empty
        final sentinel. As in the reference, is_final may come TWICE (the
        flushed remainder and the sentinel). Streaming skips the code
        predictor's repetition sets."""
        chunk = chunk_size or self.pipeline_config.default_streaming_chunk_size
        next_decode = first_decode_chunk or DECODE_CHUNK_SIZE
        pd = self._assemble(text, speaker, **prompt_kwargs)
        total = 0
        if pd is not None:
            code_stream = gen_mod.stream_codes(
                self.params, self.cp_params, self.config, pd,
                temperature=(temperature if temperature is not None
                             else self.pipeline_config.default_temperature),
                max_tokens=(max_tokens if max_tokens is not None
                            else self.pipeline_config.default_max_tokens),
                chunk_steps=chunk, track_cp_penalty=False, seed=seed,
            )
            buffered = np.zeros((0, self.config.code_predictor_config.num_code_groups),
                                np.int32)
            left_context = None
            for frames in code_stream:
                valid = gen_mod.filter_valid_frames(frames)
                if len(valid) == 0:
                    continue
                buffered = np.concatenate([buffered, valid])
                while len(buffered) >= next_decode:
                    batch, buffered = buffered[:next_decode], buffered[next_decode:]
                    next_decode = DECODE_CHUNK_SIZE
                    samples, left_context = self._decode_with_context(batch, left_context)
                    total += len(batch)
                    yield AudioChunk(sanitize_samples(samples), (total - len(batch), total), False)
            if len(buffered):
                samples, left_context = self._decode_with_context(buffered, left_context)
                total += len(buffered)
                yield AudioChunk(sanitize_samples(samples), (total - len(buffered), total), True)
        yield AudioChunk(np.zeros(0, np.float32), (total, total), True)

    def _decode_with_context(self, frames: np.ndarray, left_context):
        """One vocoder call over `frames` with optional re-decoded left
        context: returns (samples of `frames`, next left context)."""
        if left_context is not None:
            decode_input = np.concatenate([left_context, frames])
            drop = len(left_context) * self._samples_per_frame
        else:
            decode_input, drop = frames, 0
        codes = torch.from_numpy(np.ascontiguousarray(decode_input.T[None])).long()
        wav = voc.decode_frames(
            self.vocoder_params, codes.to(self.device), self.speech_config.decoder_config
        )
        return wav[0].cpu().numpy()[drop:], frames[-LEFT_CONTEXT_SIZE:]
