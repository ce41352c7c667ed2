"""High-level TTS pipeline of the PyTorch port: load a model directory and
synthesize with a built-in speaker, blocking or streaming (counterpart of
qwen3_tts_tpu/pipeline.py's single-stream main path).

Model directory layout (the reference's):
  config.json            talker config (flat or nested talker_config)
  model.safetensors      talker + code predictor
  tokenizer.json         BPE tokenizer
  speech_tokenizer/      vocoder config.json + model.safetensors

Loading mirrors the JAX pipeline's rules. A checkpoint declared pre-quantized
(config.json `quantization`, as MLX's 4/6/8-bit checkpoints) keeps its
packed linears and tables, which run K7 and gather-dequant lookups. Otherwise
the talker and code predictor are quantized at load
(apply_runtime_quantization): runtime_quantization_mode="int8" gives int8
group-64 entries on K3, any other mode the reference's mixed 4/6-bit packed
entries on K7. With the megakernels on (the default on CUDA) the decode loop
runs K1 per talker step and K2 per code-predictor frame, built from the
loaded weights; for a pre-quantized checkpoint or the int8 mode their
rowwise int8 trees are the only resident copy of the layer weights, the
codec head and the cp tables (prefill reads them through `w8r` views),
while in the mixed mode the packed copies stay resident beside them. The
vocoder runs K4/K5/K6 when use_vocoder_kernels is set.
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
from .ops.cuda.cp_megakernel import build_cp_kernel_params
from .ops.cuda.talker_megakernel import build_talker_kernel_params
from .ops.quant import (
    KERNEL_SHARED_LINS,
    apply_int8_quantization,
    apply_mixed_quantization,
    kernel_w8r_view,
)
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
    """Pipeline options. apply_runtime_quantization: quantize a checkpoint
    that is not pre-quantized at load, in runtime_quantization_mode "int8"
    (K3) or any other mode, which is the mixed 4/6-bit scheme (K7).
    use_talker_megakernel / use_cp_megakernel: None means on when the
    pipeline's device is CUDA (the JAX package turns them on for its
    accelerator); True on the CPU runs their plain versions; False runs the
    layer-by-layer path."""

    apply_runtime_quantization: bool = True
    runtime_quantization_mode: str = "int8"
    default_temperature: float = 0.85
    default_max_tokens: int = 2400
    default_streaming_chunk_size: int = 12
    use_cp_megakernel: bool | None = None
    use_talker_megakernel: bool | None = None
    use_vocoder_kernels: bool = True


class Qwen3TTSError(Exception):
    """Load-time errors."""


_TALKER_SHARED = ("layers", "codec_head")
_CP_SHARED = ("layers", "lm_head", "codec_embedding")


def _quantize(tree: dict, shared: tuple[str, ...], int8_mode: bool) -> dict:
    """Runtime quantization (int8 group-64, or mixed 4/6-bit packed) of every
    subtree not shared with a megakernel (the shared ones are dropped once
    the kernel tree is built)."""
    sub = {k: v for k, v in tree.items() if k not in shared}
    sub = apply_int8_quantization(sub) if int8_mode else apply_mixed_quantization(sub)
    return {**tree, **sub}


def _drop_shared(tree: dict, tables: tuple[str, ...]) -> dict:
    """The tree without the entries the kernel tree replaces. Entries with a
    bias stay (the kernels carry none)."""
    lay = {k: v for k, v in tree["layers"].items()
           if not (k in dict(KERNEL_SHARED_LINS) and "b" not in v)}
    out = {k: v for k, v in tree.items() if not (k in tables and "b" not in v)}
    out["layers"] = lay
    return out


def _attach_views(tree: dict, tables: dict[str, str]) -> dict:
    """Fill the dropped entries with `w8r` views of tree["kernel"]'s tensors
    (the same storage: no copy)."""
    k = tree["kernel"]
    lay = dict(tree["layers"])
    for name, pre in KERNEL_SHARED_LINS:
        lay.setdefault(name, kernel_w8r_view(k, pre))
    out = dict(tree, layers=lay)
    for name, pre in tables.items():
        out.setdefault(name, kernel_w8r_view(k, pre))
    return out


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
        pc = self.pipeline_config
        on_cuda = self.device.type == "cuda"
        use_talker_k = on_cuda if pc.use_talker_megakernel is None else pc.use_talker_megakernel
        use_cp_k = on_cuda if pc.use_cp_megakernel is None else pc.use_cp_megakernel
        prequant = self.config.quantization is not None
        rq = pc.apply_runtime_quantization and not prequant
        int8_mode = pc.runtime_quantization_mode == "int8"
        # Buffer sharing: the subtrees a megakernel streams are not runtime-
        # quantized; the kernel tree is built from the loaded weights (packed
        # ones included), those host copies are dropped before upload, and
        # prefill reads the kernel's tensors through `w8r` views. Off in the
        # mixed mode, whose packed copies stay resident beside the kernels.
        share_talker = use_talker_k and (prequant or (rq and int8_mode))
        share_cp = use_cp_k and (prequant or (rq and int8_mode))
        if use_talker_k:
            tkp = build_talker_kernel_params(params, self.config)
        if use_cp_k:
            ckp = build_cp_kernel_params(cp_params, self.config.code_predictor_config)
        if rq:
            params = _quantize(params, _TALKER_SHARED if share_talker else (), int8_mode)
            cp_params = _quantize(cp_params, _CP_SHARED if share_cp else (), int8_mode)
        if share_talker:
            params = _drop_shared(params, ("codec_head",))
        if share_cp:
            cp_params = _drop_shared(cp_params, ("lm_head", "codec_embedding"))
        self.params = to_torch(params, self.device, dtype)
        self.cp_params = to_torch(cp_params, self.device, dtype)
        del params, cp_params
        # the kernel trees keep their exact format: int8 weights, fp32 rest
        if use_talker_k:
            self.params["kernel"] = to_torch(tkp, self.device, torch.float32)
            if share_talker:
                self.params = _attach_views(self.params, {"codec_head": "ch"})
        if use_cp_k:
            kern = to_torch(ckp, self.device, torch.float32)
            for part in ("q", "s", "m"):  # unprojected: emb and embr are one table
                if ckp[f"embr_{part}"] is ckp[f"emb_{part}"]:
                    kern[f"embr_{part}"] = kern[f"emb_{part}"]
            self.cp_params["kernel"] = kern
            if share_cp:
                # the raw (unprojected) tables: the layer path projects itself
                self.cp_params = _attach_views(
                    self.cp_params, {"lm_head": "head", "codec_embedding": "embr"})

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

    def model_resident_bytes(self) -> int:
        """Device bytes of the resident model (talker, code predictor,
        vocoder), counting each storage once: the megakernel trees and their
        `w8r` views share theirs."""
        seen: set[tuple[str, int]] = set()
        total = 0

        def walk(node):
            nonlocal total
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            elif isinstance(node, torch.Tensor):
                st = node.untyped_storage()
                key = (str(node.device), st.data_ptr())
                if key not in seen:
                    seen.add(key)
                    total += st.nbytes()

        for tree in (self.params, self.cp_params, self.vocoder_params):
            walk(tree)
        return total

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
