"""High-level TTS pipeline of the PyTorch port: load a model directory and
expose every single-stream generation mode (counterpart of
qwen3_tts_tpu/pipeline.py): generate (built-in speaker, speaker embedding,
or any prompt mode by keyword), generate_voice_design,
generate_custom_voice, generate_icl, generate_stream and its VoiceDesign /
CustomVoice forms, generate_batch (long text with a 480-sample crossfade),
generate_to_file (streaming WAV), extract_speaker_embedding /
encode_reference_audio for cloning, and warmup; and batched serving of
several texts at once, generate_many and generate_many_stream
(models/serving.py; on CUDA each lockstep step replays a CUDA graph).

Model directory layout (the reference's):
  config.json            talker config (flat or nested talker_config)
  model.safetensors      talker + code predictor (+ optional speaker_encoder.*)
  tokenizer.json         BPE tokenizer
  speech_tokenizer/      vocoder config.json + model.safetensors
                         (+ optional encoder.* weights for ICL)

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
vocoder runs K4/K5/K6 when use_vocoder_kernels resolves on (_knob). The
speaker and audio encoders (plain PyTorch, fp32) load when their weights
are present.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from .config import Qwen3TTSConfig, SpeechTokenizerConfig
from .convert import to_torch
from .frontend.chunker import chunk_text
from .frontend.tokenizer import Qwen3Tokenizer
from .io import checkpoint as ckpt
from .io import safetensors_io
from .io.wav import StreamingWAVWriter
from .models import generate as gen_mod
from .models import prompt as prompt_mod
from .models import serving as srv
from .models import vocoder as voc
from .models.audio_encoder import AudioEncoder
from .models.speaker_encoder import SpeakerEncoder
from .ops.cuda import _build
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
    use_talker_megakernel / use_cp_megakernel / use_vocoder_kernels: None
    means on when the pipeline's device is CUDA (the JAX package turns them
    on for its accelerator); True on the CPU runs the kernels' plain
    versions; False runs the layer-by-layer path (the dense vocoder). The
    environment variables QWEN3TTS_TALKER_KERNEL, QWEN3TTS_CP_KERNEL and
    QWEN3TTS_VOCODER_KERNEL override them (_knob)."""

    apply_runtime_quantization: bool = True
    runtime_quantization_mode: str = "int8"
    default_temperature: float = 0.85
    default_max_tokens: int = 2400
    default_streaming_chunk_size: int = 12
    crossfade_samples: int = 480
    use_cp_megakernel: bool | None = None
    use_talker_megakernel: bool | None = None
    use_vocoder_kernels: bool | None = None


def _knob(cfg_value: bool | None, env_name: str, device: torch.device) -> bool:
    """A kernel switch, resolved as the JAX pipeline resolves it: the
    environment variable wins (any value but 0 / false / no / off / empty
    turns the kernel on), then the configuration value, then auto: on for a
    CUDA device."""
    env = os.environ.get(env_name)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off", "")
    if cfg_value is None:
        return device.type == "cuda"
    return cfg_value


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


def resident_bytes(*trees) -> int:
    """Bytes of the tensor storages in nested dicts / lists, each storage
    counted once."""
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

    walk(trees)
    return total


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

        weights = safetensors_io.load_file(weights_path)
        params, cp_params = ckpt.load_talker_checkpoint(weights, self.config, dtype=np.float32)
        # speaker encoder: "speaker_encoder." keys in the main file
        spk_keys = {k: v for k, v in weights.items() if k.startswith("speaker_encoder.")}
        self.speaker_encoder = (SpeakerEncoder.from_weights(spk_keys, device=self.device)
                                if spk_keys else None)
        del weights
        pc = self.pipeline_config
        use_talker_k = _knob(pc.use_talker_megakernel, "QWEN3TTS_TALKER_KERNEL", self.device)
        use_cp_k = _knob(pc.use_cp_megakernel, "QWEN3TTS_CP_KERNEL", self.device)
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
        st_weights = safetensors_io.load_file(st_weights_path)
        # the dense vocoder tree stays fp32 (as in the JAX pipeline); the
        # kernels' GEMM weights take the pipeline dtype
        self.vocoder_params = to_torch(
            ckpt.load_vocoder_checkpoint(st_weights, dec_cfg, dtype=np.float32),
            self.device, torch.float32,
        )
        # audio encoder for ICL: "encoder." keys in the vocoder file
        enc_keys = {k: v for k, v in st_weights.items() if "encoder." in k}
        self.audio_encoder = None
        if enc_keys and self.speech_config.encoder_config is not None:
            self.audio_encoder = AudioEncoder.from_weights(enc_keys, self.speech_config,
                                                           device=self.device)
        del st_weights
        if _knob(pc.use_vocoder_kernels, "QWEN3TTS_VOCODER_KERNEL", self.device):
            self.vocoder_params["kernel"] = voc.build_vocoder_kernel_params(
                self.vocoder_params, dec_cfg, dtype
            )
        self._samples_per_frame = dec_cfg.total_upsample

    def model_resident_bytes(self) -> int:
        """Device bytes of the resident model (talker, code predictor,
        vocoder, encoders), counting each storage once: the megakernel trees
        and their `w8r` views share theirs."""
        encoders = [e.params for e in (self.speaker_encoder, self.audio_encoder) if e]
        return resident_bytes(self.params, self.cp_params, self.vocoder_params, *encoders)

    def warmup(self, max_tokens: int = 24) -> None:
        """Build the CUDA kernels (on a CUDA device) and run one blocking and
        one streaming generation, so the first real call pays neither."""
        if self.device.type == "cuda":
            _build.lib()
        text = "Warm up the blocking and streaming generation paths."
        if self.available_speakers:
            kwargs: dict = {"speaker": self.available_speakers[0]}
        elif self.supports_voice_design:
            kwargs = {"instruct": "A warm, neutral narrator voice."}
        else:
            kwargs = {}
        self.generate(text, max_tokens=max_tokens, seed=0, **kwargs)
        for _ in self.generate_stream(text, max_tokens=max_tokens, seed=0, **kwargs):
            pass

    # -- capabilities ------------------------------------------------------

    @property
    def available_speakers(self) -> list[str]:
        return sorted(self.config.spk_id.keys())

    @property
    def supports_voice_cloning(self) -> bool:
        return self.speaker_encoder is not None

    @property
    def supports_icl(self) -> bool:
        return self.audio_encoder is not None

    @property
    def model_type(self) -> str | None:
        return self.config.tts_model_type

    @property
    def supports_voice_design(self) -> bool:
        return self.config.tts_model_type == "voice_design"

    @property
    def supports_custom_voice(self) -> bool:
        return self.config.tts_model_type == "custom_voice"

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
        return sanitize_samples(self._chunked_decode(frames.T[None])[0])

    def _chunked_decode(self, codes: np.ndarray, lengths: list[int] | None = None) -> np.ndarray:
        """vocoder.chunked_decode of codes [B, nq, T] in 100-frame rows with
        10 frames of context (or the QWEN3TTS_DECODE_* overrides)."""
        return voc.chunked_decode(
            self.vocoder_params, codes, self.speech_config.decoder_config, device=self.device,
            chunk_size=int(os.environ.get("QWEN3TTS_DECODE_CHUNK_SIZE", "100")),
            left_context=int(os.environ.get("QWEN3TTS_DECODE_LEFT_CONTEXT", "10")),
            lengths=lengths,
        )

    # -- generation modes --------------------------------------------------

    def generate(
        self,
        text: str,
        speaker: str = "",
        *,
        instruct: str | None = None,
        speaker_embedding=None,
        reference_transcript: str | None = None,
        reference_audio_codes=None,
        temperature: float | None = None,
        max_tokens: int | None = None,
        seed: int = 0,
    ) -> np.ndarray:
        """Blocking synthesis: float32 PCM at 24 kHz. Takes every prompt mode
        (a built-in speaker, a speaker embedding, an instruct, an ICL
        reference); the dedicated wrappers below name the common ones."""
        frames = self._generate_codes(
            text, speaker, instruct=instruct, speaker_embedding=speaker_embedding,
            reference_transcript=reference_transcript,
            reference_audio_codes=reference_audio_codes,
            temperature=temperature, max_tokens=max_tokens, seed=seed,
        )
        return self._decode_to_audio(frames)

    def generate_voice_design(self, text: str, voice_description: str, *,
                              temperature: float | None = None, max_tokens: int | None = None,
                              seed: int = 0) -> np.ndarray:
        """Synthesis from a natural-language voice description."""
        return self.generate(text, instruct=voice_description, temperature=temperature,
                             max_tokens=max_tokens, seed=seed)

    def generate_custom_voice(self, text: str, speaker: str, instruct: str, *,
                              temperature: float | None = None, max_tokens: int | None = None,
                              seed: int = 0) -> np.ndarray:
        """A built-in speaker with a style instruct."""
        return self.generate(text, speaker, instruct=instruct, temperature=temperature,
                             max_tokens=max_tokens, seed=seed)

    def generate_icl(self, text: str, reference_transcript: str, reference_audio_codes, *,
                     speaker: str = "", temperature: float | None = None,
                     max_tokens: int | None = None, seed: int = 0) -> np.ndarray:
        """In-context-learning voice cloning from a reference transcript and
        its codec codes (encode_reference_audio)."""
        return self.generate(text, speaker, reference_transcript=reference_transcript,
                             reference_audio_codes=reference_audio_codes,
                             temperature=temperature, max_tokens=max_tokens, seed=seed)

    # -- batched serving ---------------------------------------------------

    def _assemble_many(self, texts: list[str], speakers: list[str] | str):
        """(prompts, their texts' indices) of the texts long enough to
        prompt."""
        if isinstance(speakers, str):
            speakers = [speakers] * len(texts)
        pds, keep = [], []
        for i, (text, speaker) in enumerate(zip(texts, speakers)):
            pd = self._assemble(text, speaker)
            if pd is not None:
                pds.append(pd)
                keep.append(i)
        return pds, keep

    def generate_many(
        self,
        texts: list[str],
        speakers: list[str] | str = "",
        *,
        temperature: float | None = None,
        max_tokens: int | None = None,
        seed: int = 0,
    ) -> list[np.ndarray]:
        """Serve several utterances concurrently (lockstep batched decode,
        models/serving.py; text i draws with seed + i), then vocode every
        stream in one batched chunked decode that skips rows past a
        stream's frames. Greedy, each stream's codes are those of
        generate_codes without the code predictor's repetition sets."""
        pds, keep = self._assemble_many(texts, speakers)
        outputs: list[np.ndarray] = [np.zeros(0, np.float32)] * len(texts)
        if not pds:
            return outputs
        pc = self.pipeline_config
        frames_list = srv.generate_codes_batched(
            self.params, self.cp_params, self.config, pds,
            temperature=temperature if temperature is not None else pc.default_temperature,
            max_tokens=max_tokens if max_tokens is not None else pc.default_max_tokens,
            seed=seed,
        )
        valid_list = [gen_mod.filter_valid_frames(f) for f in frames_list]
        t_max = max(len(v) for v in valid_list)
        if t_max == 0:
            return outputs
        nq = self.config.code_predictor_config.num_code_groups
        codes = np.zeros((len(valid_list), nq, t_max), np.int32)
        for j, v in enumerate(valid_list):
            codes[j, :, : len(v)] = v.T
        wav = self._chunked_decode(codes, lengths=[len(v) for v in valid_list])
        for j, i in enumerate(keep):
            outputs[i] = sanitize_samples(wav[j][: len(valid_list[j]) * self._samples_per_frame])
        return outputs

    def generate_many_stream(
        self,
        texts: list[str],
        speakers: list[str] | str = "",
        *,
        temperature: float | None = None,
        max_tokens: int | None = None,
        batch_size: int = 8,
        chunk_steps: int = 18,
        first_decode_chunk: int | None = None,
        seed: int = 0,
    ) -> Iterator[tuple[int, AudioChunk]]:
        """Streaming continuous batching: yields (text index, AudioChunk) as
        audio becomes ready while decoding goes on. Up to batch_size
        utterances decode in lockstep, finished slots admit queued texts
        mid-flight, and the vocoder runs batched across streams on ready
        18-frame rows (serving.ContinuousServer.serve_audio). Each text ends
        with exactly one is_final chunk. first_decode_chunk (with a finer
        chunk_steps) ships each stream's first audio after that many
        frames."""
        pds, keep = self._assemble_many(texts, speakers)
        if not pds:
            return
        pc = self.pipeline_config
        server = srv.ContinuousServer(
            self.params, self.cp_params, self.config,
            batch_size=min(batch_size, max(1, len(pds))),
            prompt_bucket=gen_mod.pick_bucket(max(pd.input_embeds.shape[1] for pd in pds)),
            trailing_bucket=gen_mod.pick_bucket(
                max(pd.trailing_hidden.shape[1] for pd in pds), gen_mod.TRAILING_BUCKETS),
            chunk_steps=chunk_steps, seed=seed,
        )
        for chunk in server.serve_audio(
            pds, self.vocoder_params, self.speech_config.decoder_config,
            temperature=temperature if temperature is not None else pc.default_temperature,
            max_tokens=max_tokens if max_tokens is not None else pc.default_max_tokens,
            first_decode_chunk=first_decode_chunk,
        ):
            yield keep[chunk.request], AudioChunk(sanitize_samples(chunk.samples),
                                                  chunk.token_range, chunk.is_final)

    # -- streaming ---------------------------------------------------------

    def generate_stream(
        self,
        text: str,
        speaker: str = "",
        *,
        instruct: str | None = None,
        speaker_embedding=None,
        reference_transcript: str | None = None,
        reference_audio_codes=None,
        temperature: float | None = None,
        max_tokens: int | None = None,
        chunk_size: int | None = None,
        first_decode_chunk: int | None = None,
        seed: int = 0,
    ) -> Iterator[AudioChunk]:
        """Buffer-and-batch streaming: decode every 18 valid frames with 8
        frames of re-decoded left context, flush the remainder, then an empty
        final sentinel. As in the reference, is_final may come TWICE (the
        flushed remainder and the sentinel). Streaming skips the code
        predictor's repetition sets. Each window's vocoder call and its copy
        to the host are queued without waiting; the first window ships at
        once, and every later one is pulled only after the next window is
        queued, so its copy rides under the next decode chunk (as the JAX
        pipeline does). Chunk contents and token ranges are those of
        decoding each window in turn."""
        chunk = chunk_size or self.pipeline_config.default_streaming_chunk_size
        next_decode = first_decode_chunk or DECODE_CHUNK_SIZE
        pd = self._assemble(text, speaker, instruct=instruct,
                            speaker_embedding=speaker_embedding,
                            reference_transcript=reference_transcript,
                            reference_audio_codes=reference_audio_codes)
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
            pending = None  # (pull, token range) of the window not yet shipped

            def ship(item) -> AudioChunk:
                pull, token_range = item
                return AudioChunk(sanitize_samples(pull()), token_range, False)

            for frames in code_stream:
                valid = gen_mod.filter_valid_frames(frames)
                if len(valid) == 0:
                    continue
                buffered = np.concatenate([buffered, valid])
                while len(buffered) >= next_decode:
                    batch, buffered = buffered[:next_decode], buffered[next_decode:]
                    next_decode = DECODE_CHUNK_SIZE
                    pull, left_context = self._dispatch_decode_with_context(batch, left_context)
                    total += len(batch)
                    item = (pull, (total - len(batch), total))
                    if total == len(batch):
                        yield ship(item)  # first audio ships at once
                        continue
                    if pending is not None:
                        yield ship(pending)
                    pending = item
            if pending is not None:
                yield ship(pending)
            if len(buffered):
                samples, left_context = self._decode_with_context(buffered, left_context)
                total += len(buffered)
                yield AudioChunk(sanitize_samples(samples), (total - len(buffered), total), True)
        yield AudioChunk(np.zeros(0, np.float32), (total, total), True)

    def generate_stream_voice_design(self, text: str, voice_description: str,
                                     **kwargs) -> Iterator[AudioChunk]:
        """Streaming VoiceDesign."""
        return self.generate_stream(text, instruct=voice_description, **kwargs)

    def generate_stream_custom_voice(self, text: str, speaker: str, instruct: str,
                                     **kwargs) -> Iterator[AudioChunk]:
        """Streaming CustomVoice."""
        return self.generate_stream(text, speaker, instruct=instruct, **kwargs)

    # -- long text ---------------------------------------------------------

    def generate_batch(
        self,
        text: str,
        speaker: str = "",
        *,
        instruct: str | None = None,
        speaker_embedding=None,
        reference_transcript: str | None = None,
        temperature: float | None = None,
        on_progress: Callable[[float], None] | None = None,
        seed: int = 0,
    ) -> np.ndarray:
        """Chunk long text (chunk_text), synthesize each chunk (at most 600
        frames, seed + chunk index), decode it in 24-frame windows with 8
        frames of left context, and stitch chunks with a linear crossfade of
        crossfade_samples. One chunk goes through the whole prompt (instruct
        and transcript kept, unlike the reference's single-chunk shortcut);
        a crossfade tail left when every later chunk yields no frames is
        flushed, not dropped. As in the JAX pipeline, ICL codes are not
        taken here."""
        crossfade = self.pipeline_config.crossfade_samples
        text_chunks = chunk_text(text)
        if not text_chunks:
            return np.zeros(0, np.float32)
        prompt = dict(speaker=speaker, instruct=instruct, speaker_embedding=speaker_embedding,
                      reference_transcript=reference_transcript, temperature=temperature)
        if len(text_chunks) == 1:
            if on_progress:
                on_progress(0.0)
            out = self._decode_to_audio(self._generate_codes(text_chunks[0], seed=seed,
                                                             **prompt))
            if on_progress:
                on_progress(1.0)
            return out

        pieces: list[np.ndarray] = []
        tail = np.zeros(0, np.float32)
        for idx, text_chunk in enumerate(text_chunks):
            if on_progress:
                on_progress(idx / len(text_chunks))
            frames = self._generate_codes(text_chunk, max_tokens=600, seed=seed + idx, **prompt)
            if len(frames) == 0:
                continue
            samples = self._decode_chunked(frames, decode_chunk_size=24)
            if len(samples) == 0:
                continue
            if len(tail) and crossfade > 0:
                fade = min(crossfade, len(tail), len(samples))
                t = np.arange(fade, dtype=np.float32)
                pieces.append(tail[:fade] * ((fade - t) / fade) + samples[:fade] * (t / fade))
                samples = samples[fade:]
            if idx == len(text_chunks) - 1:
                pieces.append(samples)
                tail = np.zeros(0, np.float32)
            elif len(samples) > crossfade:
                pieces.append(samples[: len(samples) - crossfade])
                tail = samples[len(samples) - crossfade:]
            else:
                tail = samples
        if len(tail):
            pieces.append(tail)
        if on_progress:
            on_progress(1.0)
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    def generate_to_file(
        self,
        text: str,
        output_path: str | os.PathLike,
        speaker: str = "",
        *,
        instruct: str | None = None,
        speaker_embedding=None,
        reference_transcript: str | None = None,
        reference_audio_codes=None,
        temperature: float | None = None,
        on_progress: Callable[[float], None] | None = None,
        seed: int = 0,
    ) -> int:
        """Long-text synthesis straight to a 16-bit WAV file, chunk by chunk
        (at most 600 frames each, 16-frame vocoder windows); returns the
        number of samples written."""
        text_chunks = chunk_text(text)
        if not text_chunks:
            return 0
        writer = StreamingWAVWriter(output_path, SAMPLE_RATE)
        try:
            for idx, text_chunk in enumerate(text_chunks):
                if on_progress:
                    on_progress(idx / len(text_chunks))
                frames = self._generate_codes(
                    text_chunk, speaker, instruct=instruct,
                    speaker_embedding=speaker_embedding,
                    reference_transcript=reference_transcript,
                    reference_audio_codes=reference_audio_codes,
                    temperature=temperature, max_tokens=600, seed=seed + idx,
                )
                if len(frames) == 0:
                    continue
                samples = self._decode_chunked(frames, decode_chunk_size=16)
                if len(samples):
                    writer.write(samples)
            if on_progress:
                on_progress(1.0)
        finally:
            count = writer.finalize()
        return count

    # -- vocoder windows ---------------------------------------------------

    def _dispatch_decode_with_context(self, frames: np.ndarray, left_context):
        """Queue one vocoder call over `frames` with optional re-decoded left
        context, and its copy to the host, without waiting: returns (a
        function that waits and gives the window's raw samples, next left
        context). On CUDA the copy goes to pinned memory behind an event."""
        if left_context is not None:
            decode_input = np.concatenate([left_context, frames])
            drop = len(left_context) * self._samples_per_frame
        else:
            decode_input, drop = frames, 0
        codes = torch.from_numpy(np.ascontiguousarray(decode_input.T[None])).long()
        wav = voc.decode_frames(
            self.vocoder_params, codes.to(self.device), self.speech_config.decoder_config
        )[0]
        if wav.is_cuda:
            host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
            host.copy_(wav, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

            def pull() -> np.ndarray:
                done.synchronize()
                return host.numpy()[drop:]
        else:
            def pull() -> np.ndarray:
                return wav.numpy()[drop:]
        return pull, frames[-LEFT_CONTEXT_SIZE:]

    def _decode_with_context(self, frames: np.ndarray, left_context):
        """Blocking form of _dispatch_decode_with_context: (samples of
        `frames`, next left context)."""
        pull, ctx = self._dispatch_decode_with_context(frames, left_context)
        return pull(), ctx

    def _decode_chunked(self, frames: np.ndarray, decode_chunk_size: int) -> np.ndarray:
        """Vocoder decode in windows of `decode_chunk_size` frames, each with
        the 8 frames before it as re-decoded context. Windows are independent
        given their context, so two are kept in flight: window i + 1 is
        queued before window i's samples are pulled, and its copy to the host
        overlaps the next window's vocoding."""
        pieces: list[np.ndarray] = []
        pending = None
        for pos in range(0, len(frames), decode_chunk_size):
            left = frames[max(0, pos - LEFT_CONTEXT_SIZE): pos] if pos else None
            pull, _ = self._dispatch_decode_with_context(
                frames[pos: pos + decode_chunk_size], left)
            if pending is not None:
                pieces.append(sanitize_samples(pending()))
            pending = pull
        if pending is not None:
            pieces.append(sanitize_samples(pending()))
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    # -- voice-cloning inputs ----------------------------------------------

    def extract_speaker_embedding(self, audio_samples) -> np.ndarray | None:
        """Speaker embedding (enc_dim, 1024 at 0.6B) of 24 kHz audio; None
        without a speaker encoder."""
        if self.speaker_encoder is None:
            return None
        return self.speaker_encoder.extract_embedding(np.asarray(audio_samples))

    def encode_reference_audio(self, audio_samples) -> list[np.ndarray] | None:
        """Codec codes (one row per codebook) of 24 kHz reference audio, for
        generate_icl; None without an audio encoder."""
        if self.audio_encoder is None:
            return None
        codes = self.audio_encoder.encode(np.asarray(audio_samples))
        return [codes[q] for q in range(codes.shape[0])]
