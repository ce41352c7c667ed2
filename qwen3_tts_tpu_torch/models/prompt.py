"""TTS prompt assembly in embedding space (counterpart of
qwen3_tts_tpu/models/prompt.py::assemble_prompt, named-speaker mode):

  role(3 text tokens) ⧺ [tts_pad × padCount, tts_bos] + codecEmbed[:-1]
  (elementwise sum) ⧺ (text token 3 + codec_bos embed)

with the trailing text hidden = proj(embed(text tokens 4..N-6)) ⧺ tts_eos,
fed one embed per decode step. Prompts are exact-length (no buckets).
Instruct, ICL, speaker-embedding and free-form-speaker prompts are not
ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Qwen3TTSConfig
from . import talker as talker_mod

MIN_PROMPT_TOKENS = 9


@dataclass
class PromptData:
    input_embeds: torch.Tensor     # [1, P, H]
    trailing_hidden: torch.Tensor  # [1, T, H]
    tts_pad_embed: torch.Tensor    # [1, 1, H]


def assemble_prompt(
    params: dict,
    config: Qwen3TTSConfig,
    tokenizer,
    text: str,
    speaker: str = "",
    instruct: str | None = None,
    speaker_embedding=None,
    reference_transcript: str | None = None,
    reference_audio_codes=None,
) -> PromptData | None:
    """Prompt embeddings for a built-in speaker (or no speaker); None when
    the text is shorter than 9 tokens."""
    speaker_id = config.spk_id.get(speaker.lower())
    if (
        instruct or speaker_embedding is not None or reference_transcript
        or reference_audio_codes is not None or (speaker and speaker_id is None)
    ):
        raise NotImplementedError(
            "only the named-speaker prompt is ported; instruct / ICL / "
            "speaker-embedding / free-form speaker prompts are ROADMAP "
            "(other generation modes)"
        )
    dev = params["norm"]["w"].device
    chat_text = f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"
    ids = torch.tensor(tokenizer.encode(chat_text), dtype=torch.int64, device=dev)
    n = len(ids)
    if n < MIN_PROMPT_TOKENS:
        return None

    def t(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)

    tts = talker_mod.encode_text(
        params, t([config.tts_bos_token_id, config.tts_eos_token_id, config.tts_pad_token_id])
    )[None]
    tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
    codec_ids = [config.codec_nothink_id, config.codec_think_bos_id, config.codec_think_eos_id]
    if speaker_id is not None:
        codec_ids.append(speaker_id)
    codec_ids += [config.codec_pad_id, config.codec_bos_id]
    codec_embed = talker_mod.encode_audio(params, t(codec_ids))[None]

    role_embed = talker_mod.encode_text(params, ids[0:3])[None]
    pad_count = codec_embed.shape[1] - 2
    combined = torch.cat([tts_pad.expand(1, pad_count, -1), tts_bos], dim=1)
    combined = combined + codec_embed[:, :-1]
    first_text = talker_mod.encode_text(params, ids[3:4])[None] + codec_embed[:, -1:]
    input_embeds = torch.cat([role_embed, combined, first_text], dim=1)

    if n - 9 > 0:
        trailing = talker_mod.encode_text(params, ids[4:n - 5])[None]
        trailing_hidden = torch.cat([trailing, tts_eos], dim=1)
    else:
        trailing_hidden = tts_eos
    return PromptData(input_embeds, trailing_hidden, tts_pad)
