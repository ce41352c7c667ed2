"""Speaker encoder: the ECAPA-TDNN x-vector extractor for voice cloning
(counterpart of qwen3_tts_tpu/models/speaker_encoder.py, plain PyTorch:
the JAX encoder reaches no Pallas kernel).

mel spectrogram (nFFT 1024, hop 256, symmetric Hann, Slaney filterbank with
area normalization, log clipped at 1e-5) -> TDNN block -> 3 SE-Res2Net
blocks -> concat of their outputs -> MFA TDNN -> attentive statistics
pooling (population variance) -> 1x1 conv fc -> embedding. Every TDNN conv
reflect-pads (k-1)*d/2 on both sides and applies ReLU. Channels-last
[B, T, C]; conv params {"w": [K, Cin, Cout], "b": [Cout]}.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpeakerEncoderConfig
from ..convert import to_torch
from ..ops.conv import conv1d
from ..utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int = 24000, n_fft: int = 1024, num_mels: int = 128,
                   fmin: float = 0.0, fmax: float = 12000.0) -> np.ndarray:
    """Slaney-style mel filterbank with area normalization, [n_fft//2+1, mels]."""
    num_freqs = n_fft // 2 + 1
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    log_step = np.log(6.4) / 27.0

    def hz_to_mel(hz):
        hz = np.asarray(hz, np.float64)
        return np.where(hz >= min_log_hz,
                        min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / log_step,
                        hz / f_sp)

    def mel_to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel >= min_log_mel,
                        min_log_hz * np.exp(log_step * (mel - min_log_mel)), f_sp * mel)

    all_freqs = np.arange(num_freqs) * (sample_rate / 2) / (num_freqs - 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2))
    f_diff = np.diff(f_pts)
    down = (all_freqs[:, None] - f_pts[None, :-2]) / f_diff[None, :-1]
    up = (f_pts[None, 2:] - all_freqs[:, None]) / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2:] - f_pts[:-2])
    return (fb * enorm[None, :]).astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Symmetric Hann (periodic=False)."""
    i = np.arange(win_length, dtype=np.float32)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (win_length - 1)))


def mel_spectrogram(audio, *, n_fft: int = 1024, num_mels: int = 128,
                    sample_rate: int = 24000, hop_size: int = 256, win_size: int = 1024,
                    fmin: float = 0.0, fmax: float = 12000.0,
                    device=None) -> torch.Tensor:
    """audio [L] or [B, L] (numpy or tensor) -> log-mel [B, frames, mels]."""
    x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(audio, torch.Tensor)
                        else audio, device=device).float()
    if x.dim() == 1:
        x = x[None]
    pad = n_fft // 2
    padded = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(1, n_fft, hop_size)  # [B, frames, n_fft]
    window = torch.from_numpy(hann_window(win_size)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1).abs()
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)).to(x.device)
    return torch.log(torch.clamp(spec @ fb, min=1e-5))


def _reflect_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad <= 0:
        return x
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def tdnn_block(params: dict, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Reflect-padded dilated conv + ReLU."""
    pad = (params["w"].shape[0] - 1) * dilation // 2
    return torch.relu(conv1d(params, _reflect_pad_time(x, pad), dilation=dilation))


def res2net_block(params: dict, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    """Hierarchical multi-scale conv; params["blocks"]: scale - 1 TDNNs."""
    w = x.shape[-1] // scale
    pieces = [x[..., i * w:(i + 1) * w] for i in range(scale)]
    outputs = [pieces[0]]
    part = None
    for i in range(1, scale):
        inp = pieces[i] if i == 1 else pieces[i] + part
        part = tdnn_block(params["blocks"][i - 1], inp, dilation)
        outputs.append(part)
    return torch.cat(outputs, dim=-1)


def se_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excitation over the time mean."""
    s = x.mean(dim=1, keepdim=True)
    s = torch.relu(conv1d(params["conv1"], s))
    return x * torch.sigmoid(conv1d(params["conv2"], s))


def se_res2net_block(params: dict, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    """TDNN -> Res2Net -> TDNN -> SE, plus the residual."""
    h = tdnn_block(params["tdnn1"], x)
    h = res2net_block(params["res2net_block"], h, scale, dilation)
    h = tdnn_block(params["tdnn2"], h)
    return se_block(params["se_block"], h) + x


def attentive_stats_pooling(params: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Attention-weighted mean and std over time: [B, T, C] -> [B, 1, 2C]."""
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(x.var(dim=1, keepdim=True, correction=0) + eps)
    attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    a = conv1d(params["conv"], torch.tanh(tdnn_block(params["tdnn"], attn_in)))
    a = torch.softmax(a, dim=1)  # over time
    wmean = (a * x).sum(dim=1, keepdim=True)
    wvar = (a * (x - wmean) ** 2).sum(dim=1, keepdim=True)
    return torch.cat([wmean, torch.sqrt(torch.clamp(wvar, min=eps))], dim=-1)


def speaker_encoder_forward(params: dict, mels: torch.Tensor,
                            config: SpeakerEncoderConfig) -> torch.Tensor:
    """mels [B, T, M] -> embeddings [B, enc_dim]."""
    scale = config.enc_res2net_scale
    h = tdnn_block(params["blocks"][0], mels, config.enc_dilations[0])
    hiddens = []
    for i in range(1, 4):
        h = se_res2net_block(params["blocks"][i], h, scale, config.enc_dilations[i])
        hiddens.append(h)
    h = tdnn_block(params["mfa"], torch.cat(hiddens, dim=-1), config.enc_dilations[4])
    h = attentive_stats_pooling(params["asp"], h)
    return conv1d(params["fc"], h)[:, 0, :]


def _strip(weights: dict) -> dict:
    p = "speaker_encoder."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}


def _conv_p(w: dict, prefix: str) -> dict:
    weight = np.asarray(w[f"{prefix}.weight"], np.float32).transpose(2, 1, 0)  # HIO
    p = {"w": np.ascontiguousarray(weight)}
    if f"{prefix}.bias" in w:
        p["b"] = np.asarray(w[f"{prefix}.bias"], np.float32)
    return p


def load_speaker_encoder_params(weights: dict, config: SpeakerEncoderConfig) -> dict:
    """The ECAPA tree (numpy) from "speaker_encoder."-prefixed keys."""
    w = _strip(weights)

    def se_res2net(prefix: str) -> dict:
        return {
            "tdnn1": _conv_p(w, f"{prefix}.tdnn1.conv"),
            "tdnn2": _conv_p(w, f"{prefix}.tdnn2.conv"),
            "se_block": {"conv1": _conv_p(w, f"{prefix}.se_block.conv1"),
                         "conv2": _conv_p(w, f"{prefix}.se_block.conv2")},
            "res2net_block": {"blocks": [
                _conv_p(w, f"{prefix}.res2net_block.blocks.{j}.conv")
                for j in range(config.enc_res2net_scale - 1)
            ]},
        }

    return {
        "blocks": [_conv_p(w, "blocks.0.conv"), se_res2net("blocks.1"),
                   se_res2net("blocks.2"), se_res2net("blocks.3")],
        "mfa": _conv_p(w, "mfa.conv"),
        "asp": {"tdnn": _conv_p(w, "asp.tdnn.conv"), "conv": _conv_p(w, "asp.conv")},
        "fc": _conv_p(w, "fc"),
    }


def config_from_weights(weights: dict) -> SpeakerEncoderConfig:
    """ECAPA widths from the checkpoint's shapes (torch conv layout
    [Cout, Cin, K]); dilations keep their defaults (1, 2, 3, 4, 1)."""
    w = _strip(weights)

    def shape(key):
        return np.asarray(w[key]).shape

    b0 = shape("blocks.0.conv.weight")
    ch, kz = [b0[0]], [b0[2]]
    scale = 1 + len({k.split(".")[4] for k in w
                     if k.startswith("blocks.1.res2net_block.blocks.") and k.endswith(".weight")})
    for i in (1, 2, 3):
        ch.append(shape(f"blocks.{i}.tdnn1.conv.weight")[0])
        kz.append(shape(f"blocks.{i}.res2net_block.blocks.0.conv.weight")[2])
    mfa = shape("mfa.conv.weight")
    ch.append(mfa[0])
    kz.append(mfa[2])
    return SpeakerEncoderConfig(
        enc_dim=shape("fc.weight")[0], mel_dim=b0[1], enc_channels=tuple(ch),
        enc_kernel_sizes=tuple(kz), enc_res2net_scale=scale,
        enc_se_channels=shape("blocks.1.se_block.conv1.weight")[0],
        enc_attention_channels=shape("asp.tdnn.conv.weight")[0],
    )


class SpeakerEncoder:
    """The pipeline's speaker-embedding extractor: fp32 weights on `device`
    (default CUDA, as every entry point of the port)."""

    def __init__(self, params: dict, config: SpeakerEncoderConfig | None = None, *,
                 device=None):
        self.config = config or SpeakerEncoderConfig()
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device, torch.float32)

    @classmethod
    def from_weights(cls, weights: dict, config: SpeakerEncoderConfig | None = None, *,
                     device=None) -> "SpeakerEncoder":
        cfg = config or config_from_weights(weights)
        return cls(load_speaker_encoder_params(weights, cfg), cfg, device=device)

    @torch.no_grad()
    def extract_embedding(self, audio, sample_rate: int = 24000) -> np.ndarray:
        """audio [L] at `sample_rate` -> embedding [enc_dim] float32 numpy."""
        mels = mel_spectrogram(audio, sample_rate=sample_rate, num_mels=self.config.mel_dim,
                               device=self.device)
        emb = speaker_encoder_forward(self.params, mels, self.config)
        return emb.reshape(-1).cpu().numpy()
