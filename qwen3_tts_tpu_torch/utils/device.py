"""Device selection for the PyTorch port.

The device is explicit: the caller's argument wins, then the
`QWEN3TTS_DEVICE` environment variable, then "cuda". Asking for CUDA on a
host without it raises; the port never carries on on the CPU by itself.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "QWEN3TTS_DEVICE"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device to run on; raises RuntimeError when CUDA is asked
    for and `torch.cuda.is_available()` is False."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' (or set {DEVICE_ENV}=cpu) to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
