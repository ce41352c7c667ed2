"""Minimal safetensors reader/writer for the PyTorch port.

Same format and API as qwen3_tts_tpu/io/safetensors_io.py, without
ml_dtypes: BF16 tensors are read through `torch.frombuffer(...,
dtype=torch.bfloat16)` and returned as float32 numpy arrays (bf16 -> fp32 is
exact), and torch bf16 tensors can be written.

Format: 8-byte little-endian header length N, N bytes of JSON
({name: {dtype, shape, data_offsets}}, optional "__metadata__"), then the raw
little-endian tensor buffer.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "U16": np.uint16,
    "U32": np.uint32,
    "U64": np.uint64,
    "BOOL": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_header(path: str) -> dict[str, tuple[str, tuple[int, ...]]]:
    """Only the header: {name: (dtype name, shape)} (the layout audit,
    io/audit.py, never needs the tensor bytes)."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len).decode("utf-8"))
    return {name: (info["dtype"], tuple(info["shape"]))
            for name, info in header.items() if name != "__metadata__"}


def load_file(path: str) -> dict[str, np.ndarray]:
    """Load all tensors as numpy arrays (copies; BF16 widened to float32)."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len).decode("utf-8"))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)

    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        buf = np.array(data[start:end])  # copy out of the memmap
        if info["dtype"] == "BF16":
            t = torch.frombuffer(bytearray(buf.tobytes()), dtype=torch.bfloat16)
            out[name] = t.float().numpy().reshape(shape)
        else:
            out[name] = buf.view(_DTYPES[info["dtype"]]).reshape(shape)
    del data
    return out


def _bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def save_file(tensors: Mapping[str, object], path: str) -> None:
    """Write numpy arrays or torch tensors (bf16 included) to a .safetensors
    file, streaming one tensor at a time."""
    header: dict[str, dict] = {}
    offset = 0
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            dt = "BF16" if arr.dtype == torch.bfloat16 else _DTYPE_NAMES[
                np.dtype(torch.empty(0, dtype=arr.dtype).numpy().dtype)
            ]
            nbytes = arr.numel() * arr.element_size()
            shape = list(arr.shape)
        else:
            a = np.asarray(arr)
            if np.dtype(a.dtype) not in _DTYPE_NAMES:
                raise ValueError(f"unsupported dtype for safetensors: {a.dtype}")
            dt, nbytes, shape = _DTYPE_NAMES[np.dtype(a.dtype)], a.nbytes, list(a.shape)
        header[name] = {
            "dtype": dt, "shape": shape, "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes

    header_bytes = json.dumps(header).encode("utf-8")
    header_bytes += b" " * ((8 - len(header_bytes) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for arr in tensors.values():
            f.write(_bytes(arr))
