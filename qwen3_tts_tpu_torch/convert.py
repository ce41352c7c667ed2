"""Convert parameter trees given as numpy arrays (the JAX package's layouts,
e.g. pulled from qwen3_tts_tpu trees with np.asarray) into the port's
trees of torch tensors, including each kernel's layout built from the dense
tree. The pipeline uses the same conversion on the trees it loads, so a test
can feed identical weights to both packages. The speaker- and audio-encoder
trees (lists of codebooks included) go through to_torch as they are; a K4a
tree made by the JAX package's builder goes through fused_pretransformer_params.
"""

from __future__ import annotations

import numpy as np
import torch

# TPU-only layouts (Mosaic lane permutations) the CUDA kernels do not read
_TPU_ONLY = ("w8_kl", "wq_kl")


def to_torch(tree, device="cpu", dtype: torch.dtype = torch.float32):
    """numpy tree -> torch tree on `device`: float leaves in `dtype`, except
    quantization scales/biases (kept fp32); integer and bool leaves keep
    their type; TPU-only layout entries are dropped."""
    if isinstance(tree, dict):
        return {
            k: (torch.from_numpy(np.array(v, np.float32)).to(device)
                if k in ("scales", "biases") else to_torch(v, device, dtype))
            for k, v in tree.items()
            if k not in _TPU_ONLY
        }
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    arr = np.array(tree)  # a copy: never aliases the caller's buffer
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device).to(dtype)
    return torch.from_numpy(arr).to(device)


def vocoder_params(tree: dict, cfg, device="cpu", *, kernel_dtype=None) -> dict:
    """Dense vocoder tree (fp32) plus, when `kernel_dtype` is given, the
    K4/K5/K6 kernel subtree under "kernel" with GEMM weights in that dtype."""
    from .models.vocoder import build_vocoder_kernel_params

    out = to_torch({k: v for k, v in tree.items() if k != "kernel"}, device, torch.float32)
    if kernel_dtype is not None:
        out["kernel"] = build_vocoder_kernel_params(out, cfg, kernel_dtype)
    return out


def fused_pretransformer_params(tree: dict, cfg, device="cpu", dtype=torch.bfloat16) -> dict:
    """The JAX package's K4a tree (build_pretransformer_kernel_params_device,
    as numpy) -> the port's: the same arrays, weights in `dtype` and norms,
    LayerScales, biases and rotm in fp32, plus inv_freq [head_dim / 2]."""
    from .ops.cuda.pretransformer_kernel import _inv_freq

    weights = ("wi", "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wout")
    out = {k: to_torch(v, device, dtype if k in weights else torch.float32)
           for k, v in tree.items()}
    out["inv_freq"] = torch.from_numpy(_inv_freq(cfg.head_dim, cfg.rope_theta)).to(device)
    return out
