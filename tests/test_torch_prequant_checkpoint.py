"""The port's keep-packed load of pre-quantized checkpoints pinned to the JAX
package's, on two model dirs: the JAX package's golden dir (packed talker
weights at heterogeneous 4/6/8-bit widths, dense keys where a width does not
pack, so fused and stacked entries fall back to dense) and a uniform 4-bit
group-64 dir written by the port's write_prequantized_model_dir. The trees
must be equal, and so must the megakernel trees built from them (K1's and
K2's rowwise int8 weights from the packed entries)."""

import json
import os

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.io import checkpoint as jckpt
from qwen3_tts_tpu.ops.pallas import cp_megakernel as jcpk
from qwen3_tts_tpu.ops.pallas import talker_megakernel as jtmk
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.io import checkpoint as tckpt
from qwen3_tts_tpu_torch.io import safetensors_io
from qwen3_tts_tpu_torch.ops.cuda import cp_megakernel as tcpk
from qwen3_tts_tpu_torch.ops.cuda import talker_megakernel as ttmk

torch.set_num_threads(1)


def assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in b:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def packed_paths(tree, path=""):
    if isinstance(tree, dict):
        if "wq" in tree:
            return [path]
        return [p for k, v in tree.items() for p in packed_paths(v, f"{path}/{k}")]
    return []


@pytest.fixture(scope="module", params=["golden", "uniform"])
def loaded(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    if request.param == "golden":
        jtesting.write_golden_model_dir(d)
    else:
        ttesting.write_prequantized_model_dir(d, ttesting.tiny_talker_config(),
                                              ttesting.tiny_decoder_config())
    with open(os.path.join(d, "config.json")) as f:
        raw = json.load(f)
    assert raw["quantization"]["bits"] == 4
    cfg_j = jconfig.Qwen3TTSConfig.from_json(json.dumps(raw))
    cfg_t = tconfig.Qwen3TTSConfig.from_json(json.dumps(raw))
    w = safetensors_io.load_file(os.path.join(d, "model.safetensors"))
    jt = jckpt.load_talker_checkpoint(dict(w), cfg_j)
    tt = tckpt.load_talker_checkpoint(dict(w), cfg_t)
    return request.param, cfg_j, cfg_t, jt, tt


def test_keep_packed_trees_pinned(loaded):
    kind, _, _, jt, tt = loaded
    for mine, theirs in zip(tt, jt):  # (talker, code predictor)
        assert_trees_equal(mine, theirs)
    talker, cp = packed_paths(tt[0]), packed_paths(tt[1])
    if kind == "uniform":  # every linear and table packed
        assert len(talker) == 9 and len(cp) == 6, (talker, cp)
        assert tt[0]["layers"]["qkv_proj"]["wq"].dtype == np.uint32
    else:  # some packed, some fallen back to dense
        assert talker and "w" in tt[0]["layers"]["qkv_proj"], talker


def test_kernel_trees_from_packed_weights_pinned(loaded):
    _, cfg_j, cfg_t, jt, tt = loaded
    assert_trees_equal(ttmk.build_talker_kernel_params(tt[0], cfg_t),
                       jtmk.build_talker_kernel_params(jt[0], cfg_j))
    assert_trees_equal(tcpk.build_cp_kernel_params(tt[1], cfg_t.code_predictor_config),
                       jcpk.build_cp_kernel_params(jt[1], cfg_j.code_predictor_config))
