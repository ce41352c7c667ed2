"""The port's copy of checkpoint assembly pinned to the JAX package's: the
talker tree (dense, and packed weights dequantized on load), a pre-quantized
checkpoint loaded packed, and the vocoder tree with its export layouts."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.io import checkpoint as jckpt
from qwen3_tts_tpu.ops.quant import quantize_np
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch import testing as ttesting
from qwen3_tts_tpu_torch.io import checkpoint as tckpt

torch.set_num_threads(1)


def assert_trees_equal(a, b, path="") -> None:
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in b:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("prequantized_weights", [False, True])
def test_talker_checkpoint_pinned(prequantized_weights):
    """Dense trees equal; packed weights without a `quantization` block are
    dequantized on load identically."""
    cfg_j = jtesting.tiny_talker_config()
    cfg_t = tconfig.Qwen3TTSConfig.from_json(jtesting.config_to_json_dict(cfg_j))
    tp = ttesting.random_host_talker_params(cfg_t, 0)
    cp = ttesting.random_host_cp_params(cfg_t, 1)
    w = jtesting.export_talker_checkpoint(tp, cp, cfg_j)
    if prequantized_weights:
        key = "talker.model.layers.0.mlp.down_proj.weight"
        packed, s, b = quantize_np(w[key], 4, 64)
        w[key] = packed
        w[key[: -len("weight")] + "scales"] = s
        w[key[: -len("weight")] + "biases"] = b
    jt = jckpt.load_talker_checkpoint(dict(w), cfg_j)
    tt = tckpt.load_talker_checkpoint(dict(w), cfg_t)
    assert_trees_equal(tt, jt)


def test_prequantized_checkpoint_refused():
    """Pre-quantized checkpoints were refused before K7; now one loads with
    its packed codec head kept packed, as the JAX package loads it."""
    raw = jtesting.config_to_json_dict(jtesting.tiny_talker_config())
    raw["quantization"] = {"bits": 4, "group_size": 64}
    cfg_t = tconfig.Qwen3TTSConfig.from_json(raw)
    tp = ttesting.random_host_talker_params(cfg_t, 0)
    w = jtesting.export_talker_checkpoint(tp, ttesting.random_host_cp_params(cfg_t, 1),
                                          jconfig.Qwen3TTSConfig.from_json(raw))
    key = "talker.model.codec_head.weight"
    w[key], w["talker.model.codec_head.scales"], w["talker.model.codec_head.biases"] = (
        quantize_np(w[key], 4, 64))
    tt = tckpt.load_talker_checkpoint(dict(w), cfg_t)
    assert sorted(tt[0]["codec_head"]) == ["biases", "scales", "wq"]
    np.testing.assert_array_equal(tt[0]["codec_head"]["wq"], w[key])
    jt = jckpt.load_talker_checkpoint(dict(w), jconfig.Qwen3TTSConfig.from_json(raw))
    assert_trees_equal(tt, jt)


def test_vocoder_checkpoint_pinned():
    dec_t = ttesting.tiny_decoder_config()
    dec_j = jconfig.TokenizerDecoderConfig.from_dict(ttesting.decoder_config_to_json_dict(dec_t))
    voc = ttesting.random_vocoder_params(dec_t, seed=3)
    w = ttesting.export_vocoder_checkpoint(voc)
    w_j = jtesting.export_vocoder_checkpoint(
        {k: _np_tree(v) for k, v in voc.items()}, dec_j)
    assert_trees_equal(w, w_j)
    assert_trees_equal(tckpt.load_vocoder_checkpoint(dict(w), dec_t),
                       jckpt.load_vocoder_checkpoint(dict(w), dec_j))
    # the export round-trips the layouts (transpose convs pre-flipped)
    back = tckpt.load_vocoder_checkpoint(dict(w), dec_t)
    np.testing.assert_array_equal(back["upsample"][0]["tconv"]["w"],
                                  voc["upsample"][0]["tconv"]["w"].numpy())
    np.testing.assert_array_equal(back["decoder"]["blocks"][1]["up"]["w"],
                                  voc["decoder"]["blocks"][1]["up"]["w"].numpy())


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return t.numpy()
