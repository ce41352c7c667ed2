"""The port's copies of jax-free modules pinned to their originals: config
parsing, the BPE tokenizer and safetensors (bf16 read without ml_dtypes).
Checkpoint assembly is pinned in test_torch_checkpoint.py."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import testing as jtesting
from qwen3_tts_tpu.frontend.tokenizer import Qwen3Tokenizer as JTokenizer
from qwen3_tts_tpu.io import safetensors_io as jst
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch.frontend.tokenizer import Qwen3Tokenizer as TTokenizer
from qwen3_tts_tpu_torch.io import safetensors_io as tst

torch.set_num_threads(1)


@pytest.mark.parametrize("nested", [False, True])
def test_config_from_json_pinned(nested):
    raw = jtesting.config_to_json_dict(jtesting.tiny_talker_config(tts_model_type="custom_voice"))
    raw["quantization_config"] = {"bits": 6, "group_size": 32}
    if nested:
        raw = {"talker_config": raw, "tts_bos_token_id": 7, "tts_model_type": "voice_design"}
    j = jconfig.Qwen3TTSConfig.from_json(json.dumps(raw))
    t = tconfig.Qwen3TTSConfig.from_json(json.dumps(raw))
    assert j.__dict__.keys() == t.__dict__.keys()
    for k in j.__dict__:
        a, b = getattr(t, k), getattr(j, k)
        assert (a.__dict__ if hasattr(a, "__dict__") else a) == (
            b.__dict__ if hasattr(b, "__dict__") else b), k
    st = {"decoder_config": {"upsample_rates": [8, 5, 4, 3], "latent_dim": 512},
          "output_sample_rate": 24000}
    assert (tconfig.SpeechTokenizerConfig.from_json(st).decoder_config.__dict__
            == jconfig.SpeechTokenizerConfig.from_json(st).decoder_config.__dict__)


TEXTS = [
    "<|im_start|>assistant\nHello world, it's 42 o'clock!<|im_end|>\n",
    "the thin thing’s “quoted” text\n\nwith  spaces",
    "café naïve 中文 emoji \U0001F600 end",
    "we're    testing   contractions you'll they've I'd",
]


def test_tokenizer_ids_pinned(tmp_path):
    data = jtesting.make_tiny_tokenizer_json()
    vocab = data["model"]["vocab"]
    merges = []
    for a, b in (("t", "h"), ("th", "e"), ("Ġ", "th"), ("i", "n"), ("Ġ", "w"), ("o", "r")):
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab) + 500)
    data["model"]["merges"] = merges
    (tmp_path / "tokenizer.json").write_text(json.dumps(data))
    jt, tt = JTokenizer(tmp_path), TTokenizer(tmp_path)
    jt._native = None  # the pure-Python path on both sides
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))


def test_safetensors_bf16_read_without_ml_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "b": rng.integers(0, 255, (4, 8)).astype(np.uint8),
        "c": rng.standard_normal(7).astype(np.float32),
    }
    jst.save_file(tensors, str(tmp_path / "x.safetensors"))
    got = tst.load_file(str(tmp_path / "x.safetensors"))
    np.testing.assert_array_equal(got["a"], tensors["a"].astype(np.float32))
    np.testing.assert_array_equal(got["b"], tensors["b"])
    np.testing.assert_array_equal(got["c"], tensors["c"])
    # the port's writer (torch bf16) reads back through the JAX reader
    tst.save_file({"t": torch.from_numpy(tensors["c"]).to(torch.bfloat16), "b": tensors["b"]},
                  str(tmp_path / "y.safetensors"))
    back = jst.load_file(str(tmp_path / "y.safetensors"))
    np.testing.assert_array_equal(back["t"].astype(np.float32),
                                  torch.from_numpy(tensors["c"]).to(torch.bfloat16).float())
