"""The port's native BPE binding (frontend/native_bpe.py, the tokenizer's
_init_native hook) and its profiling helpers (utils/profiling.py), held
against the JAX package's:

- native ids (native=True) equal the port's Python path, the default, and
  the JAX tokenizer's, on a merge table and on the tiny tokenizer.json,
  byte fallback included (the library builds into the port's own build
  directory, never native/);
- QWEN3TTS_NATIVE_BPE=0 keeps the Python path, and a word past the native
  output cap falls back to it with the same ids;
- PhaseTimer, debug and the trace window mirror tests/test_utils.py, the
  trace a Chrome trace file.
The native tests skip only where no g++ is found."""

import json
import os
import shutil

import jax  # noqa: F401  (conftest keeps it on the CPU)
import pytest
import torch

from qwen3_tts_tpu.frontend.tokenizer import Qwen3Tokenizer as JaxTokenizer
from qwen3_tts_tpu_torch.frontend import native_bpe
from qwen3_tts_tpu_torch.frontend.tokenizer import Qwen3Tokenizer
from qwen3_tts_tpu_torch.testing import make_tiny_tokenizer_json
from qwen3_tts_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

VOCAB = {"<0x%02X>" % b: b for b in range(256)}
VOCAB.update({"Ġ": 256, "Ċ": 257})
for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz.,!?"):
    VOCAB[ch] = 258 + i
VOCAB.update({"he": 300, "llo": 301, "hello": 302, "Ġw": 303, "Ġwo": 304})
MERGES = ["h e", "l l", "ll o", "he llo", "Ġ w", "Ġw o"]
TEXTS = [
    "hello world",
    "hello, world!",
    "a b c\nnew line",
    "unicode: ünïcodé test",  # byte fallback
    "  double  spaces  ",
    "",
    "<|im_start|>assistant\nThe golden parity sentence exercises every module once."
    "<|im_end|>\n",
]


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the tokenizer keeps its Python path")


def test_native_ids_equal_python_and_jax(tmp_path):
    need_gxx()
    lib = native_bpe.build_library()
    assert lib == native_bpe.library_path() and os.path.exists(lib)
    assert os.path.dirname(lib) == native_bpe.build_dir()
    assert not lib.startswith(os.path.join(os.path.dirname(native_bpe.SOURCE), ""))
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(make_tiny_tokenizer_json(), f)
    makers = [(lambda **kw: Qwen3Tokenizer(vocab=VOCAB, merges=MERGES, **kw),
               JaxTokenizer(vocab=VOCAB, merges=MERGES)),
              (lambda **kw: Qwen3Tokenizer(str(tmp_path), **kw), JaxTokenizer(str(tmp_path)))]
    for make, jtok in makers:
        tok, py = make(native=True), make()
        assert tok._native is not None and py._native is None  # Python by default
        for t in TEXTS:
            assert tok.encode(t) == py.encode(t) == jtok.encode(t), t
    nb = native_bpe.NativeBpe(VOCAB, {m: i for i, m in enumerate(MERGES)})
    assert nb.encode_word("hello") == [302] and nb.encode_word("Ġwo") == [304]
    assert nb.encode_word("é") == [0xC3, 0xA9]


def test_native_disable_switch_and_overflow(monkeypatch):
    need_gxx()
    monkeypatch.setenv(native_bpe.DISABLE_ENV, "0")
    assert native_bpe.load_library() is None
    tok = Qwen3Tokenizer(vocab=VOCAB, merges=MERGES, native=True)
    assert tok._native is None
    assert tok.encode("hello world") == JaxTokenizer(vocab=VOCAB, merges=MERGES).encode(
        "hello world")
    monkeypatch.delenv(native_bpe.DISABLE_ENV)
    monkeypatch.setattr(native_bpe.NativeBpe, "MAX_OUT", 8)
    tok = Qwen3Tokenizer(vocab=VOCAB, merges=MERGES, native=True)
    py = Qwen3Tokenizer(vocab=VOCAB, merges=MERGES)
    long_word = "zq" * 50  # no merge applies: 100 ids > MAX_OUT
    assert tok._native.encode_word(long_word) is None
    text = f"hello {long_word} world"
    assert tok.encode(text) == py.encode(text)


def test_phase_timer_and_debug(capsys, monkeypatch):
    t = prof.PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b", sync={"x": [torch.zeros(3), (torch.ones(2), 1)]}):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert "a:" in t.summary() and "ms/call" in t.summary()
    monkeypatch.delenv(prof.DEBUG_ENV, raising=False)
    assert not prof.debug_enabled()
    prof.debug("hidden")
    monkeypatch.setenv(prof.DEBUG_ENV, "1")
    prof.debug("shown", 42)
    err = capsys.readouterr().err
    assert "hidden" not in err and "shown 42" in err


def test_trace_window(tmp_path, monkeypatch):
    monkeypatch.delenv(prof.PROFILE_ENV, raising=False)
    with prof.trace() as p:
        x = 1 + 1
    assert x == 2 and p is None and not any(tmp_path.iterdir())
    with prof.trace(str(tmp_path / "a")) as p:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert p is not None
    monkeypatch.setenv(prof.PROFILE_ENV, str(tmp_path / "b"))
    with prof.trace():
        torch.ones(4) + 1
    for sub in ("a", "b"):
        files = list((tmp_path / sub).glob("trace_*.json"))
        assert len(files) == 1
        with open(files[0]) as f:
            assert json.load(f)["traceEvents"]
