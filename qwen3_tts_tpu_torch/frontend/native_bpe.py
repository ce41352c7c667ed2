"""ctypes binding of the repository's native C++ BPE core (native/qbpe.cpp),
counterpart of qwen3_tts_tpu/frontend/native_bpe.py.

The merge loop and the vocab / byte-fallback lookup run in C++ for a
tokenizer made with native=True when the shared library can be built; the
pure-Python path in tokenizer.py is the default and the fallback (no
compiler found, or QWEN3TTS_NATIVE_BPE=0). `g++` builds the
library on first use into build/native/ at the repository root (listed in
.gitignore) and rebuilds it when the source is newer. Host code, not a
kernel: nothing here touches a device.

    python -m qwen3_tts_tpu_torch.frontend.native_bpe [--force]
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np

DISABLE_ENV = "QWEN3TTS_NATIVE_BPE"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "qbpe.cpp")
_LOCK = threading.Lock()
_lib = None


def build_dir() -> str:
    return os.path.join(_REPO, "build", "native")


def library_path() -> str:
    return os.path.join(build_dir(), "libqbpe.so")


def build_library(force: bool = False) -> str | None:
    """Compile native/qbpe.cpp into library_path(); returns the path, or None
    when the source or a compiler is missing or the compile fails. The
    library is written under a temporary name and renamed into place, so
    processes building at once never load a half-written file."""
    path = library_path()
    if not os.path.exists(SOURCE):
        return None
    if (not force and os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(SOURCE)):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    try:
        subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library():
    """The loaded library (built if needed), or None when it is disabled or
    cannot be built."""
    global _lib
    if os.environ.get(DISABLE_ENV) == "0":
        return None
    with _LOCK:
        if _lib is not None:
            return _lib
        path = build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.qbpe_new.argtypes = []
        lib.qbpe_new.restype = ctypes.c_void_p
        lib.qbpe_free.argtypes = [ctypes.c_void_p]
        lib.qbpe_free.restype = None
        lib.qbpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int32]
        lib.qbpe_add_token.restype = None
        lib.qbpe_add_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
        lib.qbpe_add_merge.restype = None
        lib.qbpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.qbpe_encode_word.restype = ctypes.c_int
        _lib = lib
        return lib


class NativeBpe:
    """Owns a C++ BPE handle loaded with a vocab and a merge table. The
    handle is read-only after construction and each call has its own output
    buffer, so threads may encode at once (the service tokenizes on its
    request threads)."""

    MAX_OUT = 4096

    def __init__(self, vocab: dict[str, int], merges: dict[str, int]):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native BPE library unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.qbpe_new())
        for token, tid in vocab.items():
            b = token.encode("utf-8")
            lib.qbpe_add_token(self._h, b, len(b), tid)
        for pair, rank in merges.items():
            left, _, right = pair.partition(" ")
            lb, rb = left.encode("utf-8"), right.encode("utf-8")
            lib.qbpe_add_merge(self._h, lb, len(lb), rb, len(rb), rank)

    def encode_word(self, word: str) -> list[int] | None:
        """BPE ids of one pre-split word with Ġ / Ċ already mapped; None when
        they would exceed MAX_OUT (the caller then takes the Python path,
        which has no limit)."""
        b = word.encode("utf-8")
        cap = max(1, min(len(b), self.MAX_OUT))  # at most one id per byte
        out = (ctypes.c_int32 * cap)()
        n = self._lib.qbpe_encode_word(self._h, b, len(b), out, cap)
        if n < 0:
            return None
        return np.frombuffer(out, np.int32, n).tolist()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.qbpe_free(h)
            self._h = None


if __name__ == "__main__":
    built = build_library(force="--force" in sys.argv)
    print(built if built else "build failed (no g++, or native/qbpe.cpp missing)")
