"""The port's native host decoders and edit distance: copies of native/
wavio.c, flacio.c and editdistance.c with a plain C interface, built with
the host C compiler into one shared library and loaded by `ctypes` (no
CPython C API, so no `Python.h` is needed):

    cc -O3 -shared -fPIC -o libtpu_asr_native.so wavio.c flacio.c \
       editdistance.c

The library is built at first use (never at import) into
`build/tpu_asr_torch/native/<hash>/` beside the package, keyed on a hash of
the flags and the sources, as ops/_kernels.py builds the CUDA kernels; the
compiler's log lands beside it as `cc.log`. A failed build raises with that
log: the callers (data/audio.py, utils/wer.py) do not fall back to their
plain Python versions on their own.

- `wav_decode(data)`, `flac_decode(data)`: (mono float32 array, sample
  rate), the decoders' ValueError on a bad file;
- `edit_distance(a, b)`: Levenshtein distance between two sequences of
  hashable items (words, token ids), equal items mapped to one id.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "tpu_asr_torch"
              / "native")
SOURCES = ("wavio.c", "flacio.c", "editdistance.c")
CC_FLAGS = ("-O3", "-shared", "-fPIC")
LIB_NAME = "libtpu_asr_native.so"
_BUILD_LOCK = threading.Lock()    # the data loader's threads decode at once

_F32P = ctypes.POINTER(ctypes.c_float)
_DECODE_ARGS = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_F32P),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_char_p)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *CC_FLAGS, "-o", str(tmp),
           *(str(SRC / name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {LIB_NAME}: {' '.join(cmd)}: {e}")
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    (path.parent / "cc.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {LIB_NAME} failed (code "
                           f"{proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, path)           # atomic: concurrent builds agree
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    with _BUILD_LOCK:
        lib = ctypes.CDLL(str(build()))
    for name in ("tat_wav_decode", "tat_flac_decode"):
        fn = getattr(lib, name)
        fn.argtypes = _DECODE_ARGS
        fn.restype = ctypes.c_int
    lib.tat_native_free.argtypes = [ctypes.c_void_p]
    lib.tat_native_free.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tat_edit_distance.argtypes = [i64p, ctypes.c_int64, i64p,
                                      ctypes.c_int64]
    lib.tat_edit_distance.restype = ctypes.c_long
    return lib


def _decode(name: str, data: bytes, what: str) -> Tuple[np.ndarray, int]:
    lib = library()
    pcm, sr, n, err = _F32P(), ctypes.c_uint32(), ctypes.c_uint64(), \
        ctypes.c_char_p()
    rc = getattr(lib, name)(data, len(data), ctypes.byref(pcm),
                            ctypes.byref(sr), ctypes.byref(n),
                            ctypes.byref(err))
    if rc != 0:
        raise ValueError(f"{what}{err.value.decode()}")
    try:
        out = np.ctypeslib.as_array(pcm, (n.value,)).copy() if n.value \
            else np.zeros(0, np.float32)
    finally:
        lib.tat_native_free(pcm)
    return out, int(sr.value)


def wav_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (mono float32, sample rate) by wavio.c."""
    return _decode("tat_wav_decode", data, "")


def flac_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32, sample rate) by flacio.c."""
    return _decode("tat_flac_decode", data, "FLAC: ")


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance by editdistance.c."""
    ids: dict = {}
    seqs = [np.fromiter((ids.setdefault(x, len(ids)) for x in s), np.int64)
            for s in (a, b)]
    i64p = ctypes.POINTER(ctypes.c_int64)
    d = library().tat_edit_distance(
        seqs[0].ctypes.data_as(i64p), len(seqs[0]),
        seqs[1].ctypes.data_as(i64p), len(seqs[1]))
    if d < 0:
        raise MemoryError("tat_edit_distance: out of memory")
    return int(d)
