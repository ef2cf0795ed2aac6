"""ctypes binding of the native FLAC decoder (``native/flac_decoder.cpp``).

A copy of ``speechain_tpu/utils/native_audio.py::read_flac`` (float
output only). The shared library is built by ``native/build.sh``; this
module loads it at the first call.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None


def _find_lib() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # the variable first: users can substitute their own build
    candidates = [
        os.environ.get("SPEECHAIN_NATIVE_LIB", ""),
        os.path.join(here, "native", "libspeechain_native.so"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        "native audio library not built; run native/build.sh "
        f"(searched {candidates})")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_find_lib())
        lib.flac_decode_file.restype = ctypes.c_longlong
        lib.flac_decode_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
    return _LIB


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to (mono float32 in [-1, 1], sample_rate);
    several channels are averaged."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.flac_decode_file(path.encode(), ctypes.byref(out),
                             ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise ValueError(f"failed to decode FLAC file {path!r}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(int(n) * ch.value,)).copy()
    finally:
        lib.flac_free(out)
    arr = arr.reshape(int(n), ch.value)
    arr = arr.mean(axis=1) if ch.value > 1 else arr[:, 0]
    return arr.astype(np.float32), int(sr.value)
