"""ctypes binding of the native FLAC decoder (``native/flac_decoder.cpp``).

A copy of ``speechain_tpu/utils/native_audio.py``: ``read_flac`` and
the batch assembler ``batch_read_i16`` (``native/batch_assembler.cpp``)
that the loader's native fast path calls. The shared library is built by
``native/build.sh``; this module loads it at the first call.
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
        lib.flac_decode_file_i16.restype = ctypes.c_longlong
        lib.flac_decode_file_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.flac_free_i16.argtypes = [ctypes.POINTER(ctypes.c_int16)]
        if hasattr(lib, "batch_assemble_i16"):
            lib.batch_assemble_i16.restype = ctypes.c_longlong
            lib.batch_assemble_i16.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ]
        _LIB = lib
    return _LIB


def read_flac(path: str, int16: bool = False) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to (mono float32 in [-1, 1], sample_rate);
    several channels are averaged. ``int16``: a mono 16-bit stream comes
    back as raw int16 PCM; other layouts stay float32."""
    lib = _load()
    if int16:
        out16 = ctypes.POINTER(ctypes.c_int16)()
        sr16 = ctypes.c_int()
        n16 = lib.flac_decode_file_i16(path.encode(), ctypes.byref(out16),
                                       ctypes.byref(sr16))
        if n16 > 0:
            try:
                arr16 = np.ctypeslib.as_array(out16,
                                              shape=(int(n16),)).copy()
            finally:
                lib.flac_free_i16(out16)
            return arr16, int(sr16.value)
        if n16 != -2:  # -2: not mono 16-bit, decoded as float below
            raise ValueError(f"failed to decode FLAC file {path!r}")
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


def batch_read_i16(paths, t_pad: int, b_pad: int, expected_sr: int = 0):
    """Read, decode and pad-pack a batch of mono PCM16 wav / flac files in
    one native call (``native/batch_assembler.cpp``): (feat (b_pad, t_pad,
    1) int16, feat_len (b_pad,) int32), or None where a file needs the
    Python path (another sample format or container, several channels, a
    sample rate other than ``expected_sr``) or the library has no
    assembler."""
    lib = _load()
    if not hasattr(lib, "batch_assemble_i16"):
        return None
    n = len(paths)
    if n > b_pad:
        raise ValueError(f"{n} files for a batch of {b_pad} rows")
    out = np.zeros((b_pad, t_pad), np.int16)
    lens = np.zeros((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.batch_assemble_i16(
        c_paths, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_longlong(t_pad),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.c_int(expected_sr))
    if rc != 0:
        return None
    feat_len = np.zeros((b_pad,), np.int32)
    feat_len[:n] = lens.astype(np.int32)
    return out[..., None], feat_len
