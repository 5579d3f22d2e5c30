"""ctypes bindings for the native PCM codec (native/hisstools_codec.cpp).

A copy of ``hisstools_library_tpu/io/native_codec.py`` (which imports no jax)
with one change: the library is built by :mod:`.._native` into
``build/hisstools_torch_native/``, not beside the JAX package's own
``native/libhisstools_codec.so``. Loading failures fall back silently to the
numpy codecs in audio_file.py (the behaviour is identical — the native path
exists for data-loader throughput on large multichannel IR banks, mirroring
the reference's C++ conversion loops).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import _native


def _bind(lib: ctypes.CDLL) -> None:
    lib.ht_decode_pcm.restype = ctypes.c_int
    lib.ht_decode_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p]
    lib.ht_encode_pcm.restype = ctypes.c_int
    lib.ht_encode_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p]
    lib.ht_codec_version.restype = ctypes.c_int32


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None if unavailable."""
    return _native.load("hisstools_codec.cpp", (), _bind)


def available() -> bool:
    return load() is not None


_BYTES = {0: 1, 1: 2, 2: 3, 3: 4, 4: 4, 5: 8}


def decode_pcm(raw: bytes, fmt: int, little_endian: bool,
               wave_uint8: bool = False) -> Optional[np.ndarray]:
    """Decode PCM bytes to normalised float64; None if native path unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(raw) // _BYTES[fmt]
    out = np.empty(n, np.float64)
    buf = np.frombuffer(raw, np.uint8)
    rc = lib.ht_decode_pcm(
        buf.ctypes.data_as(ctypes.c_void_p), n, fmt,
        1 if little_endian else 0, 1 if wave_uint8 else 0,
        out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def encode_pcm(x: np.ndarray, fmt: int, little_endian: bool,
               wave_uint8: bool = False) -> Optional[bytes]:
    """Encode normalised float64 samples to PCM bytes; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    n = x.size
    out = np.empty(n * _BYTES[fmt], np.uint8)
    rc = lib.ht_encode_pcm(
        x.ctypes.data_as(ctypes.c_void_p), n, fmt,
        1 if little_endian else 0, 1 if wave_uint8 else 0,
        out.ctypes.data_as(ctypes.c_void_p))
    return out.tobytes() if rc == 0 else None
