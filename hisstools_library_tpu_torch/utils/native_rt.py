"""ctypes bindings for the native real-time runtime (native/rt_runtime.cpp).

A copy of ``hisstools_library_tpu/utils/native_rt.py`` (which imports no jax;
the port imports nothing of that package) with one change: the library is
built by :mod:`.._native` into ``build/hisstools_torch_native/``, not beside
the JAX package's own ``native/librt_runtime.so``.

The reference implements its serving-host machinery in C++ — the three-phase
backoff spinlock (ThreadLocks.hpp:51-87), the hot-swappable IR buffer the
audio thread may only ``attempt()`` (MemorySwap.h:174-212), and the staging
buffers that decouple the audio callback from processing cadence
(PartitionedConvolve.cpp:304-307). This module binds the port's native
counterparts:

- :class:`NativeSpinLock` / :class:`NativeMemorySwap` — drop-in replacements
  for the pure-Python classes in :mod:`.memory_swap` whose lock and cell live
  in native memory (usable from non-Python audio threads);
- :class:`Ring` — lock-free SPSC float ring buffer (audio-callback safe);
- :class:`AudioHost` — a native duplex audio-callback thread that feeds a
  capture ring and drains a playback ring at a fixed block cadence, counting
  overruns/underruns — the real-time test harness for the serving loop.

Built on demand with g++ and cached; :func:`available` is False when no
toolchain is present, and every class here then raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import itertools
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import _native
from .memory_swap import Handle

_u64 = ctypes.c_uint64
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_p = ctypes.c_void_p

_SIGNATURES = {
    "ht_lock_create": (_p, []),
    "ht_lock_destroy": (None, [_p]),
    "ht_lock_attempt": (_i32, [_p]),
    "ht_lock_acquire": (None, [_p]),
    "ht_lock_release": (None, [_p]),
    "ht_swap_create": (_p, []),
    "ht_swap_destroy": (None, [_p]),
    "ht_swap_attempt": (_i32, [_p, ctypes.POINTER(_u64),
                               ctypes.POINTER(_u64)]),
    "ht_swap_access": (None, [_p, ctypes.POINTER(_u64),
                              ctypes.POINTER(_u64)]),
    "ht_swap_set": (None, [_p, _u64, _u64, ctypes.POINTER(_u64),
                           ctypes.POINTER(_u64)]),
    "ht_swap_release": (None, [_p]),
    "ht_ring_create": (_p, [_u64]),
    "ht_ring_destroy": (None, [_p]),
    "ht_ring_capacity": (_u64, [_p]),
    "ht_ring_readable": (_u64, [_p]),
    "ht_ring_writable": (_u64, [_p]),
    "ht_ring_write": (_u64, [_p, _p, _u64]),
    "ht_ring_read": (_u64, [_p, _p, _u64]),
    "ht_ring_discard": (_u64, [_p, _u64]),
    "ht_bring_create": (_p, [_u64]),
    "ht_bring_destroy": (None, [_p]),
    "ht_bring_capacity": (_u64, [_p]),
    "ht_bring_readable": (_u64, [_p]),
    "ht_bring_writable": (_u64, [_p]),
    "ht_bring_write": (_u64, [_p, _p, _u64]),
    "ht_bring_read": (_u64, [_p, _p, _u64]),
    "ht_loader_create": (_p, [ctypes.c_char_p, _u64, _u64, _u64, _p]),
    "ht_loader_finished": (_i32, [_p]),
    "ht_loader_join": (None, [_p] + [ctypes.POINTER(_i64)] * 3),
    "ht_loader_destroy": (None, [_p]),
    "ht_host_create": (_p, [_p, _p, _p, _u64, _i32, _i32,
                            ctypes.c_double, _i64, _i64, _p, _u64]),
    "ht_host_done": (_i32, [_p]),
    "ht_host_join": (None, [_p] + [ctypes.POINTER(_i64)] * 4),
    "ht_host_destroy": (None, [_p]),
    "ht_rt_version": (_i32, []),
}


def _bind(lib: ctypes.CDLL) -> None:
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    return _native.load("rt_runtime.cpp", ("-pthread",), _bind)


def available() -> bool:
    return load() is not None


class NativeSpinLock:
    """Three-phase backoff spinlock living in native memory (drop-in for
    :class:`memory_swap.SpinLock`; reference ThreadLocks.hpp:51-87)."""

    def __init__(self):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ptr = self._lib.ht_lock_create()

    def attempt(self) -> bool:
        return bool(self._lib.ht_lock_attempt(self._ptr))

    def acquire(self) -> None:
        self._lib.ht_lock_acquire(self._ptr)

    def release(self) -> None:
        self._lib.ht_lock_release(self._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_lock_destroy(self._ptr)
            self._ptr = None


class NativeMemorySwap:
    """Hot-swappable value cell whose lock and (value, size) pair live in
    native memory; same interface as :class:`memory_swap.MemorySwap`.

    Python payloads are parked in a slot table keyed by an integer the native
    cell stores; slots are only mutated under the cell's lock, and a replaced
    payload's slot is dropped in the swapping thread — the reference's
    free-in-the-assigning-thread discipline (MemorySwap.h:15-17)."""

    def __init__(self, value: Any = None, size: int = 0):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ptr = self._lib.ht_swap_create()
        self._slots: Dict[int, Any] = {}
        self._ids = itertools.count(1)
        if value is not None:
            self.swap(value, size).release()

    # -- helpers -------------------------------------------------------------

    def _store(self, value: Any) -> int:
        if value is None:
            return 0
        slot = next(self._ids)
        self._slots[slot] = value
        return slot

    def _fetch(self, slot: int) -> Any:
        return self._slots.get(slot) if slot else None

    # -- MemorySwap interface ------------------------------------------------

    def clear(self) -> None:
        self.swap(None, 0).release()

    def attempt(self) -> Handle:
        v, s = _u64(), _u64()
        if self._lib.ht_swap_attempt(self._ptr, ctypes.byref(v),
                                     ctypes.byref(s)):
            return Handle(self, self._fetch(v.value), s.value)
        return Handle(None, None, 0)

    def access(self) -> Handle:
        v, s = _u64(), _u64()
        self._lib.ht_swap_access(self._ptr, ctypes.byref(v), ctypes.byref(s))
        return Handle(self, self._fetch(v.value), s.value)

    def swap(self, value: Any, size: int) -> Handle:
        v, s = _u64(), _u64()
        self._lib.ht_swap_access(self._ptr, ctypes.byref(v), ctypes.byref(s))
        self._set_unlocked(value, size)
        return Handle(self, value, size if value is not None else 0)

    def grow(self, alloc, size: int) -> Handle:
        # std::greater semantics (MemorySwap.h:204-207): only grows.
        v, s = _u64(), _u64()
        self._lib.ht_swap_access(self._ptr, ctypes.byref(v), ctypes.byref(s))
        if size > s.value:
            value = alloc(size)
            self._set_unlocked(value, size)
            return Handle(self, value, size)
        return Handle(self, self._fetch(v.value), s.value)

    def equal(self, alloc, size: int) -> Handle:
        v, s = _u64(), _u64()
        self._lib.ht_swap_access(self._ptr, ctypes.byref(v), ctypes.byref(s))
        if s.value != size:  # exact-size, as MemorySwap.h's std::not_equal_to
            value, new_size = alloc(size), size
            self._set_unlocked(value, new_size)
            return Handle(self, value, new_size)
        return Handle(self, self._fetch(v.value), s.value)

    # internal: requires the lock held (Handle.swap/equal call through here)
    def _set_unlocked(self, value: Any, size: int) -> Tuple[Any, int]:
        slot = self._store(value)
        size = size if value is not None else 0
        old_v, old_s = _u64(), _u64()
        self._lib.ht_swap_set(self._ptr, slot, size,
                              ctypes.byref(old_v), ctypes.byref(old_s))
        if old_v.value:
            self._slots.pop(old_v.value, None)  # freed in the swapping thread
        return value, size

    def _unlock(self) -> None:
        self._lib.ht_swap_release(self._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_swap_destroy(self._ptr)
            self._ptr = None


class Ring:
    """Lock-free SPSC float32 ring buffer (native; audio-callback safe)."""

    def __init__(self, capacity_floats: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ptr = self._lib.ht_ring_create(capacity_floats)

    @property
    def ptr(self):
        return self._ptr

    def capacity(self) -> int:
        return self._lib.ht_ring_capacity(self._ptr)

    def readable(self) -> int:
        return self._lib.ht_ring_readable(self._ptr)

    def writable(self) -> int:
        return self._lib.ht_ring_writable(self._ptr)

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        return self._lib.ht_ring_write(
            self._ptr, data.ctypes.data_as(_p), data.size)

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.ht_ring_read(self._ptr, out.ctypes.data_as(_p), n)
        return out[:got]

    def discard(self, n: int) -> int:
        return self._lib.ht_ring_discard(self._ptr, n)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_ring_destroy(self._ptr)
            self._ptr = None


class ByteRing:
    """Lock-free SPSC byte ring buffer (native; data-loader staging)."""

    def __init__(self, capacity_bytes: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ptr = self._lib.ht_bring_create(capacity_bytes)

    @property
    def ptr(self):
        return self._ptr

    def capacity(self) -> int:
        return self._lib.ht_bring_capacity(self._ptr)

    def readable(self) -> int:
        return self._lib.ht_bring_readable(self._ptr)

    def writable(self) -> int:
        return self._lib.ht_bring_writable(self._ptr)

    def write(self, data: bytes) -> int:
        buf = np.frombuffer(data, np.uint8)
        return self._lib.ht_bring_write(
            self._ptr, buf.ctypes.data_as(_p), buf.size)

    def read(self, n: int) -> bytes:
        out = np.empty(n, np.uint8)
        got = self._lib.ht_bring_read(self._ptr, out.ctypes.data_as(_p), n)
        return out[:got].tobytes()

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_bring_destroy(self._ptr)
            self._ptr = None


class FileLoader:
    """Native async file loader: a background thread streams a byte range of
    a file into a :class:`ByteRing` with backpressure — the prefetching
    data-loader half of the runtime (the reference reads synchronously on the
    caller's thread, IAudioFile.cpp readAudio loops; a serving host wants the
    disk off the hot path). Call :meth:`join` after :meth:`finished` (or to
    abort a partial stream)."""

    def __init__(self, path: str, offset: int, length: int, ring: ByteRing,
                 chunk_bytes: int = 1 << 16):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ring = ring  # keep alive for the thread's lifetime
        self._ptr = self._lib.ht_loader_create(
            os.fsencode(path), offset, length, chunk_bytes, ring.ptr)
        if not self._ptr:
            raise OSError(f"cannot open/position {path!r} at {offset}")

    def finished(self) -> bool:
        return bool(self._lib.ht_loader_finished(self._ptr))

    def join(self) -> Dict[str, int]:
        br, st, er = _i64(), _i64(), _i64()
        self._lib.ht_loader_join(self._ptr, ctypes.byref(br),
                                 ctypes.byref(st), ctypes.byref(er))
        return {"bytes_read": br.value, "stalls": st.value,
                "io_errors": er.value}

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_loader_destroy(self._ptr)
            self._ptr = None


class AudioHost:
    """Native duplex audio-callback thread (a simulated audio device).

    Every ``frames_per_block / sample_rate`` seconds it pushes the next
    interleaved source block into ``in_ring`` (capture side) and drains one
    block from ``out_ring`` (playback side), zero-filling and counting an
    underrun when the worker has not kept up. The played audio is captured to
    a sink buffer for offline verification."""

    def __init__(self, in_ring: Ring, out_ring: Ring, src: np.ndarray,
                 frames_per_block: int, channels: int, sample_rate: float,
                 total_blocks: int, warmup_blocks: int = 0,
                 capture: bool = True):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        # Keep buffers alive for the native thread's lifetime.
        self._src = np.ascontiguousarray(src, np.float32).ravel()
        self._sink = (np.zeros(total_blocks * frames_per_block * channels,
                               np.float32) if capture else None)
        self._rings = (in_ring, out_ring)
        self.frames_per_block = frames_per_block
        self.channels = channels
        self._ptr = self._lib.ht_host_create(
            in_ring.ptr, out_ring.ptr, self._src.ctypes.data_as(_p),
            self._src.size, frames_per_block, channels, sample_rate,
            total_blocks, warmup_blocks,
            self._sink.ctypes.data_as(_p) if self._sink is not None else None,
            self._sink.size if self._sink is not None else 0)

    def done(self) -> bool:
        return bool(self._lib.ht_host_done(self._ptr))

    def join(self) -> Dict[str, int]:
        blocks, under, over, late = _i64(), _i64(), _i64(), _i64()
        self._lib.ht_host_join(self._ptr, ctypes.byref(blocks),
                               ctypes.byref(under), ctypes.byref(over),
                               ctypes.byref(late))
        return {"blocks": blocks.value, "underruns": under.value,
                "overruns": over.value, "late_ns_max": late.value}

    @property
    def played(self) -> Optional[np.ndarray]:
        """Interleaved audio the host actually played (post-join)."""
        if self._sink is None:
            return None
        return self._sink.reshape(-1, self.channels * self.frames_per_block)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ht_host_destroy(self._ptr)
            self._ptr = None
