"""Lock-guarded hot-swappable storage — the host-side runtime counterpart of
``MemorySwap<T>`` + ``thread_lock``
(HIRT_Multichannel_Convolution/MemorySwap.h, ThreadLocks.hpp).

A copy of ``hisstools_library_tpu/utils/memory_swap.py`` (which imports no
jax; the port imports nothing of that package). Device computation is
functional (an IR "swap" is just passing new prepared spectra into the next
step), but a *serving host* still has the reference's two-thread problem —
a real-time processing thread that must never block versus a loader thread
preparing new IRs. This class reproduces the reference's discipline:

- ``attempt()``  non-blocking try-acquire (the audio thread); returns an empty
  handle when the loader holds the lock (MemorySwap.h:180-185), in which case the
  caller outputs silence exactly as MonoConvolve::process does (:181-183).
- ``access()``   blocking acquire (loader thread).
- ``swap/grow/equal`` replace or conditionally (re)allocate the stored value under
  the lock (:188-212), with the old value released in the swapping thread.

The spinlock follows ThreadLocks.hpp:51-87's three-phase backoff: spin, timed
yield, sleep.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class SpinLock:
    """Three-phase backoff spinlock (reference thread_lock, ThreadLocks.hpp:51-87)."""

    def __init__(self):
        self._flag = threading.Lock()

    def attempt(self) -> bool:
        return self._flag.acquire(blocking=False)

    def acquire(self) -> None:
        # Phase 1: quick spins; Phase 2: short sleeps; Phase 3: longer sleeps.
        for _ in range(10):
            if self._flag.acquire(blocking=False):
                return
        deadline = time.monotonic() + 10e-6
        while time.monotonic() < deadline:
            if self._flag.acquire(blocking=False):
                return
        while not self._flag.acquire(blocking=False):
            time.sleep(0.1e-3)

    def release(self) -> None:
        self._flag.release()


class Handle(Generic[T]):
    """RAII-style pointer handle (reference MemorySwap::Ptr, :30-115). Use as a
    context manager; ``get()`` is None when acquisition failed."""

    def __init__(self, owner: Optional["MemorySwap[T]"], value: Optional[T],
                 size: int):
        self._owner = owner
        self._value = value
        self._size = size

    def get(self) -> Optional[T]:
        return self._value

    def get_size(self) -> int:
        return self._size if self._value is not None else 0

    def valid(self) -> bool:
        return self._value is not None

    def release(self) -> None:
        if self._owner is not None:
            self._owner._unlock()
            self._owner = None
            self._value = None

    # swap/grow/equal through a held handle (reference Ptr::swap/grow/equal :62-87)
    def swap(self, value: T, size: int) -> None:
        if self._owner is not None:
            self._value, self._size = self._owner._set_unlocked(value, size)

    def grow(self, alloc: Callable[[int], T], size: int) -> None:
        # std::greater semantics (MemorySwap.h:204-207): only grows.
        if self._owner is not None and size > self._size:
            self._value, self._size = self._owner._set_unlocked(alloc(size), size)

    def equal(self, alloc: Callable[[int], T], size: int) -> None:
        # Exact-size semantics (std::not_equal_to in the reference,
        # MemorySwap.h:174-212): shrinks reallocate too — callers like the
        # reference's MonoConvolve::resize test `getSize() == length`.
        if self._owner is not None and self._size != size:
            self._value, self._size = self._owner._set_unlocked(alloc(size), size)

    def __enter__(self) -> "Handle[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class MemorySwap(Generic[T]):
    """Thread-safe hot-swappable value with non-blocking audio-thread access."""

    def __init__(self, value: Optional[T] = None, size: int = 0,
                 free: Optional[Callable[[T], None]] = None):
        self._lock = SpinLock()
        self._value = value
        self._size = size if value is not None else 0
        self._free = free

    def clear(self) -> None:
        self.swap(None, 0)

    def attempt(self) -> Handle[T]:
        """Non-blocking acquire — empty handle if the lock is held (:180-185)."""
        if self._lock.attempt():
            return Handle(self, self._value, self._size)
        return Handle(None, None, 0)

    def access(self) -> Handle[T]:
        """Blocking acquire (:174-178)."""
        self._lock.acquire()
        return Handle(self, self._value, self._size)

    def swap(self, value: Optional[T], size: int) -> Handle[T]:
        """Blocking replace; frees the old value in this thread (:188-193)."""
        self._lock.acquire()
        self._set_unlocked(value, size)
        return Handle(self, self._value, self._size)

    def grow(self, alloc: Callable[[int], T], size: int) -> Handle[T]:
        """Reallocate only if the current size is smaller (std::greater,
        MemorySwap.h:204-207)."""
        self._lock.acquire()
        if size > self._size:
            self._set_unlocked(alloc(size), size)
        return Handle(self, self._value, self._size)

    def equal(self, alloc: Callable[[int], T], size: int) -> Handle[T]:
        """Reallocate unless the current size is EXACTLY ``size`` (the
        reference's allocate_if<std::not_equal_to>, MemorySwap.h:209-212 —
        shrinks reallocate too)."""
        self._lock.acquire()
        if self._size != size:
            self._set_unlocked(alloc(size), size)
        return Handle(self, self._value, self._size)

    # internal: requires the lock held
    def _set_unlocked(self, value: Optional[T], size: int):
        old = self._value
        self._value = value
        self._size = size if value is not None else 0
        if old is not None and self._free is not None:
            self._free(old)
        return self._value, self._size

    def _unlock(self) -> None:
        self._lock.release()
