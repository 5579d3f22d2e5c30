"""Real-time serving loop: IR hot-swap under a running stream.

Counterpart of ``hisstools_library_tpu/utils/serving.py``. The reference's
RT-safety story (the reason MemorySwap + ThreadLocks exist):

- the audio thread calls ``MonoConvolve::process`` which ``attempt()``s the
  swappable IR buffer and **emits silence** while the loader holds it
  (HIRT_Multichannel_Convolution/MonoConvolve.cpp:179-201);
- the loader thread prepares and installs a new IR under the blocking lock
  (``MemorySwap::equal``, MonoConvolve.cpp:118-140, MemorySwap.h:174-212),
  growing the allocation only when capacity is exceeded;
- after a swap the engine state is reset (MonoConvolve.cpp:136).

Here the swappable value is the prepared ``MonoIR`` on the card and the
"allocation capacity" is the padded IR length: every IR up to the capacity
gives the same tensor shapes, so the audio thread's step
(:func:`models.mono.process_any`, any callback length: K9, K1 -> MAC -> K6
and the time-domain head on a CUDA device) meets the same shapes across
swaps; growing past the capacity changes them, the reference's reallocation.

Both threads queue their work on their own current CUDA stream, the
default stream unless the caller sets another, so on one card the audio
thread's callbacks queued during a swap wait behind the loader's
per-partition transforms.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import resolve_device
from ..models import mono
from ..models.mono import LatencyMode, PartitionScheme
from . import profiling
from .memory_swap import MemorySwap


@dataclasses.dataclass
class _PreparedIR:
    """What the loader installs: the prepared IR + an identity stamp."""
    ir: mono.MonoIR
    version: int
    capacity: int


class StreamingServer:
    """Two-thread serving harness around the sample-granular streaming engine.

    Audio thread: :meth:`process` — never blocks; silence while the loader
    holds the IR, state reset on the first block after a swap.
    Loader thread: :meth:`set_ir` — prepares the new IR *outside* the lock
    (device transforms of the padded IR), installs it under the lock.
    Entry points build on ``device`` (the card unless named).
    """

    def __init__(self, channels: int, capacity: int = 1 << 16,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None,
                 dtype: torch.dtype = torch.float32, backend: Optional[str] = None,
                 native: Optional[bool] = None, device=None):
        self.scheme = scheme if scheme is not None else \
            PartitionScheme.from_latency(latency)
        self.channels = channels
        self.capacity = capacity
        self.dtype = dtype
        self.backend = backend
        self.device = resolve_device(device)
        # The swap cell's lock lives in native memory when the native runtime
        # is available (native/rt_runtime.cpp — the reference's C++
        # MemorySwap/ThreadLocks counterpart, usable from non-Python audio
        # threads); the pure-Python cell serves otherwise. ``native`` forces
        # either choice: True raises RuntimeError when the runtime cannot be
        # built.
        from . import native_rt
        use_native = native_rt.available() if native is None else native
        self._swap = (native_rt.NativeMemorySwap() if use_native
                      else MemorySwap())
        self._version = 0
        self._version_lock = threading.Lock()
        # Audio-thread-local (single consumer): current state + the IR version
        # it was built for.
        self._state: Optional[mono.MonoStreamState] = None
        self._state_version = -1

    # -- loader thread --------------------------------------------------------

    def set_ir(self, ir, capacity: Optional[int] = None) -> int:
        """Prepare and install a new IR bank; returns its version stamp.

        ``ir``: (channels, L) host array (or (L,) for every channel).
        Preparation (rFFT of every partition) runs outside the lock so the
        audio thread is blocked only for the pointer swap — the reference's
        allocation-outside/swap-inside discipline (MemorySwap.h:15-17:
        memory is freed in the swapping thread)."""
        ir = np.asarray(ir)
        if ir.ndim == 1:
            ir = np.broadcast_to(ir, (self.channels, ir.shape[-1]))
        if ir.shape[0] != self.channels:
            raise ValueError(f"IR bank has {ir.shape[0]} channels, "
                             f"server has {self.channels}")
        length = ir.shape[-1]
        cap = capacity if capacity is not None else self.capacity
        cap = max(cap, 1)
        while cap < length:  # grow capacity: new shapes from the next block on
            cap *= 2
        padded = np.zeros((self.channels, cap), ir.dtype)
        padded[:, :length] = ir
        prepared_ir = mono.prepare_ir(self.scheme, padded, dtype=self.dtype,
                                      backend=self.backend, offline_tail=False,
                                      device=self.device)
        # Wait for the preparation before installing it, so the audio
        # thread's first block after the swap never queues behind the
        # per-partition transforms still in flight.
        profiling.sync(prepared_ir)
        with self._version_lock:
            self._version += 1
            version = self._version
        self.capacity = cap
        self._swap.swap(_PreparedIR(prepared_ir, version, cap), cap).release()
        return version

    # -- audio thread ---------------------------------------------------------

    def process(self, block) -> Tuple[torch.Tensor, bool]:
        """One audio callback of ANY length: returns (output, live).

        ``live`` is False when the loader held the lock — the output is
        silence for exactly that block (reference MonoConvolve.cpp:181-183) and
        the stream resumes (with reset state, as after the reference's
        set->reset) once the swap completes. The returned tensor's computation
        is queued on the device but not waited for — the callback never
        blocks on the device either."""
        # Convert at the edge, as the reference's double overload does
        # (Convolver.cpp:156-183): the engine runs in self.dtype regardless
        # of what the callback feeds (float64 numpy is numpy's default).
        block = torch.as_tensor(block).to(device=self.device,
                                          dtype=self.dtype).contiguous()
        with self._swap.attempt() as handle:
            prepared = handle.get()
            if prepared is None:
                return torch.zeros_like(block), False
            if prepared.version != self._state_version:
                # First block after a swap (or first block ever): fresh state.
                self._state = mono.init_stream_state(
                    self.scheme, prepared.ir, (self.channels,), self.dtype)
                self._state_version = prepared.version
            self._state, y = mono.process_any(prepared.ir, self._state, block,
                                              backend=self.backend)
            return y, True

    def latency_samples(self) -> int:
        return self.scheme.latency
