"""Profiling and roofline accounting helpers.

Counterpart of ``hisstools_library_tpu/utils/profiling.py``. The reference
has no in-library tracing (SURVEY.md §5); its test programs carry ad-hoc
wall-clock timers. Here the equivalents are:

- :func:`sync` — wait for the card's queued work (CUDA launches return
  before the device finishes);
- :class:`Timer` — wall-clock timing that synchronises before it stops;
- :func:`trace` — a ``torch.profiler`` window written as a Chrome trace;
- :class:`span` — a named span of the port's own (``hst::<layer>.<name>``)
  at the entries, the engines, the FFT routing and the kernel wrappers,
  recorded only while a ``torch.profiler`` is recording;
- :func:`convolve_roofline` — analytic bytes/flops model of the
  partitioned-convolve hot loop, for the achieved fraction of the H100's
  bandwidth speed-of-light.

A trace from :func:`trace` (or from any ``torch.profiler.profile``) shows
the port's spans as ``user_annotation`` events among the operators, on the
clock of the device trace: ``hst::entry.*`` (the calls users make),
``hst::engine.*`` (schemes and engines), ``hst::fft.*`` (``fft/api``'s
routing and spectrum packing) and ``hst::kernel.*`` (each kernel wrapper,
named as PERF.md's kernel table names the kernel). PERF.md §3 lists every
span. With no profiler recording, a span costs one check of a flag.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from .checkpoint import leaves

SPAN_PREFIX = "hst::"


def enable_compile_cache() -> str:
    """The port's persistent kernel build directory
    (``_build.BUILD_DIR``), returned as a string. The kernels are built
    there on first use and named by a hash of their sources, so a build is
    always reused; there is nothing to enable (the JAX twin switches on
    XLA's compilation cache)."""
    from .. import _build
    return str(_build.BUILD_DIR)


def sync(out) -> None:
    """Wait until the device of ``out``'s first tensor leaf has finished its
    queued work; a no-op for CPU tensors and for ``out`` with no tensor."""
    leaf = next((t for t in leaves(out) if isinstance(t, torch.Tensor)), None)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class Timer:
    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, out=None) -> float:
        if out is not None:
            sync(out)
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` around a block (CPU activity, and CUDA activity
    when a card is present), written as a Chrome trace into ``log_dir``
    (default: ``hisstools-torch-trace`` in the temporary directory). Yields
    the profiler, whose ``key_averages()`` give the sums by kernel."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "hisstools-torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class span:
    """A span of the port named ``hst::<name>``, as a decorator
    (``@span("engine.mono.process")``) or a context manager (``with
    span("engine.deconvolve.divide"):``).

    While a ``torch.profiler`` is recording, the span is a
    ``torch.profiler.record_function``: the profiler keeps it in memory and
    its Chrome trace exports it, on the thread that ran it and on the clock
    of the device operations launched inside it. Otherwise the span calls
    straight through: the only cost is a check of
    ``torch.autograd.profiler._is_profiler_enabled``, the flag the profiler
    sets while it records (``record_function`` itself costs microseconds
    even with no profiler). Spans nest on the calling thread, so each
    device operation can be put down to the innermost span that launched
    it."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._open = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._open.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._open is not None:
            rf, self._open = self._open, None
            rf.__exit__(*exc)

    def __call__(self, fn):
        name = SPAN_PREFIX + self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned


@dataclass
class Roofline:
    flops: float
    bytes: float

    def time_bound(self, peak_flops: float, peak_bw: float) -> float:
        """Speed-of-light seconds on hardware with the given peaks."""
        return max(self.flops / peak_flops, self.bytes / peak_bw)

    def fraction_of_peak(self, measured_seconds: float, peak_flops: float,
                         peak_bw: float) -> float:
        return self.time_bound(peak_flops, peak_bw) / measured_seconds


# NVIDIA H100 SXM (data sheet, 700 W): 67 TFLOP/s FP32 outside the tensor
# cores, 3.35 TB/s HBM3. A card set below 700 W runs slower under load.
H100_SXM_PEAK_FLOPS_F32 = 67e12
H100_SXM_PEAK_BW = 3.35e12


def convolve_roofline(channels: int, signal_len: int, fft_size: int,
                      num_partitions: int, dtype_bytes: int = 4) -> Roofline:
    """Bytes/flops of one uniform section's offline pass: batched rFFT + lag MAC +
    batched riFFT, assuming ideal fusion (each spectrum read once per MAC pass and
    the accumulator kept on-chip)."""
    h = fft_size // 2
    t = signal_len // h
    bins = h
    # FFTs: 2 x (T frames x 5 N log2 N flops), spectra bytes in/out
    fft_flops = 2 * channels * t * 5.0 * fft_size * np.log2(fft_size)
    # MAC: 8 flops per complex multiply-add per bin per partition
    mac_flops = channels * t * num_partitions * bins * 8.0
    # Ideal traffic: X once, H once, Y once (+ input/output samples)
    traffic = dtype_bytes * channels * (
        2 * t * bins            # X spectra write+...
        + 2 * num_partitions * bins   # H read
        + 2 * t * bins          # Y spectra
        + 2 * signal_len        # raw in + out
    )
    return Roofline(fft_flops + mac_flops, traffic)
