"""Peaks of the card and the least time a call's work could take.

The peaks and the bound are frozen copies of ``chip_smoke.py``'s
``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``fft_flops`` and ``bound``
(``chip_smoke.py:269-272``, ``:354-357``, ``:403-409``), rewritten for a
call's work as the cell's shapes define it: what any implementation has to
read, write and compute, whatever kernels run it.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM, NVIDIA's data sheet (dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

F32 = 4  # bytes a sample


def fft_flops(n: int, frames: int) -> float:
    """Operations of ``frames`` real transforms of size n: 2.5 N log2 N each
    (half a complex N-point FFT's 5 N log2 N)."""
    return 2.5 * n * math.log2(n) * frames


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: (seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs(frames_out: int, frames_in: int, parts: int, history: bool) -> int:
    """(output frame, IR partition) products whose input frame exists: with a
    history every output frame meets every partition; without one, frame f
    meets partition p only where 0 <= f - p < frames_in."""
    if history:
        return frames_out * parts
    total = 0
    for p in range(parts):  # input frame j = f - p for f < frames_out
        total += max(0, min(frames_out - p, frames_in))
    return total


def convolution_flops(channels: int, n_in: int, n_taps: int, n_out: int,
                      history: bool, ir_in_call: bool) -> float:
    """The fewest transform and product operations of an FFT convolution
    giving ``n_out`` samples from ``n_in`` new input samples and ``n_taps``
    taps, over uniformly partitioned overlap-save at every power-of-two size
    (one partition covers a single large FFT): forward transforms of the new
    input frames, an inverse a frame out, 8 operations a bin for each valid
    (frame, partition) product, and the IR's transforms where the call makes
    them. ``history``: earlier input is carried in (a stream block)."""
    best = math.inf
    for log2n in range(2, 27):
        n = 1 << log2n
        s = n >> 1
        parts = -(-n_taps // s)
        frames_out = -(-n_out // s)
        frames_in = -(-n_in // s)
        ops = (fft_flops(n, frames_in + frames_out + (parts if ir_in_call else 0))
               + 8.0 * (s + 1) * _pairs(frames_out, frames_in, parts, history))
        best = min(best, ops)
    return channels * best
