"""Variable-width kernel smoothing (e.g. spectrum smoothing), on torch
tensors.

Counterpart of ``hisstools_library_tpu/ops/smoothing.py`` (reference
``kernel_smoother``, KernelSmoother.hpp). The smoothing width ramps linearly
from ``width_lo`` to ``width_hi`` across the series (:64-77); outputs that
share a rounded half-width share one resampled kernel (:143-205). Widths
depend only on host parameters, so the filters are built on the host in
float64, and the filter bank is cached on the device.

Up to a filter width of 4096 the whole smoother is one host-built (L, W)
filter bank applied as one ``unfold`` of the edge-padded series and
``(windows * bank).sum(-1)``: an elementwise product and a sum, no matmul,
so TF32 cannot touch it on the card. Only where the (lead, L, W) product
would exceed :data:`BANK_BUDGET` elements is it applied in L-chunks. Wider
filters go group by group through ``spectral_processor.convolve`` (FFT) or
``time_domain.fir_offline`` (direct), by the reference's heuristic
``n > 64 && hw > 16 && hw*64 > n`` (:240-245).

Filter construction (make_filter, :257-287): the kernel is linearly
resampled over the filter width with end handling driven by whether the
kernel's endpoints are zero (Ends detection :92-103); each filter is
normalised to unit sum. Edge modes ZeroPad / Extend / Wrap / Fold / Mirror
pad the series by ``filter_size`` on each side through the table reader's
index math (:107-132).
"""

from __future__ import annotations

import enum
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import spectral_processor as sp
from .table_reader import EdgeMode as TableEdge, _edge_indices

# The filter bank's (lead, L, W) product is applied in L-chunks above this
# many elements (2^25: 128 MB of float32).
BANK_BUDGET = 1 << 25


class EdgeMode(enum.Enum):
    ZeroPad = 0
    Extend = 1
    Wrap = 2
    Fold = 3
    Mirror = 4


class _Ends(enum.Enum):
    Zero = 0
    NonZero = 1
    SymZero = 2
    SymNonZero = 3  # declared by the reference but never assigned (:30,92-103)


_TABLE_EDGE = {
    EdgeMode.ZeroPad: TableEdge.ZeroPad,
    EdgeMode.Extend: TableEdge.Extend,
    EdgeMode.Wrap: TableEdge.Wrap,
    EdgeMode.Fold: TableEdge.Fold,
    EdgeMode.Mirror: TableEdge.Mirror,
}


def _pad_edges(x: torch.Tensor, pad: int, mode: EdgeMode) -> torch.Tensor:
    """Pad ``pad`` samples on each side using the edge behaviour (:107-132)."""
    if pad == 0:
        return x
    L = x.shape[-1]
    idx = torch.cat([torch.arange(-pad, 0), torch.arange(L, L + pad)]).to(x.device)
    mapped, zero_mask = _edge_indices(idx, L, _TABLE_EDGE[mode])
    vals = x[..., mapped]
    if zero_mask is not None:
        vals = torch.where(zero_mask, torch.zeros_like(vals), vals)
    return torch.cat([vals[..., :pad], x, vals[..., pad:]], dim=-1)


def _resample_kernel(kernel: np.ndarray, width: int, ends: _Ends) -> np.ndarray:
    """make_filter (:257-287): linear-resample the kernel over ``width``
    samples, on the host in float64."""
    kl = len(kernel)
    if kl == 1:
        return np.full(width, kernel[0])
    width_adjust = -1.0 if ends == _Ends.NonZero else (0.0 if ends == _Ends.SymZero else 1.0)
    scale_width = max(1.0, width + width_adjust)
    norm = (kl - 1) / scale_width
    offset = 1 if ends == _Ends.Zero else 0
    loop = width - 1 if ends == _Ends.NonZero else width
    pos = (np.arange(loop) + offset) * norm
    i0 = np.minimum(pos.astype(np.int64), kl - 2)
    fr = pos - i0
    filt = np.empty(width, np.float64)
    filt[:loop] = kernel[i0] + fr * (kernel[i0 + 1] - kernel[i0])
    if ends == _Ends.NonZero:
        filt[width - 1] = kernel[kl - 1]
    return filt


def _use_fft(n: int, half_width: int) -> bool:
    return n > 64 and half_width > 16 and half_width * 64 > n


def _half_widths(L: int, width_lo: float, width_mul: float) -> np.ndarray:
    """Each output's half-width: C++ ``std::round`` (half away from zero) of
    (width_lo + i * width_mul) / 2, not Python's banker's rounding."""
    return np.floor((width_lo + np.arange(L) * width_mul) * 0.5 + 0.5).astype(np.int64)


def _groups(hws: np.ndarray):
    """(start, end, half-width) of each run of equal half-widths."""
    cuts = np.concatenate([[0], np.flatnonzero(np.diff(hws)) + 1, [len(hws)]])
    return [(int(a), int(b), int(hws[a])) for a, b in zip(cuts[:-1], cuts[1:])]


def _filter(kernel: np.ndarray, hw: int, symmetric: bool, ends: _Ends):
    """The resampled filter of half-width ``hw`` and its unit-sum gain."""
    if symmetric:
        half = _resample_kernel(kernel, hw, ends)
        filt_sum = half.sum() * 2.0 - half[0]
        filt = np.concatenate([half[::-1], half[1:]])
    else:
        filt = _resample_kernel(kernel, 2 * hw - 1, ends)
        filt_sum = filt.sum()
    return filt, (1.0 / filt_sum if filt_sum else 1.0)


@functools.lru_cache(maxsize=8)
def _bank(kernel_bytes: bytes, L: int, width_lo: float, width_mul: float, symmetric: bool,
          ends: _Ends, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (L, W) filter bank, built on the host in float64 and cached on the
    device: row i holds output i's filter, reversed and centred in the
    W-wide window, so y[i] = sum_j filt[j] * padded[fs + i + (hw-1) - j]."""
    kernel = np.frombuffer(kernel_bytes, np.float64)
    hws = _half_widths(L, width_lo, width_mul)
    hw_max = int(max(hws[0], hws[-1]))
    bank = np.zeros((L, 2 * hw_max - 1), np.float64)
    centre = hw_max - 1
    for i, j, hw in _groups(hws):
        filt, gain = _filter(kernel, hw, symmetric, ends)
        bank[i:j, centre - (hw - 1): centre + hw] = filt[::-1] * gain
    return torch.from_numpy(bank).to(device, dtype)


def _group_conv(seg: torch.Tensor, filt: np.ndarray, n_out: int, gain: float,
                backend: Optional[str]) -> torch.Tensor:
    """conv(seg, filt)[w-1 : w-1+n_out] * gain, by FFT or directly as the
    size heuristic picks."""
    from ..models.time_domain import fir_offline

    w = len(filt)
    fd = torch.as_tensor(filt, dtype=seg.dtype, device=seg.device)
    if _use_fft(n_out, (w + 1) // 2):
        full = sp.convolve(seg, fd, sp.EdgeMode.Linear, backend=backend)
    else:
        full = fir_offline(seg, fd)  # causal: y[k] = conv(seg, filt)[k]
    return full[..., w - 1: w - 1 + n_out] * torch.as_tensor(gain, dtype=seg.dtype)


def smooth(x: torch.Tensor, kernel, width_lo: float, width_hi: float,
           symmetric: bool = False, edges: EdgeMode = EdgeMode.ZeroPad,
           backend: Optional[str] = None) -> torch.Tensor:
    """Smooth ``x`` with a kernel whose width ramps from width_lo to
    width_hi (kernel_smoother::smooth, :55-209).

    ``x``: (..., L) tensor; ``kernel``: host array (the smoothing shape, e.g.
    half a Hann window)."""
    kernel = np.asarray(kernel, np.float64)
    L = x.shape[-1]
    kl = len(kernel)
    if L == 0 or kl == 0:
        return x

    width_lo = min(float(L), max(1.0, width_lo))
    width_hi = min(float(L), max(1.0, width_hi))
    width_mul = (width_hi - width_lo) / (L - 1) if L > 1 else 0.0
    hws = _half_widths(L, width_lo, width_mul)
    filter_size = int(math.ceil(max(width_lo, width_hi) * 0.5))

    # Ends detection (:92-103)
    mx = kernel.max()
    if mx <= 0.0:
        # A kernel with no positive mass would make the end-ratio test below
        # 0/0: reject it instead of letting nan comparisons classify it.
        raise ValueError("smoothing kernel must have a positive maximum")
    eps = np.finfo(np.float64).eps
    ends = _Ends.NonZero
    if (symmetric or kernel[0] / mx < eps) and kernel[-1] / mx < eps:
        ends = _Ends.SymZero if symmetric else _Ends.Zero

    padded = _pad_edges(x, filter_size, edges)
    hw_max = int(max(hws[0], hws[-1]))
    w_max = 2 * hw_max - 1
    if w_max <= 4096:
        bank = _bank(kernel.tobytes(), L, width_lo, width_mul, symmetric, ends, x.dtype,
                     x.device)
        base = filter_size - (hw_max - 1)
        windows = padded.unfold(-1, w_max, 1)[..., base:base + L, :]  # (..., L, W) view
        lead_n = math.prod(x.shape[:-1])
        chunk = L if lead_n * L * w_max <= BANK_BUDGET else max(
            1, BANK_BUDGET // max(1, lead_n * w_max))
        outs = [(windows[..., c0:c0 + chunk, :] * bank[c0:c0 + chunk]).sum(-1)
                for c0 in range(0, L, chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    # Filters wider than 4096: one FFT or direct convolution per group.
    out_parts = []
    for i, j, hw in _groups(hws):
        filt, gain = _filter(kernel, hw, symmetric, ends)
        # data window: padded coords [i - (hw-1) + filter_size, ...)
        start = i - (hw - 1) + filter_size
        seg = padded[..., start:start + (j - i) + 2 * hw - 2]
        out_parts.append(_group_conv(seg, filt, j - i, gain, backend))
    return torch.cat(out_parts, dim=-1)
