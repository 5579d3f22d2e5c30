"""FFT-based convolution / correlation of signals of any length, with edge
modes, and phase change, on torch tensors.

Counterpart of ``hisstools_library_tpu/ops/spectral_processor.py``
(reference ``spectral_processor<T>``, SpectralProcessor.hpp:12-682). Every
operation is a function of its inputs; sizes are Python ints from the
shapes, so the edge-mode "arrange" logic (SpectralProcessor.hpp:445-538) is
slices and adds. The JAX package's ``.at[].add`` scatters become slice adds
into fresh tensors (a clone or ``torch.zeros``), never into a view of the
FFT output that is returned.

All five edge modes (SpectralProcessor.hpp:23):

- ``Linear``     : full linear result, length ``s1 + s2 - 1``
- ``Wrap``       : circular result, length ``max``; tail wraps to the head
- ``WrapCentre`` : circular with the wrap centred
- ``Fold``       : the larger input's edges are reflected (no repeat of the
                   edge sample) before convolving; output length ``max``
- ``FoldRepeat`` : as Fold but the edge sample repeats

Scaling matches the reference exactly: real path ``0.25/N``
(SpectralProcessor.hpp:643), complex path ``1/N`` (:573), ``change_phase``
``0.5/N`` (:207). The transforms follow :mod:`..fft.api`: on a CUDA tensor
the real ops launch K10/K11, K1/K6 or K13/K14 by size (a 10 s x 10 s
convolution at 48 kHz is N = 2^20) and K16 for the product between them,
the complex ops K12.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.types import Split, cmul, cmul_conj
from ..fft import api as fft_api
from ..utils.profiling import span
from . import spectral


class EdgeMode(enum.Enum):
    Linear = 0
    Wrap = 1
    WrapCentre = 2
    Fold = 3
    FoldRepeat = 4


def calc_fft_size_log2(size: int) -> int:
    """Ceiling log2 (reference SpectralProcessor.hpp:230-241)."""
    if size <= 0:
        return 0
    return (size - 1).bit_length() if size > 1 else 0


class _OpSizes:
    """Size bookkeeping for a binary op (reference op_sizes,
    SpectralProcessor.hpp:323-354)."""

    def __init__(self, size1: int, size2: int, mode: EdgeMode):
        self.mode = mode
        self.size1 = size1
        self.size2 = size2
        self.min = min(size1, size2)
        self.max = max(size1, size2)
        self.linear = size1 + size2 - 1
        self.fold_copy = self.max + ((self.min >> 1) << 1)
        calc = self.linear if not self.fold_mode else self.fold_copy + self.min - 1
        self.fft_log2 = calc_fft_size_log2(calc)
        self.fft = 1 << self.fft_log2

    @property
    def fold_mode(self) -> bool:
        return self.mode in (EdgeMode.Fold, EdgeMode.FoldRepeat)


def convolved_size(size1: int, size2: int, mode: EdgeMode) -> int:
    """Output length of :func:`convolve` (reference calc_conv_corr_size,
    SpectralProcessor.hpp:546-557)."""
    if not size1 or not size2:
        return 0
    s = _OpSizes(size1, size2, mode)
    return s.linear if mode == EdgeMode.Linear else s.max


correlated_size = convolved_size


def required_fft_size(size1: int, size2: int) -> int:
    if not size1 or not size2:
        return 0
    return _OpSizes(size1, size2, EdgeMode.Linear).fft


# -----------------------------------------------------------------------------
# Folding edge preparation
# -----------------------------------------------------------------------------

@span("engine.spectral.fold_pad")
def _fold_pad(x: torch.Tensor, fold_size: int, repeat: bool) -> torch.Tensor:
    """Reflect ``fold_size`` samples of each edge around the signal
    (reference fold/copy_fold, SpectralProcessor.hpp:358-372). ``repeat``
    includes the edge sample itself in the reflection."""
    if fold_size == 0:
        return x
    off = 0 if repeat else 1
    n = x.shape[-1]
    left = torch.flip(x[..., off:fold_size + off], dims=(-1,))
    right = torch.flip(x[..., n - fold_size - off:n - off], dims=(-1,))
    return torch.cat([left, x, right], dim=-1)


# -----------------------------------------------------------------------------
# Arrange: scatter the circular result into the requested edge layout
# -----------------------------------------------------------------------------

@span("engine.spectral.arrange_convolve")
def _arrange_convolve(full: torch.Tensor, s: _OpSizes) -> torch.Tensor:
    """Reference arrange_convolve (SpectralProcessor.hpp:445-481)."""
    min_m1 = s.min - 1
    if s.mode == EdgeMode.Linear:
        return full[..., : s.linear]
    if s.mode == EdgeMode.Wrap:
        out = full[..., : s.max].clone()
        out[..., :min_m1] += full[..., s.max : s.linear]
        return out
    if s.mode == EdgeMode.WrapCentre:
        wrapped = min_m1 >> 1
        out = full[..., wrapped : wrapped + s.max].clone()
        out[..., : min_m1 - wrapped] += full[..., s.max + wrapped : s.linear]
        out[..., s.max - wrapped : s.max] += full[..., :wrapped]
        return out
    # Fold / FoldRepeat
    return full[..., min_m1 : min_m1 + s.max]


@span("engine.spectral.arrange_correlate")
def _arrange_correlate(full: torch.Tensor, s: _OpSizes) -> torch.Tensor:
    """Reference arrange_correlate (SpectralProcessor.hpp:483-538)."""
    s2m1 = s.size2 - 1
    fft = s.fft
    if s.mode == EdgeMode.Linear:
        head = full[..., : s.size1]
        tail = full[..., fft - s2m1 : fft] if s2m1 else head[..., :0]
        return torch.cat([head, tail], dim=-1)
    if s.mode == EdgeMode.Wrap:
        head = full[..., : s.size1]
        if s.size2 > s.size1:
            out = F.pad(head, (0, s.size2 - s.size1))
        else:
            out = head[..., : s.max].clone()
        if s2m1:
            out[..., s.max - s2m1 : s.max] += full[..., fft - s2m1 : fft]
        return out
    if s.mode == EdgeMode.WrapCentre:
        wrapped1 = (s.min - 1) >> 1
        wrapped2 = min(s2m1, s.max - wrapped1)
        wrapped3 = s2m1 - wrapped2
        offset = 0 if wrapped3 else s.max - (s2m1 + wrapped1)
        out = torch.zeros(full.shape[:-1] + (s.max,), dtype=full.dtype, device=full.device)
        out[..., : s.size1 - wrapped1] = full[..., wrapped1 : s.size1]
        if wrapped1:
            out[..., s.max - wrapped1 : s.max] = full[..., :wrapped1]
        if wrapped2:
            out[..., offset : offset + wrapped2] += full[..., fft - wrapped2 : fft]
        if wrapped3:
            out[..., s.max - wrapped3 : s.max] += full[..., fft - wrapped2 - wrapped3 : fft - wrapped2]
        return out
    # Fold / FoldRepeat
    if s.size1 >= s.size2:
        return full[..., : s.max]
    head = full[..., :1]
    tail = full[..., fft - (s.max - 1) : fft]
    return torch.cat([head, tail], dim=-1)


# -----------------------------------------------------------------------------
# Real binary ops
# -----------------------------------------------------------------------------

def _binary_op_real(x1: torch.Tensor, x2: torch.Tensor, mode: EdgeMode,
                    correlate_op: bool, backend: Optional[str]) -> torch.Tensor:
    n1 = x1.shape[-1]
    n2 = x2.shape[-1]
    if convolved_size(n1, n2, mode) == 0:
        return x1.new_zeros(x1.shape[:-1] + (0,))
    if n1 == 1 and n2 == 1:
        return x1 * x2

    s = _OpSizes(n1, n2, mode)
    if s.fold_mode:
        fold_size = s.min >> 1
        repeat = mode == EdgeMode.FoldRepeat
        if n1 >= n2:
            x1 = _fold_pad(x1, fold_size, repeat)
        else:
            x2 = _fold_pad(x2, fold_size, repeat)

    X1 = Split(*fft_api.rfft_padded(x1, s.fft, backend=backend))
    X2 = Split(*fft_api.rfft_padded(x2, s.fft, backend=backend))
    scale = 0.25 / s.fft
    if correlate_op:
        P = spectral.ir_correlate_real(X1, X2, scale, backend=backend)
    else:
        P = spectral.ir_convolve_real(X1, X2, scale, backend=backend)
    full = fft_api.rifft(P.re, P.im, backend=backend)
    arrange = _arrange_correlate if correlate_op else _arrange_convolve
    return arrange(full, s)


@span("entry.spectral_processor.convolve")
def convolve(x1: torch.Tensor, x2: torch.Tensor, mode: EdgeMode = EdgeMode.Linear,
             backend: Optional[str] = None) -> torch.Tensor:
    """FFT convolution of real signals with edge handling (reference
    spectral_processor::convolve, SpectralProcessor.hpp:169-172)."""
    return _binary_op_real(x1, x2, mode, correlate_op=False, backend=backend)


@span("entry.spectral_processor.correlate")
def correlate(x1: torch.Tensor, x2: torch.Tensor, mode: EdgeMode = EdgeMode.Linear,
              backend: Optional[str] = None) -> torch.Tensor:
    """FFT cross-correlation c[m] = sum_n x1[n+m] x2[n] of real signals, the
    reference convention X1 * conj(X2) (spectral_processor::correlate,
    SpectralProcessor.hpp:181-184; correlate functor :265-272)."""
    return _binary_op_real(x1, x2, mode, correlate_op=True, backend=backend)


# -----------------------------------------------------------------------------
# Complex binary ops
# -----------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    return F.pad(x, (0, n - cur))


def _binary_op_complex(z1: Split, z2: Split, mode: EdgeMode, correlate_op: bool,
                       backend: Optional[str]) -> Split:
    n1 = max(z1.re.shape[-1], z1.im.shape[-1])
    n2 = max(z2.re.shape[-1], z2.im.shape[-1])
    if convolved_size(n1, n2, mode) == 0:
        empty = z1.re.new_zeros(z1.re.shape[:-1] + (0,))
        return Split(empty, empty)
    if n1 == 1 and n2 == 1:
        return (cmul_conj if correlate_op else cmul)(z1, z2)

    s = _OpSizes(n1, n2, mode)
    r1, i1 = _pad_to(z1.re, n1), _pad_to(z1.im, n1)
    r2, i2 = _pad_to(z2.re, n2), _pad_to(z2.im, n2)
    if s.fold_mode:
        fold_size = s.min >> 1
        repeat = mode == EdgeMode.FoldRepeat
        if n1 >= n2:
            r1 = _fold_pad(r1, fold_size, repeat)
            i1 = _fold_pad(i1, fold_size, repeat)
        else:
            r2 = _fold_pad(r2, fold_size, repeat)
            i2 = _fold_pad(i2, fold_size, repeat)

    fr1, fi1 = fft_api.fft(_pad_to(r1, s.fft), _pad_to(i1, s.fft), backend=backend)
    fr2, fi2 = fft_api.fft(_pad_to(r2, s.fft), _pad_to(i2, s.fft), backend=backend)
    scale = 1.0 / s.fft
    if correlate_op:
        P = spectral.ir_correlate_complex(Split(fr1, fi1), Split(fr2, fi2), scale)
    else:
        P = spectral.ir_convolve_complex(Split(fr1, fi1), Split(fr2, fi2), scale)
    gr, gi = fft_api.ifft(P.re, P.im, backend=backend)
    # The unscaled inverse is N * IDFT; with the scale folded in above, the
    # circular result.
    arrange = _arrange_correlate if correlate_op else _arrange_convolve
    return Split(arrange(gr, s), arrange(gi, s))


def convolve_complex(z1: Split, z2: Split, mode: EdgeMode = EdgeMode.Linear,
                     backend: Optional[str] = None) -> Split:
    """Complex-signal convolution (reference SpectralProcessor.hpp:164-167)."""
    return _binary_op_complex(z1, z2, mode, correlate_op=False, backend=backend)


def correlate_complex(z1: Split, z2: Split, mode: EdgeMode = EdgeMode.Linear,
                      backend: Optional[str] = None) -> Split:
    """Complex-signal correlation (reference SpectralProcessor.hpp:176-179)."""
    return _binary_op_complex(z1, z2, mode, correlate_op=True, backend=backend)


# -----------------------------------------------------------------------------
# Phase manipulation
# -----------------------------------------------------------------------------

def change_phase(x: torch.Tensor, phase: float, time_multiplier: float = 1.0,
                 zero_center: bool = False, backend: Optional[str] = None
                 ) -> torch.Tensor:
    """Convert a signal to minimum/linear/maximum/mixed phase (reference
    spectral_processor::change_phase, SpectralProcessor.hpp:188-208): rfft
    (zero-padded to ``next_pow2(round(size * time_multiplier))``) -> ir_phase
    -> rifft scaled by ``0.5/N``. Returns the full FFT-size signal."""
    size = x.shape[-1]
    if size == 1:
        return x
    fft_log2 = calc_fft_size_log2(int(round(size * time_multiplier)))
    n = 1 << fft_log2
    X = Split(*fft_api.rfft_padded(x, n, backend=backend))
    Y = spectral.ir_phase(X, n, phase, zero_center, backend=backend)
    y = fft_api.rifft(Y.re, Y.im, backend=backend)
    return y * (0.5 / n)
