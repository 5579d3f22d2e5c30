"""Spectral IR functions: the per-bin HIRT toolbox math, on torch tensors.

Counterpart of ``hisstools_library_tpu/ops/spectral.py`` (the ``ir_*``
free-function family, reference SpectralFunctions.hpp:364-436). Every
function takes and returns *packed* split spectra (:class:`Split`, N/2 bins,
DC in ``re[0]``, Nyquist in ``im[0]``); the reference's ``real_operation``
DC/Nyquist special-casing (SpectralFunctions.hpp:63-129) is lane-0 handling
on the packed planes, as in the JAX package. Tables built with numpy go to the
input's device; the transforms in :func:`minimum_phase_components` follow
:mod:`..fft.api` (the Hopper kernels on a CUDA tensor), and so do the real
binary ops :func:`ir_convolve_real`, :func:`ir_correlate_real` and
:func:`ir_deconvolve_real`, which take the backend's route to K16 (one pass
over the packed bins, ``csrc/bin_product.cu``) or to their plain versions.

``fft_size`` below always refers to the *full* transform size N (= 2 x bins),
as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.types import Split, cmul, cmul_conj, resolve_device
from ..fft import api as fft_api
from ..fft import hopper_kernels
from ..utils.profiling import span

# Reference floors log-power at -300 dB (SpectralFunctions.hpp:176-184).
_MIN_POWER = 10.0 ** (-300.0 / 10.0)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy table as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


# -----------------------------------------------------------------------------
# Simple per-bin ops
# -----------------------------------------------------------------------------

def ir_copy(s: Split) -> Split:
    """Identity (reference ir_copy, SpectralFunctions.hpp:364-368)."""
    return Split(s.re, s.im)


def ir_time_reverse(s: Split) -> Split:
    """Complex conjugate = time reversal (SpectralFunctions.hpp:386-389).
    DC/Nyquist are real and pass unchanged: lane 0 of the imaginary plane
    (the packed Nyquist) is not negated."""
    im = torch.cat([s.im[..., :1], -s.im[..., 1:]], dim=-1)
    return Split(s.re, im)


def ir_spike(nbins: int, fft_size: int, spike_position: float,
             dtype: torch.dtype = torch.float32, device=None) -> Split:
    """Pure-delay spectrum: bin k = e^{-2 pi i k position / N} (reference
    impl::spike, SpectralFunctions.hpp:231-247). The Nyquist lane stores
    cos(theta * N/2); imaginary parts of DC/Nyquist are dropped. On the card
    unless ``device`` names another."""
    theta = -2.0 * math.pi * spike_position / float(fft_size)
    k = np.arange(nbins, dtype=np.float64)
    re = np.cos(theta * k)
    im = np.sin(theta * k)
    im[0] = math.cos(theta * (fft_size >> 1))
    re[0] = 1.0
    device = resolve_device(device)
    return Split(torch.as_tensor(re, dtype=dtype, device=device),
                 torch.as_tensor(im, dtype=dtype, device=device))


def ir_delay(s: Split, fft_size: int, delay: float) -> Split:
    """Per-bin phase rotation by ``delay`` samples (impl::delay_calc,
    SpectralFunctions.hpp:249-263). ``delay == 0`` is a copy."""
    if delay == 0.0:
        return ir_copy(s)
    theta = -2.0 * math.pi * delay / float(fft_size)
    k = np.arange(s.shape[-1], dtype=np.float64)
    rot = Split(_table(np.cos(theta * k), s.re), _table(np.sin(theta * k), s.re))
    out = cmul(s, rot)
    # DC: rotation is identity; Nyquist: times cos(theta * N/2), imag dropped.
    nyq_rot = math.cos(theta * (fft_size >> 1))
    re = torch.cat([s.re[..., :1], out.re[..., 1:]], dim=-1)
    im = torch.cat([s.im[..., :1] * nyq_rot, out.im[..., 1:]], dim=-1)
    return Split(re, im)


def _amplitude(s: Split, alternate_sign: bool) -> Split:
    """|X| per bin with optional (-1)^k (impl::amplitude[_linear],
    SpectralFunctions.hpp:149-165). DC/Nyquist amplitudes are |re[0]| /
    |im[0]|; the alternating variant's Nyquist sign is (-1)^(N/2), the
    reference indexing its functor at i = N/2."""
    nbins = s.shape[-1]
    mag = torch.sqrt(s.re * s.re + s.im * s.im)
    dc = s.re[..., :1].abs()
    nyq = s.im[..., :1].abs()
    if alternate_sign:
        k = np.arange(nbins)
        mag = mag * _table(np.where(k & 1, -1.0, 1.0), s.re)
        if nbins & 1:
            nyq = -nyq
    re = torch.cat([dc, mag[..., 1:]], dim=-1)
    im = torch.cat([nyq, torch.zeros_like(mag[..., 1:])], dim=-1)
    return Split(re, im)


def log_power(s: Split) -> Split:
    """0.5 * log(max(|X|^2, 1e-30)) into the real plane (impl::log_power,
    SpectralFunctions.hpp:176-184); DC/Nyquist use their real packed
    values."""
    p = s.re * s.re + s.im * s.im
    dc = s.re[..., :1] ** 2
    nyq = s.im[..., :1] ** 2
    body = 0.5 * torch.log(torch.clamp_min(p[..., 1:], _MIN_POWER))
    dc_l = 0.5 * torch.log(torch.clamp_min(dc, _MIN_POWER))
    nyq_l = 0.5 * torch.log(torch.clamp_min(nyq, _MIN_POWER))
    re = torch.cat([dc_l, body], dim=-1)
    im = torch.cat([nyq_l, torch.zeros_like(body)], dim=-1)
    return Split(re, im)


# -----------------------------------------------------------------------------
# Minimum phase machinery
# -----------------------------------------------------------------------------

def minimum_phase_components(s: Split, fft_size: int,
                             backend: Optional[str] = None) -> Split:
    """Cepstral-domain components C with exp(C) = minimum-phase spectrum
    (reference impl::minimum_phase_components, SpectralFunctions.hpp:283-336):
    log power spectrum -> inverse real FFT (cepstrum) -> causal fold
    (doubling implicit in the forward rfft's x2 scale; samples 0 and N/2
    halved, upper half zeroed, all scaled 1/N) -> forward real FFT."""
    n = fft_size
    lp = log_power(s)
    cep = fft_api.rifft(lp.re, lp.im, backend=backend)  # length n
    scale = 1.0 / n
    w = np.zeros(n, np.float64)
    w[0] = 0.5 * scale
    w[1:n // 2] = scale
    w[n // 2] = 0.5 * scale
    cep = cep * _table(w, cep)
    re, im = fft_api.rfft(cep, backend=backend)
    return Split(re, im)


def _complex_exponential(c: Split, conjugate: bool) -> Split:
    """exp(re + i im) per bin (impl::complex_exponential[_conjugate],
    SpectralFunctions.hpp:186-204); DC/Nyquist = exp(real packed value)."""
    amp = torch.exp(c.re)
    sgn = -1.0 if conjugate else 1.0
    re = amp * torch.cos(c.im)
    im = sgn * amp * torch.sin(c.im)
    dc = torch.exp(c.re[..., :1])
    nyq = torch.exp(c.im[..., :1])
    return Split(torch.cat([dc, re[..., 1:]], dim=-1),
                 torch.cat([nyq, im[..., 1:]], dim=-1))


def _phase_interpolate(c: Split, fft_size: int, phase: float,
                       zero_center: bool) -> Split:
    """Morph between minimum (phase=0), linear (0.5) and maximum (1.0) phase
    (impl::phase_interpolate, SpectralFunctions.hpp:206-229). Anything over
    linear induces a -1 sample delay to avoid wraparound."""
    delay_factor = 0.0 if phase <= 0.5 else 1.0 / float(fft_size)
    phase = min(1.0, max(0.0, phase))
    min_factor = 1.0 - 2.0 * phase
    lin_factor = 0.0 if zero_center else -2.0 * math.pi * (phase - delay_factor)

    k = _table(np.arange(c.shape[-1], dtype=np.float64), c.re)
    amp = torch.exp(c.re)
    ph = lin_factor * k + min_factor * c.im
    re = amp * torch.cos(ph)
    im = amp * torch.sin(ph)
    dc = torch.exp(c.re[..., :1])  # cos(0) = 1
    nyq = torch.exp(c.im[..., :1]) * math.cos(lin_factor * (fft_size >> 1))
    return Split(torch.cat([dc, re[..., 1:]], dim=-1),
                 torch.cat([nyq, im[..., 1:]], dim=-1))


def ir_phase(s: Split, fft_size: int, phase: float, zero_center: bool = False,
             backend: Optional[str] = None) -> Split:
    """Phase manipulation of a packed spectrum (reference ir_phase,
    SpectralFunctions.hpp:391-412): phase 0.5 -> amplitude (linear phase
    unless ``zero_center``); otherwise the minimum-phase cepstral transform
    followed by complex exponential / conjugate / interpolation."""
    if phase == 0.5:
        return _amplitude(s, alternate_sign=not zero_center)
    c = minimum_phase_components(s, fft_size, backend=backend)
    if phase == 1.0 and zero_center:
        return _complex_exponential(c, conjugate=True)
    if phase == 0.0:
        return _complex_exponential(c, conjugate=False)
    return _phase_interpolate(c, fft_size, phase, zero_center)


# -----------------------------------------------------------------------------
# Binary ops (convolution / correlation in the frequency domain)
# -----------------------------------------------------------------------------

def _per_bin(kernel, plain, a: Split, b: Split, backend: Optional[str], *args) -> Split:
    """One per-bin product of packed spectra: K16 (``kernel``, on its
    operands' layout, :func:`..fft.hopper_kernels.bin_operands`) where the
    FFT backend resolves to the kernels, as :mod:`..fft.api` routes a
    transform, else ``plain``."""
    if fft_api._resolve(backend, a.re.device) != "pallas":
        return Split(*plain(a.re, a.im, b.re, b.im, *args))
    return Split(*kernel(*hopper_kernels.bin_operands(a.re, a.im, b.re, b.im), *args))


def ir_convolve_complex(a: Split, b: Split, scale=1.0) -> Split:
    """Per-bin complex multiply with scale (SpectralFunctions.hpp:414-418)."""
    out = cmul(a, b)
    return out * scale if scale != 1.0 else out


@span("engine.spectral.ir_convolve_real")
def ir_convolve_real(a: Split, b: Split, scale=1.0, backend: Optional[str] = None) -> Split:
    """Packed real-spectrum multiply, DC/Nyquist independent
    (SpectralFunctions.hpp:420-424); on the card K16 ``bin_mul``."""
    return _per_bin(hopper_kernels.bin_mul, hopper_kernels.bin_mul_plain, a, b, backend,
                    scale)


def ir_correlate_complex(a: Split, b: Split, scale=1.0) -> Split:
    """a * conj(b) per bin (SpectralFunctions.hpp:426-430)."""
    out = cmul_conj(a, b)
    return out * scale if scale != 1.0 else out


@span("engine.spectral.ir_correlate_real")
def ir_correlate_real(a: Split, b: Split, scale=1.0, backend: Optional[str] = None) -> Split:
    """Packed real-spectrum correlation (SpectralFunctions.hpp:432-436); on
    the card K16 ``bin_mul_conj``."""
    return _per_bin(hopper_kernels.bin_mul_conj, hopper_kernels.bin_mul_conj_plain, a, b,
                    backend, scale)


def ir_deconvolve_real(y: Split, x: Split, regularization: float, scale=1.0,
                       backend: Optional[str] = None) -> Split:
    """Regularised packed real-spectrum division ``Y conj(X) / (|X|^2 +
    regularization * max|X|^2)`` of the true spectra the packed planes stand
    for (the floor per row of ``x``, over every bin, DC and Nyquist
    included), as a packed spectrum times ``scale``; DC and Nyquist divide
    apart. The division of ``models/pipeline.ir_deconvolve``; on the card
    K16 ``bin_floor`` then ``bin_deconvolve``."""
    return _per_bin(hopper_kernels.bin_deconvolve, hopper_kernels.bin_deconvolve_plain, y, x,
                    backend, regularization, scale)
