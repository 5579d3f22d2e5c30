"""The IR measurement pipeline's deconvolution, on torch tensors.

Counterpart of ``hisstools_library_tpu/models/pipeline.py``, of which only
:func:`ir_deconvolve` is ported so far: the rest (peak finding, the frame
chain, :class:`IRPipeline`) needs ``ops/smoothing``, ``ops/stft``,
``ops/windows`` and the partial tracker, still to be ported.

:func:`ir_deconvolve` is the regularised spectral division
``H = Y * conj(X) / (|X|^2 + eps)`` on unpacked spectra (the HIRT
deconvolution core built from the reference's per-bin machinery). On a CUDA
tensor its transforms launch the Hopper kernels by size (K13/K14 for a 12 s
capture at 48 kHz, N = 2^20).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import Split, cmul_conj
from ..fft import api as fft_api
from ..ops import spectral_processor as sp


def ir_deconvolve(measured: torch.Tensor, excitation: torch.Tensor,
                  regularization: float = 1e-4,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Deconvolve the excitation from a measured response.

    Both inputs are time signals (..., L); the result is the impulse response
    at the common FFT size (next pow2 of the longer input), computed as
    ``irfft( Y conj(X) / (|X|^2 + reg * max|X|^2) )``.
    """
    n1 = measured.shape[-1]
    n2 = excitation.shape[-1]
    n = 1 << sp.calc_fft_size_log2(max(n1, n2))

    Y = Split(*fft_api.rfft_padded(measured, n, backend=backend))
    X = Split(*fft_api.rfft_padded(excitation, n, backend=backend))

    # Unpacked full spectra keep the DC/Nyquist handling plain.
    yr, yi = fft_api.unpack_spectrum(Y)
    xr, xi = fft_api.unpack_spectrum(X)
    power = xr * xr + xi * xi
    floor = regularization * power.amax(dim=-1, keepdim=True)
    denom = power + floor
    num = cmul_conj(Split(yr, yi), Split(xr, xi))
    H = fft_api.pack_spectrum(num.re / denom, num.im / denom)
    return fft_api.rifft(H.re, H.im, backend=backend) * (0.5 / n)
