"""Uniform partitioned overlap-save FFT convolution: the offline engine.

Counterpart of ``hisstools_library_tpu/models/partitioned.py``
(``validate_fft_size``, ``impulse_spectra``, ``_lag_mac_dispatch`` and
``PartitionedConvolve.process_offline`` / ``_process_offline_fused``). The
streaming engine (``step``, ``process_block``, ...) is not ported yet.

A section with FFT size N (hop H = N/2) emits ``conv(x, ir)`` delayed by one
hop. Output = inverse of the accumulated spectra x ``1/(4N)``, the reference's
``scaleStore`` factor (PartitionedConvolve.cpp:232-241) for the x2 forward
scale on both operands. FFT sizes 2^5..2^20 as in the reference
(PartitionedConvolve.h:18-19).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import Split, packed_mul
from ..fft import api as fft_api
from ..fft import hopper_fft

MIN_FFT_SIZE_LOG2 = 5
MAX_FFT_SIZE_LOG2 = 20


def validate_fft_size(fft_size: int) -> int:
    if fft_size < 1:
        raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE, str(fft_size))
    log2n = fft_size.bit_length() - 1
    if (1 << log2n) != fft_size:
        raise ConvolveException(ConvolveError.FFT_SIZE_NON_POWER_OF_TWO, str(fft_size))
    if log2n < MIN_FFT_SIZE_LOG2 or log2n > MAX_FFT_SIZE_LOG2:
        raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE, str(fft_size))
    return log2n


def impulse_spectra(ir, fft_size: int, offset: int = 0, length: int = 0,
                    dtype: torch.dtype = torch.float32,
                    backend: Optional[str] = None, device=None) -> Split:
    """Chop ``ir[offset : offset + length]`` into H-sample chunks, zero-pad each
    to the FFT size and rFFT into the partition spectra (reference
    PartitionedConvolve::set, :173-225).

    ``ir``: (..., L) array. Returns a packed Split of shape (..., P, N/2) on
    ``device``. The chunks are framed in ``dtype`` on the device: zero
    padding and the cast commute, so this equals framing in float64 first."""
    validate_fft_size(fft_size)
    h = fft_size >> 1
    ir = np.asarray(ir)
    n = ir.shape[-1]
    take = 0 if n <= offset else n - offset
    if length:
        take = min(take, length)
    p = max(1, -(-take // h))  # at least one (zero) partition
    chunk = torch.as_tensor(ir[..., offset:offset + take]).to(device=device, dtype=dtype)
    frames = F.pad(chunk, (0, p * h - take)).reshape(ir.shape[:-1] + (p, h))
    frames = F.pad(frames, (0, h))  # zero-pad each chunk to N
    re, im = fft_api.rfft(frames.contiguous(), backend=backend)
    return Split(re, im)


def _lag_mac_dispatch(xp_re: torch.Tensor, xp_im: torch.Tensor,
                      h_re: torch.Tensor, h_im: torch.Tensor, t: int,
                      mac_backend: str):
    """Partition MAC over zero-padded spectra, one pass per lag.

    ``xp_*``: (..., T+P, K) zero-padded spectra; ``h_*``: (..., P, K).
    Returns packed-correct (..., T, K) accumulations. This is the TPU
    package's XLA loop form, in torch ops on any device; its Pallas form
    (K15, ``pallas_kernels.py: lag_mac``) is not ported, so
    ``mac_backend="pallas"`` raises on a CUDA tensor."""
    if mac_backend == "pallas" and xp_re.device.type != "cpu":
        raise NotImplementedError(
            "mac_backend='pallas': K15 lag_mac (fft/pallas_kernels.py:109) is "
            "not ported to the GPU yet; use mac_backend='xla'")
    p = h_re.shape[-2]
    acc_re = torch.zeros(xp_re.shape[:-2] + (t, xp_re.shape[-1]),
                         dtype=xp_re.dtype, device=xp_re.device)
    acc_im = torch.zeros_like(acc_re)
    for lag in range(p):
        start = p - 1 - lag
        prod = packed_mul(Split(xp_re[..., start:start + t, :],
                                xp_im[..., start:start + t, :]),
                          Split(h_re[..., lag:lag + 1, :], h_im[..., lag:lag + 1, :]))
        acc_re += prod.re
        acc_im += prod.im
    return acc_re, acc_im


class PartitionedConvolve:
    """Offline entry points of the uniform partitioned engine."""

    @staticmethod
    def process_offline(spectra: Split, x: torch.Tensor,
                        backend: Optional[str] = None,
                        mac_backend: str = "auto") -> torch.Tensor:
        """Whole-signal path with no sequential dependency: rFFT over all hops,
        P-lag MAC along the hop axis, inverse. Returns the same output as
        streaming from a fresh state (length = len(x), including the engine's
        one-hop delay).

        With the "pallas" backend (the default on CUDA) and eligible shapes
        the chain runs as K2 -> K3 -> K4 (:meth:`_process_offline_fused`).
        The staged form below needs K6 and K15 on the GPU, which are not
        ported: on a CUDA tensor it runs only with ``backend="xla"``."""
        resolved = fft_api._resolve(backend, x.device)
        if resolved == "pallas" and mac_backend in ("auto", "pallas"):
            out = PartitionedConvolve._process_offline_fused(spectra, x)
            if out is not None:
                return out
        if resolved == "pallas" and x.device.type != "cpu":
            raise NotImplementedError(
                "staged offline path on the GPU: K6 rifft_packed "
                "(fft/pallas_fft.py:518) and K15 lag_mac "
                "(fft/pallas_kernels.py:109) are not ported yet; the shapes "
                "are outside the fused chain (N = 4096..2^17, float32), or "
                "pass backend='xla'")
        h = spectra.shape[-1]
        n = 2 * h
        p = spectra.shape[-2]
        L = x.shape[-1]
        if L % h:
            x = F.pad(x, (0, h - L % h))
        t = x.shape[-1] // h
        blocks = x.reshape(*x.shape[:-1], t, h)
        prev = torch.cat([torch.zeros_like(blocks[..., :1, :]), blocks[..., :-1, :]],
                         dim=-2)
        frames = torch.cat([prev, blocks], dim=-1)  # (..., T, N)
        X = Split(*fft_api.rfft(frames, backend=resolved))

        # Y_t = sum_p X_{t-1-p} Hhat_p : lag-accumulate along the hop axis.
        lags = min(p, t)
        pad = (0, 0, lags, 0)
        acc_re, acc_im = _lag_mac_dispatch(
            F.pad(X.re, pad), F.pad(X.im, pad),
            spectra.re[..., :lags, :], spectra.im[..., :lags, :], t, mac_backend)

        y = fft_api.rifft(acc_re, acc_im, backend=resolved) * (1.0 / (4.0 * n))
        out = y[..., h:]  # (..., T, H)
        return out.reshape(*out.shape[:-2], t * h)[..., :L]

    @staticmethod
    def _process_offline_fused(spectra: Split, x: torch.Tensor,
                               shift: int = 0) -> Optional[torch.Tensor]:
        """The offline chain as kernels: streaming rFFT of the hop blocks read
        in place (K2), causal MAC over the valid lags (K3), tail inverse of
        the kept half-block with the 1/(4N) scale folded in (K4). ``shift``
        trailing zeros extend the signal and the first ``shift`` outputs are
        dropped (shift = hop is FastFIR's look-ahead). Returns None when the
        shapes are not eligible (the caller takes the staged path)."""
        h = spectra.shape[-1]
        n = 2 * h
        p = spectra.shape[-2]
        L = x.shape[-1]
        eff = L + shift
        t = -(-eff // h)
        lags = min(p, t - 1) if t > 1 else 0
        if (not hopper_fft.stream_feasible(n) or x.dtype != torch.float32
                or lags < 1):
            return None
        lead = x.shape[:-1]
        c = math.prod(lead)
        x2d = F.pad(x, (0, t * h - L)).reshape(c, t, h)
        hr = spectra.re[..., :lags, :].expand(lead + (lags, h))
        hi = spectra.im[..., :lags, :].expand(lead + (lags, h))
        y = hopper_fft.fastfir_chain(
            x2d, hr.reshape(c, lags, h).to(torch.float32).contiguous(),
            hi.reshape(c, lags, h).to(torch.float32).contiguous(),
            scale=1.0 / (4.0 * n))
        return y.reshape(*lead, t * h)[..., shift:shift + L]
