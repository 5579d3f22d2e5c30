"""The plain reference: linear convolution and regularised deconvolution.

Plain PyTorch FFTs, computed in float64 (or, for the lower-precision
control, from bfloat16 operands in float32 with a bfloat16 result), in
blocks of channels so that the largest cell fits beside its inputs. It
imports nothing of the program under test and takes only the inputs the
harness made.
"""

from __future__ import annotations

import torch

# Channels a block: a float64 spectrum of 16 channels at N = 2^22 is 0.5 GB.
ROWS = 16

PRECISIONS = ("float64", "bfloat16")


def _operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return t.double()
    if precision == "bfloat16":  # operands stored in bfloat16, arithmetic in float32
        return t.bfloat16().float()
    raise ValueError(f"unknown precision {precision!r}")


def _result(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t if precision == "float64" else t.bfloat16().double()


def fft_size(n: int) -> int:
    """The smallest power of two >= n."""
    return 1 << max(n - 1, 0).bit_length()


def convolve(x: torch.Tensor, h: torch.Tensor, start: int, length: int,
             precision: str = "float64") -> torch.Tensor:
    """``(x * h)[..., start:start + length]``: the linear convolution of each
    row of ``x`` (C, Lx) with the same row of ``h`` (C, Lh), through one FFT
    of at least Lx + Lh - 1 points. Returns float64 (C, length)."""
    if start < 0 or start + length > x.shape[-1] + h.shape[-1] - 1:
        raise ValueError("the requested samples lie outside the linear convolution")
    n = fft_size(x.shape[-1] + h.shape[-1] - 1)
    out = torch.empty(x.shape[:-1] + (length,), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xs = _operand(x[i:i + ROWS], precision)
        hs = _operand(h[i:i + ROWS], precision)
        spec = torch.fft.rfft(xs, n) * torch.fft.rfft(hs, n)
        out[i:i + ROWS] = _result(torch.fft.irfft(spec, n)[..., start:start + length],
                                  precision)
    return out


def deconvolve(measured: torch.Tensor, excitation: torch.Tensor, regularization: float,
               precision: str = "float64") -> torch.Tensor:
    """The impulse responses of ``measured`` (C, Lm) to ``excitation`` (Le,):
    ``irfft(Y conj(X) / (|X|^2 + reg max|X|^2), N)`` with N the smallest power
    of two >= max(Lm, Le), as HIRT's sweep deconvolution. Returns float64
    (C, N)."""
    n = fft_size(max(measured.shape[-1], excitation.shape[-1]))
    spec_x = torch.fft.rfft(_operand(excitation, precision), n)
    power = spec_x.real.square() + spec_x.imag.square()
    gain = spec_x.conj() / (power + regularization * power.max())
    del spec_x, power
    out = torch.empty(measured.shape[:-1] + (n,), dtype=torch.float64,
                      device=measured.device)
    for i in range(0, measured.shape[0], ROWS):
        spec = torch.fft.rfft(_operand(measured[i:i + ROWS], precision), n) * gain
        out[i:i + ROWS] = _result(torch.fft.irfft(spec, n), precision)
    return out


def relative_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's ||got - want|| / ||want|| in float64 (C,)."""
    got = got.double()
    err = torch.linalg.vector_norm(got - want, dim=-1)
    return err / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-300)
