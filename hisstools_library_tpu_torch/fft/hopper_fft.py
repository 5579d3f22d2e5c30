"""Real FFT kernels for Hopper: the counterpart of ``fft/pallas_fft.py``.

Each TPU kernel of the FastFIR path has a hand-written CUDA kernel here
(sources in ``csrc/``, built by :mod:`.._build`) and a plain PyTorch version
beside it, in ``torch.fft``:

==============================  =====================================  ============================
function                        replaces (hisstools_library_tpu/...)   CUDA source
==============================  =====================================  ============================
:func:`rfft_packed`       (K1)  fft/pallas_fft.py: rfft_packed         csrc/rfft_packed.cu
:func:`rfft_packed_stream` (K2) fft/pallas_fft.py: rfft_packed_stream  csrc/rfft_packed_stream.cu
:func:`rifft_packed_tail` (K4)  fft/pallas_fft.py: rifft_packed_tail   csrc/rifft_packed_tail.cu
:func:`fastfir_chain`     (K5)  fft/pallas_fft.py: fastfir_chain       K2 -> K3 -> K4 in turn
==============================  =====================================  ============================

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises: ``NotImplementedError`` names the
kernel still to be ported when the call is outside the ported envelope
(float64, or N outside 4096..2^17), and no path falls back to ``torch.fft``.
Each wrapper counts its launches in ``<wrapper>.launches``.

``fastfir_chain`` keeps the TPU function's signature and result but runs K2,
K3 and K4 in turn: the TPU kernel keeps each channel's spectra ring and
impulse spectra on chip (~7.9 MB at the main path's N = 2^16, P = 15), far
beyond a Hopper block's 227 KB of shared memory. A fused Hopper kernel (for
example a bin-tiled MAC across thread-block clusters) is open work; it would
keep the hop spectra, ~2.1 GB of traffic per main-path pass, out of HBM.

Precision: :func:`set_mode` keeps the TPU package's knob (``"bf16x3"`` or
``"highest"``). On Hopper both modes run the same FP32 SIMT kernels, with
twiddles computed in float64 on the host and stored as float32.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .hopper_kernels import lag_mac_causal

MIN_REAL_SIZE = 4096
MAX_SINGLE_REAL = 1 << 17

_MODE = "highest"  # or "bf16x3"; both run the same FP32 kernels on Hopper


def set_mode(mode: str) -> None:
    """Set the precision mode ("highest" or "bf16x3"). Kept for callers of
    the TPU package; on Hopper both modes run the same FP32 kernels."""
    global _MODE
    if mode not in ("highest", "bf16x3"):
        raise ValueError(f"unknown fft mode {mode!r}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


def real_eligible(n: int) -> bool:
    """True when the real-FFT kernels serve size ``n`` (4096..2^17)."""
    return MIN_REAL_SIZE <= n <= MAX_SINGLE_REAL and (n & (n - 1)) == 0


def stream_feasible(n: int) -> bool:
    """True when the streaming forward (K2) and tail inverse (K4) serve real
    size ``n``. The four-step is multi-pass, so no on-chip memory model
    limits it below :data:`MAX_SINGLE_REAL`."""
    return real_eligible(n)


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 table tw[e] = exp(-2 pi i e / n), computed in float64."""
    ang = np.arange(n, dtype=np.float64) * (-2.0 * np.pi / n)
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _check(kernel: str, n: int, *tensors: torch.Tensor) -> None:
    """Raise unless the kernel takes these tensors at real size ``n``."""
    if not real_eligible(n):
        missing = ("K10/K11 (_small_fwd_call/_small_inv_call)" if n < MIN_REAL_SIZE
                   else "K13/K14 (_rfft_packed_split/_rifft_packed_split)")
        raise NotImplementedError(
            f"{kernel}: serves N = {MIN_REAL_SIZE}..{MAX_SINGLE_REAL}; N = {n} "
            f"needs {missing}, not yet ported")
    _build.check_tensors(kernel, *tensors)


# -----------------------------------------------------------------------------
# Plain versions (torch.fft): the CPU path and the kernels' reference
# -----------------------------------------------------------------------------

def rfft_packed_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed real FFT by ``torch.fft``: x2 scale, Nyquist in ``im[0]``."""
    z = torch.fft.rfft(x, dim=-1)
    re = 2.0 * z.real
    im = 2.0 * z.imag
    return (re[..., :-1].contiguous(),
            torch.cat([re[..., -1:], im[..., 1:-1]], dim=-1))


def rifft_packed_plain(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Unscaled packed inverse by ``torch.fft``: rifft(rfft(x)) == 2N x."""
    n = 2 * re.shape[-1]
    zero = torch.zeros_like(re[..., :1])
    full_re = torch.cat([re, im[..., :1]], dim=-1)
    full_im = torch.cat([zero, im[..., 1:], zero], dim=-1)
    return torch.fft.irfft(torch.complex(full_re, full_im), n=n, dim=-1) * n


def rfft_packed_stream_plain(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectrum t = rfft_packed([x2d[t-1] | x2d[t]]), x2d[-1] = 0."""
    prev = torch.cat([torch.zeros_like(x2d[..., :1, :]), x2d[..., :-1, :]], dim=-2)
    return rfft_packed_plain(torch.cat([prev, x2d], dim=-1))


def rifft_packed_tail_plain(re: torch.Tensor, im: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """scale * rifft(Y_t)[H:] per hop."""
    return rifft_packed_plain(re, im)[..., re.shape[-1]:] * scale


# -----------------------------------------------------------------------------
# Kernel wrappers
# -----------------------------------------------------------------------------

def rfft_packed(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: real FFT -> packed N/2 bins (x2 scale, Nyquist in im[0]), batched
    over the leading axes, natural bin order."""
    if x.device.type == "cpu":
        return rfft_packed_plain(x)
    n = x.shape[-1]
    _check("K1 rfft_packed", n, x)
    lead = x.shape[:-1]
    b = math.prod(lead)
    re = torch.empty(*lead, n // 2, dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    if b == 0:
        return re, im
    scratch = torch.empty(b, n, dtype=torch.float32, device=x.device)
    rc = _build.load().hst_rfft_packed(
        x.data_ptr(), re.data_ptr(), im.data_ptr(), scratch.data_ptr(),
        _twiddles(n, x.device).data_ptr(), b, n, _build.stream(x.device))
    _build.check(rc, "K1 rfft_packed")
    rfft_packed.launches += 1
    return re, im


rfft_packed.launches = 0


def rfft_packed_stream(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: overlap-save forward. ``x2d``: (..., T, H) hop blocks; returns
    packed planes (..., T, N/2), N = 2H, spectrum t = rfft([x2d[t-1] |
    x2d[t]]) with x2d[-1] = 0, read in place with no frames buffer."""
    if x2d.device.type == "cpu":
        return rfft_packed_stream_plain(x2d)
    t, hop = x2d.shape[-2], x2d.shape[-1]
    n = 2 * hop
    _check("K2 rfft_packed_stream", n, x2d)
    lead = x2d.shape[:-2]
    c = math.prod(lead)
    re = torch.empty(*lead, t, hop, dtype=torch.float32, device=x2d.device)
    im = torch.empty_like(re)
    if c * t == 0:
        return re, im
    scratch = torch.empty(c * t, n, dtype=torch.float32, device=x2d.device)
    rc = _build.load().hst_rfft_packed_stream(
        x2d.data_ptr(), re.data_ptr(), im.data_ptr(), scratch.data_ptr(),
        _twiddles(n, x2d.device).data_ptr(), c, t, n, _build.stream(x2d.device))
    _build.check(rc, "K2 rfft_packed_stream")
    rfft_packed_stream.launches += 1
    return re, im


rfft_packed_stream.launches = 0


def rifft_packed_tail(re: torch.Tensor, im: torch.Tensor,
                      scale: float = 1.0) -> torch.Tensor:
    """K4: overlap-save inverse. ``re``/``im``: (..., T, N/2) packed hop
    spectra; returns (..., T, H) = scale * rifft(Y_t)[H:], the kept half."""
    if re.device.type == "cpu":
        return rifft_packed_tail_plain(re, im, scale)
    hop = re.shape[-1]
    n = 2 * hop
    _check("K4 rifft_packed_tail", n, re, im)
    if im.shape != re.shape:
        raise ValueError(f"K4 rifft_packed_tail: re {tuple(re.shape)} and "
                         f"im {tuple(im.shape)} differ")
    frames = math.prod(re.shape[:-1])
    out = torch.empty(re.shape, dtype=torch.float32, device=re.device)
    if frames == 0:
        return out
    scratch = torch.empty(frames, n, dtype=torch.float32, device=re.device)
    rc = _build.load().hst_rifft_packed_tail(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        _twiddles(n, re.device).data_ptr(), frames, n, float(scale),
        _build.stream(re.device))
    _build.check(rc, "K4 rifft_packed_tail")
    rifft_packed_tail.launches += 1
    return out


rifft_packed_tail.launches = 0


def fastfir_chain(x2d: torch.Tensor, h_re: torch.Tensor, h_im: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The whole FastFIR chain. ``x2d``: (C, T, H) hop blocks; ``h_*``:
    (C, P, N/2) packed impulse spectra. Returns (C, T, H) =
    scale * rifft(sum_lag X_{t-1-lag} H_lag)[H:] per hop, as K2 -> K3 -> K4
    (see the module docstring for why not one kernel yet)."""
    x_re, x_im = rfft_packed_stream(x2d)
    y_re, y_im = lag_mac_causal(x_re, x_im, h_re, h_im)
    return rifft_packed_tail(y_re, y_im, scale)
