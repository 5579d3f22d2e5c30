"""FFT public API with HISSTools/vDSP-compatible packing and scaling.

Counterpart of ``hisstools_library_tpu/fft/api.py``:

- ``fft(re, im)``   : unscaled complex DFT of split planes.
- ``ifft(re, im)``  : unscaled inverse (N x the textbook IDFT), an FFT with the
                      planes swapped.
- ``rfft(x)``       : real FFT of size N -> N/2 packed bins, scaled x2 against
                      the textbook DFT; DC in ``re[0]``, Nyquist in ``im[0]``.
- ``rfft_padded``   : zero-pad (or cut) to the FFT size, then ``rfft``.
- ``rifft(re, im)`` : unscaled inverse of the packed layout,
                      ``rifft(rfft(x)) == 2N x``.
- ``unzip`` / ``zip_split`` / ``unzip_zero`` : interleaved <-> split planes.
- ``pack_spectrum`` / ``unpack_spectrum`` : textbook N/2 + 1 bins <-> packed.

Backends keep the TPU package's names so callers port unchanged:

- ``"pallas"``: the hand-written Hopper kernels (:mod:`.hopper_fft`) on a CUDA
  tensor, their plain PyTorch versions on a CPU tensor.
- ``"xla"``: ``torch.fft``, the counterpart of the TPU package's ``jnp.fft``
  path, which is not a Pallas kernel. ``"matmul"`` is an alias of ``"xla"``.

With no backend given, the tensor's device decides: ``"pallas"`` on CUDA (as
the TPU package defaults to its kernels on a TPU), ``"xla"`` on the CPU.
With ``"pallas"`` on a CUDA tensor ``fft`` / ``ifft`` launch K12 (N =
1..2^28; its tiny form below 32) and ``rfft`` / ``rifft`` K10/K11 (N =
2..2048; their tiny forms below 32), K1/K6 (4096..2^17) or K13/K14
(2^18..2^28), every power of two up to :data:`MAX_FFT_SIZE_LOG2`; for
float64 they raise ``NotImplementedError``, and nothing on the card calls
``torch.fft``. The TPU package's large-size routing (``_route_large``, the
out-of-core and sharded transforms) and its float64 ``TypeError`` do not carry
over: float64 runs the plain versions on the CPU. The kernels take contiguous
planes; a strided view (a slice of a packed spectrum, a truncated signal) is
copied once here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.types import Split
from ..utils.profiling import span
from . import hopper_fft

# Max size parity with the reference: setups up to 2^28 (HISSTools_FFT.h:87-98).
MAX_FFT_SIZE_LOG2 = 28

_DEFAULT_BACKEND: Optional[str] = None  # None = by the tensor's device


def set_default_backend(name: Optional[str]) -> None:
    """Set the process-wide default FFT backend ("xla", "matmul", "pallas"),
    or None to restore the choice by device."""
    global _DEFAULT_BACKEND
    if name is not None and name not in ("xla", "matmul", "pallas"):
        raise ValueError(f"unknown FFT backend {name!r}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> Optional[str]:
    return _DEFAULT_BACKEND


def _resolve(backend: Optional[str], device: torch.device) -> str:
    """The backend to run on ``device``: "pallas" or "xla"."""
    name = backend if backend is not None else _DEFAULT_BACKEND
    if name is None:
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if name not in ("xla", "matmul", "pallas"):
        raise ValueError(f"unknown FFT backend {name!r}")
    return "xla" if name == "matmul" else name


def _log2_size(n: int) -> int:
    if n <= 0:
        raise ValueError(f"FFT size must be a positive power of two, got {n}")
    log2n = n.bit_length() - 1
    if (1 << log2n) != n:
        raise ValueError(f"FFT size must be a power of two, got {n}")
    if log2n > MAX_FFT_SIZE_LOG2:
        raise ValueError(f"FFT size 2^{log2n} exceeds max 2^{MAX_FFT_SIZE_LOG2}")
    return log2n


def fft(re: torch.Tensor, im: torch.Tensor, backend: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled complex DFT along the last axis (reference hisstools_fft)."""
    _log2_size(re.shape[-1])
    if _resolve(backend, re.device) == "pallas":
        return hopper_fft.fft_split(re.contiguous(), im.contiguous())
    return hopper_fft.fft_split_plain(re, im)


def ifft(re: torch.Tensor, im: torch.Tensor, backend: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled inverse complex DFT (= N x IDFT). Reference hisstools_ifft, an
    FFT with the real and imaginary planes swapped."""
    fr, fi = fft(im, re, backend=backend)
    return fi, fr


@span("fft.rfft")
def rfft(x: torch.Tensor, backend: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real FFT of size N -> packed N/2-bin split spectrum (x2 scale, Nyquist
    in im[0]), along the last axis."""
    n = x.shape[-1]
    _log2_size(n)
    if n == 1:
        raise ValueError("rfft requires N >= 2")
    if _resolve(backend, x.device) == "pallas":
        return hopper_fft.rfft_packed(x.contiguous())
    return hopper_fft.rfft_packed_plain(x)


@span("fft.rifft")
def rifft(re: torch.Tensor, im: torch.Tensor, backend: Optional[str] = None
          ) -> torch.Tensor:
    """Unscaled inverse of the packed real spectrum: ``rifft(rfft(x)) == 2N x``,
    along the last axis. ``"pallas"`` on a CUDA tensor launches K6 (N =
    4096..2^17), K11 (N = 2..2048) or K14 (2^18..2^28)."""
    n = re.shape[-1] * 2
    _log2_size(n)
    if _resolve(backend, re.device) == "pallas":
        return hopper_fft.rifft_packed(re.contiguous(), im.contiguous())
    return hopper_fft.rifft_packed_plain(re, im)


@span("fft.rfft_padded")
def rfft_padded(x: torch.Tensor, fft_size: int, backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the signal to ``fft_size`` (or cut it there), then
    :func:`rfft` (reference out-of-place hisstools_rfft,
    HISSTools_FFT.h:180-208)."""
    n = x.shape[-1]
    if n > fft_size:
        x = x[..., :fft_size]
    elif n < fft_size:
        x = torch.nn.functional.pad(x, (0, fft_size - n))
    return rfft(x, backend=backend)


# -----------------------------------------------------------------------------
# zip / unzip (interleaved <-> split conversions)
# -----------------------------------------------------------------------------

def unzip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Even samples -> re, odd samples -> im (reference hisstools_unzip,
    HISSTools_FFT.h:333-345). Input length must be even."""
    return x[..., 0::2], x[..., 1::2]


def zip_split(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Interleave split planes back to a single tensor (reference
    hisstools_zip, HISSTools_FFT.h:357-369)."""
    return torch.stack([re, im], dim=-1).reshape(*re.shape[:-1], re.shape[-1] * 2)


def unzip_zero(x: torch.Tensor, fft_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unzip ``min(len, fft_size)`` samples into an fft_size/2 split buffer,
    zero padding the remainder (reference hisstools_unzip_zero,
    HISSTools_FFT.h:295-321); an odd length zeroes the dangling imaginary
    slot."""
    take = min(x.shape[-1], fft_size)
    x = x[..., :take]
    if take < fft_size:
        x = torch.nn.functional.pad(x, (0, fft_size - take))
    return unzip(x)


# -----------------------------------------------------------------------------
# Packed <-> standard complex-bin conversion
# -----------------------------------------------------------------------------

@span("fft.pack_spectrum")
def pack_spectrum(re_full: torch.Tensor, im_full: torch.Tensor) -> Split:
    """(N/2+1)-bin textbook spectrum -> packed N/2-bin Split with the x2
    scale."""
    re = 2.0 * re_full
    im = 2.0 * im_full
    im = torch.cat([re[..., -1:], im[..., 1:-1]], dim=-1)
    return Split(re[..., :-1], im)


@span("fft.unpack_spectrum")
def unpack_spectrum(s: Split) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed N/2-bin Split -> (N/2+1)-bin textbook spectrum (the x2 scale
    undone)."""
    dc = s.re[..., :1]
    nyq = s.im[..., :1]
    re = torch.cat([dc, s.re[..., 1:], nyq], dim=-1) * 0.5
    zeros = torch.zeros_like(dc)
    im = torch.cat([zeros, s.im[..., 1:], zeros], dim=-1) * 0.5
    return re, im
