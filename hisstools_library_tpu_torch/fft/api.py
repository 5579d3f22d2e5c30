"""FFT public API with HISSTools/vDSP-compatible packing and scaling.

Counterpart of ``hisstools_library_tpu/fft/api.py`` for the real transforms:

- ``rfft(x)``       : real FFT of size N -> N/2 packed bins, scaled x2 against
                      the textbook DFT; DC in ``re[0]``, Nyquist in ``im[0]``.
- ``rifft(re, im)`` : unscaled inverse of the packed layout,
                      ``rifft(rfft(x)) == 2N x``.

Backends keep the TPU package's names so callers port unchanged:

- ``"pallas"``: the hand-written Hopper kernels (:mod:`.hopper_fft`) on a CUDA
  tensor, their plain PyTorch versions on a CPU tensor.
- ``"xla"``: ``torch.fft``, the counterpart of the TPU package's ``jnp.fft``
  path, which is not a Pallas kernel. ``"matmul"`` is an alias of ``"xla"``.

With no backend given, the tensor's device decides: ``"pallas"`` on CUDA (as
the TPU package defaults to its kernels on a TPU), ``"xla"`` on the CPU. The
other transforms of the TPU API (``fft``, ``ifft``, ``rfft_padded``, zip and
pack helpers) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def rfft(x: torch.Tensor, backend: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real FFT of size N -> packed N/2-bin split spectrum (x2 scale, Nyquist
    in im[0]), along the last axis."""
    n = x.shape[-1]
    _log2_size(n)
    if n == 1:
        raise ValueError("rfft requires N >= 2")
    if _resolve(backend, x.device) == "pallas":
        return hopper_fft.rfft_packed(x)
    return hopper_fft.rfft_packed_plain(x)


def rifft(re: torch.Tensor, im: torch.Tensor, backend: Optional[str] = None
          ) -> torch.Tensor:
    """Unscaled inverse of the packed real spectrum: ``rifft(rfft(x)) == 2N x``,
    along the last axis. ``"pallas"`` on a CUDA tensor launches K6 (N =
    4096..2^17) or K11 (N = 32..2048); above 2^17 it raises, naming K14."""
    n = re.shape[-1] * 2
    _log2_size(n)
    if _resolve(backend, re.device) == "pallas":
        return hopper_fft.rifft_packed(re, im)
    return hopper_fft.rifft_packed_plain(re, im)
