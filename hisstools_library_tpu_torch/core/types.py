"""Split-complex types and packed-spectrum products, on torch tensors.

Counterpart of ``hisstools_library_tpu/core/types.py``. Spectra are two real
planes, never complex tensors, in the HISSTools/vDSP packed convention: a real
FFT of size N yields N/2 bins, DC in ``re[..., 0]``, Nyquist in
``im[..., 0]``, forward scaled x2 against the textbook DFT.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def default_device() -> torch.device:
    """The device the port's entry points build on when none is named: the
    CUDA card. A caller who wants the CPU names it (``device="cpu"``); without
    a card a call that names no device fails in torch's own CUDA error."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def tensor_from(a, device=None) -> torch.Tensor:
    """A new tensor holding a copy of the array ``a`` (numpy, a JAX array or
    anything ``np.asarray`` takes), dtype kept, on ``device`` (the card
    unless named)."""
    return torch.tensor(np.asarray(a), device=resolve_device(device))


def array_from(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of the tensor ``t``."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class Split:
    """Split-complex pair of tensors of one shape, dtype and device. The last
    axis is the bin axis by convention."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.re.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.re.dtype

    def to(self, device) -> "Split":
        return Split(self.re.to(device), self.im.to(device))

    @staticmethod
    def zeros(shape, dtype: torch.dtype = torch.float32, device=None) -> "Split":
        device = resolve_device(device)
        return Split(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))

    @staticmethod
    def from_numpy(src, device=None) -> "Split":
        """A Split from any pair with ``re``/``im`` arrays (numpy, or a JAX
        package Split), copied onto ``device``."""
        return Split(tensor_from(src.re, device), tensor_from(src.im, device))

    def numpy(self) -> "Split":
        """The same pair as host numpy arrays."""
        return Split(array_from(self.re), array_from(self.im))

    def astype(self, dtype: torch.dtype) -> "Split":
        return Split(self.re.to(dtype), self.im.to(dtype))

    def __add__(self, other: "Split") -> "Split":
        return Split(self.re + other.re, self.im + other.im)

    def __mul__(self, scale) -> "Split":
        return Split(self.re * scale, self.im * scale)

    def conj(self) -> "Split":
        return Split(self.re, -self.im)


def cmul(a: Split, b: Split) -> Split:
    """Complex multiply in split layout (reference SpectralFunctions.hpp:274-281)."""
    return Split(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: Split, b: Split) -> Split:
    """a * conj(b), the correlation product (reference
    SpectralFunctions.hpp:265-272)."""
    return Split(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def _packed(prod: Split, a: Split, b: Split, scale) -> Split:
    # Bin 0 holds two real values (DC, Nyquist) that multiply independently.
    re = torch.cat([a.re[..., :1] * b.re[..., :1], prod.re[..., 1:]], dim=-1)
    im = torch.cat([a.im[..., :1] * b.im[..., :1], prod.im[..., 1:]], dim=-1)
    if scale != 1.0:
        re, im = re * scale, im * scale
    return Split(re, im)


def packed_mul(a: Split, b: Split, scale=1.0) -> Split:
    """Multiply two packed real spectra (reference ``ir_convolve_real``,
    SpectralFunctions.hpp:63-84, and PartitionedConvolve.cpp:387-426)."""
    return _packed(cmul(a, b), a, b, scale)


def packed_mul_conj(a: Split, b: Split, scale=1.0) -> Split:
    """Correlation a * conj(b) of packed real spectra (reference
    ``ir_correlate_real``, SpectralFunctions.hpp:433-436)."""
    return _packed(cmul_conj(a, b), a, b, scale)
