"""Offline (non-real-time) FIR convolution at maximum throughput.

Counterpart of ``hisstools_library_tpu/models/offline.py``: uniform
partitioned overlap-save with look-ahead, one section at a large FFT size with
IR offset 0, whose one-hop delay is removed by shifting the output left.

Use :class:`FastFIR` when the same IR convolves many signals (spectra prepared
once), or :func:`fast_fir` for one-shot use. On a CUDA device the default
backend runs the chain on the Hopper kernels (K1 for the IR spectra, then
one K5 call per pass at N = 2^14..2^17, K2 -> K3 -> K4 at 4096..8192).
With ``HISSTOOLS_DEBUG_STAGES=1`` a :class:`FastFIR` call first prints a
per-stage SNR report (:func:`utils.debug_stages.maybe_report`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import Split, resolve_device
from . import partitioned as part


def choose_fft_size(ir_len: int) -> int:
    """The uniform FFT size for an IR of ``ir_len`` taps: ~IR/8, at least
    2^11, at most 2^17 (the TPU package's rule, kept so both pick the same
    partitioning; 2^16 for a 10 s IR at 48 kHz)."""
    target = max(ir_len // 8, 2048)
    n = 1 << max(int(np.ceil(np.log2(target))), 11)
    return int(min(max(n, 1 << part.MIN_FFT_SIZE_LOG2), 1 << 17))


class FastFIR:
    """Uniform partitioned offline convolver with prepared spectra."""

    def __init__(self, ir, fft_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 backend: Optional[str] = None, device=None):
        from ..utils import debug_stages
        ir = np.asarray(ir)
        self.ir_len = ir.shape[-1]
        self.fft_size = fft_size or choose_fft_size(self.ir_len)
        self.hop = self.fft_size >> 1
        self.spectra = part.impulse_spectra(ir, self.fft_size, 0, 0, dtype,
                                            backend, device=device)
        self.backend = backend
        # Host IR copy kept only when per-stage debugging is on (the report
        # needs the raw taps for its float64 oracles).
        self._ir_debug = ir if debug_stages.enabled() else None

    @classmethod
    def from_spectra(cls, re, im, device=None,
                     backend: Optional[str] = None) -> "FastFIR":
        """An engine over packed spectra (..., P, N/2) prepared elsewhere,
        for example a TPU-package FastFIR's ``spectra`` as numpy arrays,
        copied onto ``device`` (the card unless named). ``ir_len`` is then
        the partitioned length P * N/2."""
        eng = cls.__new__(cls)
        spectra = Split(torch.from_numpy(np.array(re)), torch.from_numpy(np.array(im)))
        eng.spectra = spectra.to(resolve_device(device))
        eng.hop = spectra.shape[-1]
        eng.fft_size = 2 * eng.hop
        eng.ir_len = spectra.shape[-2] * eng.hop
        eng.backend = backend
        eng._ir_debug = None
        return eng

    def spectra_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """The packed spectra as host numpy arrays (re, im)."""
        return (self.spectra.re.detach().cpu().numpy(),
                self.spectra.im.detach().cpu().numpy())

    def __call__(self, x: torch.Tensor, mac_backend: str = "auto") -> torch.Tensor:
        """conv(x, ir)[: len(x)], the steady-state causal convolution."""
        if self._ir_debug is not None:
            from ..utils import debug_stages
            debug_stages.maybe_report(self._ir_debug, x, self.fft_size,
                                      self.backend, "FastFIR")
        return self.apply(self.spectra, x, backend=self.backend,
                          mac_backend=mac_backend)

    @staticmethod
    def apply(spectra: Split, x: torch.Tensor, backend: Optional[str] = None,
              mac_backend: str = "auto") -> torch.Tensor:
        """Uniform-partitioned offline convolution with look-ahead.

        ``backend=None`` resolves by the device of ``x`` ("pallas" on CUDA,
        so the kernels run; "xla" on the CPU)."""
        # The fused chain where it serves, with the look-ahead folded into
        # its one pad; else the staged form shifted left by one hop.
        return part._offline(spectra, x, spectra.shape[-1], backend, mac_backend)


def fast_fir(x: torch.Tensor, ir, fft_size: Optional[int] = None,
             dtype: Optional[torch.dtype] = None, backend: Optional[str] = None,
             mac_backend: str = "auto") -> torch.Tensor:
    """One-shot offline convolution: conv(x, ir)[: len(x)], on x's device."""
    eng = FastFIR(ir, fft_size, dtype or x.dtype, backend, device=x.device)
    return eng(x, mac_backend=mac_backend)
