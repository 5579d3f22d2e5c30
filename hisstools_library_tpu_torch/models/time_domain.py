"""Zero-latency time-domain FIR head.

Counterpart of ``hisstools_library_tpu/models/time_domain.py`` (reference
``HISSTools::TimeDomainConvolve``). The FIR is one grouped (depthwise)
``conv1d`` over channels, and the streaming state is an explicit carry of the
last ``taps - 1`` input samples. No Pallas kernel stands behind it on the TPU
(XLA's convolution), so torch's convolution serves here on every device.

Precision: on CUDA a float32 ``conv1d`` goes through cuDNN, which uses TF32 by
default (about three decimal digits). :func:`_causal_fir` turns that off for
its call, so the head runs in full FP32 like the TPU package's
``Precision.HIGHEST``.

The 2044-tap limit (TimeDomainConvolve.cpp:64) is kept as the default maximum
for scheme parity; arbitrary lengths are allowed when used standalone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import resolve_device

MAX_TAPS = 2044


def make_taps(ir: np.ndarray, offset: int = 0, length: int = 0,
              max_taps: int = MAX_TAPS) -> np.ndarray:
    """Extract the head taps ``ir[offset : offset + min(len - offset, length or max)]``
    (reference TimeDomainConvolve::set, :69-87). Host-side (numpy)."""
    ir = np.asarray(ir)
    n = ir.shape[-1]
    if n <= offset:
        return np.zeros(ir.shape[:-1] + (0,), ir.dtype)
    take = min(n - offset, length if length else max_taps)
    return ir[..., offset:offset + take]


def _causal_fir(x: torch.Tensor, h: torch.Tensor, history: int = 0) -> torch.Tensor:
    """y[n] = sum_j h[j] x[n - j], per leading-dim channel, with x[n] = 0
    before x's first sample. The first ``history`` samples of x are past
    input: they feed the sum, and only the outputs of the rest come back
    (L - history of them), so a caller that carries history pads nothing.

    ``x``: (..., L); ``h``: (..., T) with identical leading dims (or 1-D h,
    shared by every channel). A depthwise grouped convolution, in full FP32
    on CUDA (TF32 off)."""
    taps = h.shape[-1]
    lead = x.shape[:-1]
    L = x.shape[-1]
    if taps == 0 or L == history:  # no taps, or no new sample: nothing to sum
        return x.new_zeros(lead + (L - history,))
    c = int(np.prod(lead)) if lead else 1
    xr = x.reshape(1, c, L)
    if taps - 1 > history:
        xr = F.pad(xr, (taps - 1 - history, 0))
    hb = h.expand(lead + (taps,)) if lead else h
    hr = torch.flip(hb, dims=(-1,)).reshape(c, 1, taps).to(x.dtype)
    if c == 1:
        # A lone channel runs beside a zero one, so that it takes the same
        # depthwise kernel as many channels do (groups=1 is another kernel
        # that sums in another order): a channel's output is then the same
        # bits however many channels share the call, as the channel-sharded
        # engines (parallel.sharded) need.
        xr = F.pad(xr, (0, 0, 0, 1))
        hr = F.pad(hr, (0, 0, 0, 0, 0, 1))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(xr, hr, groups=xr.shape[1])[:, :c]
    return y.reshape(*lead, y.shape[-1])[..., y.shape[-1] - (L - history):]


def fir_offline(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR of the whole signal: y[n] = sum_j h[j] x[n - j], len(y) == len(x)
    — the streaming engine's steady-state output (no warm-up truncation)."""
    return _causal_fir(x, h)


class TimeDomainConvolve:
    """Streaming FIR head with functional state.

    State is the last ``taps - 1`` input samples; ``process`` returns a new
    state and never changes the one it was given."""

    def __init__(self, offset: int = 0, length: int = 0, max_taps: int = MAX_TAPS):
        if length > max_taps:
            raise ConvolveException(ConvolveError.TIME_LENGTH_OUT_OF_RANGE,
                                    f"length {length} > {max_taps}")
        self.offset = offset
        self.length = length
        self.max_taps = max_taps
        self.taps: Optional[torch.Tensor] = None

    def set(self, ir, dtype: torch.dtype = torch.float32,
            device=None) -> ConvolveError:
        """Load the impulse head (reference :69-87) onto ``device`` (the
        card unless named)."""
        ir_np = np.asarray(ir)
        self.taps = torch.as_tensor(
            make_taps(ir_np, self.offset, self.length, self.max_taps)).to(
                device=resolve_device(device), dtype=dtype)
        too_long = (not self.length) and (ir_np.shape[-1] - self.offset) > self.max_taps
        return ConvolveError.TIME_IMPULSE_TOO_LONG if too_long else ConvolveError.NONE

    def init_state(self, batch_shape=(), dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
        """A fresh state, on the taps' device unless ``device`` is given (the
        card when neither is)."""
        taps = int(self.taps.shape[-1]) if self.taps is not None else 1
        if device is None and self.taps is not None:
            device = self.taps.device
        return torch.zeros(tuple(batch_shape) + (max(taps - 1, 1),), dtype=dtype,
                           device=resolve_device(device))

    @staticmethod
    def process(taps: torch.Tensor, state: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One streaming block: returns (new_state, y) with y the causal FIR output.

        ``taps``: (..., T); ``state``: (..., >= T-1) previous input tail;
        ``x``: (..., B)."""
        t = taps.shape[-1]
        if t == 0:
            return state, torch.zeros_like(x)
        if t > 1 and state.shape[-1] < t - 1:
            # A state built before set() installed longer taps would silently
            # shorten the output (tail slice under-fills the history window).
            raise ValueError(f"state holds {state.shape[-1]} samples but "
                             f"{t} taps need {t - 1}; rebuild with init_state()"
                             " after set()")
        tail = state[..., state.shape[-1] - (t - 1):] if t > 1 else state[..., :0]
        ext = torch.cat([tail, x], dim=-1)
        y = _causal_fir(ext, taps, history=t - 1)
        keep = max(t - 1, 1)
        new_state = ext[..., ext.shape[-1] - keep:].clone()
        return new_state, y
