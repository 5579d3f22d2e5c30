"""Uniform partitioned overlap-save FFT convolution: the section engine.

Counterpart of ``hisstools_library_tpu/models/partitioned.py``:
``validate_fft_size``, ``impulse_spectra``, ``_lag_mac_dispatch``,
``PartitionedState``, and ``PartitionedConvolve`` with its offline path
(``process_offline`` / ``_process_offline_fused``) and its hop-aligned
streaming path (``set``, ``init_state``, ``process``, ``process_block``,
``_slot_normalise``). The sample-granular path (``step``, ``step_any``,
``StreamState``, ``stream_from_aligned``) is not ported yet: it needs K6 and
K9.

A section with FFT size N (hop H = N/2) emits ``conv(x, ir)`` delayed by one
hop. Output = inverse of the accumulated spectra x ``1/(4N)``, the reference's
``scaleStore`` factor (PartitionedConvolve.cpp:232-241) for the x2 forward
scale on both operands. FFT sizes 2^5..2^20 as in the reference
(PartitionedConvolve.h:18-19).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import Split, array_from, packed_mul, tensor_from
from ..fft import api as fft_api
from ..fft import hopper_fft, hopper_kernels

MIN_FFT_SIZE_LOG2 = 5
MAX_FFT_SIZE_LOG2 = 20
# The TPU package's partition bound for its MAC kernels (pallas_kernels.py:279).
MAX_MAC_PARTITIONS = 512
# process_block takes the whole-chain stream kernel (K8) only at P <= 8: the
# TPU package's default policy (partitioned.py:494-496), kept so both packages
# route a given shape alike.
STREAM_CHAIN_MAX_P = 8


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
    Returns packed-correct (..., T, K) accumulations. Routed as the TPU
    package routes it: off the CPU, ``mac_backend="pallas"``, and ``"auto"``
    at P <= 512, take the Pallas form (K15, ``pallas_kernels.py: lag_mac``),
    which is not ported, so they raise on a CUDA tensor; ``"xla"`` (and
    every call on the CPU) runs the loop form in torch ops."""
    p = h_re.shape[-2]
    if xp_re.device.type != "cpu" and (
            mac_backend == "pallas"
            or (mac_backend == "auto" and p <= MAX_MAC_PARTITIONS)):
        raise NotImplementedError(
            f"mac_backend={mac_backend!r} off the CPU: K15 lag_mac "
            "(fft/pallas_kernels.py:109) is not ported to the GPU yet; pass "
            "mac_backend='xla' for the torch loop")
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


@dataclasses.dataclass
class PartitionedState:
    """Streaming state (the reference's internal buffers made explicit:
    PartitionedConvolve.h:62-81). ``pos`` (t mod P, the ring write position)
    is a host int, so no call reads a scalar back from the card."""

    prev: torch.Tensor   # (..., H)      previous input block
    ring: Split          # (..., P, N/2) frequency-domain delay line of input spectra
    pos: int = 0         # ring write position

    @classmethod
    def from_numpy(cls, src, device=None) -> "PartitionedState":
        """A state from any object with these fields holding arrays: the JAX
        package's ``PartitionedState`` (to continue its stream here) or
        :meth:`numpy`'s result."""
        return cls(tensor_from(src.prev, device), Split.from_numpy(src.ring, device),
                   int(np.asarray(src.pos)))

    def numpy(self) -> "PartitionedState":
        """The same state with host numpy arrays in place of tensors."""
        return PartitionedState(array_from(self.prev), self.ring.numpy(), self.pos)


class PartitionedConvolve:
    """Configuration holder + pure processing functions for one uniform section."""

    def __init__(self, fft_size: int, max_length: int = 0, offset: int = 0,
                 length: int = 0):
        validate_fft_size(fft_size)
        self.fft_size = fft_size
        self.hop = fft_size >> 1
        self.offset = offset
        self.length = length
        self.max_length = max_length
        self.spectra: Optional[Split] = None

    def set(self, ir, dtype: torch.dtype = torch.float32,
            backend: Optional[str] = None, device=None) -> ConvolveError:
        err = ConvolveError.NONE
        ir = np.asarray(ir)
        if self.max_length:
            avail = max(0, ir.shape[-1] - self.offset)
            want = min(avail, self.length) if self.length else avail
            if want > self.max_length:
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
        length = self.length if self.length else (self.max_length or 0)
        if self.max_length and length:
            # Convolve only what fits, like the reference (it clamps to
            # mMaxImpulseLength alongside the error, PartitionedConvolve.cpp
            # :195-199).
            length = min(length, self.max_length)
        self.spectra = impulse_spectra(ir, self.fft_size, self.offset, length,
                                       dtype, backend, device=device)
        return err

    @property
    def num_partitions(self) -> int:
        return 0 if self.spectra is None else self.spectra.shape[-2]

    def init_state(self, batch_shape=(), dtype: torch.dtype = torch.float32,
                   device=None) -> PartitionedState:
        """A fresh state, on the spectra's device unless ``device`` is given."""
        if device is None and self.spectra is not None:
            device = self.spectra.re.device
        p = max(self.num_partitions, 1)
        shape = tuple(batch_shape)
        return PartitionedState(
            prev=torch.zeros(shape + (self.hop,), dtype=dtype, device=device),
            ring=Split.zeros(shape + (p, self.hop), dtype, device),
            pos=0)

    @staticmethod
    def _slot_normalise(ring: Split, pos: int) -> Split:
        """Reorder ring slots oldest-first (the pos == 0 layout): slot
        (pos + k) mod P holds the spectrum of age P - k."""
        p = ring.shape[-2]
        order = torch.tensor([(pos + k) % p for k in range(p)], device=ring.re.device)
        return Split(ring.re.index_select(-2, order), ring.im.index_select(-2, order))

    @staticmethod
    def process(spectra: Split, state: PartitionedState, x: torch.Tensor,
                backend: Optional[str] = None) -> Tuple[PartitionedState, torch.Tensor]:
        """Stream a signal whose length is a multiple of the hop: every hop
        advances in one batched pass (:meth:`process_block`)."""
        return PartitionedConvolve.process_block(spectra, state, x, backend=backend)

    @staticmethod
    def process_block(spectra: Split, state: PartitionedState, x: torch.Tensor,
                      backend: Optional[str] = None, mac_backend: str = "auto",
                      lag0: Optional[Split] = None, assume_pos0: bool = False
                      ) -> Tuple[PartitionedState, torch.Tensor]:
        """Advance the streaming engine by all of ``x``'s hops at once.

        The whole block's spectra batch through one rFFT, the ring history
        joins them as the leading rows of the lag-MAC window, and one inverse
        emits every hop. The returned state is new and slot-normalised
        (pos = 0); ``state`` is left as it was.

        ``lag0``: optional (..., 1, K) packed spectrum multiplied with the
        CURRENT hop's own spectrum and added to each hop's accumulation, the
        zero-delay partition that mono's block paths use to collapse a whole
        non-uniform scheme into this engine. ``assume_pos0``: the caller's
        promise that ``state.pos == 0`` (states from init or a previous
        process_block).

        Routing, as the TPU package routes it (``backend=None`` resolves by
        the device: the kernels on CUDA, ``torch.fft`` on the CPU):

        - ``"pallas"``, float32, P <= 8, N = 2^14..2^17: the whole block as one
          kernel, K8 :func:`hopper_fft.fastfir_chain_stream`;
        - otherwise the frames [prev | cur] are materialised and transformed
          (``fft_api.rfft``: K1, or K10 below 4096), the MAC runs as K7
          :func:`hopper_kernels.lag_mac_ring` when T <= P <= 512 and else as
          :func:`_lag_mac_dispatch`, the lag-0 product runs in torch ops, and
          the kept halves come from K4 (N >= 4096) or ``fft_api.rifft``."""
        h = spectra.shape[-1]
        n = 2 * h
        p = spectra.shape[-2]
        L = x.shape[-1]
        if L % h:
            raise ValueError(f"signal length {L} not a multiple of hop {h}")
        if L == 0:
            return state, torch.zeros_like(x)
        t = L // h
        lead = x.shape[:-1]
        c = math.prod(lead)
        blocks = x.reshape(*lead, t, h)
        resolved = fft_api._resolve(backend, x.device)
        ring = state.ring
        if not assume_pos0 and state.pos % p:
            ring = PartitionedConvolve._slot_normalise(ring, state.pos)
        new_prev = blocks[..., -1, :].clone()
        scale = 1.0 / (4.0 * n)

        def per_channel(plane: torch.Tensor, rows: int) -> torch.Tensor:
            # (..., rows, K) broadcast to x's channels, as (C, rows, K); a
            # view wherever the layout allows one.
            return plane.expand(lead + (rows, h)).reshape(c, rows, h)

        if (resolved == "pallas" and mac_backend in ("auto", "pallas")
                and x.dtype == torch.float32 and p <= STREAM_CHAIN_MAX_P
                and hopper_fft.stream_chain_eligible(n)):
            l0r = l0i = None
            if lag0 is not None:
                l0r = per_channel(lag0.re, 1)[:, 0, :]
                l0i = per_channel(lag0.im, 1)[:, 0, :]
            y, nr, ni = hopper_fft.fastfir_chain_stream(
                blocks.reshape(c, t, h).contiguous(),
                state.prev.reshape(c, h).contiguous(),
                ring.re.reshape(c, p, h).contiguous(),
                ring.im.reshape(c, p, h).contiguous(),
                per_channel(spectra.re, p), per_channel(spectra.im, p),
                scale, l0r, l0i)
            new_state = PartitionedState(
                new_prev, Split(nr.reshape(lead + (p, h)), ni.reshape(lead + (p, h))), 0)
            return new_state, y.reshape(*lead, L)

        # Frames [hop_{j-1} | hop_j] with hop_{-1} = the carried block.
        prev_rows = torch.cat([state.prev[..., None, :], blocks[..., :-1, :]], dim=-2)
        frames = torch.cat([prev_rows, blocks], dim=-1)
        xre, xim = fft_api.rfft(frames, backend=resolved)      # (..., T, K)

        if (mac_backend in ("auto", "pallas") and x.dtype != torch.float64
                and t <= p <= MAX_MAC_PARTITIONS):
            yre, yim, nre, nim = hopper_kernels.lag_mac_ring(
                ring.re.reshape(c, p, h).contiguous(),
                ring.im.reshape(c, p, h).contiguous(),
                xre.reshape(c, t, h), xim.reshape(c, t, h),
                per_channel(spectra.re, p).to(xre.dtype),
                per_channel(spectra.im, p).to(xre.dtype))
            acc_re = yre.reshape(lead + (t, h))
            acc_im = yim.reshape(lead + (t, h))
            new_ring = Split(nre.reshape(lead + (p, h)), nim.reshape(lead + (p, h)))
        else:
            xp_re = torch.cat([ring.re, xre], dim=-2)             # (..., P+T, K)
            xp_im = torch.cat([ring.im, xim], dim=-2)
            h_re = spectra.re.expand(lead + spectra.re.shape[-2:])
            h_im = spectra.im.expand(lead + spectra.im.shape[-2:])
            acc_re, acc_im = _lag_mac_dispatch(xp_re, xp_im, h_re, h_im, t,
                                               mac_backend)
            new_ring = Split(xp_re[..., t:, :].contiguous(),
                             xp_im[..., t:, :].contiguous())

        if lag0 is not None:
            # Zero-delay partition: each hop's own spectrum times lag0.
            prod = packed_mul(Split(xre, xim), lag0)
            acc_re = acc_re + prod.re
            acc_im = acc_im + prod.im

        if (resolved == "pallas" and hopper_fft.stream_feasible(n)
                and x.dtype != torch.float64):
            out = hopper_fft.rifft_packed_tail(acc_re, acc_im, scale)
        else:
            out = (fft_api.rifft(acc_re, acc_im, backend=resolved) * scale)[..., h:]
        return PartitionedState(new_prev, new_ring, 0), out.reshape(*lead, L)

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
        ported: on a CUDA tensor it runs only with ``backend="xla",
        mac_backend="xla"``."""
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
                "pass backend='xla', mac_backend='xla'")
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
