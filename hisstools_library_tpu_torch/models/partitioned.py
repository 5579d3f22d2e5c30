"""Uniform partitioned overlap-save FFT convolution: the section engine.

Counterpart of ``hisstools_library_tpu/models/partitioned.py``:
``validate_fft_size``, ``impulse_spectra``, ``_lag_mac_dispatch``,
``PartitionedState``, ``StreamState``, and ``PartitionedConvolve`` with its
offline path (``process_offline`` / ``_process_offline_fused``), its
hop-aligned streaming path (``set``, ``init_state``, ``process``,
``process_block``, ``_slot_normalise``) and its sample-granular path
(``init_stream_state``, ``step_any``, ``step``, ``_fire``, ``_emit``,
``stream_from_aligned``, ``stream_to_aligned``), which takes blocks of any
length and fires a section only where a hop boundary falls.

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
from ..core.types import Split, array_from, packed_mul, resolve_device, tensor_from
from ..fft import api as fft_api
from ..fft import hopper_fft, hopper_kernels
from ..utils.profiling import span

MIN_FFT_SIZE_LOG2 = 5
MAX_FFT_SIZE_LOG2 = 20
# process_block takes the whole-block stream chain (K8) only at P <= 8: the
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
    ``device`` (the card unless named). The chunks are framed in ``dtype`` on
    the device: zero padding and the cast commute, so this equals framing in
    float64 first."""
    validate_fft_size(fft_size)
    h = fft_size >> 1
    ir = np.asarray(ir)
    n = ir.shape[-1]
    take = 0 if n <= offset else n - offset
    if length:
        take = min(take, length)
    p = max(1, -(-take // h))  # at least one (zero) partition
    chunk = torch.as_tensor(ir[..., offset:offset + take]).to(
        device=resolve_device(device), dtype=dtype)
    frames = F.pad(chunk, (0, p * h - take)).reshape(ir.shape[:-1] + (p, h))
    frames = F.pad(frames, (0, h))  # zero-pad each chunk to N
    re, im = fft_api.rfft(frames.contiguous(), backend=backend)
    return Split(re, im)


def _lag_mac_dispatch(xp_re: torch.Tensor, xp_im: torch.Tensor,
                      h_re: torch.Tensor, h_im: torch.Tensor, t: int,
                      mac_backend: str):
    """Partition MAC over zero-padded spectra.

    ``xp_*``: (..., T+P, K) zero-padded spectra; ``h_*``: (..., P, K).
    Returns packed-correct (..., T, K) accumulations. ``mac_backend="pallas"``,
    and ``"auto"`` off the CPU, take K15 :func:`hopper_kernels.lag_mac` (its
    plain version on a CPU tensor) at any P: the TPU package's partition
    bound is its VMEM budget, which the card does not share. ``"xla"``, and
    ``"auto"`` on the CPU, run the loop form in torch ops."""
    p = h_re.shape[-2]
    k = xp_re.shape[-1]
    if mac_backend == "pallas" or (mac_backend == "auto" and xp_re.device.type != "cpu"):
        lead = xp_re.shape[:-2]
        c = math.prod(lead)
        y_re, y_im = hopper_kernels.lag_mac(
            xp_re.reshape(c, t + p, k), xp_im.reshape(c, t + p, k),
            h_re.expand(lead + (p, k)).reshape(c, p, k),
            h_im.expand(lead + (p, k)).reshape(c, p, k), t)
        return y_re.reshape(lead + (t, k)), y_im.reshape(lead + (t, k))
    return hopper_kernels.lag_mac_plain(xp_re, xp_im, h_re, h_im, t)


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


@dataclasses.dataclass
class StreamState:
    """Sample-granular streaming state for any callback block size: the
    reference's RW-counter main loop (PartitionedConvolve.cpp:243-385) made
    explicit. ``win``: the last N input samples; ``out_buf``: the H-sample
    output store of the current hop period; ``phase``: samples consumed since
    the last hop boundary; ``ring``/``pos``: the spectra ring, as in
    :class:`PartitionedState`. ``phase`` and ``pos`` are host ints, so no
    call reads a scalar back from the card."""

    win: torch.Tensor      # (..., N)
    out_buf: torch.Tensor  # (..., H)
    phase: int
    ring: Split            # (..., P, N/2)
    pos: int

    @classmethod
    def from_numpy(cls, src, device=None) -> "StreamState":
        """A state from any object with these fields holding arrays: the JAX
        package's ``StreamState`` (to continue its stream here) or
        :meth:`numpy`'s result, copied onto ``device`` (the card unless
        named)."""
        return cls(tensor_from(src.win, device), tensor_from(src.out_buf, device),
                   int(np.asarray(src.phase)), Split.from_numpy(src.ring, device),
                   int(np.asarray(src.pos)))

    def numpy(self) -> "StreamState":
        """The same state with host numpy arrays in place of tensors."""
        return StreamState(array_from(self.win), array_from(self.out_buf), self.phase,
                           self.ring.numpy(), self.pos)


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
        """A fresh state, on the spectra's device unless ``device`` is given
        (the card when neither is)."""
        if device is None and self.spectra is not None:
            device = self.spectra.re.device
        device = resolve_device(device)
        p = max(self.num_partitions, 1)
        shape = tuple(batch_shape)
        return PartitionedState(
            prev=torch.zeros(shape + (self.hop,), dtype=dtype, device=device),
            ring=Split.zeros(shape + (p, self.hop), dtype, device),
            pos=0)

    def init_stream_state(self, batch_shape=(), dtype: torch.dtype = torch.float32,
                          device=None) -> StreamState:
        """A fresh sample-granular state, on the spectra's device unless
        ``device`` is given (the card when neither is)."""
        if device is None and self.spectra is not None:
            device = self.spectra.re.device
        device = resolve_device(device)
        p = max(self.num_partitions, 1)
        shape = tuple(batch_shape)
        return StreamState(
            win=torch.zeros(shape + (self.fft_size,), dtype=dtype, device=device),
            out_buf=torch.zeros(shape + (self.hop,), dtype=dtype, device=device),
            phase=0, ring=Split.zeros(shape + (p, self.hop), dtype, device), pos=0)

    @staticmethod
    def _slot_normalise(ring: Split, pos: int) -> Split:
        """Reorder ring slots oldest-first (the pos == 0 layout): slot
        (pos + k) mod P holds the spectrum of age P - k. A roll, so no index
        tensor is built on the host."""
        return Split(torch.roll(ring.re, -pos, dims=-2), torch.roll(ring.im, -pos, dims=-2))

    # -- sample-granular path ------------------------------------------------

    @staticmethod
    @span("engine.partitioned.emit")
    def _emit(spectra: Split, ring: Split, pos: int,
              backend: Optional[str] = None) -> torch.Tensor:
        """Output store for the hop period starting now: the MAC across
        partitions with :meth:`step`'s slot mapping (slot s holds lag
        (pos - 1 - s) mod P), the inverse (K6 at N >= 4096, K11 below, on
        the card), the kept half, 1/(4N).

        The TPU package runs this MAC as plain XLA; here it is torch ops
        accumulated lag by lag in place, so no (..., P, K) product is ever
        materialised (at the Zero preset's final section, (128, 58, 8192),
        that would be two 487 MB temporaries per firing)."""
        p = spectra.shape[-2]
        h = spectra.shape[-1]
        n = 2 * h
        lead = torch.broadcast_shapes(ring.re.shape[:-2], spectra.re.shape[:-2])
        acc_re = torch.zeros(lead + (h,), dtype=ring.re.dtype, device=ring.re.device)
        acc_im = torch.zeros_like(acc_re)
        for s in range(p):
            lag = (pos - 1 - s) % p
            rr, ri = ring.re[..., s, :], ring.im[..., s, :]
            hr, hi = spectra.re[..., lag, :], spectra.im[..., lag, :]
            acc_re.addcmul_(rr, hr).addcmul_(ri, hi, value=-1.0)
            acc_im.addcmul_(rr, hi).addcmul_(ri, hr)
        # The packed (DC, Nyquist) lane: two real MACs. Spectra of bin 0 in
        # slot order: slot s takes H[(pos - 1 - s) mod P] = roll(flip(H), pos).
        h0_re = torch.roll(torch.flip(spectra.re[..., 0], dims=(-1,)), pos, dims=-1)
        h0_im = torch.roll(torch.flip(spectra.im[..., 0], dims=(-1,)), pos, dims=-1)
        acc_re[..., 0] = (ring.re[..., 0] * h0_re).sum(-1)
        acc_im[..., 0] = (ring.im[..., 0] * h0_im).sum(-1)
        y = fft_api.rifft(acc_re, acc_im, backend=backend)
        return y[..., h:] * (1.0 / (4.0 * n))

    @staticmethod
    def _insert(ring: Split, pos: int, re: torch.Tensor, im: torch.Tensor) -> Split:
        """A new ring with the spectrum (re, im) at slot ``pos``."""
        new_re, new_im = ring.re.clone(), ring.im.clone()
        new_re[..., pos, :] = re
        new_im[..., pos, :] = im
        return Split(new_re, new_im)

    @staticmethod
    @span("engine.partitioned.fire")
    def _fire(spectra: Split, ring: Split, pos: int, frame: torch.Tensor,
              backend: Optional[str] = None) -> Tuple[Split, int, torch.Tensor]:
        """Hop-boundary work (reference PartitionedConvolve.cpp:352-377): the
        completed [prev | cur] frame's spectrum joins the ring, then the next
        hop period's output store is computed. Returns (ring, pos, store).

        With the "pallas" backend (the default on CUDA), float32 and a small
        section (N = 32..1024, P <= 256) the whole firing is one K9 launch
        (:func:`hopper_kernels.hop_fire`), which keeps the ring oldest-first
        (pos == 0). A ring with pos != 0 (a JAX package state whose section
        did not fit its TPU kernel, or one from :meth:`step`) is
        slot-normalised once, before its first K9 firing; pos then stays 0.
        Otherwise the frame is transformed (``fft_api.rfft``), written at
        slot ``pos`` of a new ring, and :meth:`_emit` runs."""
        p = spectra.shape[-2]
        n = frame.shape[-1]
        resolved = fft_api._resolve(backend, frame.device)
        if (resolved == "pallas" and frame.dtype == torch.float32
                and hopper_kernels.hop_fire_eligible(n, p)):
            if pos % p:
                ring = PartitionedConvolve._slot_normalise(ring, pos)
            rr, ri, y = hopper_kernels.hop_fire(frame, ring.re.contiguous(),
                                                ring.im.contiguous(), spectra.re,
                                                spectra.im)
            return Split(rr, ri), 0, y
        ring = PartitionedConvolve._insert(
            ring, pos, *fft_api.rfft(frame.contiguous(), backend=resolved))
        pos = (pos + 1) % p
        return ring, pos, PartitionedConvolve._emit(spectra, ring, pos, resolved)

    @staticmethod
    def stream_from_aligned(spectra: Split, state: PartitionedState,
                            backend: Optional[str] = None) -> StreamState:
        """Lift a hop-aligned state into the sample-granular form (phase 0).

        The output store is computed from the current ring (what the next
        :meth:`step` would emit), so streaming continues from the hop
        boundary as if it had never left the aligned form. The ring is
        slot-normalised to pos == 0, K9's layout."""
        win = torch.cat([torch.zeros_like(state.prev), state.prev], dim=-1)
        out_buf = PartitionedConvolve._emit(spectra, state.ring, state.pos, backend)
        ring = state.ring
        if state.pos % spectra.shape[-2]:
            ring = PartitionedConvolve._slot_normalise(ring, state.pos)
        return StreamState(win, out_buf, 0, ring, 0)

    @staticmethod
    def stream_to_aligned(state: StreamState) -> PartitionedState:
        """Project back to the hop-aligned form. Valid only on a hop boundary
        (``phase == 0``): between boundaries there is no aligned equivalent,
        and this raises."""
        if state.phase:
            raise ValueError(f"stream_to_aligned needs a hop boundary (phase 0), "
                             f"got phase {state.phase}")
        h = state.out_buf.shape[-1]
        return PartitionedState(prev=state.win[..., h:].clone(), ring=state.ring,
                                pos=state.pos)

    @staticmethod
    @span("engine.partitioned.step_any")
    def step_any(spectra: Split, state: StreamState, x: torch.Tensor,
                 backend: Optional[str] = None) -> Tuple[StreamState, torch.Tensor]:
        """Process a block of ANY length, the reference's main loop semantics
        (PartitionedConvolve.cpp:243-385): stage the input, dole out the
        output store, and fire (:meth:`_fire`) only where a hop boundary is
        crossed.

        With phase p the block crosses k = (p + L) // H boundaries. The phase
        is a host int, so k is known before any work is queued: the TPU
        package's ``lax.cond`` on the trailing partial hop becomes a Python
        branch and no scalar is read back from the card. Returns a new state
        and leaves ``state`` as it was."""
        h = spectra.shape[-1]
        n = 2 * h
        L = x.shape[-1]
        phase = state.phase
        k = (phase + L) // h
        if k == 0:  # inside one hop period: stage the input, dole out the store
            win = torch.cat([state.win[..., L:], x], dim=-1)
            out = state.out_buf[..., phase:phase + L].clone()
            return dataclasses.replace(state, win=win, phase=phase + L), out
        buf = torch.cat([state.win, x], dim=-1)                 # (..., N + L)
        ring, pos = state.ring, state.pos
        ys = []
        for j in range(k):
            start = h - phase + j * h
            ring, pos, y = PartitionedConvolve._fire(spectra, ring, pos,
                                                     buf[..., start:start + n], backend)
            ys.append(y)
        outcat = torch.cat([state.out_buf] + ys, dim=-1)
        out = outcat[..., phase:phase + L]
        new_state = StreamState(win=buf[..., buf.shape[-1] - n:].clone(),
                                out_buf=outcat[..., k * h:(k + 1) * h].clone(),
                                phase=phase + L - k * h, ring=ring, pos=pos)
        return new_state, out

    @staticmethod
    def step(spectra: Split, state: PartitionedState, block: torch.Tensor,
             backend: Optional[str] = None) -> Tuple[PartitionedState, torch.Tensor]:
        """One hop: emit from the current ring (spectra X_{t-1}..X_{t-P}),
        then insert X_t at slot ``pos`` of a new ring. ``block`` is exactly H
        samples."""
        p = spectra.shape[-2]
        out = PartitionedConvolve._emit(spectra, state.ring, state.pos, backend)
        ring = PartitionedConvolve._insert(
            state.ring, state.pos,
            *fft_api.rfft(torch.cat([state.prev, block], dim=-1), backend=backend))
        return PartitionedState(prev=block.clone(), ring=ring,
                                pos=(state.pos + 1) % p), out

    @staticmethod
    def process(spectra: Split, state: PartitionedState, x: torch.Tensor,
                backend: Optional[str] = None) -> Tuple[PartitionedState, torch.Tensor]:
        """Stream a signal whose length is a multiple of the hop: every hop
        advances in one batched pass (:meth:`process_block`)."""
        return PartitionedConvolve.process_block(spectra, state, x, backend=backend)

    @staticmethod
    @span("engine.partitioned.process_block")
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
          call of K8 :func:`hopper_fft.fastfir_chain_stream` (three launches:
          the frames' forward in one HBM pass, the state kernel, the inverse
          in one pass);
        - otherwise the frames [prev | cur] are materialised and transformed
          (``fft_api.rfft``: K1, or K10 below 4096), the MAC runs as K7
          :func:`hopper_kernels.lag_mac_ring` when T <= P (any P: the TPU
          package's bound of 512 is its VMEM budget) and else as
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
                and hopper_fft.chain_eligible(n)):
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
                and t <= p):
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
        the chain runs as K5 at N = 2^14..2^17, or as K2 -> K3 -> K4 at
        4096..8192 (:meth:`_process_offline_fused`).
        Otherwise the staged form below runs: the forward transform
        (``fft_api.rfft``: K1, or K10 below 4096), the MAC
        (:func:`_lag_mac_dispatch`: K15 or the torch loop) and the inverse
        (``fft_api.rifft``: K6, or K11 below 4096)."""
        resolved = fft_api._resolve(backend, x.device)
        if resolved == "pallas" and mac_backend in ("auto", "pallas"):
            out = PartitionedConvolve._process_offline_fused(spectra, x)
            if out is not None:
                return out
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
    @span("engine.partitioned.offline_fused")
    def _process_offline_fused(spectra: Split, x: torch.Tensor,
                               shift: int = 0) -> Optional[torch.Tensor]:
        """The offline chain as kernels: the rFFT of the hop blocks read in
        place, the causal MAC over the valid lags and the tail inverse of the
        kept half-block with the 1/(4N) scale folded in. Float32 N =
        2^14..2^17 runs it as one call of K5 :func:`hopper_fft.fastfir_chain`
        at any P (the TPU package gates its K5 at N >= 2^14 too, less its
        VMEM model); N = 4096..8192 as K2 -> K3 -> K4
        (:func:`hopper_fft.fastfir_chain_staged`). ``shift`` trailing zeros
        extend the signal and the first ``shift`` outputs are dropped (shift
        = hop is FastFIR's look-ahead). Returns None when the shapes are not
        eligible (the caller takes the staged path)."""
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
        # H as (C, lags, K) views where the layout allows: K5 reads row
        # slices and channel-broadcast planes in place.
        hr = spectra.re[..., :lags, :].expand(lead + (lags, h)).reshape(c, lags, h)
        hi = spectra.im[..., :lags, :].expand(lead + (lags, h)).reshape(c, lags, h)
        hr, hi = hr.to(torch.float32), hi.to(torch.float32)
        if hopper_fft.chain_eligible(n):
            y = hopper_fft.fastfir_chain(x2d, hr, hi, scale=1.0 / (4.0 * n))
        else:
            y = hopper_fft.fastfir_chain_staged(x2d, hr.contiguous(), hi.contiguous(),
                                                scale=1.0 / (4.0 * n))
        return y.reshape(*lead, t * h)[..., shift:shift + L]
