"""Multichannel N-in / M-out convolution routing.

Counterpart of ``hisstools_library_tpu/models/multichannel.py`` (reference
``HISSTools::Convolver`` and ``NToMonoConvolve``): the (out x in) matrix of
convolvers is one batched mono engine whose IR spectra carry leading dims
``(M, N)``; the input broadcasts over the output axis and the N-to-mono
reduction is one ``sum`` over the input axis.

Two routing modes, as in the reference (Convolver.cpp:5-41):

- **N2M**: every input convolves into every output through IR[out, in].
- **Parallel**: N independent channels, IR[c] applied to input c.

The IR bank lives on the host in float64 numpy, as in the JAX package, so a
bank, a prepared :class:`mono.MonoIR` and every state convert between the two
packages (``from_numpy`` / ``numpy`` with an (M, N) or (C,) batch): a JAX
Convolver stream continues here. :meth:`Convolver.prepare` builds on the card
unless the constructor names a ``device`` (the CPU runs every kernel's plain
version).

On the card, the paths launch what ``mono`` launches for them:
``process_offline`` the prepared offline tail's chain, K5 ``fastfir_chain``
(one call over all M x N pairs; a 10 s IR is N = 2^16); ``process`` with a
single-section scheme of N = 2^16..2^17 or a two-tier state whose far tier is
2^16..2^17 at P <= 8, K8 ``fastfir_chain_stream`` (its forward, state kernel
and inverse; the near tier's 2^14 runs it too); ``process_any`` K9
``hop_fire`` for the sections at N <= 1024 and K1 -> MAC -> K6 above.

The N2M broadcast is ``expand`` (a stride-0 view over M). What copies it out
to (M, N, L): the offline chain's padding (``_process_offline_fused`` pads the
signal to whole hops; M x N x L float32 once, 124 MB for 8 x 8 pairs of
483 328 samples), ``process_block``'s contiguous (M*N, T, H) hop blocks for
K8 (the block's M x N x L floats), and ``process_any``'s window
concatenation per section; the K8 and K5 wrappers read H and the lag-0
planes in place. Each copy is one pass over the broadcast signal, small
beside the kernels' traffic over the spectra (2 x 8 bytes a bin a partition
for each of the M x N pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import ConvolveError, ConvolveException
from ..utils.profiling import span
from . import mono
from .mono import LatencyMode, PartitionScheme


class Convolver:
    """N x M (or parallel N x N) convolution matrix.

    IRs are set per (in, out) pair on the host; processing is the pure
    functions below over the prepared IR. ``process(state, ins)``: ins
    (N, L) -> outs (M, L). ``device`` is where :meth:`prepare` builds (the
    card unless named)."""

    def __init__(self, num_ins: int, num_outs: Optional[int] = None,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None,
                 max_length: int = 16384, device=None):
        parallel = num_outs is None
        num_ins = max(1, num_ins)
        self.parallel = parallel
        self.num_ins = num_ins
        self.num_outs = num_ins if parallel else max(1, num_outs)
        self.scheme = scheme if scheme is not None else PartitionScheme.from_latency(latency)
        self.max_length = max_length
        self.device = device
        # Host IR bank: (M, N, L) zero-padded float64; parallel mode (C, L).
        self._bank: Optional[np.ndarray] = None
        self._bank_len = 0
        self.ir: Optional[mono.MonoIR] = None
        self._tail_lazy = False

    @property
    def _batch(self) -> Tuple[int, ...]:
        return (self.num_ins,) if self.parallel else (self.num_outs, self.num_ins)

    # -- IR management (host) ------------------------------------------------

    def _ensure_bank(self, length: int):
        if self._bank is None or length > self._bank_len:
            bank = np.zeros(self._batch + (length,), np.float64)
            if self._bank is not None and self._bank_len:
                bank[..., :self._bank_len] = self._bank
            self._bank = bank
            self._bank_len = length

    def _check_pair(self, in_chan: int, out_chan: int) -> ConvolveError:
        if self.parallel and in_chan != out_chan:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        if not 0 <= out_chan < self.num_outs:
            return ConvolveError.OUT_CHAN_OUT_OF_RANGE
        if not 0 <= in_chan < self.num_ins:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        return ConvolveError.NONE

    def _row(self, in_chan: int, out_chan: int):
        return (in_chan,) if self.parallel else (out_chan, in_chan)

    def resize(self, in_chan: int, out_chan: int, length: int) -> ConvolveError:
        """Reserve capacity for a coming IR (reference Convolver::resize,
        Convolver.cpp:102-112). All pairs share one batched engine, so the
        bank-wide capacity grows: the pair can then take a ``length``-tap IR
        with ``resize=False``."""
        err = self._check_pair(in_chan, out_chan)
        if err == ConvolveError.NONE:
            self.max_length = max(self.max_length, int(length))
        return err

    def set(self, in_chan: int, out_chan: int, ir, resize: bool = True) -> ConvolveError:
        """Load one IR (reference Convolver::set, Convolver.cpp:114-134). For
        parallel mode pass in_chan == out_chan. Call :meth:`prepare` after.
        With ``resize=False`` an IR above the capacity is loaded clamped to it
        and the truncation is reported (MonoConvolve.cpp:117-139)."""
        err = self._check_pair(in_chan, out_chan)
        if err != ConvolveError.NONE:
            return err
        ir = np.asarray(ir, np.float64)
        if ir.shape[-1] > self.max_length:
            if resize:
                self.max_length = ir.shape[-1]
            else:
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                ir = ir[..., :self.max_length]
        n = ir.shape[-1]
        self._ensure_bank(max(self._bank_len, n, 1))
        row = self._row(in_chan, out_chan)
        self._bank[row] = 0.0
        self._bank[row][:n] = ir
        self.ir = None  # the prepared spectra are stale
        return err

    def set_all(self, irs, resize: bool = True) -> ConvolveError:
        """Load the whole IR bank: (C, L) for parallel or (M, N, L) for N2M."""
        irs = np.asarray(irs, np.float64)
        if irs.shape[:-1] != self._batch:
            raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE,
                                    f"bank shape {irs.shape} != {self._batch + ('L',)}")
        err = ConvolveError.NONE
        if irs.shape[-1] > self.max_length:
            if resize:
                self.max_length = irs.shape[-1]
            else:  # loaded clamped and reported, as in set()
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                irs = irs[..., :self.max_length]
        self._bank = irs.copy()
        self._bank_len = irs.shape[-1]
        self.ir = None
        return err

    def clear(self, in_chan: Optional[int] = None, out_chan: Optional[int] = None,
              resize: bool = True) -> ConvolveError:
        """Zero one IR or the whole bank (reference Convolver::clear, :51-75:
        no channel clears every pair; a pair takes BOTH channels). In parallel
        mode either channel alone names the channel. Channels are checked
        whether or not a bank exists yet."""
        if in_chan is None and out_chan is None:
            if self._bank is not None:
                self._bank[...] = 0.0
            self.ir = None
            return ConvolveError.NONE
        if self.parallel:
            in_chan = out_chan if in_chan is None else in_chan
            out_chan = in_chan if out_chan is None else out_chan
            if in_chan != out_chan:
                return ConvolveError.IN_CHAN_OUT_OF_RANGE
        elif in_chan is None or out_chan is None:
            raise ValueError("N2M clear needs both in_chan and out_chan "
                             "(or neither, to clear the whole bank)")
        if not 0 <= in_chan < self.num_ins:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        if not 0 <= out_chan < self.num_outs:
            return ConvolveError.OUT_CHAN_OUT_OF_RANGE
        if self._bank is not None:
            self._bank[self._row(in_chan, out_chan)] = 0.0
        self.ir = None
        return ConvolveError.NONE

    def prepare(self, dtype: torch.dtype = torch.float32, backend: Optional[str] = None,
                offline_tail: Optional[bool] = None) -> mono.MonoIR:
        """Build the prepared IR from the host bank on the constructor's
        ``device`` (the card unless named).

        ``offline_tail``: None (the default) is lazy: the offline tail (an
        extra transform of the whole bank and about a bank's worth of device
        memory that streaming never reads) attaches on the first
        :meth:`process_offline`; True builds it now; False never."""
        if self._bank is None:
            self._ensure_bank(1)
        self._tail_lazy = offline_tail is None
        self._dtype = dtype
        self._backend = backend
        self.ir = mono.prepare_ir(self.scheme, self._bank, dtype=dtype, backend=backend,
                                  offline_tail=bool(offline_tail), device=self.device)
        return self.ir

    # -- processing ----------------------------------------------------------

    @property
    def block_size(self) -> int:
        return self.scheme.sizes[-1] >> 1

    def _prepared(self, dtype: torch.dtype) -> mono.MonoIR:
        if self.ir is None:
            self.prepare(dtype)
        return self.ir

    def init_state(self, dtype: torch.dtype = torch.float32) -> mono.MonoState:
        return mono.init_state(self.scheme, self._prepared(dtype), self._batch, dtype)

    @span("entry.Convolver.process")
    def process(self, state, ins: torch.Tensor, backend: Optional[str] = None):
        """ins: (N, L) -> outs (M, L) [parallel: (C, L) -> (C, L)]; streaming,
        L a multiple of the block size (with a two-tier state, of the far
        hop)."""
        return process(self.ir, state, ins, self.parallel, backend=backend)

    def init_block_state(self, dtype: torch.dtype = torch.float32) -> mono.MonoBlockState:
        """Two-tier hop-aligned block state (:func:`mono.init_block_state`):
        needs a far-tier IR; :meth:`process` blocks must be multiples of
        ``ir.far.shape[-1]`` samples."""
        return mono.init_block_state(self.scheme, self._prepared(dtype), self._batch, dtype)

    def init_stream_state(self, dtype: torch.dtype = torch.float32) -> mono.MonoStreamState:
        """Fresh sample-granular state for :meth:`process_any`."""
        return mono.init_stream_state(self.scheme, self._prepared(dtype), self._batch, dtype)

    @span("entry.Convolver.process_any")
    def process_any(self, state: mono.MonoStreamState, ins: torch.Tensor,
                    backend: Optional[str] = None
                    ) -> Tuple[mono.MonoStreamState, torch.Tensor]:
        """Streaming step of ANY block length (reference Convolver::process
        takes any numSamples, Convolver.cpp:138-154)."""
        return process_any(self.ir, state, ins, self.parallel, backend=backend)

    @span("entry.Convolver.process_offline")
    def process_offline(self, ins: torch.Tensor,
                        backend: Optional[str] = None) -> torch.Tensor:
        """Convolve whole signals. The first call on a lazily prepared bank
        attaches the offline tail (the section spectra are kept)."""
        if self.ir is not None and self.ir.tail is None and self._tail_lazy:
            tail, shift = mono._make_offline_tail(self.scheme, self._bank, self._dtype,
                                                  self._backend, self.ir.head_taps.device)
            self.ir = dataclasses.replace(self.ir, tail=tail, tail_shift=shift)
        return process_offline(self.ir, ins, self.parallel, backend=backend)

    def reset(self, *, in_chan: Optional[int] = None, out_chan: Optional[int] = None,
              state=None, dtype: torch.dtype = torch.float32):
        """Streaming-state reset (reference Convolver::reset, :80-104). With
        no channel returns a fresh full state; with channels and the current
        ``state``, a new state with only that channel's history zeroed.
        Keyword-only, as in the JAX package."""
        if in_chan is None and out_chan is None:
            return self.init_state(dtype)
        if state is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE,
                                    "per-channel reset needs the current state")
        if self.parallel:
            if in_chan is None or in_chan >= self.num_ins:
                raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE, str(in_chan))
            idx = (in_chan,)
        else:
            if out_chan is None or out_chan >= self.num_outs:
                raise ConvolveException(ConvolveError.OUT_CHAN_OUT_OF_RANGE, str(out_chan))
            if in_chan is None or in_chan >= self.num_ins:
                raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE, str(in_chan))
            idx = (out_chan, in_chan)
        return reset_channel(state, idx)


# -- pure functions -----------------------------------------------------------

def reset_channel(state, idx: Tuple[int, ...]):
    """A new state with one channel's streaming history zeroed.

    ``idx`` indexes the batch prefix: ``(chan,)`` for parallel routing or
    ``(out_chan, in_chan)`` for N2M. Only tensors change: the ring
    positions and phases are host ints shared by every channel, and a zeroed
    ring is a fresh engine at any slot position, so the channel restarts like
    a new state while the others keep theirs (reference Convolver::reset,
    Convolver.cpp:80-104)."""
    if isinstance(state, torch.Tensor):
        out = state.clone()
        out[idx] = 0
        return out
    if isinstance(state, tuple):
        return tuple(reset_channel(s, idx) for s in state)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: reset_channel(getattr(state, f.name), idx)
            for f in dataclasses.fields(state)})
    return state


def _broadcast(ir: mono.MonoIR, ins: torch.Tensor) -> torch.Tensor:
    """ins (N, L) as the (M, N, L) input of the N2M matrix: a stride-0 view."""
    return ins[None].expand((ir.head_taps.shape[0],) + tuple(ins.shape))


@span("engine.matrix.reduce")
def _reduce(y: torch.Tensor) -> torch.Tensor:
    """The N2M matrix's (M, N, L) outputs summed over the input axis."""
    return y.sum(dim=-2)


def process(ir: mono.MonoIR, state, ins: torch.Tensor, parallel: bool,
            backend: Optional[str] = None):
    """Streaming multichannel step. N2M: ir leading dims (M, N), ins (N, L)
    -> (M, L) by the sum over the input axis (reference NToMonoConvolve's
    accumulate loop). Parallel: ir leading dim (C,), ins (C, L) -> (C, L)."""
    if parallel:
        return mono.process(ir, state, ins, backend=backend)
    with span("engine.matrix.process"):
        new_state, y = mono.process(ir, state, _broadcast(ir, ins), backend=backend)
        return new_state, _reduce(y)


def process_any(ir: mono.MonoIR, state: mono.MonoStreamState, ins: torch.Tensor,
                parallel: bool, backend: Optional[str] = None
                ) -> Tuple[mono.MonoStreamState, torch.Tensor]:
    """Sample-granular multichannel step: any block length, routed as
    :func:`process`."""
    if parallel:
        return mono.process_any(ir, state, ins, backend=backend)
    with span("engine.matrix.process"):
        new_state, y = mono.process_any(ir, state, _broadcast(ir, ins), backend=backend)
        return new_state, _reduce(y)


def process_offline(ir: mono.MonoIR, ins: torch.Tensor, parallel: bool,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Whole-signal multichannel convolution, routed as :func:`process`."""
    if parallel:
        return mono.process_offline(ir, ins, backend=backend)
    with span("engine.matrix.process"):
        return _reduce(mono.process_offline(ir, _broadcast(ir, ins), backend=backend))
