"""Non-uniform partitioned convolution schemes: the hop-aligned streaming engine.

Counterpart of ``hisstools_library_tpu/models/mono.py`` (reference
``HISSTools::MonoConvolve``): an optional time-domain head plus up to four
partitioned sections of increasing FFT size (``PartitionScheme``, the presets
of MonoConvolve.cpp:26-31), prepared once (:func:`prepare_ir`) and streamed in
blocks that are whole multiples of the largest hop (:func:`process`).

:func:`process` runs one of three paths, chosen by the state it is given:

- a :class:`MonoBlockState` (:func:`init_block_state`): the TWO-TIER path. A
  near ring (the final section's first G-1 partitions plus the zero-delay
  ``block0`` term) runs as one K8 call; the far ring (the IR past G hops,
  re-partitioned at hop G*h) runs as K1 -> K7 -> K4.
- a :class:`MonoState` and an IR with ``block0``: the COLLAPSED path. The final
  section plus ``block0`` replace every section (K1 -> K7 -> lag-0 product ->
  K4); the smaller sections' states are refreshed from the block's tail (K10
  at N = 256, 1024 and K1 at 4096).
- otherwise the per-section path: the head (``time_domain``) and each section
  through :meth:`PartitionedConvolve.process`.

:func:`process_any` is the sample-granular path: blocks of ANY length (an
audio callback's), each section firing only where its own hop boundary falls
(:meth:`partitioned.PartitionedConvolve.step_any`; K9 for the sections at N <=
1024, K1 -> MAC -> K6 above). :func:`stream_state_from_aligned` and
:func:`stream_state_from_block` hand a hop-aligned stream over to it.
:func:`process_offline` convolves a whole signal with no sequential
dependency: through the prepared offline tail (one uniform engine, K5), or
section by section (the small ones as direct FIRs whose taps come back
through K11, the large ones through the fused chain: K2 -> K3 -> K4 at 4096,
K5 at 16384).

Every function returns new states and leaves the ones it was given as they
were. States and prepared IRs convert to and from numpy (``from_numpy`` /
``numpy``), so a stream of the JAX package continues here and the reverse.
Entry points build on the card unless ``device`` names another. With
``HISSTOOLS_DEBUG_STAGES=1``, :meth:`MonoConvolve.set` keeps the host IR and
:meth:`MonoConvolve.process_offline` first prints a per-stage SNR report
(:func:`utils.debug_stages.maybe_report`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import Split, array_from, resolve_device, tensor_from
from ..fft import api as fft_api
from ..utils.profiling import span
from . import partitioned as part
from . import time_domain as td
from .offline import choose_fft_size


class LatencyMode(enum.Enum):
    Zero = 0
    Short = 1
    Medium = 2


@dataclasses.dataclass(frozen=True)
class SectionPlan:
    """One partitioned section: FFT size + the IR window it owns."""
    fft_size: int
    offset: int
    length: int  # 0 = remainder of the IR


@dataclasses.dataclass(frozen=True)
class PartitionScheme:
    """Static partition plan (reference setPartitions, MonoConvolve.cpp:203-258)."""

    sizes: Tuple[int, ...]
    zero_latency: bool

    def __post_init__(self):
        prev = 0
        for s in self.sizes:
            log2s = s.bit_length() - 1
            if (1 << log2s) != s or not (5 <= log2s <= 20) or s <= prev:
                raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                        f"invalid FFT size/order {self.sizes}")
            prev = s
        if not self.sizes:
            raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                    "no valid FFT sizes given")
        if len(self.sizes) > 4:
            # sections() builds plans for at most four sizes (A < B < C < D);
            # extra sizes would silently drop IR coverage.
            raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                    f"at most 4 FFT sizes supported, got "
                                    f"{len(self.sizes)}")

    @classmethod
    def from_latency(cls, mode: LatencyMode) -> "PartitionScheme":
        if mode == LatencyMode.Zero:
            return cls((256, 1024, 4096, 16384), True)
        if mode == LatencyMode.Short:
            return cls((256, 1024, 4096, 16384), False)
        return cls((1024, 4096, 16384), False)

    @classmethod
    def for_latency_budget(cls, samples: int) -> "PartitionScheme":
        """Throughput-optimal scheme whose output latency fits the budget: a
        single uniform section at N = 2 * budget (hop <= budget, N <= 2^17);
        budgets below the Medium preset's latency fall back to the reference
        presets (MonoConvolve.cpp:26-31)."""
        if samples < 128:
            return cls.from_latency(LatencyMode.Zero)
        if samples < 512:
            return cls.from_latency(LatencyMode.Short)
        if samples < 1024:
            return cls.from_latency(LatencyMode.Medium)
        n = 1 << min(samples.bit_length(), 17)  # hop = N/2 <= budget
        return cls((n,), zero_latency=False)

    @property
    def latency(self) -> int:
        """Output delay in samples (0 for zero-latency, else A/2)."""
        return 0 if self.zero_latency else self.sizes[0] >> 1

    @property
    def head_taps(self) -> int:
        return self.sizes[0] >> 1 if self.zero_latency else 0

    def sections(self) -> List[SectionPlan]:
        """The per-section IR windows (reference createPart logic)."""
        sizes = self.sizes
        n = len(sizes)
        offset = sizes[0] >> 1 if self.zero_latency else 0
        plans: List[SectionPlan] = []

        def add(size: int, nxt: int):
            nonlocal offset
            cover = (nxt - size) >> 1
            plans.append(SectionPlan(size, offset, cover))
            offset += cover

        if n == 4:
            add(sizes[0], sizes[1])
        if n > 2:
            add(sizes[n - 3], sizes[n - 2])
        if n > 1:
            add(sizes[n - 2], sizes[n - 1])
        plans.append(SectionPlan(sizes[-1], offset, 0))  # resizable final section
        return plans


def _split_or_none(src, device) -> Optional[Split]:
    return None if src is None else Split.from_numpy(src, device)


@dataclasses.dataclass
class MonoState:
    """Hop-aligned streaming state: TD-head tail + one PartitionedState per
    section."""
    head: torch.Tensor
    sections: Tuple[part.PartitionedState, ...]

    @classmethod
    def from_numpy(cls, src, device=None) -> "MonoState":
        """From any object with these fields holding arrays (the JAX
        package's ``MonoState``, or :meth:`numpy`'s result), copied onto
        ``device`` (the card unless named)."""
        return cls(tensor_from(src.head, device),
                   tuple(part.PartitionedState.from_numpy(s, device)
                         for s in src.sections))

    def numpy(self) -> "MonoState":
        return MonoState(array_from(self.head), tuple(s.numpy() for s in self.sections))


@dataclasses.dataclass
class MonoStreamState:
    """Sample-granular streaming state: TD-head tail + one
    :class:`partitioned.StreamState` per section. :func:`process_any` takes
    blocks of any length with it (reference Convolver::process semantics,
    Convolver.cpp:138-154: the engine, not the caller, owns hop alignment)."""
    head: torch.Tensor
    sections: Tuple[part.StreamState, ...]

    @classmethod
    def from_numpy(cls, src, device=None) -> "MonoStreamState":
        """From any object with these fields holding arrays (the JAX
        package's ``MonoStreamState``, or :meth:`numpy`'s result), copied
        onto ``device`` (the card unless named)."""
        return cls(tensor_from(src.head, device),
                   tuple(part.StreamState.from_numpy(s, device) for s in src.sections))

    def numpy(self) -> "MonoStreamState":
        return MonoStreamState(array_from(self.head),
                               tuple(s.numpy() for s in self.sections))


@dataclasses.dataclass
class MonoIR:
    """Prepared impulse on the device: head taps + per-section spectra.

    ``tail``/``tail_shift`` (optional) re-partition the whole IR at the
    offline-optimal uniform FFT size for offline processing; streaming never
    touches them. ``block0`` (optional) is the zero-delay partition of the
    collapsed and two-tier block paths: the packed spectrum, at the final
    section's FFT size, of the IR taps that the head and the non-final
    sections cover, shifted by the scheme latency. ``far`` (optional) is the
    IR past G final hops re-partitioned at hop G*h for the two-tier path."""
    head_taps: torch.Tensor
    spectra: Tuple[Split, ...]
    tail: Optional[Split] = None
    # Structure, not a leaf: the JAX twin keeps it in its treedef, so
    # utils.checkpoint's leaves match that package's tree_flatten.
    tail_shift: int = dataclasses.field(default=0, metadata={"static": True})
    block0: Optional[Split] = None
    far: Optional[Split] = None

    @classmethod
    def from_numpy(cls, src, device=None) -> "MonoIR":
        """From any object with these fields holding arrays (the JAX
        package's ``MonoIR``, or :meth:`numpy`'s result), copied onto
        ``device`` (the card unless named)."""
        return cls(tensor_from(src.head_taps, device),
                   tuple(Split.from_numpy(s, device) for s in src.spectra),
                   _split_or_none(src.tail, device), int(src.tail_shift),
                   _split_or_none(src.block0, device),
                   _split_or_none(src.far, device))

    def numpy(self) -> "MonoIR":
        opt = (lambda s: None if s is None else s.numpy())
        return MonoIR(array_from(self.head_taps), tuple(s.numpy() for s in self.spectra),
                      opt(self.tail), self.tail_shift, opt(self.block0), opt(self.far))


@dataclasses.dataclass
class MonoBlockState:
    """Two-tier hop-aligned streaming state (see :func:`_process_block_two_tier`).

    ``near``: ring of the final section's first G-1 partitions (hop h);
    ``far``: ring of the far-IR re-partition (hop G*h, :attr:`MonoIR.far`);
    ``hist``/``hpos``: raw input history as a hop ring, (..., S, h) rows, next
    write row ``hpos`` (a host int), oldest row at ``hpos``, carrying the last
    S*h input samples so a hand-off to the per-section path
    (:func:`aligned_state_from_block`) rebuilds every section state."""
    near: part.PartitionedState
    far: part.PartitionedState
    hist: torch.Tensor
    hpos: int = 0

    @classmethod
    def from_numpy(cls, src, device=None) -> "MonoBlockState":
        """From any object with these fields holding arrays (the JAX
        package's ``MonoBlockState``, or :meth:`numpy`'s result), copied
        onto ``device`` (the card unless named)."""
        return cls(part.PartitionedState.from_numpy(src.near, device),
                   part.PartitionedState.from_numpy(src.far, device),
                   tensor_from(src.hist, device), int(np.asarray(src.hpos)))

    def numpy(self) -> "MonoBlockState":
        return MonoBlockState(self.near.numpy(), self.far.numpy(),
                              array_from(self.hist), self.hpos)


class MonoConvolve:
    """Non-uniform partitioned convolver for one IR. Pure processing
    functions; configuration is host-side."""

    def __init__(self, max_length: int = 16384,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None):
        self.scheme = scheme if scheme is not None else PartitionScheme.from_latency(latency)
        self.max_length = max_length
        self.plans = self.scheme.sections()
        self.ir: Optional[MonoIR] = None
        self.length = 0
        self._ir_host = None  # held only until a lazy offline tail is built
        self._ir_debug = None  # the host IR, kept while debug_stages is enabled

    def resize(self, length: int) -> ConvolveError:
        """Grow the final section's capacity (reference MonoConvolve::resize,
        :101-111). Functionally a no-op here: spectra are rebuilt by set()."""
        self.max_length = max(self.max_length, length)
        return ConvolveError.NONE

    def set(self, ir, dtype: torch.dtype = torch.float32, request_resize: bool = True,
            backend: Optional[str] = None, offline_tail: Optional[bool] = None,
            device=None) -> ConvolveError:
        """Prepare the IR on ``device`` (the card unless named): head taps +
        per-section partition spectra (reference MonoConvolve::set,
        :118-140).

        ``offline_tail``: None (the default) builds the throughput-optimal
        offline tail lazily, on the first :meth:`process_offline` (an extra
        full-IR transform and about an IR's worth of device memory that
        streaming never touches); True builds it now; False never builds it
        (per-section offline processing)."""
        ir = np.asarray(ir)
        err = ConvolveError.NONE
        if ir.shape[-1] > self.max_length:
            if request_resize:
                self.resize(ir.shape[-1])
            else:
                # Reference semantics (MonoConvolve.cpp:117-139): without a
                # resize the IR is still loaded, clamped to the declared
                # capacity, and the error reports the truncation.
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                ir = ir[..., :self.max_length]
        from ..utils import debug_stages
        # The host IR is kept only to build a lazy tail, and released then.
        self._ir_host = ir if offline_tail is None else None
        self._ir_debug = ir if debug_stages.enabled() else None
        self._dtype, self._backend = dtype, backend
        self.ir = prepare_ir(self.scheme, ir, self.max_length, dtype, backend,
                             offline_tail=bool(offline_tail), device=device)
        self.length = ir.shape[-1]
        return err

    def init_state(self, batch_shape=(), dtype: torch.dtype = torch.float32) -> MonoState:
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_state(self.scheme, self.ir, batch_shape, dtype)

    def init_block_state(self, batch_shape=(), dtype: torch.dtype = torch.float32
                         ) -> MonoBlockState:
        """State for the two-tier block path (requires a far-tier IR; blocks
        must be multiples of ``ir.far.shape[-1]`` samples)."""
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_block_state(self.scheme, self.ir, batch_shape, dtype)

    @property
    def block_size(self) -> int:
        """Block quantum of :meth:`process` (the largest section's hop)."""
        return self.scheme.sizes[-1] >> 1

    def process(self, state, x: torch.Tensor, backend: Optional[str] = None):
        return process(self.ir, state, x, backend=backend)

    def init_stream_state(self, batch_shape=(), dtype: torch.dtype = torch.float32
                          ) -> MonoStreamState:
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_stream_state(self.scheme, self.ir, batch_shape, dtype)

    def process_any(self, state: MonoStreamState, x: torch.Tensor,
                    backend: Optional[str] = None
                    ) -> Tuple[MonoStreamState, torch.Tensor]:
        """Stream a block of ANY length (the sample-granular real-time path)."""
        return process_any(self.ir, state, x, backend=backend)

    def process_offline(self, x: torch.Tensor,
                        backend: Optional[str] = None) -> torch.Tensor:
        """Convolve a whole signal (:func:`process_offline`). After a
        ``set(..., offline_tail=None)`` the first call attaches the offline
        tail to the prepared IR; the head and section spectra do not depend
        on it and are kept."""
        if self.ir is not None and self.ir.tail is None and self._ir_host is not None:
            tail, shift = _make_offline_tail(self.scheme, self._ir_host, self._dtype,
                                             self._backend, self.ir.head_taps.device)
            self.ir = dataclasses.replace(self.ir, tail=tail, tail_shift=shift)
            self._ir_host = None
        if self._ir_debug is not None:
            from ..utils import debug_stages
            debug_stages.maybe_report(self._ir_debug, x, None, backend,
                                      "MonoConvolve.process_offline")
        return process_offline(self.ir, x, backend=backend)


# -- pure functional API ---------------------------------------------------------

def prepare_ir(scheme: PartitionScheme, ir, max_length: int = 0,
               dtype: torch.dtype = torch.float32, backend: Optional[str] = None,
               offline_tail: bool = True, device=None) -> MonoIR:
    """Build the prepared IR for a scheme on ``device`` (the card unless
    named). ``ir``: (..., L) host array. ``max_length`` > 0 clamps the IR to
    that many taps. With ``offline_tail`` the whole IR is also partitioned at
    the offline-optimal uniform FFT size (:attr:`MonoIR.tail`)."""
    device = resolve_device(device)
    ir = np.asarray(ir)
    if max_length and ir.shape[-1] > max_length:
        ir = ir[..., :max_length]
    head = td.make_taps(ir, 0, scheme.head_taps) if scheme.head_taps else \
        np.zeros(ir.shape[:-1] + (0,), ir.dtype)
    spectra = tuple(
        part.impulse_spectra(ir, plan.fft_size, plan.offset, plan.length, dtype,
                             backend, device=device)
        for plan in scheme.sections())
    tail, tail_shift = (_make_offline_tail(scheme, ir, dtype, backend, device)
                        if offline_tail else (None, 0))
    block0 = _block_lag0_spectra(scheme, ir, dtype, backend, device)
    far = (_far_tier_spectra(scheme, ir, dtype, backend, device)
           if block0 is not None else None)
    return MonoIR(torch.as_tensor(head).to(device=device, dtype=dtype), spectra,
                  tail, tail_shift, block0, far)


def _block_lag0_spectra(scheme: PartitionScheme, ir, dtype, backend,
                        device=None) -> Optional[Split]:
    """Zero-delay partition for the block paths: at block granularity
    B = largest hop, head + non-final sections sum to ``conv(x, ir[0 : B -
    latency])`` delayed by the scheme latency, which the final section's own
    [prev | current] frame can compute. One packed spectrum of those taps
    (latency-shifted, FFT size 2B) therefore replaces every small engine."""
    b = scheme.sizes[-1] >> 1
    cover = b - scheme.latency
    if cover <= 0:
        return None  # single-section scheme: nothing below the final section
    ir = np.asarray(ir)
    shifted = np.zeros(ir.shape[:-1] + (b,), np.float64)
    take = min(cover, ir.shape[-1])
    shifted[..., scheme.latency:scheme.latency + take] = ir[..., :take]
    return part.impulse_spectra(shifted, 2 * b, 0, 0, dtype, backend, device=device)


def _far_hop(scheme: PartitionScheme, ir_len: int) -> int:
    """Far-tier hop for the two-tier path: the offline-optimal uniform hop
    (``choose_fft_size / 2``) snapped to a power-of-two multiple G >= 2 of the
    final section's hop, with the far FFT size 2*G*h inside the engine range.
    Returns 0 when no valid multiple exists. (G is clamped to at least 2 even
    where the offline-optimal hop is not above the final hop, as in the JAX
    package.)"""
    h = scheme.sizes[-1] >> 1
    g = max(choose_fft_size(ir_len) // (2 * h), 2)
    while g >= 2 and 2 * g * h > (1 << part.MAX_FFT_SIZE_LOG2):
        g >>= 1
    return g * h if g >= 2 else 0


def _far_tier_spectra(scheme: PartitionScheme, ir, dtype, backend,
                      device=None) -> Optional[Split]:
    """Far-IR re-partition for the two-tier path: the IR beyond G final hops,
    chunked at hop H2 = G*h (FFT size 2*H2, IR offset H2 - latency), so its
    conv is delayed by the scheme latency exactly like the near tier."""
    ir = np.asarray(ir)
    h2 = _far_hop(scheme, ir.shape[-1])
    if not h2:
        return None
    o2 = h2 - scheme.latency
    if ir.shape[-1] <= o2:
        return None  # far tier would be empty
    return part.impulse_spectra(ir, 2 * h2, o2, 0, dtype, backend, device=device)


def _make_offline_tail(scheme: PartitionScheme, ir, dtype, backend, device=None):
    """The offline tail: the whole IR re-partitioned at the throughput-optimal
    uniform FFT size, with the ``tail_shift`` realignment."""
    ir = np.asarray(ir)
    if ir.shape[-1] == 0:
        return None, 0
    nprime = choose_fft_size(ir.shape[-1])
    shift = (nprime >> 1) - scheme.latency
    if shift < 0:
        return None, 0
    return part.impulse_spectra(ir, nprime, 0, 0, dtype, backend, device=device), shift


def init_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
               dtype: torch.dtype = torch.float32, device=None) -> MonoState:
    """Fresh per-section state, on the IR's device unless ``device`` is given."""
    device = ir.head_taps.device if device is None else device
    shape = tuple(batch_shape)
    head_len = max(int(ir.head_taps.shape[-1]) - 1, 1)
    sections = []
    for plan, spec in zip(scheme.sections(), ir.spectra):
        h = plan.fft_size >> 1
        p = spec.shape[-2]
        sections.append(part.PartitionedState(
            prev=torch.zeros(shape + (h,), dtype=dtype, device=device),
            ring=Split.zeros(shape + (p, h), dtype, device), pos=0))
    return MonoState(torch.zeros(shape + (head_len,), dtype=dtype, device=device),
                     tuple(sections))


def init_stream_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
                      dtype: torch.dtype = torch.float32, device=None) -> MonoStreamState:
    """Fresh sample-granular state (the any-block-size path), on the IR's
    device unless ``device`` is given."""
    device = ir.head_taps.device if device is None else device
    shape = tuple(batch_shape)
    head_len = max(int(ir.head_taps.shape[-1]) - 1, 1)
    sections = []
    for plan, spec in zip(scheme.sections(), ir.spectra):
        eng = part.PartitionedConvolve(plan.fft_size)
        eng.spectra = spec
        sections.append(eng.init_stream_state(shape, dtype, device))
    return MonoStreamState(torch.zeros(shape + (head_len,), dtype=dtype, device=device),
                           tuple(sections))


def init_block_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
                     dtype: torch.dtype = torch.float32, device=None) -> MonoBlockState:
    """Fresh state for the two-tier path (requires an IR prepared with a far
    tier). Blocks fed to :func:`process` with it must be multiples of the far
    hop (``ir.far.shape[-1]`` samples)."""
    if ir.far is None or ir.block0 is None:
        raise ConvolveException(
            ConvolveError.MEM_UNAVAILABLE,
            "IR has no far tier: prepare_ir builds one for multi-section "
            "schemes whose IR extends past the far hop")
    del scheme  # the prepared IR fully determines the state shapes
    device = ir.head_taps.device if device is None else device
    shape = tuple(batch_shape)
    h = ir.spectra[-1].shape[-1]
    p = ir.spectra[-1].shape[-2]
    h2 = ir.far.shape[-1]
    p2 = ir.far.shape[-2]
    g = h2 // h
    near = part.PartitionedState(
        prev=torch.zeros(shape + (h,), dtype=dtype, device=device),
        ring=Split.zeros(shape + (g - 1, h), dtype, device), pos=0)
    far = part.PartitionedState(
        prev=torch.zeros(shape + (h2,), dtype=dtype, device=device),
        ring=Split.zeros(shape + (p2, h2), dtype, device), pos=0)
    # Hop rows covering both rebuild reach-backs: the final section's state
    # ((P+1)*h samples) for the per-section hand-off, and the far ring's
    # ((P2+1)*H2 samples) for block_state_from_hist.
    s = max(p + 1, (p2 + 1) * g)
    hist = torch.zeros(shape + (s, h), dtype=dtype, device=device)
    return MonoBlockState(near, far, hist, 0)


def _hist_push(hist: torch.Tensor, hpos: int, x: torch.Tensor
               ) -> Tuple[torch.Tensor, int]:
    """Append ``x``'s hop rows to the raw-history ring (oldest at ``hpos``),
    as a new tensor: at most two slice copies, no index tensor built on the
    host."""
    s = hist.shape[-2]
    h = hist.shape[-1]
    t = x.shape[-1] // h
    rows = x.reshape(*x.shape[:-1], t, h).to(hist.dtype)
    if t >= s:
        return rows[..., t - s:, :].clone(), 0
    out = hist.clone()
    first = min(t, s - hpos)  # rows up to the ring's end, the rest wrap to 0
    out[..., hpos:hpos + first, :] = rows[..., :first, :]
    out[..., :t - first, :] = rows[..., first:, :]
    return out, (hpos + t) % s


def _hist_linear(hist: torch.Tensor, hpos: int) -> torch.Tensor:
    """Unroll the raw-history ring oldest-first into (..., S*h) samples."""
    lin = torch.roll(hist, -hpos, dims=-2)
    return lin.reshape(*lin.shape[:-2], hist.shape[-2] * hist.shape[-1])


def _process_block_two_tier(ir: MonoIR, state: MonoBlockState, x: torch.Tensor,
                            backend: Optional[str]
                            ) -> Tuple[MonoBlockState, torch.Tensor]:
    """Two-tier hop-aligned processing: near ring + far ring + zero-delay term.

    Coverage: ``block0`` ir[0 : h - latency] (lag 0 on the hop's own frame),
    the near ring ir[h - latency : G*h - latency] (the final section's first
    G-1 partitions at hop h) and the far ring ir[G*h - latency :] re-chunked at
    hop G*h. Each term delays its conv by the scheme latency, so the sum is
    the scheme's exact output, while the dominant far MAC runs at the offline
    engine's hop."""
    h = ir.spectra[-1].shape[-1]
    h2 = ir.far.shape[-1]
    g = h2 // h
    if x.shape[-1] % h2:
        raise ValueError(
            f"two-tier block length {x.shape[-1]} must be a multiple of the "
            f"far hop {h2}")
    near_spec = Split(ir.spectra[-1].re[..., :g - 1, :],
                      ir.spectra[-1].im[..., :g - 1, :])
    # assume_pos0: both tier states come from init_block_state or a previous
    # process_block, which are slot-normalised (pos == 0).
    near, y = part.PartitionedConvolve.process_block(
        near_spec, state.near, x, backend=backend, lag0=ir.block0,
        assume_pos0=True)
    far, y_far = part.PartitionedConvolve.process_block(
        ir.far, state.far, x, backend=backend, assume_pos0=True)
    hist, hpos = _hist_push(state.hist, state.hpos, x)
    return MonoBlockState(near, far, hist, hpos), y + y_far


def aligned_state_from_block(ir: MonoIR, state: MonoBlockState,
                             backend: Optional[str] = None) -> MonoState:
    """Project a two-tier block state onto the per-section :class:`MonoState`.

    Every section's state is a function of the last (P_final+1)*h input
    samples, which ``state.hist`` carries, so the rebuild transforms the same
    frames the per-section engine would have and the hand-off continues as if
    the per-section path had run throughout."""
    tail = _hist_linear(state.hist, state.hpos)
    keep = max(int(ir.head_taps.shape[-1]) - 1, 1)
    if ir.head_taps.shape[-1]:
        head = tail[..., tail.shape[-1] - keep:].clone()
    else:
        head = tail.new_zeros(tail.shape[:-1] + (keep,))
    sections = tuple(_refresh_aligned_section(spec, tail, backend)
                     for spec in ir.spectra)
    return MonoState(head, sections)


def stream_state_from_block(ir: MonoIR, state: MonoBlockState,
                            backend: Optional[str] = None) -> MonoStreamState:
    """Hand a two-tier block state to the sample-granular path."""
    return stream_state_from_aligned(
        ir, aligned_state_from_block(ir, state, backend), backend)


def stream_state_from_aligned(ir: MonoIR, state: MonoState,
                              backend: Optional[str] = None) -> MonoStreamState:
    """Lift a hop-aligned :class:`MonoState` into the sample-granular form;
    streaming continues from the hop boundary as if it had never left the
    aligned form (each section's output store comes from its ring: K11 at
    N = 256, 1024 and K6 at 4096, 16384 on the card)."""
    sections = tuple(
        part.PartitionedConvolve.stream_from_aligned(spec, sec, backend)
        for spec, sec in zip(ir.spectra, state.sections))
    return MonoStreamState(state.head, sections)


@span("engine.mono.process_any")
def process_any(ir: MonoIR, state: MonoStreamState, x: torch.Tensor,
                backend: Optional[str] = None
                ) -> Tuple[MonoStreamState, torch.Tensor]:
    """Stream a block of ANY length through the scheme. Each section fires
    only on its own hop boundaries: the reference's per-section RW counters
    (PartitionedConvolve.cpp:243-385) threaded through MonoConvolve::process
    (MonoConvolve.cpp:179-201). The head is the grouped conv1d of
    :mod:`time_domain`, in full FP32 (TF32 off). The outputs are summed in
    place into the head's (a new tensor), never into a section's."""
    head_state = state.head
    if ir.head_taps.shape[-1]:
        head_state, out = td.TimeDomainConvolve.process(ir.head_taps, state.head, x)
    else:
        out = torch.zeros_like(x)
    new_sections = []
    for spec, sec_state in zip(ir.spectra, state.sections):
        sec_state, y = part.PartitionedConvolve.step_any(spec, sec_state, x,
                                                         backend=backend)
        new_sections.append(sec_state)
        out += y
    return MonoStreamState(head_state, tuple(new_sections)), out


def block_state_from_hist(ir: MonoIR, hist: torch.Tensor,
                          backend: Optional[str] = None) -> MonoBlockState:
    """Build a two-tier block state from raw input history.

    ``hist``: the last max(P_final+1, (P2+1)*G)*h raw input samples ending at
    the stream head (zero-padded on the left when the stream is younger). The
    near and far rings are rebuilt from it by the same frame refresh the
    per-section hand-off uses."""
    h = ir.spectra[-1].shape[-1]
    p = ir.spectra[-1].shape[-2]
    p2 = ir.far.shape[-2]
    g = ir.far.shape[-1] // h
    need = max(p + 1, (p2 + 1) * g) * h
    if hist.shape[-1] != need:
        raise ValueError(f"hist must carry {need} samples, got {hist.shape[-1]}")
    near_full = _refresh_aligned_section(
        Split(ir.spectra[-1].re[..., :g - 1, :],
              ir.spectra[-1].im[..., :g - 1, :]), hist, backend)
    far_full = _refresh_aligned_section(ir.far, hist, backend)
    rows = hist.reshape(*hist.shape[:-1], need // h, h).clone()
    return MonoBlockState(near_full, far_full, rows, 0)


@span("engine.mono.process")
def process(ir: MonoIR, state: Union[MonoState, MonoBlockState], x: torch.Tensor,
            backend: Optional[str] = None
            ) -> Tuple[Union[MonoState, MonoBlockState], torch.Tensor]:
    """Stream a block whose length is a multiple of the largest hop.

    With a :class:`MonoBlockState` the scheme runs as the two-tier engine
    (block quantum = the far hop) and a new :class:`MonoBlockState` comes
    back. With ``ir.block0`` present the whole scheme runs as one uniform
    engine per block (:func:`_process_block_collapsed`); otherwise each
    section and the head run on their own."""
    if isinstance(state, MonoBlockState):
        return _process_block_two_tier(ir, state, x, backend)
    if (ir.block0 is not None and x.shape[-1] > 0
            and x.shape[-1] % (ir.spectra[-1].shape[-1]) == 0):
        return _process_block_collapsed(ir, state, x, backend)
    out = torch.zeros_like(x)
    head_state = state.head
    if ir.head_taps.shape[-1]:
        head_state, y = td.TimeDomainConvolve.process(ir.head_taps, state.head, x)
        out = out + y
    new_sections = []
    for spec, sec_state in zip(ir.spectra, state.sections):
        sec_state, y = part.PartitionedConvolve.process(spec, sec_state, x,
                                                        backend=backend)
        new_sections.append(sec_state)
        out = out + y
    return MonoState(head_state, tuple(new_sections)), out


@span("engine.mono.refresh_section")
def _refresh_aligned_section(spec: Split, tail: torch.Tensor,
                             backend: Optional[str]) -> part.PartitionedState:
    """Rebuild a section's hop-aligned state from the last input samples
    ``tail``: its ring holds the newest P frame spectra, reaching back
    (P-1)*h + N samples, oldest-first with pos = 0 (process_block's layout)."""
    h = spec.shape[-1]
    n = 2 * h
    p = spec.shape[-2]
    b = tail.shape[-1]
    frames = torch.stack(
        [tail[..., b - (p - 1 - k) * h - n: b - (p - 1 - k) * h] for k in range(p)],
        dim=-2)
    re, im = fft_api.rfft(frames, backend=backend)
    return part.PartitionedState(prev=tail[..., b - h:].clone(), ring=Split(re, im),
                                 pos=0)


@span("engine.mono.collapsed")
def _process_block_collapsed(ir: MonoIR, state: MonoState, x: torch.Tensor,
                             backend: Optional[str]
                             ) -> Tuple[MonoState, torch.Tensor]:
    """Hop-aligned processing of the whole scheme as one uniform engine.

    The final section's ring MAC (lags >= 1) plus the ``block0`` zero-delay
    partition equals the sum of every section and the TD head once the caller
    hands over whole largest-hop blocks. The non-final section states and the
    head tail are refreshed from the block's tail, so a later hand-off to
    another path continues as if the per-section path had run."""
    b = ir.spectra[-1].shape[-1]  # largest hop = final section's N/2
    new_big, out = part.PartitionedConvolve.process_block(
        ir.spectra[-1], state.sections[-1], x, backend=backend, lag0=ir.block0)
    tail = x[..., x.shape[-1] - b:]
    head_state = state.head
    if ir.head_taps.shape[-1]:
        keep = state.head.shape[-1]
        head_state = tail[..., b - keep:].clone()
    new_sections = [_refresh_aligned_section(spec, tail, backend)
                    for spec in ir.spectra[:-1]]
    new_sections.append(new_big)
    return MonoState(head_state, tuple(new_sections)), out


# Sections at or below this FFT size run as direct FIRs offline (the TPU
# package's threshold, kept so both packages split a scheme alike): a
# few-thousand-tap depthwise convolution instead of thousands of tiny hops.
_DIRECT_SECTION_MAX_FFT = 1024
_DIRECT_SECTION_MAX_TAPS = 4096


def _direct_eligible(fft_size: int, partitions: int) -> bool:
    """The offline direct-FIR predicate (shared by every caller, so no
    section is dropped or counted twice)."""
    h = fft_size >> 1
    return (fft_size <= _DIRECT_SECTION_MAX_FFT
            and h * (partitions + 1) <= _DIRECT_SECTION_MAX_TAPS)


def section_taps_from_spectra(spec: Split) -> torch.Tensor:
    """A section's equivalent direct-FIR taps from its partition spectra: H
    zero taps (the section emits window tap m at delay H + m) followed by the
    IR window (rifft(rfft(c)) = 2N c; K11 at N = 256, 1024 on the card)."""
    h = spec.shape[-1]
    n = 2 * h
    chunks = fft_api.rifft(spec.re, spec.im) * (1.0 / (2.0 * n))  # (..., P, N)
    lead = spec.re.shape[:-2]
    window = chunks[..., :h].reshape(*lead, spec.shape[-2] * h)
    return torch.cat([window.new_zeros(lead + (h,)), window], dim=-1)


def _section_offline_direct(spec: Split, x: torch.Tensor) -> torch.Tensor:
    """One small section evaluated as a direct FIR instead of overlap-save
    (a grouped conv1d in full FP32, TF32 off)."""
    return td.fir_offline(x, section_taps_from_spectra(spec)).to(x.dtype)


@span("engine.mono.tail_offline")
def _tail_offline(tail: Split, x: torch.Tensor, shift: int,
                  backend: Optional[str]) -> torch.Tensor:
    """The re-partitioned IR as one uniform engine, its output realigned by
    dropping ``shift`` leading samples. With the "pallas" backend (the
    default on CUDA) it is the fused chain, K5 at N = 2^14..2^17."""
    if fft_api._resolve(backend, x.device) == "pallas":
        y = part.PartitionedConvolve._process_offline_fused(tail, x, shift=shift)
        if y is not None:
            return y
    L = x.shape[-1]
    y = part.PartitionedConvolve.process_offline(
        tail, torch.nn.functional.pad(x, (0, shift)), backend=backend)
    return y[..., shift:shift + L]


@span("engine.mono.process_offline")
def process_offline(ir: MonoIR, x: torch.Tensor,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Whole-signal convolution through the scheme, with no sequential
    dependency. With the prepared offline tail it is one uniform engine over
    the whole IR; otherwise the head and the small sections run as direct
    FIRs and the larger sections through the partitioned offline engine
    (the fused chain with the "pallas" backend)."""
    if ir.tail is not None:
        return _tail_offline(ir.tail, x, ir.tail_shift, backend)
    out = torch.zeros_like(x)
    if ir.head_taps.shape[-1]:
        out = out + td.fir_offline(x, ir.head_taps)
    for spec in ir.spectra:
        if _direct_eligible(2 * spec.shape[-1], spec.shape[-2]):
            out = out + _section_offline_direct(spec, x)
        else:
            out = out + part.PartitionedConvolve.process_offline(spec, x, backend=backend)
    return out
