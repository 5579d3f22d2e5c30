"""Sinusoidal-model partial tracking, on torch tensors.

Counterpart of ``hisstools_library_tpu/models/partial_tracker.py``
(reference ``partial_tracker``, PartialTracker.hpp). The reference builds the
(peak x track) cost list, sorts it ascending and assigns greedily, skipping
peaks and tracks already assigned (:224-289). Here, as in the JAX package,
the greedy assignment runs as parallel rounds of "local dominants": under the
strict order (cost, peak-major flat index) an entry that is the minimum of
both its row and its column is extracted by the sequential greedy before
either is consumed, so every such entry is assigned in one round, its row and
column masked, and the round repeated. The JAX package loops while a finite
cost remains; here :func:`process` runs exactly min(max_peaks, max_tracks)
rounds with no host sync (each round assigns at least the global minimum, so
that many rounds always suffice, and a round after the last finite cost
selects nothing), which gives the same results. ``torch.argmin`` picks the
first minimum, the JAX tie-break.

Cost model (:344-413): frequency distance in Hz or MIDI pitch, amplitude
distance linear or dB, absolute or squared, each scaled by 1/unit (squared
costs square the scale), gated by ``max_cost``. Defaults: squared, pitch, dB,
0.5 semitone / 6 dB units, max cost 1 (:325-326). The dB floor is
``1e-300``, which is 0 in float32, so a silent track costs -inf dB in float32
as under the JAX package's weak typing.

Track states OFF / START / CONTINUE / SWITCH mirror ``track::set_peak``
(:56-73); change statistics mirror ``change_tracker`` (:75-156). States and
changes convert to and from numpy (``from_numpy`` / ``numpy``), so a JAX
tracker's state continues here on the next frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import array_from, resolve_device, tensor_from

# Track states
OFF, START, CONTINUE, SWITCH = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_peaks: int
    max_tracks: int
    square_cost: bool = True
    use_pitch: bool = True
    use_db: bool = True
    freq_scale: float = 1.0 / 0.5   # 1 / freq_unit (default 0.5 semitones)
    amp_scale: float = 1.0 / 6.0    # 1 / amp_unit (default 6 dB)
    max_cost: float = 1.0
    track_changes: bool = False

    def with_cost_calculation(self, square_cost, use_pitch, use_db):
        return dataclasses.replace(self, square_cost=square_cost,
                                   use_pitch=use_pitch, use_db=use_db)

    def with_cost_scaling(self, freq_unit, amp_unit, max_cost):
        return dataclasses.replace(self, freq_scale=1.0 / freq_unit,
                                   amp_scale=1.0 / amp_unit, max_cost=max_cost)


@dataclasses.dataclass
class TrackerState:
    freq: torch.Tensor    # (T,)
    amp: torch.Tensor     # (T,)
    state: torch.Tensor   # (T,) int32

    @staticmethod
    def init(max_tracks: int, dtype: torch.dtype = torch.float32,
             device=None) -> "TrackerState":
        device = resolve_device(device)
        return TrackerState(torch.zeros(max_tracks, dtype=dtype, device=device),
                            torch.zeros(max_tracks, dtype=dtype, device=device),
                            torch.zeros(max_tracks, dtype=torch.int32, device=device))

    @staticmethod
    def from_numpy(src, device=None) -> "TrackerState":
        """A state from any object with ``freq``, ``amp``, ``state`` arrays
        (numpy, or a JAX package TrackerState), copied onto ``device``."""
        return TrackerState(tensor_from(src.freq, device), tensor_from(src.amp, device),
                            tensor_from(src.state, device).to(torch.int32))

    def numpy(self) -> "TrackerState":
        """The same state as host numpy arrays."""
        return TrackerState(array_from(self.freq), array_from(self.amp),
                            array_from(self.state))


@dataclasses.dataclass
class Changes:
    """Per-frame assignment change statistics (change_tracker, :75-156)."""
    freq_sum: torch.Tensor
    freq_abs: torch.Tensor
    amp_sum: torch.Tensor
    amp_abs: torch.Tensor
    count: torch.Tensor

    _FIELDS = ("freq_sum", "freq_abs", "amp_sum", "amp_abs", "count")

    @staticmethod
    def from_numpy(src, device=None) -> "Changes":
        return Changes(*(tensor_from(getattr(src, f), device) for f in Changes._FIELDS))

    def numpy(self) -> "Changes":
        return Changes(*(array_from(getattr(self, f)) for f in Changes._FIELDS))


def _pitch(freq):
    return torch.log2(freq.clamp_min(1e-30) / 440.0) * 12.0 + 69.0


def _db(amp):
    return torch.log10(amp.clamp_min(1e-300)) * 20.0


def process(config: TrackerConfig, state: TrackerState,
            peak_freq: torch.Tensor, peak_amp: torch.Tensor,
            n_peaks, start_threshold) -> Tuple[TrackerState, Changes]:
    """One tracking frame (reference partial_tracker::process, :224-289).

    ``peak_freq`` / ``peak_amp``: (max_peaks,) with the first ``n_peaks``
    (an int or a 0-d tensor) valid. Returns the new track state and the
    frame's change statistics. No host sync: every shape and trip count
    comes from ``config``."""
    pk = config.max_peaks
    tr = config.max_tracks
    dtype = peak_freq.dtype
    dev = peak_freq.device

    valid = torch.arange(pk, device=dev) < n_peaks
    active = state.state != OFF

    pf = _pitch(peak_freq) if config.use_pitch else peak_freq
    tf = _pitch(state.freq) if config.use_pitch else state.freq
    pa = _db(peak_amp) if config.use_db else peak_amp
    ta = _db(state.amp) if config.use_db else state.amp

    fs = config.freq_scale ** 2 if config.square_cost else config.freq_scale
    as_ = config.amp_scale ** 2 if config.square_cost else config.amp_scale

    df = pf[:, None] - tf[None, :]
    da = pa[:, None] - ta[None, :]
    if config.square_cost:
        cost = df * df * fs + da * da * as_
    else:
        cost = torch.abs(df) * fs + torch.abs(da) * as_

    inf = torch.full((), float("inf"), dtype=dtype, device=dev)  # a fill: capturable
    mask = valid[:, None] & active[None, :] & (cost < config.max_cost)
    cost = torch.where(mask, cost, inf)

    rows_i = torch.arange(pk, device=dev)[:, None]
    cols_i = torch.arange(tr, device=dev)[None, :]
    p_asn = torch.zeros(pk, dtype=torch.bool, device=dev)
    t_asn = torch.zeros(tr, dtype=torch.bool, device=dev)
    new_f, new_a = state.freq, state.amp
    new_s = torch.full((tr,), OFF, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    sums = [zero] * 4
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(min(pk, tr)):
        row_min_j = torch.argmin(cost, dim=1)          # (pk,) ties -> lowest j
        col_min_i = torch.argmin(cost, dim=0)          # (tr,) ties -> lowest i
        sel = ((cols_i == row_min_j[:, None]) & (rows_i == col_min_i[None, :])
               & torch.isfinite(cost))                 # local dominants
        sel_p = sel.any(dim=1)
        sel_t = sel.any(dim=0)
        peak_for_track = torch.argmax(sel.to(torch.int32), dim=0)  # selected i per column

        cost = torch.where(sel_p[:, None] | sel_t[None, :], inf, cost)
        p_asn = p_asn | sel_p
        t_asn = t_asn | sel_t
        new_f = torch.where(sel_t, peak_freq[peak_for_track], new_f)
        new_a = torch.where(sel_t, peak_amp[peak_for_track], new_a)
        new_s = torch.where(sel_t, CONTINUE, new_s)

        # Change statistics of the Continue assignments (add_change, :85-108),
        # in the configured units (the values the cost was built from).
        if config.track_changes:
            for k, d in enumerate((df, df.abs(), da, da.abs())):
                sums[k] = sums[k] + torch.where(sel, d, zero).sum()
            count = count + sel.sum(dtype=torch.int32)

    chg = Changes(*sums, count)
    # Average the change statistics (change_tracker::complete, :110-120).
    if config.track_changes:
        recip = torch.where(count > 0, 1.0 / count.clamp_min(1).to(dtype),
                            torch.ones((), dtype=dtype, device=dev))
        chg = Changes(*(s * recip for s in sums), count)

    # Start new tracks: unassigned peaks (input order) with amp >=
    # threshold fill free tracks in index order (:264-280).
    eligible = valid & ~p_asn & (peak_amp >= start_threshold)
    free = ~t_asn
    e_rank = torch.cumsum(eligible.to(torch.int32), 0) * eligible.to(torch.int32)  # 1-based
    f_rank = torch.cumsum(free.to(torch.int32), 0) * free.to(torch.int32)
    # match[i, j]: eligible peak of rank r goes to the free track of rank r
    match = (e_rank[:, None] == f_rank[None, :]) & eligible[:, None] & free[None, :]
    peak_for_track = torch.argmax(match.to(torch.int32), dim=0)  # (T,)
    has_new = match.any(dim=0)
    start_state = torch.where(state.state != OFF, SWITCH, START).to(torch.int32)
    new_f = torch.where(has_new, peak_freq[peak_for_track], new_f)
    new_a = torch.where(has_new, peak_amp[peak_for_track], new_a)
    new_s = torch.where(has_new, start_state, new_s)

    # Unassigned tracks go inactive with a zeroed peak (:282-289).
    assigned_any = t_asn | has_new
    new_f = torch.where(assigned_any, new_f, zero)
    new_a = torch.where(assigned_any, new_a, zero)
    return TrackerState(new_f, new_a, new_s), chg


class PartialTracker:
    """Object-style wrapper mirroring the reference class API. ``state``
    (optional) continues a tracker, e.g. one carried over from the JAX
    package with :meth:`TrackerState.from_numpy`."""

    def __init__(self, n_peaks: int, n_tracks: int, track_changes: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 state: Optional[TrackerState] = None):
        self.config = TrackerConfig(max_peaks=n_peaks, max_tracks=n_tracks,
                                    track_changes=track_changes)
        self.dtype = dtype
        if device is None and state is not None:
            device = state.freq.device
        self.device = resolve_device(device)
        self.state = state if state is not None else TrackerState.init(
            n_tracks, dtype, self.device)
        self.changes: Optional[Changes] = None

    def set_cost_calculation(self, square_cost: bool, use_pitch: bool, use_db: bool):
        self.config = self.config.with_cost_calculation(square_cost, use_pitch, use_db)

    def set_cost_scaling(self, freq_unit: float, amp_unit: float, max_cost: float):
        self.config = self.config.with_cost_scaling(freq_unit, amp_unit, max_cost)

    def reset(self):
        self.state = TrackerState.init(self.config.max_tracks, self.dtype, self.device)
        self.changes = None

    def process(self, freqs, amps, start_threshold: float = 0.0):
        """Track one frame of peaks. freqs / amps: up to max_peaks values."""
        freqs = np.asarray(freqs, np.float64)
        amps = np.asarray(amps, np.float64)
        n = min(len(freqs), self.config.max_peaks)
        pf = np.zeros(self.config.max_peaks)
        pa = np.zeros(self.config.max_peaks)
        pf[:n] = freqs[:n]
        pa[:n] = amps[:n]
        self.state, self.changes = process(
            self.config, self.state,
            torch.as_tensor(pf, dtype=self.dtype, device=self.device),
            torch.as_tensor(pa, dtype=self.dtype, device=self.device),
            n, start_threshold)
        return self.state

    def get_track(self, idx: int):
        return (float(self.state.freq[idx]), float(self.state.amp[idx]),
                int(self.state.state[idx]))

    # change_tracker accessors (reference :296-309): 0 before the first frame
    # and after reset(), like the reference's zero-initialised members.
    def freq_change_sum(self):
        return float(self.changes.freq_sum) if self.changes is not None else 0.0

    def freq_change_abs(self):
        return float(self.changes.freq_abs) if self.changes is not None else 0.0

    def amp_change_sum(self):
        return float(self.changes.amp_sum) if self.changes is not None else 0.0

    def amp_change_abs(self):
        return float(self.changes.amp_abs) if self.changes is not None else 0.0
