"""The port's partial tracker, peak finder and IR pipeline against the JAX
package, on the CPU.

Inputs are made from seeded numpy and handed to both. Tolerances: in float64
the track states are equal and frequencies and amplitudes agree to 1e-12
(assignments copy peaks, so they are exact; the change statistics are sums);
float32 cases use well-separated costs, so rounding cannot reorder the greedy
assignment, and are compared to the same 1e-12 relative; the change
statistics to 1e-5 absolute in float32. The pipeline's IRs, spectra, peaks
and tracks hold >= 110 dB in float32 and >= 250 dB in float64 (a float32
phase change: see ``_check_fields``), and its track states are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hisstools_library_tpu.models import partial_tracker as jpt
from hisstools_library_tpu.models import pipeline as jpipe
from hisstools_library_tpu_torch.models import partial_tracker as tpt
from hisstools_library_tpu_torch.models import pipeline as tpipe

CPU = "cpu"
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}
TDT = {np.float32: torch.float32, np.float64: torch.float64}


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _frames(rng, pk, n_frames, dtype, separated=False, base=None):
    """Frames of peaks (freq, amp, n_valid) around a set of partials that
    drift, fade in and out, with extra random peaks. ``separated``: the
    partials sit whole semitones apart and move by < 0.05 semitone a frame,
    so each peak has at most one finite cost."""
    if base is None:
        base = 440.0 * 2.0 ** (rng.choice(48, pk, replace=False) / 12.0 if separated
                               else rng.uniform(-24, 24, pk) / 12.0)
    out = []
    for _ in range(n_frames):
        keep = rng.random(pk) < 0.8
        drift = 2.0 ** (rng.uniform(-0.04, 0.04, pk) / 12.0)
        f = (base * drift)[keep]
        if not separated:
            f = np.concatenate([f, rng.uniform(100.0, 8000.0, 3)])
        a = rng.uniform(0.05, 1.0, f.size)
        order = rng.permutation(f.size)[:pk]
        n = int(rng.integers(0, order.size + 1)) if not separated else order.size
        pf = np.zeros(pk)
        pa = np.zeros(pk)
        pf[:order.size], pa[:order.size] = f[order], a[order]
        out.append((pf.astype(dtype), pa.astype(dtype), n))
    return out


def _start_state(pk, dtype):
    return (jpt.TrackerState.init(pk, JDT[dtype]),
            tpt.TrackerState.init(pk, TDT[dtype], device=CPU))


def _assert_state_equal(js, ts, rtol=1e-12):
    assert np.array_equal(np.asarray(js.state), ts.state.numpy())
    assert ts.state.dtype == torch.int32
    for j, t in ((js.freq, ts.freq), (js.amp, ts.amp)):
        assert np.allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def _run_both(cfg, frames, dtype, js=None, ts=None, threshold=0.0):
    jcfg = jpt.TrackerConfig(**dataclasses.asdict(cfg))
    if js is None:
        js, ts = _start_state(cfg.max_tracks, dtype)
    for pf, pa, n in frames:
        js, jc = jpt.process(jcfg, js, jnp.asarray(pf), jnp.asarray(pa), n, threshold)
        ts, tc = tpt.process(cfg, ts, torch.from_numpy(pf), torch.from_numpy(pa), n, threshold)
        _assert_state_equal(js, ts)
        for name in ("freq_sum", "freq_abs", "amp_sum", "amp_abs", "count"):
            j, t = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
            assert np.allclose(t, j, rtol=1e-12, atol=1e-12 if dtype == np.float64 else 1e-5), name
    return js, ts


@pytest.mark.parametrize("pk,tr", [(16, 16), (8, 12), (12, 6)])
def test_tracker_random_frames_float64(pk, tr):
    rng = np.random.default_rng(pk * 100 + tr)
    cfg = tpt.TrackerConfig(max_peaks=pk, max_tracks=tr)
    _run_both(cfg, _frames(rng, pk, 40, np.float64), np.float64, threshold=0.1)


def test_tracker_separated_frames_float32():
    rng = np.random.default_rng(5)
    cfg = tpt.TrackerConfig(max_peaks=16, max_tracks=16, track_changes=True)
    _run_both(cfg, _frames(rng, 16, 30, np.float32, separated=True), np.float32)


@pytest.mark.parametrize("square,pitch,db", [(s, p, d) for s in (False, True)
                                             for p in (False, True) for d in (False, True)])
def test_tracker_cost_options(square, pitch, db):
    """Every cost calculation (squared or absolute, pitch or Hz, dB or
    linear) with change tracking on, and the cost scaling."""
    rng = np.random.default_rng(int(square) * 4 + int(pitch) * 2 + int(db))
    cfg = tpt.TrackerConfig(max_peaks=8, max_tracks=8, track_changes=True)
    cfg = cfg.with_cost_calculation(square, pitch, db)
    cfg = cfg.with_cost_scaling(0.5 if pitch else 20.0, 6.0 if db else 0.3, 1.0)
    _run_both(cfg, _frames(rng, 8, 12, np.float64), np.float64)


def test_tracker_ties_and_zero_amp():
    """Equal costs (two identical peaks, two identical tracks) take the
    lowest flat index, as JAX's argmin; a 0-amp peak and a silent track
    (-inf dB in float32, -6000 dB in float64)."""
    for dtype in (np.float64, np.float32):
        pf = np.array([440.0, 440.0, 660.0, 880.0, 0.0, 0.0], dtype)
        pa = np.array([0.5, 0.5, 0.0, 0.25, 0.0, 0.0], dtype)
        cfg = tpt.TrackerConfig(max_peaks=6, max_tracks=6, track_changes=True)
        frames = [(pf, pa, 4), (pf, pa, 4), (pf[[1, 0, 3, 2, 4, 5]], pa[[1, 0, 3, 2, 4, 5]], 4),
                  (pf * 1.001, pa, 6)]
        _run_both(cfg, frames, dtype)


def _local_dominant_rounds(cost):
    """How many parallel rounds the JAX package's while_loop runs."""
    c = cost.copy()
    rounds = 0
    while np.isfinite(c).any():
        rmin, cmin = c.argmin(1), c.argmin(0)
        sel = ((np.arange(c.shape[1])[None, :] == rmin[:, None])
               & (np.arange(c.shape[0])[:, None] == cmin[None, :]) & np.isfinite(c))
        c[sel.any(1), :] = np.inf
        c[:, sel.any(0)] = np.inf
        rounds += 1
    return rounds


def test_fixed_rounds_match_while_loop_16x16():
    """The port's exactly-min(P, T) rounds against JAX's while_loop on a
    16 x 16 frame whose greedy assignment needs several rounds: tracks and
    peaks interleave a tenth of a semitone apart, so preferences chain."""
    pk = 16
    pitch = 60.0 + 0.1 * np.arange(2 * pk)
    freqs = 440.0 * 2.0 ** ((pitch - 69.0) / 12.0)
    amps = np.linspace(0.3, 0.6, 2 * pk)
    track_f, peak_f = freqs[0::2], freqs[1::2]
    track_a, peak_a = amps[0::2], amps[1::2]
    cost = (4.0 * (pitch[1::2, None] - pitch[None, 0::2]) ** 2
            + (20 * np.log10(peak_a)[:, None] - 20 * np.log10(track_a)[None, :]) ** 2 / 36.0)
    cost = np.where(cost < 1.0, cost, np.inf)
    assert _local_dominant_rounds(cost) > 1
    cfg = tpt.TrackerConfig(max_peaks=pk, max_tracks=pk, track_changes=True)
    js = jpt.TrackerState(jnp.asarray(track_f), jnp.asarray(track_a),
                          jnp.full(pk, jpt.CONTINUE, jnp.int32))
    ts = tpt.TrackerState.from_numpy(js, device=CPU)
    js, ts = _run_both(cfg, [(peak_f, peak_a, pk)], np.float64, js, ts)
    assert int((ts.state == tpt.CONTINUE).sum()) > 1


def test_jax_state_continues_in_port():
    """A JAX tracker's state, moved as numpy, continues in the port on the
    next frame with identical results (and back)."""
    rng = np.random.default_rng(9)
    cfg = tpt.TrackerConfig(max_peaks=12, max_tracks=12, track_changes=True)
    frames = _frames(rng, 12, 20, np.float64)
    js, ts = _run_both(cfg, frames[:10], np.float64)
    moved = tpt.TrackerState.from_numpy(jpt.TrackerState(*(np.asarray(a) for a in
                                                            (js.freq, js.amp, js.state))),
                                        device=CPU)
    _run_both(cfg, frames[10:], np.float64, js, moved)
    back = moved.numpy()
    assert isinstance(back.freq, np.ndarray) and back.state.dtype == np.int32
    chg = tpt.Changes.from_numpy(tpt.Changes(*(np.float64(v) for v in range(4)), np.int32(2)),
                                 device=CPU)
    assert chg.numpy().count == 2 and chg.count.dtype == torch.int32


def test_partial_tracker_class_matches_jax():
    rng = np.random.default_rng(10)
    jt = jpt.PartialTracker(8, 8, track_changes=True, dtype=jnp.float64)
    tt = tpt.PartialTracker(8, 8, track_changes=True, dtype=torch.float64, device=CPU)
    for t in (jt, tt):
        t.set_cost_calculation(True, True, True)
        t.set_cost_scaling(0.6, 5.0, 1.5)
    assert tt.freq_change_sum() == 0.0
    for pf, pa, n in _frames(rng, 8, 10, np.float64):
        jt.process(pf[:n], pa[:n], start_threshold=0.2)
        tt.process(pf[:n], pa[:n], start_threshold=0.2)
        _assert_state_equal(jt.state, tt.state)
        assert tt.get_track(3) == pytest.approx(jt.get_track(3), rel=1e-12)
        for name in ("freq_change_sum", "freq_change_abs", "amp_change_sum", "amp_change_abs"):
            assert getattr(tt, name)() == pytest.approx(getattr(jt, name)(), rel=1e-12, abs=1e-12)
    tt.reset()
    assert tt.changes is None and int(tt.state.state.abs().sum()) == 0
    cont = tpt.PartialTracker(8, 8, dtype=torch.float64, state=tt.state)
    assert cont.device == tt.state.freq.device


# -- find_peaks ------------------------------------------------------------------

def test_find_peaks_sinusoids_match_jax():
    n = 4096
    t = np.arange(n)
    x = (np.sin(2 * np.pi * 440 * t / 48000) + 0.5 * np.sin(2 * np.pi * 1000 * t / 48000)
         + 0.25 * np.sin(2 * np.pi * 3500 * t / 48000))
    spec = np.abs(np.fft.rfft(x * np.hanning(n)))[:n // 2]
    for dtype in (np.float64, np.float32):
        jf, ja = jpipe.find_peaks(jnp.asarray(spec.astype(dtype)), 5, bin_hz=48000 / n)
        tf, ta = tpipe.find_peaks(torch.from_numpy(spec.astype(dtype)), 5, bin_hz=48000 / n)
        floor = 250.0 if dtype == np.float64 else 110.0
        assert snr_db(jf, tf.numpy()) >= floor and snr_db(ja, ta.numpy()) >= floor
    assert abs(float(tf[0]) - 440) < 12


def test_find_peaks_ties_match_jax():
    """Equal peak amplitudes keep bin order (stable sort), and absent slots
    are zero; batched over frames."""
    spec = np.zeros((3, 64))
    spec[:, [5, 12, 20, 33, 40]] = 1.0
    spec[1, [12, 40]] = 2.0
    spec[2] = 0.0
    spec[2, 30] = 0.5
    jf, ja = jpipe.find_peaks(jnp.asarray(spec), 4, bin_hz=10.0)
    tf, ta = tpipe.find_peaks(torch.from_numpy(spec), 4, bin_hz=10.0)
    assert np.array_equal(np.asarray(jf), tf.numpy()) and np.array_equal(np.asarray(ja), ta.numpy())
    assert tf[2, 1:].abs().sum() == 0


# -- the IR pipeline -------------------------------------------------------------

MODES = (1000.0, 2600.0, 4500.0, 7000.0, 10000.0, 14000.0)
SIGNAL_FRAMES = 62  # STFT frames (256 points, hop 128) inside the 8192-tap IR


def _capture(dtype):
    """An 8192-sample log sweep through an 8192-tap IR of six decaying modes
    of distinct amplitudes, two channels, the full linear convolution (N =
    2^14). Beyond the IR's 8192 taps the deconvolved IR is rounding noise,
    whose peaks no two implementations order alike, so peaks and tracks are
    compared on the frames inside the IR, where every peak is a mode."""
    fs = 48000.0
    t = np.arange(8192) / fs
    sweep = np.sin(2 * np.pi * 20.0 * t[-1] / np.log(1000.0)
                   * (np.exp(t / t[-1] * np.log(1000.0)) - 1.0))
    k = np.arange(8192)
    h = sum(a * np.sin(2 * np.pi * f * k / fs) for a, f in
            zip((1.0, 0.85, 0.7, 0.55, 0.45, 0.35), MODES)) * np.exp(-k / 2500.0)
    measured = np.stack([np.convolve(sweep, h), np.convolve(sweep, 0.5 * h)])
    return measured.astype(dtype), sweep.astype(dtype)


KW = dict(sample_rate=48000.0, regularization=1e-9, n_peaks=6, smooth_widths=(1.0, 3.0))
FIELDS = ("impulse", "smoothed_amp", "peak_freqs", "peak_amps")


def _check_fields(run, dtype, phase, want, got, parts):
    """Each field against the JAX package's: >= 250 dB in float64 and
    >= 110 dB in float32. A float32 phase change is the exception: its
    log / exp of low-power bins hold only ~111 dB against float64 in the JAX
    package itself at this size, so there every field of the port's float32
    run, held against the JAX float64 run, must reach the JAX float32 IR's
    own SNR less 3 dB (the bar the spectral tests set for ``change_phase``)."""
    ref, floor = want, (250.0 if dtype == np.float64 else 110.0)
    if dtype == np.float32 and phase is not None:
        ref = run(np.float64)
        floor = snr_db(ref.impulse, want.impulse) - 3.0
    for f, part in parts.items():
        assert snr_db(getattr(ref, f)[part], getattr(got, f)[part]) >= floor, f


@pytest.mark.parametrize("phase", [None, 0.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_run_ir_pipeline_frames_matches_jax(dtype, phase):
    kw = dict(KW, stft_size=256, stft_hop=128, phase=phase)

    def jax_run(dt):
        measured, sweep = _capture(dt)
        return jpipe.run_ir_pipeline_frames(jnp.asarray(measured), jnp.asarray(sweep), **kw)

    measured, sweep = _capture(dtype)
    want = jax_run(dtype)
    got = tpipe.run_ir_pipeline_frames(torch.from_numpy(measured), torch.from_numpy(sweep), **kw)
    assert got.impulse.shape == want.impulse.shape == (1 << 14,)
    assert got.smoothed_amp.shape == want.smoothed_amp.shape == (127, 128)
    sig = slice(0, SIGNAL_FRAMES)
    parts = dict.fromkeys(FIELDS + ("track_freqs", "track_amps"), sig)
    parts.update(impulse=slice(None), smoothed_amp=slice(None))
    _check_fields(jax_run, dtype, phase, want, got, parts)
    assert got.track_states.dtype == np.int32 and got.track_states.shape == (127, 6)
    assert np.array_equal(want.track_states[sig], got.track_states[sig])
    assert np.all(got.track_states[1:sig.stop] == tpt.CONTINUE)


@pytest.mark.parametrize("phase", [None, 0.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_run_ir_pipeline_matches_jax(dtype, phase):
    kw = dict(KW, phase=phase)

    def jax_run(dt):
        measured, sweep = _capture(dt)
        return jpipe.run_ir_pipeline(jnp.asarray(measured), jnp.asarray(sweep), **kw)

    measured, sweep = _capture(dtype)
    want = jax_run(dtype)
    got = tpipe.run_ir_pipeline(torch.from_numpy(measured), torch.from_numpy(sweep), **kw)
    _check_fields(jax_run, dtype, phase, want, got, dict.fromkeys(FIELDS, slice(None)))
    _assert_state_equal(want.tracker_state, got.tracker_state,
                        rtol=1e-12 if dtype == np.float64 else 1e-5)
    assert got.tracker_state.freq.device.type == "cpu"
