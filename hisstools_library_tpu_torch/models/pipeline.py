"""The multichannel IR measurement pipeline (BASELINE config 5), on torch
tensors.

Counterpart of ``hisstools_library_tpu/models/pipeline.py``. It composes the
port the way HIRT composes the reference library: excitation deconvolution ->
N-to-mono reduction -> (optional) phase reshaping -> spectral smoothing ->
peak finding -> sinusoidal partial tracking.

- :func:`ir_deconvolve` -- regularised spectral division
  ``H = Y * conj(X) / (|X|^2 + eps)`` on the packed spectra, DC and Nyquist
  apart (the HIRT deconvolution core built from the reference's per-bin
  machinery; the JAX package unpacks them first).
- :func:`find_peaks` -- local spectral maxima with parabolic (log-amplitude)
  interpolation of frequency and amplitude, top-K by amplitude.
- :func:`run_ir_pipeline` -- the whole-IR chain, one spectrum, with the
  tracker advanced once on the host side of the results.
- :func:`run_ir_pipeline_frames` -- the multi-frame chain: STFT of the mono
  IR, per-frame smoothing and peaks, and the tracker over every frame.

The JAX package's ``lru_cache`` + ``jit`` programs are plain functions here.
On a CUDA tensor the transforms launch the Hopper kernels by size
(``ir_deconvolve`` at a 2^17-sample capture: K13 twice, K16's floor and
division, and K14 once at N = 2^18; the STFT of 1024-point frames: K10w).
The frame chain's tracker loop (the JAX ``lax.scan``) calls
:func:`partial_tracker.process` once a frame with no host sync; on the card
one frame's step is captured once in a ``torch.cuda.CUDAGraph`` and
replayed per frame, since a step is some 400 small launches. Each result comes back with one device-to-host copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import Split, array_from
from ..fft import api as fft_api
from ..ops import smoothing, spectral, spectral_processor as sp
from ..ops import stft as stft_mod
from ..ops import windows
from ..utils.profiling import span
from . import partial_tracker as pt


@span("entry.pipeline.ir_deconvolve")
def ir_deconvolve(measured: torch.Tensor, excitation: torch.Tensor,
                  regularization: float = 1e-4,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Deconvolve the excitation from a measured response.

    Both inputs are time signals (..., L); the result is the impulse response
    at the common FFT size (next pow2 of the longer input), computed as
    ``irfft( Y conj(X) / (|X|^2 + reg * max|X|^2) )``.
    """
    n1 = measured.shape[-1]
    n2 = excitation.shape[-1]
    n = 1 << sp.calc_fft_size_log2(max(n1, n2))

    Y = Split(*fft_api.rfft_padded(measured, n, backend=backend))
    X = Split(*fft_api.rfft_padded(excitation, n, backend=backend))
    # The quotient's packed spectrum with the inverse's 1 / (2N) folded in.
    with span("engine.deconvolve.divide"):
        H = spectral.ir_deconvolve_real(Y, X, regularization, 0.5 / n, backend=backend)
    return fft_api.rifft(H.re, H.im, backend=backend)


def find_peaks(amp_spectrum: torch.Tensor, n_peaks: int, bin_hz: float = 1.0,
               min_amp: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K local maxima of an amplitude spectrum with parabolic
    interpolation in the log-amplitude domain.

    Returns (freqs, amps) of shape (..., n_peaks); absent peaks have amp 0.
    Peaks are ordered by amplitude; equal amplitudes keep bin order (a stable
    sort, as ``jnp.argsort``)."""
    a = amp_spectrum
    left = a[..., :-2]
    mid = a[..., 1:-1]
    right = a[..., 2:]
    is_peak = (mid > left) & (mid >= right) & (mid > min_amp)

    la = torch.log(a.clamp_min(1e-30))
    alpha = la[..., :-2]
    beta = la[..., 1:-1]
    gamma = la[..., 2:]
    denom = alpha - 2 * beta + gamma
    delta = torch.where(denom.abs() > 1e-12,
                        0.5 * (alpha - gamma) / torch.where(denom == 0, 1.0, denom),
                        0.0)
    delta = delta.clamp(-0.5, 0.5)
    interp_amp = torch.exp(beta - 0.25 * (alpha - gamma) * delta)
    bin_idx = torch.arange(1, a.shape[-1] - 1, dtype=a.dtype, device=a.device)

    score = torch.where(is_peak, mid, -torch.inf)
    order = torch.argsort(-score, dim=-1, stable=True)[..., :n_peaks]
    freqs = torch.gather(bin_idx + delta, -1, order) * bin_hz
    amps = torch.gather(torch.where(is_peak, interp_amp, 0.0), -1, order)
    amps = torch.where(torch.gather(is_peak, -1, order), amps, 0.0)
    freqs = torch.where(amps > 0, freqs, 0.0)
    return freqs, amps


def _amplitude(s: Split) -> torch.Tensor:
    """|bin| of a packed spectrum with the x2 packing undone, the true DC
    magnitude in bin 0."""
    amp = torch.sqrt(s.re * s.re + s.im * s.im) * 0.5
    return torch.cat([s.re[..., :1].abs() * 0.5, amp[..., 1:]], dim=-1)


def _smooth_peaks(amp, kernel, smooth_widths, n_peaks, bin_hz, backend):
    smoothed = smoothing.smooth(amp, kernel, smooth_widths[0], smooth_widths[1],
                                symmetric=True, edges=smoothing.EdgeMode.Extend,
                                backend=backend)
    return (smoothed,) + find_peaks(smoothed, n_peaks, bin_hz=bin_hz)


def _mono_ir(measured, excitation, regularization, phase, backend):
    """Deconvolve each channel, average to mono, optionally reshape phase."""
    h = ir_deconvolve(measured, excitation, regularization, backend=backend)
    h_mono = h.mean(dim=0) if h.ndim > 1 else h
    if phase is not None:
        h_mono = sp.change_phase(h_mono, phase, backend=backend)
    return h_mono


def _chain(measured, excitation, sample_rate, regularization, smooth_widths, kernel,
           n_peaks, phase, backend):
    """The whole-IR chain: deconvolve -> mono -> amplitude -> smooth ->
    peaks."""
    h_mono = _mono_ir(measured, excitation, regularization, phase, backend)
    amp = _amplitude(Split(*fft_api.rfft(h_mono, backend=backend)))
    return (h_mono,) + _smooth_peaks(amp, kernel, smooth_widths, n_peaks,
                                     sample_rate / h_mono.shape[-1], backend)


def _track_frames(config: pt.TrackerConfig, freqs: torch.Tensor, amps: torch.Tensor,
                  n_valid: torch.Tensor, start_threshold: float):
    """The tracker over frames (the JAX ``lax.scan``), from a fresh state:
    returns (F, T) track freqs, amps and states. One frame's step picks its
    inputs by a frame index on the device and writes its outputs and the
    carried state back, so no host sync falls between frames; on the CPU it
    runs once a frame, on the card it is captured once as a CUDA graph and
    replayed once a frame."""
    frames = freqs.shape[0]
    tr = config.max_tracks
    st = pt.TrackerState.init(tr, freqs.dtype, freqs.device)
    tf = freqs.new_zeros(frames, tr)
    ta = freqs.new_zeros(frames, tr)
    ts = torch.zeros(frames, tr, dtype=torch.int32, device=freqs.device)
    idx = torch.zeros(1, dtype=torch.long, device=freqs.device)

    def step():
        new, _ = pt.process(config, st, freqs.index_select(0, idx)[0],
                            amps.index_select(0, idx)[0], n_valid.index_select(0, idx)[0],
                            start_threshold)
        for out, v in ((tf, new.freq), (ta, new.amp), (ts, new.state)):
            out.index_copy_(0, idx, v[None])
        for carried, v in ((st.freq, new.freq), (st.amp, new.amp), (st.state, new.state)):
            carried.copy_(v)
        idx.add_(1)

    if freqs.device.type != "cuda" or frames == 0:
        for _ in range(frames):
            step()
        return tf, ta, ts
    # Warm up on a side stream before the capture, as torch.cuda.graphs asks;
    # the warm-up's frame 0 is recomputed by the first replay.
    side = torch.cuda.Stream(freqs.device)
    side.wait_stream(torch.cuda.current_stream(freqs.device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(freqs.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for t in (st.freq, st.amp, st.state, idx):
        t.zero_()
    for _ in range(frames):
        graph.replay()
    return tf, ta, ts


def _frames_chain(measured, excitation, sample_rate, regularization, smooth_widths,
                  kernel, n_peaks, stft_size, stft_hop, config, start_threshold, phase,
                  backend):
    """The multi-frame config-5 chain: deconvolve -> mono -> (phase) ->
    STFT -> per-frame amplitude -> variable-width smooth (batched over
    frames) -> per-frame peaks -> partial tracking over the frames (the
    reference's frame loop feeding partial_tracker::process,
    PartialTracker.hpp:224-289)."""
    win = windows.hann(stft_size - 1, dtype=torch.float64, device="cpu").numpy()
    h_mono = _mono_ir(measured, excitation, regularization, phase, backend)
    S = stft_mod.stft(h_mono, win, stft_size, stft_hop, backend=backend)
    smoothed, freqs, amps = _smooth_peaks(_amplitude(S), kernel, smooth_widths, n_peaks,
                                          sample_rate / stft_size, backend)
    n_valid = (amps > 0.0).sum(dim=-1)                            # (F,)
    tf, ta, ts = _track_frames(config, freqs, amps, n_valid, start_threshold)
    return h_mono, smoothed, freqs, amps, tf, ta, ts


def _default_kernel() -> np.ndarray:
    """Half a 128-point Hann window, the smoothing kernel's default."""
    return windows.hann(127, dtype=torch.float64, device="cpu").numpy()[63:]


@dataclasses.dataclass
class IRFramesResult:
    impulse: np.ndarray          # deconvolved mono IR (time domain)
    smoothed_amp: np.ndarray     # (frames, bins) smoothed amplitude spectra
    peak_freqs: np.ndarray       # (frames, n_peaks) Hz
    peak_amps: np.ndarray        # (frames, n_peaks)
    track_freqs: np.ndarray      # (frames, n_tracks) Hz per tracked partial
    track_amps: np.ndarray       # (frames, n_tracks)
    track_states: np.ndarray     # (frames, n_tracks) OFF/START/CONTINUE/SWITCH


def run_ir_pipeline_frames(measured: torch.Tensor, excitation: torch.Tensor,
                           sample_rate: float = 48000.0,
                           regularization: float = 1e-4,
                           smooth_widths: Tuple[float, float] = (1.0, 63.0),
                           smooth_kernel=None,
                           n_peaks: int = 16,
                           n_tracks: Optional[int] = None,
                           stft_size: int = 1024,
                           stft_hop: int = 512,
                           tracker_config: Optional[pt.TrackerConfig] = None,
                           start_threshold: float = 0.0,
                           phase: Optional[float] = None,
                           backend: Optional[str] = None) -> IRFramesResult:
    """Config-5 pipeline over STFT frames with partial tracking on the
    inputs' device; only the final results come to the host."""
    if smooth_kernel is None:
        smooth_kernel = _default_kernel()
    if tracker_config is None:
        tracker_config = pt.TrackerConfig(max_peaks=n_peaks, max_tracks=n_tracks or n_peaks)
    out = _frames_chain(measured, excitation, float(sample_rate), float(regularization),
                        (float(smooth_widths[0]), float(smooth_widths[1])),
                        np.asarray(smooth_kernel, np.float64), int(n_peaks), int(stft_size),
                        int(stft_hop), tracker_config, float(start_threshold), phase, backend)
    return IRFramesResult(*(array_from(t) for t in out))


@dataclasses.dataclass
class IRPipelineResult:
    impulse: np.ndarray          # deconvolved mono IR (time domain)
    smoothed_amp: np.ndarray     # smoothed amplitude spectrum
    peak_freqs: np.ndarray       # (n_peaks,) Hz
    peak_amps: np.ndarray        # (n_peaks,)
    tracker_state: pt.TrackerState


def run_ir_pipeline(measured: torch.Tensor, excitation: torch.Tensor,
                    sample_rate: float = 48000.0,
                    regularization: float = 1e-4,
                    smooth_widths: Tuple[float, float] = (1.0, 63.0),
                    smooth_kernel=None,
                    n_peaks: int = 16,
                    tracker: Optional[pt.PartialTracker] = None,
                    phase: Optional[float] = None,
                    backend: Optional[str] = None) -> IRPipelineResult:
    """The config-5 chain: deconvolve (per input channel) -> sum to mono ->
    smooth the amplitude spectrum -> find peaks -> advance the partial
    tracker (a float64 tracker on the inputs' device unless one is given).

    ``measured``: (N, L) multichannel capture; ``excitation``: (L_e,) the
    stimulus. ``phase``: optionally reshape the IR phase (0 = minimum, 0.5 =
    linear, ...) through ``spectral_processor.change_phase`` first."""
    if smooth_kernel is None:
        smooth_kernel = _default_kernel()
    out = _chain(measured, excitation, float(sample_rate), float(regularization),
                 (float(smooth_widths[0]), float(smooth_widths[1])),
                 np.asarray(smooth_kernel, np.float64), int(n_peaks), phase, backend)
    h_np, sm_np, f_np, a_np = (array_from(t) for t in out)

    if tracker is None:
        tracker = pt.PartialTracker(n_peaks, n_peaks, dtype=torch.float64,
                                    device=measured.device)
    # find_peaks pads absent slots with freq 0 / amp 0; with start_threshold
    # 0.0 each pad would start a bogus 0 Hz track, so only the genuine peaks
    # reach the tracker.
    a64 = np.asarray(a_np, np.float64)
    n_valid = int(np.count_nonzero(a64 > 0.0))
    tracker.process(np.asarray(f_np, np.float64)[:n_valid], a64[:n_valid],
                    start_threshold=0.0)
    return IRPipelineResult(impulse=h_np, smoothed_amp=sm_np, peak_freqs=f_np,
                            peak_amps=a_np, tracker_state=tracker.state)
