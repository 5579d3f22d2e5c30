"""Port parity: per-stage SNR reports (utils/debug_stages.py), the twin of
``tests/test_debug_stages.py``, on the CPU (each kernel's plain version;
the float64 chains of the two-tier and pipeline reports run there too).

Healthy engines report high SNR at every stage, and a per-stage
perturbation, monkeypatched on the port's own function, shows up in THAT
stage's number while the upstream stages stay clean. The bars are the JAX
tests': 95 dB for the streaming stages, 90 for the two-tier stages, 80 for
the pipeline's isolated stages, 50 for its deconvolution, and > 200 dB for
the ragged doling (pure data movement). The uniform offline report and the
two opt-in hooks (``HISSTOOLS_DEBUG_STAGES=1``: ``FastFIR`` calls,
``MonoConvolve.process_offline``) are held the same way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import mono  # noqa: E402
from hisstools_library_tpu_torch.models import partitioned as part  # noqa: E402
from hisstools_library_tpu_torch.models.mono import PartitionScheme  # noqa: E402
from hisstools_library_tpu_torch.models.offline import FastFIR  # noqa: E402
from hisstools_library_tpu_torch.ops import smoothing  # noqa: E402
from hisstools_library_tpu_torch.utils import debug_stages  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SCHEME = PartitionScheme((256, 1024), zero_latency=True)
B = SCHEME.sizes[-1] >> 1


def _inputs(rng):
    ir = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
    xw = rng.standard_normal((2, 2 * B)).astype(np.float32)
    xb = rng.standard_normal((2, 2 * B)).astype(np.float32)
    return ir, xw, xb


def _report(ir, xw, xb):
    rep = debug_stages.stream_stage_report(ir, xw, xb, scheme=SCHEME,
                                           backend="pallas", device=CPU)
    return {s.stage: s.snr_db for s in rep}


def test_stream_stage_report_healthy(rng):
    snrs = _report(*_inputs(rng))
    expected = {"frame_rfft", "ring_mac", "lag0_product", "rifft_tail",
                "section_refresh", "collapsed_output", "subhop_fire",
                "subhop_doling"}
    assert expected <= set(snrs)
    for stage, db in snrs.items():
        assert db > 95.0, f"{stage} only {db:.1f} dB"
    # doling is pure data movement between identical engine runs
    assert snrs["subhop_doling"] > 200.0


def test_stream_stage_report_localises_mac_perturbation(rng, monkeypatch):
    """A corrupted ring MAC (K7's wrapper) must drop ring_mac (and the
    dependent end-to-end stage) while the upstream frame_rfft stays clean."""
    real = hopper_kernels.lag_mac_ring

    def bad(hre, him, xre, xim, hr, hi):
        yre, yim, nre, nim = real(hre, him, xre, xim, hr, hi)
        return yre * (1.0 + 1e-3), yim, nre, nim

    monkeypatch.setattr(hopper_kernels, "lag_mac_ring", bad)
    snrs = _report(*_inputs(rng))
    assert snrs["frame_rfft"] > 95.0
    assert snrs["ring_mac"] < 80.0
    assert snrs["collapsed_output"] < 80.0


def test_stream_stage_report_localises_refresh_perturbation(rng, monkeypatch):
    """A corrupted non-final-section refresh must drop section_refresh while
    the big-section block stages stay clean (subhop_fire consumes the SAME
    perturbed state values on both sides, so it stays clean too)."""
    real = mono._refresh_aligned_section

    def bad(spec, tail, backend):
        st = real(spec, tail, backend)
        return part.PartitionedState(
            prev=st.prev, ring=Split(st.ring.re * (1.0 + 1e-3), st.ring.im),
            pos=st.pos)

    monkeypatch.setattr(mono, "_refresh_aligned_section", bad)
    snrs = _report(*_inputs(rng))
    assert snrs["frame_rfft"] > 95.0
    assert snrs["ring_mac"] > 95.0
    assert snrs["section_refresh"] < 80.0
    assert snrs["subhop_fire"] > 95.0


# -- two-tier block streaming decomposition -----------------------------------

SCHEME_2T = PartitionScheme((32, 64, 128, 256), zero_latency=True)


def _two_tier_report(rng):
    ir = (rng.standard_normal((2, 4096)) * 0.3).astype(np.float32)
    # warm + timed blocks sized in far hops
    mir = mono.prepare_ir(SCHEME_2T, ir, offline_tail=False, device=CPU)
    h2 = mir.far.shape[-1]
    xw = rng.standard_normal((2, 2 * h2)).astype(np.float32)
    xb = rng.standard_normal((2, h2)).astype(np.float32)
    rep = debug_stages.two_tier_stage_report(ir, xw, xb, scheme=SCHEME_2T,
                                             backend="pallas", device=CPU)
    return {s.stage: s.snr_db for s in rep}


def test_two_tier_stage_report_healthy(rng):
    snrs = _two_tier_report(rng)
    assert {"near_block", "far_block", "two_tier_output",
            "handoff_continuation"} <= set(snrs)
    for stage, db in snrs.items():
        assert db > 90.0, f"{stage} only {db:.1f} dB"


def test_two_tier_stage_report_localises_far_perturbation(rng, monkeypatch):
    """A corrupted far-tier MAC drops far_block (and the end-to-end stage)
    while near_block stays clean."""
    real = part.PartitionedConvolve.process_block

    def bad(spectra, state, x, **kw):
        st, y = real(spectra, state, x, **kw)
        if kw.get("lag0") is None and x.dtype == torch.float32:
            return st, y * (1.0 + 1e-3)  # far tier only (near carries lag0),
        return st, y                     # device-width side only

    monkeypatch.setattr(part.PartitionedConvolve, "process_block", staticmethod(bad))
    snrs = _two_tier_report(rng)
    assert snrs["near_block"] > 90.0
    assert snrs["far_block"] < 75.0
    assert snrs["two_tier_output"] < 80.0


# -- config-5 pipeline decomposition ------------------------------------------

def _pipeline_inputs(rng, sig_len=16384, fs=48000.0):
    t = np.arange(sig_len) / fs
    exc = np.sin(2 * np.pi * (20.0 * (1000.0 ** (t / t[-1]))) * t)
    ir_true = rng.standard_normal(1024) * np.exp(-np.arange(1024) / 1200.0)
    measured = np.convolve(exc, ir_true)
    return measured, exc


def _pipeline_report(measured, exc):
    rep = debug_stages.pipeline_stage_report(
        measured, exc, regularization=1e-9, stft_size=256, stft_hop=128,
        n_peaks=8, device=CPU)
    return {s.stage: s.snr_db for s in rep}


def test_pipeline_stage_report_healthy(rng):
    snrs = _pipeline_report(*_pipeline_inputs(rng))
    expected = {"deconvolve", "stft_amp", "smooth", "peaks", "track",
                "stft_amp cum", "smooth cum", "track cum"}
    assert expected <= set(snrs)
    # Isolated stages: each stage's own f32 arithmetic is clean.
    for stage in ("stft_amp", "smooth", "peaks"):
        assert snrs[stage] > 80.0, f"{stage} only {snrs[stage]:.1f} dB"
    # The end-to-end number is bounded by the deconvolution conditioning.
    assert snrs["deconvolve"] > 50.0


def test_pipeline_stage_report_localises_smooth_perturbation(rng, monkeypatch):
    """A corrupted f32 smooth drops the smooth stage while stft_amp stays
    clean — the report isolates the stage that broke."""
    real = smoothing.smooth

    def bad(series, kernel, w0, w1, **kw):
        out = real(series, kernel, w0, w1, **kw)
        if out.dtype == torch.float32:  # only the device-width side
            out = out * (1.0 + 1e-3)
        return out

    monkeypatch.setattr(smoothing, "smooth", bad)
    snrs = _pipeline_report(*_pipeline_inputs(rng))
    assert snrs["smooth"] < 70.0
    assert snrs["stft_amp"] > 80.0


# -- the uniform offline chain and the opt-in hooks ---------------------------

def _offline_inputs(rng):
    ir = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 9000)).astype(np.float32))
    return ir, x


def test_stage_report_healthy(rng):
    snrs = {s.stage: s.snr_db for s in debug_stages.stage_report(*_offline_inputs(rng))}
    assert list(snrs) == ["impulse_spectra", "hop_rfft", "partition_mac",
                          "rifft_overlap", "engine_output"]
    for stage, db in snrs.items():
        assert db > 95.0, f"{stage} only {db:.1f} dB"


def test_stage_report_localises_mac_perturbation(rng, monkeypatch):
    """A corrupted partition MAC (the engine's ``_ring_mac``) drops
    partition_mac while the transforms around it stay clean."""
    real = part._ring_mac

    def bad(*args):
        re, im, ring = real(*args)
        return re * (1.0 + 1e-3), im, ring

    monkeypatch.setattr(part, "_ring_mac", bad)
    snrs = {s.stage: s.snr_db for s in debug_stages.stage_report(*_offline_inputs(rng))}
    assert snrs["hop_rfft"] > 95.0 and snrs["rifft_overlap"] > 95.0
    assert snrs["partition_mac"] < 80.0


def test_hooks_print_under_env_flag(rng, monkeypatch, capsys):
    ir, x = _offline_inputs(rng)
    FastFIR(ir, device=CPU)(x)
    conv = mono.MonoConvolve()
    conv.set(ir, device=CPU)
    conv.process_offline(x)
    assert "[debug-stages]" not in capsys.readouterr().err  # off by default

    monkeypatch.setenv(debug_stages.ENV_FLAG, "1")
    y = FastFIR(ir, device=CPU)(x)
    err = capsys.readouterr().err
    assert "[debug-stages] FastFIR:" in err and "engine_output" in err
    conv = mono.MonoConvolve()
    conv.set(ir, device=CPU)
    y2 = conv.process_offline(x)
    err = capsys.readouterr().err
    assert "[debug-stages] MonoConvolve.process_offline:" in err
    assert "partition_mac" in err
    assert y.shape == y2.shape == x.shape
