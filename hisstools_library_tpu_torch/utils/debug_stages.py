"""Per-stage SNR debugging against float64 oracles.

Counterpart of ``hisstools_library_tpu/utils/debug_stages.py``. SURVEY §5
promises optional per-block debug dumps — "SNR vs reference per stage".
:func:`stage_report` runs the uniform partitioned-convolution chain stage by
stage with the SAME functions the engine runs (``partitioned._hop_spectra``,
``_ring_mac`` and ``_tail``, so on a CUDA tensor the float32 side runs the
hand kernels), mirrors every stage in float64 numpy, and reports the SNR at
each boundary. An accuracy regression is thereby localised to the stage
that introduced it:

- ``impulse_spectra``: IR chunk rFFTs (PartitionedConvolve::set analogue,
  reference PartitionedConvolve.cpp:173-225),
- ``hop_rfft``: per-hop input frame spectra (:352-360),
- ``partition_mac``: the frequency-domain lag MAC (:387-426),
- ``rifft_overlap``: the scaled riFFT + overlap-save half (:232-241, 352-377),
- ``engine_output``: the production engine's actual output (whatever fused
  path it selects) vs float64 direct convolution.

:func:`stream_stage_report`, :func:`two_tier_stage_report` and
:func:`pipeline_stage_report` do the same for the streaming engines and the
IR-measurement chain. The float32 side runs on the device of the signal
tensor (or ``device``, the card unless named, for host arrays); the float64
chains of the two-tier and pipeline reports run on the CPU, where the plain
versions take float64.

Opt-in runtime hook: set ``HISSTOOLS_DEBUG_STAGES=1`` and the offline engine
entry points (:class:`models.offline.FastFIR` calls,
:meth:`models.mono.MonoConvolve.process_offline`) print a report to stderr on
each call outside ``torch.compile`` tracing.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..core.types import Split, packed_mul, resolve_device

ENV_FLAG = "HISSTOOLS_DEBUG_STAGES"
_CPU = torch.device("cpu")


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "0") not in ("0", "")


@dataclasses.dataclass
class StageSNR:
    stage: str
    snr_db: float


def _np(a) -> np.ndarray:
    """A host numpy copy of a tensor (dtype kept), or ``np.asarray(a)``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np64(a) -> np.ndarray:
    return np.asarray(_np(a), np.float64)


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device`` (cast on the host,
    round to nearest, as the JAX twin's ``jnp.asarray(a, float32)``)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np_dtype))).to(device)


def _device_of(x, device) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else resolve_device(device)


def snr_db(ref, test) -> float:
    ref = _np64(ref)
    err = _np64(test) - ref
    d = float((err * err).sum())
    if d == 0.0:
        return float("inf")
    denom = float((ref * ref).sum())
    return 10.0 * np.log10(max(denom, 1e-300) / d)


# -- float64 oracles of the packed-spectrum conventions -----------------------

def packed_rfft64(frames: np.ndarray):
    """float64 packed rFFT (x2 scale, Nyquist in im[0] — fft/api.rfft)."""
    z = np.fft.rfft(np.asarray(frames, np.float64), axis=-1)
    re = 2.0 * z.real
    im = 2.0 * z.imag
    im = np.concatenate([re[..., -1:], im[..., 1:-1]], axis=-1)
    return re[..., :-1], im


def packed_rifft64(re, im):
    """float64 unscaled packed inverse: rifft(rfft(x)) == 2N x."""
    re = np.asarray(re, np.float64)
    im = np.asarray(im, np.float64)
    n = re.shape[-1] * 2
    full = np.concatenate(
        [re[..., :1], re[..., 1:] + 1j * im[..., 1:], im[..., :1]], axis=-1)
    return np.fft.irfft(full, n=n, axis=-1) * float(n)


def packed_mul64(ar, ai, br, bi):
    """float64 packed product (DC/Nyquist lanes multiply independently)."""
    re = ar * br - ai * bi
    im = ar * bi + ai * br
    re[..., 0] = ar[..., 0] * br[..., 0]
    im[..., 0] = ai[..., 0] * bi[..., 0]
    return re, im


# -- the staged chain ---------------------------------------------------------

def stage_report(ir, x, fft_size: Optional[int] = None,
                 backend: Optional[str] = None,
                 mac_backend: str = "auto", device=None) -> List[StageSNR]:
    """Per-stage SNR of the uniform partitioned offline chain.

    ``ir``: (..., L_ir) host array; ``x``: (..., L) signal (a tensor, or a
    host array placed on ``device``) with the same leading shape. The f32
    side runs the engine's own stage functions (models.partitioned's
    _hop_spectra, _ring_mac on a zero ring, _tail) plus the production
    engine end to end; each is compared against its float64 numpy mirror.
    The scheme engines' offline path delegates to this same chain
    (mono.process_offline -> offline tail), so one report covers them.
    """
    from ..models import partitioned as part
    from ..models.offline import FastFIR, choose_fft_size

    dev = _device_of(x, device)
    ir = np.asarray(ir)
    x_np = _np64(x)
    n = fft_size or choose_fft_size(ir.shape[-1])
    h = n >> 1
    f32 = (lambda a: _t(a, torch.float32, dev))

    report: List[StageSNR] = []

    # Stage 1: impulse spectra (IR chunk rFFTs).
    spectra = part.impulse_spectra(ir, n, 0, 0, torch.float32, backend, device=dev)
    p = spectra.shape[-2]
    chunks = np.zeros(ir.shape[:-1] + (p * h,), np.float64)
    chunks[..., :ir.shape[-1]] = ir
    frames64 = chunks.reshape(ir.shape[:-1] + (p, h))
    frames64 = np.concatenate([frames64, np.zeros_like(frames64)], axis=-1)
    sre64, sim64 = packed_rfft64(frames64)
    report.append(StageSNR(
        "impulse_spectra",
        min(snr_db(sre64, spectra.re), snr_db(sim64, spectra.im))))

    # Stage 2: hop spectra of the signal ([prev | cur] frames, zero history).
    L = x_np.shape[-1]
    t = -(-L // h)
    blocks = np.zeros(x_np.shape[:-1] + (t * h,), np.float64)
    blocks[..., :L] = x_np
    blocks = blocks.reshape(x_np.shape[:-1] + (t, h))
    prev = np.concatenate(
        [np.zeros_like(blocks[..., :1, :]), blocks[..., :-1, :]], axis=-2)
    hop_frames64 = np.concatenate([prev, blocks], axis=-1)
    xre, xim = part._hop_spectra(f32(np.zeros_like(blocks[..., 0, :])), f32(blocks),
                                 backend)
    xre64, xim64 = packed_rfft64(hop_frames64)
    report.append(StageSNR(
        "hop_rfft", min(snr_db(xre64, xre), snr_db(xim64, xim))))

    # Stage 3: partition MAC (the engine's own ring MAC from a zero ring on
    # the f32 side; feed both sides the f64-exact spectra so the stage is
    # isolated).
    lags = min(p, t)
    pad = np.zeros(xre64.shape[:-2] + (lags,) + xre64.shape[-1:])
    xp_re64 = np.concatenate([pad, xre64], axis=-2)
    xp_im64 = np.concatenate([pad, xim64], axis=-2)
    acc_re, acc_im, _ = part._ring_mac(
        Split(f32(pad), f32(pad)), f32(xre64), f32(xim64),
        Split(f32(sre64[..., :lags, :]), f32(sim64[..., :lags, :])), mac_backend)
    acc_re64 = np.zeros_like(xre64)
    acc_im64 = np.zeros_like(xim64)
    for lag in range(lags):
        a, b = packed_mul64(xp_re64[..., lags - 1 - lag:, :][..., :t, :],
                            xp_im64[..., lags - 1 - lag:, :][..., :t, :],
                            sre64[..., lag:lag + 1, :],
                            sim64[..., lag:lag + 1, :])
        acc_re64 += a
        acc_im64 += b
    report.append(StageSNR(
        "partition_mac", min(snr_db(acc_re64, acc_re),
                             snr_db(acc_im64, acc_im))))

    # Stage 4: riFFT + 1/(4N) + overlap-save half (from f64-exact accums;
    # the engine's own tail).
    y32 = part._tail(f32(acc_re64), f32(acc_im64), 1.0 / (4.0 * n), backend)
    y64 = packed_rifft64(acc_re64, acc_im64) * (1.0 / (4.0 * n))
    report.append(StageSNR("rifft_overlap", snr_db(y64[..., h:], y32)))

    # Stage 5: the production engine end to end (whatever fused path it
    # takes) vs float64 direct convolution. FastFIR.apply (not __call__):
    # the instance hook would re-enter this report when the env flag is set.
    out = FastFIR.apply(spectra, f32(x_np), backend=backend,
                        mac_backend=mac_backend)
    ref = _direct_conv64(x_np, ir)[..., :L]
    report.append(StageSNR("engine_output", snr_db(ref, out)))
    return report


# -- the streaming chains ------------------------------------------------------

def stream_stage_report(ir, x_warm, x_block, scheme=None,
                        backend: Optional[str] = None,
                        mac_backend: str = "auto", device=None) -> List[StageSNR]:
    """Per-stage SNR of the STREAMING engines (the collapsed hop-aligned
    block path and the sample-granular sub-hop path), mirroring
    :func:`stage_report`'s discipline: each stage's f32 side runs the
    port's own dispatch, fed the SAME inputs as an f64 numpy mirror, so a
    streaming-only accuracy regression localises to its stage.

    ``ir``: (..., L_ir); ``x_warm``/``x_block``: (..., B) hop-aligned blocks
    (B = multiple of the scheme's largest hop). Stages:

    - ``frame_rfft``       hop-frame spectra from the carried prev block
    - ``ring_mac``         the block lag MAC over the carried ring
                           (the engine's ``_ring_mac``: K7, or the torch
                           loop with ``mac_backend="xla"``)
    - ``lag0_product``     the collapsed scheme's zero-delay partition
    - ``rifft_tail``       scaled tail riFFT (the engine's ``_tail``: K4
                           where it serves)
    - ``section_refresh``  non-final-section state rebuild (mono.
                           _refresh_aligned_section)
    - ``collapsed_output`` mono.process end-to-end vs f64 direct conv
    - ``subhop_fire``      one sample-granular hop firing (K9 hop_fire /
                           _fire dispatch) vs its f64 mirror
    - ``subhop_doling``    ragged-callback staging/doling vs one whole-block
                           process_any call (pure data movement — near-exact)
    """
    from ..models import mono
    from ..models import partitioned as part
    from ..models.mono import LatencyMode, PartitionScheme

    if scheme is None:
        scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    dev = _device_of(x_block, device)
    f32 = (lambda a: _t(a, torch.float32, dev))
    ir = np.asarray(ir)
    xw = _np64(x_warm)
    xb = _np64(x_block)
    lead = xb.shape[:-1]
    B = xb.shape[-1]

    mir = mono.prepare_ir(scheme, ir, dtype=torch.float32, backend=backend,
                          offline_tail=False, device=dev)
    state0 = mono.init_state(scheme, mir, batch_shape=lead)
    state1, _ = mono.process(mir, state0, f32(xw), backend=backend)

    report: List[StageSNR] = []
    spec = mir.spectra[-1]
    st = state1.sections[-1]
    h = spec.shape[-1]
    n = 2 * h
    p = spec.shape[-2]
    t = B // h

    # Shared f64-exact inputs (the engine's own carried state values).
    prev64 = _np64(st.prev)
    ring_re64 = _np64(st.ring.re)
    ring_im64 = _np64(st.ring.im)
    h_re64 = np.broadcast_to(_np64(spec.re), lead + (p, h))
    h_im64 = np.broadcast_to(_np64(spec.im), lead + (p, h))

    # Stage 1: hop-frame rFFT from the carried previous block.
    blocks64 = xb.reshape(lead + (t, h))
    prev_rows64 = np.concatenate([prev64[..., None, :], blocks64[..., :-1, :]],
                                 axis=-2)
    frames64 = np.concatenate([prev_rows64, blocks64], axis=-1)
    xre, xim = part._hop_spectra(f32(prev64), f32(blocks64), backend)
    xre64, xim64 = packed_rfft64(frames64)
    report.append(StageSNR(
        "frame_rfft", min(snr_db(xre64, xre), snr_db(xim64, xim))))

    # Stage 2: the block ring MAC (process_block's own), f64-exact feeds.
    acc_re, acc_im, _ = part._ring_mac(
        Split(f32(ring_re64), f32(ring_im64)), f32(xre64), f32(xim64),
        Split(f32(h_re64), f32(h_im64)), mac_backend)
    acc_re64 = np.zeros(lead + (t, h))
    acc_im64 = np.zeros(lead + (t, h))
    virt_re = np.concatenate([ring_re64, xre64], axis=-2)  # rows j-p..t-1
    virt_im = np.concatenate([ring_im64, xim64], axis=-2)
    for lag in range(p):
        rows_re = virt_re[..., p - 1 - lag:p - 1 - lag + t, :]
        rows_im = virt_im[..., p - 1 - lag:p - 1 - lag + t, :]
        a, b = packed_mul64(rows_re, rows_im, h_re64[..., lag:lag + 1, :],
                            h_im64[..., lag:lag + 1, :])
        acc_re64 += a
        acc_im64 += b
    report.append(StageSNR(
        "ring_mac", min(snr_db(acc_re64, acc_re), snr_db(acc_im64, acc_im))))

    # Stage 3: the collapsed scheme's zero-delay (lag0 / block0) partition.
    if mir.block0 is not None:
        l0_re64 = _np64(mir.block0.re)
        l0_im64 = _np64(mir.block0.im)
        prod = packed_mul(Split(f32(xre64), f32(xim64)),
                          Split(f32(l0_re64), f32(l0_im64)))
        pr64, pi64 = packed_mul64(xre64, xim64, l0_re64, l0_im64)
        report.append(StageSNR(
            "lag0_product", min(snr_db(pr64, prod.re), snr_db(pi64, prod.im))))
        acc_re64 = acc_re64 + pr64
        acc_im64 = acc_im64 + pi64

    # Stage 4: scaled tail riFFT (process_block's own).
    scale = 1.0 / (4.0 * n)
    y32 = part._tail(f32(acc_re64), f32(acc_im64), scale, backend)
    y64 = packed_rifft64(acc_re64, acc_im64)[..., h:] * scale
    report.append(StageSNR("rifft_tail", snr_db(y64, y32)))

    # Stage 5: non-final-section refresh (the collapsed path's handoff prep).
    if len(mir.spectra) > 1:
        worst = float("inf")
        tail32 = f32(xb[..., -h:])
        tail64 = xb[..., -h:]
        for sp in mir.spectra[:-1]:
            hs = sp.shape[-1]
            ns = 2 * hs
            ps = sp.shape[-2]
            bs = tail64.shape[-1]
            stf = mono._refresh_aligned_section(sp, tail32, backend)
            f64 = np.stack(
                [tail64[..., bs - (ps - 1 - k) * hs - ns:
                        bs - (ps - 1 - k) * hs or None] for k in range(ps)],
                axis=-2)
            rre, rim = packed_rfft64(f64)
            worst = min(worst, snr_db(rre, stf.ring.re),
                        snr_db(rim, stf.ring.im))
        report.append(StageSNR("section_refresh", worst))

    # Stage 6: the collapsed block end to end vs f64 direct convolution.
    _, out = mono.process(mir, state1, f32(xb), backend=backend)
    full = np.concatenate([xw, xb], axis=-1)
    ref = _direct_conv64(full, ir)[..., xw.shape[-1]:xw.shape[-1] + B]
    lat = scheme.latency
    if lat:
        ref = _direct_conv64(full, ir)
        ref = np.pad(ref, [(0, 0)] * (ref.ndim - 1) + [(lat, 0)])[
            ..., xw.shape[-1]:xw.shape[-1] + B]
    report.append(StageSNR("collapsed_output", snr_db(ref, out)))

    # Stage 7: one sample-granular hop firing of the SMALLEST section
    # (K9 on the card) vs its f64 mirror.
    sp0 = mir.spectra[0]
    hs = sp0.shape[-1]
    ns = 2 * hs
    ps = sp0.shape[-2]
    st0 = mono._refresh_aligned_section(sp0, f32(xb), backend)
    ss = part.PartitionedConvolve.stream_from_aligned(sp0, st0, backend)
    ss2, _ = part.PartitionedConvolve.step_any(sp0, ss, f32(xb[..., :hs]), backend)
    # f64 mirror of _fire: insert the frame spectrum at slot pos, advance,
    # then emit with the step() slot mapping.
    win64 = _np64(ss.win)
    r0re = _np64(ss.ring.re)
    r0im = _np64(ss.ring.im)
    fre, fim = packed_rfft64(np.concatenate([win64[..., hs:], xb[..., :hs]],
                                            axis=-1))
    r0re = np.concatenate([fre[..., None, :], r0re[..., 1:, :]], axis=-2) \
        if ps > 1 else fre[..., None, :]
    r0im = np.concatenate([fim[..., None, :], r0im[..., 1:, :]], axis=-2) \
        if ps > 1 else fim[..., None, :]
    pos1 = 1 % ps
    h0re = np.broadcast_to(_np64(sp0.re), lead + (ps, hs))
    h0im = np.broadcast_to(_np64(sp0.im), lead + (ps, hs))
    # emit with step()'s slot mapping: slot s holds lag (pos - 1 - s) mod P
    a64 = np.zeros(lead + (hs,))
    b64 = np.zeros(lead + (hs,))
    for s in range(ps):
        lag = int((pos1 - 1 - s) % ps)
        aa, bb = packed_mul64(r0re[..., s, :], r0im[..., s, :],
                              h0re[..., lag, :], h0im[..., lag, :])
        a64 += aa
        b64 += bb
    fire64 = packed_rifft64(a64, b64)[..., hs:] * (1.0 / (4.0 * ns))
    report.append(StageSNR("subhop_fire", snr_db(fire64, ss2.out_buf)))

    # Stage 8: ragged staging/doling vs one whole-block call (data movement
    # only — both sides run the same engine, so this is near-exact).
    sstate = mono.stream_state_from_aligned(mir, state1, backend)
    _, y_whole = mono.process_any(mir, sstate, f32(xb), backend=backend)
    cuts = [0, 7, 7 + 64, 7 + 64 + 1000, B // 2, B]
    cuts = sorted(set(min(c, B) for c in cuts))
    srag = sstate
    pieces = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        if b > a:
            srag, yp = mono.process_any(mir, srag, f32(xb[..., a:b]),
                                        backend=backend)
            pieces.append(_np(yp))
    y_rag = np.concatenate(pieces, axis=-1)
    report.append(StageSNR("subhop_doling", snr_db(y_whole, y_rag)))
    return report


def two_tier_stage_report(ir, x_warm, x_block,
                          scheme=None,
                          backend: Optional[str] = None,
                          device=None) -> List[StageSNR]:
    """Per-stage SNR of the TWO-TIER block streaming path
    (mono.MonoBlockState) — the same isolated-vs-cumulative discipline as
    :func:`pipeline_stage_report`: each stage runs twice through the
    port's own functions, once at f32 on the signal's device (``backend``
    selects kernels) and once at f64 on the CPU, fed the f64 chain's state.

    Stages: ``near_block`` (G-1-partition ring + lag0 term), ``far_block``
    (the far ring engine at hop G*h), ``two_tier_output`` (mono.process end
    to end vs float64 direct convolution), ``handoff_continuation``
    (aligned_state_from_block -> per-section process at f32 vs f64)."""
    from ..models import mono, partitioned as part
    from ..models.mono import LatencyMode, PartitionScheme

    if scheme is None:
        scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    dev = _device_of(x_block, device)
    ir = np.asarray(ir)
    xw = _np64(x_warm)
    xb = _np64(x_block)
    lead = xb.shape[:-1]
    f64, f32 = torch.float64, torch.float32
    where = {f64: _CPU, f32: dev}

    mirs = {}
    states = {}
    for dt in (f64, f32):
        mirs[dt] = mono.prepare_ir(scheme, ir, dtype=dt, offline_tail=False,
                                   device=where[dt])
        if mirs[dt].far is None:
            raise ValueError("IR too short for a far tier at this scheme")
        s0 = mono.init_block_state(scheme, mirs[dt], batch_shape=lead,
                                   dtype=dt)
        states[dt], _ = mono.process(mirs[dt], s0, _t(xw, dt, where[dt]),
                                     backend=backend if dt == f32 else None)
    m64, m32 = mirs[f64], mirs[f32]
    st64 = states[f64]
    report: List[StageSNR] = []

    # Isolated near/far stages: the f32 stage consumes the f64 chain's state.
    g = m64.far.shape[-1] // m64.spectra[-1].shape[-1]
    near64 = Split(m64.spectra[-1].re[..., :g - 1, :],
                   m64.spectra[-1].im[..., :g - 1, :])
    near32 = Split(m32.spectra[-1].re[..., :g - 1, :],
                   m32.spectra[-1].im[..., :g - 1, :])

    def cast_state(s, dt):
        return part.PartitionedState(
            prev=s.prev.to(where[dt], dt),
            ring=Split(s.ring.re.to(where[dt], dt), s.ring.im.to(where[dt], dt)),
            pos=s.pos)

    xb64 = _t(xb, f64, _CPU)
    xb32 = _t(xb, f32, dev)
    _, yn64 = part.PartitionedConvolve.process_block(
        near64, cast_state(st64.near, f64), xb64, lag0=m64.block0,
        assume_pos0=True)
    _, yn32 = part.PartitionedConvolve.process_block(
        near32, cast_state(st64.near, f32), xb32, backend=backend,
        lag0=m32.block0, assume_pos0=True)
    report.append(StageSNR("near_block", snr_db(yn64, yn32)))

    _, yf64 = part.PartitionedConvolve.process_block(
        m64.far, cast_state(st64.far, f64), xb64, assume_pos0=True)
    _, yf32 = part.PartitionedConvolve.process_block(
        m32.far, cast_state(st64.far, f32), xb32, backend=backend,
        assume_pos0=True)
    report.append(StageSNR("far_block", snr_db(yf64, yf32)))

    # Cumulative end-to-end vs float64 direct convolution.
    st32c, y32 = mono.process(m32, states[f32], xb32, backend=backend)
    full = np.concatenate([xw, xb], axis=-1)
    ref = _direct_conv64(full, ir)[..., xw.shape[-1]:]
    lat = scheme.latency
    if lat:
        ref = _direct_conv64(np.concatenate(
            [np.zeros(lead + (lat,)), full], axis=-1), ir)[
                ..., xw.shape[-1]:xw.shape[-1] + xb.shape[-1]]
    report.append(StageSNR("two_tier_output", snr_db(ref, y32)))

    # Hand-off: project to the per-section form and continue one hop block.
    st64b, _ = mono.process(m64, st64, xb64)
    al32 = mono.aligned_state_from_block(m32, st32c, backend=backend)
    al64 = mono.aligned_state_from_block(m64, st64b)
    b = m64.spectra[-1].shape[-1]
    xq = xb[..., -b * (xb.shape[-1] // b):]
    _, yc64 = mono.process(m64, al64, _t(xq, f64, _CPU))
    _, yc32 = mono.process(m32, al32, _t(xq, f32, dev), backend=backend)
    report.append(StageSNR("handoff_continuation", snr_db(yc64, yc32)))
    return report


def pipeline_stage_report(measured, excitation,
                          sample_rate: float = 48000.0,
                          regularization: float = 1e-9,
                          smooth_widths=(1.0, 63.0),
                          n_peaks: int = 16,
                          stft_size: int = 1024, stft_hop: int = 512,
                          backend: Optional[str] = None,
                          device=None) -> List[StageSNR]:
    """Per-stage SNR of the config-5 IR-measurement chain (deconvolve -> STFT
    amplitude -> variable-width smooth -> peaks -> partial tracking).

    Each stage runs twice through the SAME functions
    (models.pipeline.ir_deconvolve, ops.stft, ops.smoothing.smooth,
    models.pipeline.find_peaks, the tracker's frame loop
    models.pipeline._track_frames): once at f32 on ``device`` (the card
    unless named; ``backend`` selects the kernels) and once at f64 on the
    CPU, the oracle.

    Two numbers per stage localise a loss: ``<stage>`` feeds the f32 stage
    the f64 upstream result (isolated — only this stage's arithmetic
    differs), ``<stage> cum`` compares the full f32 chain so far (where the
    end-to-end number actually stands after this stage). Reference analogue:
    the HIRT deconvolution core + per-frame tracker drive
    (SpectralFunctions.hpp:283-336, PartialTracker.hpp:224-289)."""
    from ..models import partial_tracker as pt
    from ..models import pipeline
    from ..ops import smoothing, stft as stft_mod, windows

    dev = resolve_device(device)
    kernel = windows.hann(127, dtype=torch.float64, device=_CPU).numpy()[63:]
    win = windows.hann(stft_size - 1, dtype=torch.float64, device=_CPU).numpy()
    m64 = np.asarray(measured, np.float64)
    e64 = np.asarray(excitation, np.float64)

    def chain(dtype, h=None, amp=None, smoothed=None, peaks=None):
        """Run the chain from the first stage whose input is not supplied."""
        d = _CPU if dtype == torch.float64 else dev
        out = {}
        if h is None:
            h = pipeline.ir_deconvolve(_t(m64, dtype, d), _t(e64, dtype, d),
                                       regularization, backend=backend)
            h = h.mean(dim=0) if h.ndim > 1 else h
        out["h"] = h = torch.as_tensor(h).to(d, dtype)
        if amp is None:
            amp = pipeline._amplitude(
                stft_mod.stft(h, win, stft_size, stft_hop, backend=backend))
        out["amp"] = amp = torch.as_tensor(amp).to(d, dtype)
        if smoothed is None:
            smoothed = smoothing.smooth(
                amp, kernel, smooth_widths[0], smooth_widths[1],
                symmetric=True, edges=smoothing.EdgeMode.Extend,
                backend=backend)
        out["smoothed"] = smoothed = torch.as_tensor(smoothed).to(d, dtype)
        if peaks is None:
            peaks = pipeline.find_peaks(smoothed, n_peaks,
                                        bin_hz=sample_rate / stft_size)
        out["freqs"] = torch.as_tensor(peaks[0]).to(d, dtype)
        out["amps"] = torch.as_tensor(peaks[1]).to(d, dtype)
        n_valid = (out["amps"] > 0.0).sum(dim=-1)
        cfg = pt.TrackerConfig(max_peaks=n_peaks, max_tracks=n_peaks)
        out["tf"], out["ta"], out["ts"] = pipeline._track_frames(
            cfg, out["freqs"], out["amps"], n_valid, 0.0)
        return {k: _np(v) for k, v in out.items()}

    ref = chain(torch.float64)
    cum = chain(torch.float32)

    report = [StageSNR("deconvolve", snr_db(ref["h"], cum["h"]))]

    iso_amp = chain(torch.float32, h=ref["h"].astype(np.float32))
    report.append(StageSNR("stft_amp", snr_db(ref["amp"], iso_amp["amp"])))
    report.append(StageSNR("stft_amp cum", snr_db(ref["amp"], cum["amp"])))

    iso_sm = chain(torch.float32, h=ref["h"].astype(np.float32),
                   amp=ref["amp"].astype(np.float32))
    report.append(StageSNR("smooth", snr_db(ref["smoothed"],
                                            iso_sm["smoothed"])))
    report.append(StageSNR("smooth cum", snr_db(ref["smoothed"],
                                                cum["smoothed"])))

    iso_pk = chain(torch.float32, h=ref["h"].astype(np.float32),
                   amp=ref["amp"].astype(np.float32),
                   smoothed=ref["smoothed"].astype(np.float32))
    report.append(StageSNR("peaks", snr_db(ref["amps"], iso_pk["amps"])))
    report.append(StageSNR("peaks cum", snr_db(ref["amps"], cum["amps"])))
    report.append(StageSNR("peak_freqs cum", snr_db(ref["freqs"],
                                                    cum["freqs"])))

    iso_tr = chain(torch.float32, h=ref["h"].astype(np.float32),
                   amp=ref["amp"].astype(np.float32),
                   smoothed=ref["smoothed"].astype(np.float32),
                   peaks=(ref["freqs"].astype(np.float32),
                          ref["amps"].astype(np.float32)))
    report.append(StageSNR("track", snr_db(ref["tf"], iso_tr["tf"])))
    report.append(StageSNR("track cum", snr_db(ref["tf"], cum["tf"])))
    return report


def _direct_conv64(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    ir = np.asarray(ir, np.float64)
    if x.ndim == 1 and ir.ndim == 1:
        return np.convolve(x, ir)[: x.shape[-1]]
    shape = np.broadcast_shapes(x.shape[:-1], ir.shape[:-1])
    xb = np.broadcast_to(x, shape + x.shape[-1:])
    hb = np.broadcast_to(ir, shape + ir.shape[-1:])
    out = np.empty(shape + x.shape[-1:])
    for idx in np.ndindex(*shape):
        out[idx] = np.convolve(xb[idx], hb[idx])[: x.shape[-1]]
    return out


def format_report(stages: List[StageSNR]) -> str:
    width = max(len(s.stage) for s in stages)
    return "\n".join(f"  {s.stage:<{width}}  {s.snr_db:8.1f} dB"
                     for s in stages)


def maybe_report(ir, x, fft_size: Optional[int], backend: Optional[str],
                 tag: str) -> None:
    """Engine hook: print a stage report when HISSTOOLS_DEBUG_STAGES is set,
    outside ``torch.compile`` tracing (skipped silently there, as the JAX
    twin skips tracers)."""
    if not enabled():
        return
    if torch.compiler.is_compiling():
        return
    stages = stage_report(ir, x, fft_size, backend)
    print(f"[debug-stages] {tag}:\n{format_report(stages)}",
          file=sys.stderr, flush=True)
