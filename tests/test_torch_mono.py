"""Port parity: mono.process at the repo's real preset sizes (models/mono.py).

The Zero preset (TD head + 256/1024/4096/16384) with one channel and a
140 000-tap IR, so the far tier exists (G = 2: far hop 16 384, P2 = 8), and
the throughput-matched scheme of ``PartitionScheme.for_latency_budget(8192)``
(one section, N = 2^14, P = 18). ``prepare_ir`` runs the JAX package's
kernels in interpret mode (K10 at N = 256, 1024; K1 at 4096..32768) against
the port's plain versions; each path then streams three carried blocks in
both packages. The two-tier path runs with ``backend="pallas"``: the near
tier as the chain kernel K8, the far tier as K1 -> K7 -> K4 (interpret mode
on the JAX side, plain versions in the port). The collapsed and matched paths
run with no backend given: ``jnp.fft`` / ``torch.fft`` transforms around the
ring MAC K7.

Tolerances: >= 110 dB SNR against JAX (float32 transforms and sums in another
order), >= 100 dB against a float64 FFT convolution (the scheme has zero
latency, so the output is conv(x, ir) itself).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import pallas_fft  # noqa: E402
from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402

SNR_JAX_DB = 110.0
SNR_F64_DB = 100.0
IR_LEN = 140_000
CPU = "cpu"  # the port builds on the card unless a call names the CPU


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def convolve_f64(x, h, n):
    """conv(x, h)[:n] in float64, through an FFT longer than the full result."""
    size = 1 << (len(x) + len(h) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), size) * np.fft.rfft(h.astype(np.float64), size)
    return np.fft.irfft(spec, size)[:n]


@pytest.fixture(scope="module", autouse=True)
def highest():
    """The JAX kernels in their "highest" precision mode for this module."""
    mode = pallas_fft.get_mode()
    pallas_fft.set_mode("highest")
    yield
    pallas_fft.set_mode(mode)


@pytest.fixture(scope="module")
def zero_preset():
    rng = np.random.default_rng(0x30)
    ir = (rng.standard_normal(IR_LEN) * np.exp(-np.arange(IR_LEN) / 24000.0)
          ).astype(np.float32)
    jir = jmono.prepare_ir(jmono.PartitionScheme.from_latency(jmono.LatencyMode.Zero),
                           ir, dtype=jnp.float32, backend="pallas", offline_tail=False)
    tir = tmono.prepare_ir(tmono.PartitionScheme.from_latency(tmono.LatencyMode.Zero),
                           ir, backend="pallas", offline_tail=False, device=CPU)
    return ir, jir, tir


def test_prepare_ir_matches_jax(zero_preset):
    _, jir, tir = zero_preset
    assert [tuple(s.shape) for s in tir.spectra] == \
        [(3, 128), (3, 512), (3, 2048), (17, 8192)]
    assert tuple(tir.far.shape) == (8, 16384) and tuple(tir.block0.shape) == (1, 8192)
    assert tir.head_taps.shape == (128,) and tir.head_taps.dtype == torch.float32
    for j, t in zip(jir.spectra + (jir.block0, jir.far), tir.spectra + (tir.block0, tir.far)):
        assert snr_db(j.re, t.re) >= SNR_JAX_DB and snr_db(j.im, t.im) >= SNR_JAX_DB
    assert np.array_equal(np.asarray(jir.head_taps), tir.head_taps.numpy())


@pytest.mark.parametrize("path", ["two_tier", "collapsed", "matched"])
def test_mono_process_matches_jax_and_float64(zero_preset, path):
    ir, jir, tir = zero_preset
    if path == "matched":
        jscheme = jmono.PartitionScheme.for_latency_budget(8192)
        tscheme = tmono.PartitionScheme.for_latency_budget(8192)
        assert tscheme.sizes == (16384,) and not tscheme.zero_latency
        jir = jmono.prepare_ir(jscheme, ir, dtype=jnp.float32, offline_tail=False)
        tir = tmono.prepare_ir(tscheme, ir, offline_tail=False, device=CPU)
        assert tir.block0 is None and tuple(tir.spectra[0].shape) == (18, 8192)
    else:
        jscheme = jmono.PartitionScheme.from_latency(jmono.LatencyMode.Zero)
        tscheme = tmono.PartitionScheme.from_latency(tmono.LatencyMode.Zero)
    if path == "two_tier":
        jst = jmono.init_block_state(jscheme, jir)
        tst = tmono.init_block_state(tscheme, tir)
        block = tir.far.shape[-1]
    else:
        jst = jmono.init_state(jscheme, jir)
        tst = tmono.init_state(tscheme, tir)
        block = tir.spectra[-1].shape[-1]
    rng = np.random.default_rng(0x31)
    backend = "pallas" if path == "two_tier" else None
    # One compile for the three calls (interpret mode is slow to trace).
    jprocess = jax.jit(lambda i, s, x: jmono.process(i, s, x, backend=backend))
    xs, ys = [], []
    for _ in range(3):
        x = rng.standard_normal(block).astype(np.float32)
        jst, jy = jprocess(jir, jst, jnp.asarray(x))
        tst, ty = tmono.process(tir, tst, torch.from_numpy(x), backend=backend)
        assert type(tst).__name__ == type(jst).__name__
        assert ty.shape == (block,) and ty.dtype == torch.float32
        assert snr_db(jy, ty) >= SNR_JAX_DB
        xs.append(x)
        ys.append(ty.numpy())
    x, y = np.concatenate(xs), np.concatenate(ys)
    latency = tscheme.latency
    ref = convolve_f64(x, ir, len(x) - latency)
    assert snr_db(ref, y[latency:]) >= SNR_F64_DB


def test_collapsed_state_views_one_copy_of_the_block_tail(zero_preset):
    """The collapsed path's refreshed states (the head and every non-final
    section's prev) are views of the final section's new prev, the one copy
    of the block's last hop: writing to the input afterwards changes no
    state, the rings are the transforms of the newest P frames, and the
    hand-off to the sample-granular path reads the views exactly as it
    reads copies."""
    from hisstools_library_tpu_torch.fft import api as fft_api
    from hisstools_library_tpu_torch.models import partitioned as tpart

    _, _, tir = zero_preset
    scheme = tmono.PartitionScheme.from_latency(tmono.LatencyMode.Zero)
    rng = np.random.default_rng(0x32)
    b = tir.spectra[-1].shape[-1]
    x = torch.from_numpy(rng.standard_normal(2 * b).astype(np.float32))
    st, _ = tmono.process(tir, tmono.init_state(scheme, tir), x)
    big = st.sections[-1].prev
    keep = st.head.shape[-1]
    assert torch.equal(big, x[-b:])
    assert st.head.untyped_storage().data_ptr() == big.untyped_storage().data_ptr()
    assert torch.equal(st.head, x[-keep:])
    for spec, sec in zip(tir.spectra[:-1], st.sections[:-1]):
        h, p = spec.shape[-1], spec.shape[-2]
        assert sec.prev.untyped_storage().data_ptr() == big.untyped_storage().data_ptr()
        assert torch.equal(sec.prev, x[-h:]) and sec.pos == 0
        frames = torch.stack([x[len(x) - (p - 1 - k) * h - 2 * h: len(x) - (p - 1 - k) * h]
                              for k in range(p)])
        re, im = fft_api.rfft(frames)
        assert torch.equal(sec.ring.re, re) and torch.equal(sec.ring.im, im)
    snapshot = [t.clone() for t in (st.head, *(s.prev for s in st.sections))]
    x.fill_(7.0)
    assert all(torch.equal(a, t) for a, t in
               zip(snapshot, (st.head, *(s.prev for s in st.sections))))

    copied = tmono.MonoState(st.head.clone(), tuple(
        tpart.PartitionedState(s.prev.clone(), s.ring, s.pos) for s in st.sections))
    y_block = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    _, y_views = tmono.process_any(tir, tmono.stream_state_from_aligned(tir, st), y_block)
    _, y_copies = tmono.process_any(tir, tmono.stream_state_from_aligned(tir, copied),
                                    y_block)
    assert torch.equal(y_views, y_copies)
