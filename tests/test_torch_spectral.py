"""Port parity: the spectral layer (ops/spectral.py, ops/spectral_processor.py,
the rest of fft/api.py and pipeline.ir_deconvolve) against the JAX package.

Inputs are made with numpy from a seed and handed to both sides, on the CPU at
small sizes. Both sides take the "xla" path there (``jnp.fft`` and
``torch.fft``). Tolerances: >= 120 dB SNR in float32 (FFTs whose sums are
taken in another order, ~130 dB), >= 250 dB in float64 (``backend="xla"`` on
both sides, the JAX side under ``jax_enable_x64`` as the suite's oracles run);
index shuffles (zip, pack) are exact. One float32 exception: the phase
interpolation with a linear-phase term (``ir_phase`` / ``change_phase`` at a
phase other than 0, 0.5 and the zero-centred 1.0) rounds its phase argument
-2 pi phase k, up to ~pi N radians, to float32, so the JAX package's own
float32 path holds only 75-117 dB against float64 there, and two float32 paths
whose FFTs round differently disagree by as much. There the port must hold
at least the JAX float32 path's own SNR against float64, less 3 dB (as
chip_smoke.py's change_phase check does). The Hopper kernels these paths launch on
a CUDA tensor are held against their plain versions in
tests/test_torch_fft.py and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.core.types import Split as JSplit  # noqa: E402
from hisstools_library_tpu.fft import api as jax_api  # noqa: E402
from hisstools_library_tpu.models import pipeline as jax_pipeline  # noqa: E402
from hisstools_library_tpu.ops import spectral as jax_spectral  # noqa: E402
from hisstools_library_tpu.ops import spectral_processor as jax_sp  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.fft import api, hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import pipeline  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral, spectral_processor as sp  # noqa: E402

DTYPES = [np.float32, np.float64]
MODES = list(sp.EdgeMode)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def floor_db(dtype):
    return 120.0 if dtype == np.float32 else 250.0


def both(a):
    """The same numpy array on both sides."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def assert_close(ref, test, dtype):
    ref, test = np.asarray(ref), np.asarray(test)
    assert ref.shape == test.shape, (ref.shape, test.shape)
    assert test.dtype == dtype
    assert snr_db(ref, test) >= floor_db(dtype)


def assert_split_close(jref, tsplit, dtype):
    assert_close(jref.re, tsplit.re, dtype)
    assert_close(jref.im, tsplit.im, dtype)


def linear_phase_term(phase, zero_center):
    """True where the phase interpolation adds a float32-rounded linear
    phase (SpectralFunctions.hpp:206-229)."""
    return not zero_center and phase not in (0.0, 0.5)


def assert_phase_close(jax_fn, port_fn, jx, tx, dtype, conditioned):
    """jax_fn(jx) against port_fn(tx); see the module docstring for the
    ill-conditioned float32 case."""
    want, got = jax_fn(jx), port_fn(tx)
    if dtype == np.float64 or conditioned:
        assert_close(want, got, dtype)
        return
    ref = np.asarray(jax_fn(jnp.asarray(np.asarray(jx), jnp.float64)))
    assert got.dtype == torch.float32
    assert snr_db(ref, got) >= snr_db(ref, want) - 3.0


def spectrum(rng, dtype, lead=(2,), nbins=256):
    """A packed spectrum with a DC-heavy lane 0, so a lane-0 mistake shows."""
    re, im = rng.standard_normal((2, *lead, nbins)).astype(dtype)
    re[..., 0] += 4.0
    return both(re), both(im)


# -- fft/api ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fft_ifft_match_jax(rng, dtype, n):
    (jre, tre), (jim, tim) = (both(a) for a in rng.standard_normal((2, 3, n)).astype(dtype))
    for jfn, tfn in ((jax_api.fft, api.fft), (jax_api.ifft, api.ifft)):
        jr, ji = jfn(jre, jim, backend="xla")
        tr, ti = tfn(tre, tim, backend="xla")
        assert_close(jr, tr, dtype)
        assert_close(ji, ti, dtype)
    # ifft(fft(z)) = N z
    tr, ti = api.ifft(*api.fft(tre, tim))
    assert snr_db(n * tre.numpy(), tr) >= floor_db(dtype)


@pytest.mark.parametrize("length", [700, 1024, 3000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rfft_padded_matches_jax(rng, dtype, length):
    """Zero padding (700), the exact size (1024) and truncation (3000)."""
    jx, tx = both(rng.standard_normal((2, length)).astype(dtype))
    jre, jim = jax_api.rfft_padded(jx, 1024, backend="xla")
    tre, tim = api.rfft_padded(tx, 1024, backend="xla")
    assert_close(jre, tre, dtype)
    assert_close(jim, tim, dtype)


@pytest.mark.parametrize("length,size", [(9, 16), (16, 16), (40, 16)])
def test_zip_helpers_match_jax(rng, length, size):
    """unzip / zip_split / unzip_zero, odd, exact and longer inputs: exact."""
    jx, tx = both(rng.standard_normal((2, length)).astype(np.float32))
    if length % 2 == 0:
        for j, t in zip(jax_api.unzip(jx), api.unzip(tx)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax_api.zip_split(*jax_api.unzip(jx))),
            api.zip_split(*api.unzip(tx)).numpy())
    for j, t in zip(jax_api.unzip_zero(jx, size), api.unzip_zero(tx, size)):
        assert t.shape == (2, size // 2)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_spectrum_round_trip_matches_jax(rng, dtype):
    (jre, tre), (jim, tim) = (both(a) for a in rng.standard_normal((2, 3, 65)).astype(dtype))
    jp = jax_api.pack_spectrum(jre, jim)
    tp = api.pack_spectrum(tre, tim)
    np.testing.assert_array_equal(np.asarray(jp.re), tp.re.numpy())
    np.testing.assert_array_equal(np.asarray(jp.im), tp.im.numpy())
    for j, t in zip(jax_api.unpack_spectrum(jp), api.unpack_spectrum(tp)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


# -- ops/spectral ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_per_bin_ops_match_jax(rng, dtype):
    """ir_copy, ir_time_reverse, ir_spike, ir_delay (0 and 3.7 samples),
    log_power (with bins at and below the -300 dB floor) and the four
    binary per-bin ops."""
    n = 512
    (jre, tre), (jim, tim) = spectrum(rng, dtype)
    js, ts = JSplit(jre, jim), Split(tre, tim)
    assert_split_close(jax_spectral.ir_copy(js), spectral.ir_copy(ts), dtype)
    assert_split_close(jax_spectral.ir_time_reverse(js), spectral.ir_time_reverse(ts), dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for pos in (0.0, 5.0, 17.25):
        assert_split_close(jax_spectral.ir_spike(n // 2, n, pos, dtype=dtype),
                           spectral.ir_spike(n // 2, n, pos, dtype=tdt, device="cpu"),
                           dtype)
    for delay in (0.0, 3.7):
        assert_split_close(jax_spectral.ir_delay(js, n, delay),
                           spectral.ir_delay(ts, n, delay), dtype)
    floored_re = np.asarray(jre).copy()
    floored_re[:, 5:9] = 0.0
    floored_re[:, 0] = 1e-200 if dtype == np.float64 else 0.0
    jf, tf = both(floored_re)
    assert_split_close(jax_spectral.log_power(JSplit(jf, jim)),
                       spectral.log_power(Split(tf, tim)), dtype)
    (jre2, tre2), (jim2, tim2) = spectrum(rng, dtype)
    js2, ts2 = JSplit(jre2, jim2), Split(tre2, tim2)
    for name in ("ir_convolve_complex", "ir_convolve_real", "ir_correlate_complex",
                 "ir_correlate_real"):
        for scale in (1.0, 0.25 / n):
            assert_split_close(getattr(jax_spectral, name)(js, js2, scale),
                               getattr(spectral, name)(ts, ts2, scale), dtype)


@pytest.mark.parametrize("zero_center", [False, True])
@pytest.mark.parametrize("phase", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ir_phase_matches_jax(rng, dtype, phase, zero_center):
    """Amplitude (0.5), the cepstral minimum phase (0.0), its conjugate (1.0,
    zero_center) and the interpolation (0.25; 1.0 without zero_center) on the
    spectrum of a decaying IR."""
    n = 1024
    x = (rng.standard_normal((2, 600)) * np.exp(-np.arange(600) / 80)).astype(dtype)
    jx, tx = both(x)
    jspec = JSplit(*jax_api.rfft_padded(jx, n, backend="xla"))
    tspec = Split(*api.rfft_padded(tx, n, backend="xla"))
    assert_split_close(jax_spectral.minimum_phase_components(jspec, n, backend="xla"),
                       spectral.minimum_phase_components(tspec, n, backend="xla"), dtype)
    conditioned = not linear_phase_term(phase, zero_center)
    for plane in ("re", "im"):
        assert_phase_close(
            lambda a: getattr(jax_spectral.ir_phase(
                JSplit(*jax_api.rfft_padded(a, n, backend="xla")), n, phase,
                zero_center, backend="xla"), plane),
            lambda a: getattr(spectral.ir_phase(
                Split(*api.rfft_padded(a, n, backend="xla")), n, phase, zero_center,
                backend="xla"), plane),
            jx, tx, dtype, conditioned)


# -- ops/spectral_processor -----------------------------------------------------------

SIZES = [(300, 57), (40, 129), (64, 64), (1, 1)]


def _real_pair(rng, dtype, s1, s2):
    return both(rng.standard_normal((2, s1)).astype(dtype)), \
        both(rng.standard_normal((2, s2)).astype(dtype))


@pytest.mark.parametrize("op", ["convolve", "correlate"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_real_binary_ops_match_jax(rng, mode, op):
    """Every edge mode, s1 > s2, s1 < s2, equal sizes and the 1 x 1 case, in
    float32 (default backend) and float64 ("xla")."""
    jmode = jax_sp.EdgeMode[mode.name]
    for dtype in DTYPES:
        backend = None if dtype == np.float32 else "xla"
        for s1, s2 in SIZES:
            (j1, t1), (j2, t2) = _real_pair(rng, dtype, s1, s2)
            want = getattr(jax_sp, op)(j1, j2, jmode, backend=backend)
            got = getattr(sp, op)(t1, t2, mode, backend=backend)
            assert got.shape[-1] == sp.convolved_size(s1, s2, mode)
            assert_close(want, got, dtype)


@pytest.mark.parametrize("length", range(1, 17))
def test_small_convolve_matches_jax(rng, length):
    """convolve of two signals of 1..16 samples (FFT sizes 4..32, the card's
    tiny kernels up to 16) in float32 (default backend) and float64 ("xla")."""
    for dtype in DTYPES:
        backend = None if dtype == np.float32 else "xla"
        (j1, t1), (j2, t2) = _real_pair(rng, dtype, length, length)
        want = jax_sp.convolve(j1, j2, backend=backend)
        got = sp.convolve(t1, t2, backend=backend)
        assert got.shape[-1] == 2 * length - 1
        assert_close(want, got, dtype)


@pytest.mark.parametrize("call,kernel", [
    # Two 5-sample signals: FFT size 16, the tiny forms of K10 and K12.
    (lambda d: sp.convolve(torch.empty(2, 5, device=d), torch.empty(2, 5, device=d),
                           backend="pallas"), "K10"),
    (lambda d: sp.correlate(torch.empty(2, 5, device=d), torch.empty(2, 3, device=d),
                            backend="pallas"), "K10"),
    (lambda d: sp.convolve_complex(*(Split(torch.empty(2, 5, device=d),
                                           torch.empty(2, 5, device=d)) for _ in range(2)),
                                   backend="pallas"), "K12"),
])
def test_small_ops_route_to_kernels_off_cpu(call, kernel):
    """Off the CPU the spectral ops at FFT sizes below 32 reach a kernel's
    wrapper, which refuses the meta device by its kernel's name."""
    with pytest.raises(ValueError, match=f"{kernel} .*CUDA"):
        call(torch.device("meta"))


@pytest.mark.parametrize("op", ["convolve_complex", "correlate_complex"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_complex_binary_ops_match_jax(rng, mode, op):
    """Complex signals in every edge mode; z1's planes differ in length (the
    shorter is zero-padded to the longer)."""
    jmode = jax_sp.EdgeMode[mode.name]
    for dtype in DTYPES:
        backend = None if dtype == np.float32 else "xla"
        for s1, s2 in SIZES:
            planes = [rng.standard_normal((2, n)).astype(dtype)
                      for n in (s1, max(s1 - 3, 1), s2, s2)]
            jz = [JSplit(jnp.asarray(a), jnp.asarray(b)) for a, b in (planes[:2], planes[2:])]
            tz = [Split(torch.from_numpy(a), torch.from_numpy(b))
                  for a, b in (planes[:2], planes[2:])]
            want = getattr(jax_sp, op)(*jz, jmode, backend=backend)
            got = getattr(sp, op)(*tz, mode, backend=backend)
            assert_split_close(want, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_and_size_helpers_match_jax(dtype):
    for s1, s2 in [(0, 5), (7, 0), (300, 57), (57, 300), (1, 1)]:
        assert sp.required_fft_size(s1, s2) == jax_sp.required_fft_size(s1, s2)
        for mode in MODES:
            jmode = jax_sp.EdgeMode[mode.name]
            assert sp.convolved_size(s1, s2, mode) == jax_sp.convolved_size(s1, s2, jmode)
            assert sp.correlated_size(s1, s2, mode) == jax_sp.correlated_size(s1, s2, jmode)
    for size in (0, 1, 2, 3, 1000, 1024, 1025):
        assert sp.calc_fft_size_log2(size) == jax_sp.calc_fft_size_log2(size)
    out = sp.convolve(torch.zeros(2, 0, dtype=torch.float64 if dtype == np.float64
                                  else torch.float32), torch.ones(2, 5))
    assert out.shape == (2, 0)


@pytest.mark.parametrize("time_multiplier", [1.0, 2.5])
@pytest.mark.parametrize("phase", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_change_phase_matches_jax(rng, dtype, phase, time_multiplier):
    x = (rng.standard_normal((2, 500)) * np.exp(-np.arange(500) / 60)).astype(dtype)
    jx, tx = both(x)
    backend = None if dtype == np.float32 else "xla"
    for zero_center in (False, True):
        assert_phase_close(
            lambda a: jax_sp.change_phase(a, phase, time_multiplier, zero_center,
                                          backend=backend),
            lambda a: sp.change_phase(a, phase, time_multiplier, zero_center,
                                      backend=backend),
            jx, tx, dtype, not linear_phase_term(phase, zero_center))
    one = torch.tensor([3.0], dtype=tx.dtype)
    assert sp.change_phase(one, phase) is one


@pytest.mark.parametrize("dtype", DTYPES)
def test_ir_deconvolve_matches_jax(rng, dtype):
    """Three channels of a noise excitation through short IRs, and the
    one-channel excitation broadcast against them."""
    exc = rng.standard_normal(1000)
    hs = rng.standard_normal((3, 40)) * np.exp(-np.arange(40) / 10)
    measured = np.stack([np.convolve(exc, h) for h in hs]).astype(dtype)
    (jm, tm), (je, te) = both(measured), both(exc.astype(dtype))
    backend = None if dtype == np.float32 else "xla"
    for reg in (1e-4, 1e-12):
        want = jax_pipeline.ir_deconvolve(jm, je, reg, backend=backend)
        got = pipeline.ir_deconvolve(tm, te, reg, backend=backend)
        assert got.shape == (3, 2048)
        assert_close(want, got, dtype)


# -- the real per-bin products: the plain versions of K16's epilogues ---------------

def _jax_divide(jy, jx, reg, scale):
    """The JAX package's ir_deconvolve division on packed spectra (its
    models/pipeline.py steps: unpack, floor over every bin, divide, pack),
    times ``scale``."""
    from hisstools_library_tpu.core.types import cmul_conj as jax_cmul_conj

    yr, yi = jax_api.unpack_spectrum(jy)
    xr, xi = jax_api.unpack_spectrum(jx)
    power = xr * xr + xi * xi
    denom = power + reg * jnp.max(power, axis=-1, keepdims=True)
    num = jax_cmul_conj(JSplit(yr, yi), JSplit(xr, xi))
    h = jax_api.pack_spectrum(num.re / denom, num.im / denom)
    return JSplit(h.re * scale, h.im * scale)


def _lane0_apart(rng, dtype, lead):
    """A packed spectrum whose DC and Nyquist differ in size and sign, so a
    product that mixed them (a complex bin 0) would be far off."""
    (jre, tre), (jim, tim) = spectrum(rng, dtype, lead=lead)
    re, im = np.array(jre), np.array(jim)
    re[..., 0] = rng.uniform(3.0, 6.0, lead)
    im[..., 0] = -rng.uniform(7.0, 11.0, lead)
    (jre, tre), (jim, tim) = both(re), both(im)
    return JSplit(jre, jim), Split(tre, tim)


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_real_products_keep_dc_and_nyquist_apart(rng, dtype, backend):
    """ir_convolve_real, ir_correlate_real and ir_deconvolve_real on odd
    batch shapes (2, 3, N/2) against (3, N/2) and against one row, with DC
    and Nyquist lanes that would be wrong if mixed; ``"pallas"`` takes the
    kernels' route, whose wrappers run the plain versions on the CPU."""
    n = 512
    ja, ta = _lane0_apart(rng, dtype, (2, 3))
    for lead in ((3,), (1,)):
        jb, tb = _lane0_apart(rng, dtype, lead)
        for name in ("ir_convolve_real", "ir_correlate_real"):
            got = getattr(spectral, name)(ta, tb, 0.25 / n, backend=backend)
            assert_split_close(getattr(jax_spectral, name)(ja, jb, 0.25 / n), got, dtype)
            np.testing.assert_array_equal(got.re[..., 0].numpy(),
                                          (ta.re[..., 0] * tb.re[..., 0] * (0.25 / n)).numpy())
            np.testing.assert_array_equal(got.im[..., 0].numpy(),
                                          (ta.im[..., 0] * tb.im[..., 0] * (0.25 / n)).numpy())
        for reg in (1e-4, 1e-12):
            got = spectral.ir_deconvolve_real(ta, tb, reg, 0.5 / n, backend=backend)
            assert got.re.shape == (2, 3, n // 2)
            assert_split_close(_jax_divide(ja, jb, reg, 0.5 / n), got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ir_deconvolve_real_floor_bounds_zero_bins(rng, dtype):
    """An excitation with zero bins (DC, Nyquist and body, exactly zero and
    1e-6 of the rest) and a row with one bin above 1e-6: there the floor
    alone bounds the quotient, which stays finite and matches the JAX
    division; exact zeros give exact zeros."""
    jy, ty = _lane0_apart(rng, dtype, (2, 3))
    jx, tx = _lane0_apart(rng, dtype, (3,))
    re, im = np.array(jx.re), np.array(jx.im)
    re[:, 5:9] = im[:, 5:9] = 0.0
    re[:, 20:30] = im[:, 20:30] = 1e-6
    re[0, 0] = 0.0   # no DC in row 0
    im[1, 0] = 0.0   # no Nyquist in row 1
    re[2], im[2] = 1e-6, 1e-6  # row 2: one bin, the floor bounds the rest
    re[2, 40] = 1.0
    (jre, tre), (jim, tim) = both(re), both(im)
    jx, tx = JSplit(jre, jim), Split(tre, tim)
    for backend in (None, "pallas"):
        got = spectral.ir_deconvolve_real(ty, tx, 1e-4, 1.0, backend=backend)
        assert bool(torch.isfinite(got.re).all() and torch.isfinite(got.im).all())
        assert_split_close(_jax_divide(jy, jx, 1e-4, 1.0), got, dtype)
        assert not got.re[:, :2, 5:9].any() and not got.im[:, :2, 5:9].any()
        assert not got.re[:, 0, 0].any() and not got.im[:, 1, 0].any()


@pytest.mark.parametrize("layout", ["broadcast", "batched", "rows"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ir_deconvolve_excitation_layouts_match_jax(rng, dtype, layout):
    """Captures of shape (2, 3, L) against one excitation row broadcast, an
    excitation a capture (batched) and one a column of captures (3, L),
    on the default route and the kernels' route."""
    exc = rng.standard_normal({"broadcast": (700,), "batched": (2, 3, 700),
                               "rows": (3, 700)}[layout])
    hs = rng.standard_normal((2, 3, 30)) * np.exp(-np.arange(30) / 8)
    ex = np.broadcast_to(exc, (2, 3, 700))
    measured = np.stack([[np.convolve(ex[i, j], hs[i, j]) for j in range(3)]
                         for i in range(2)]).astype(dtype)
    (jm, tm), (je, te) = both(measured), both(exc.astype(dtype))
    want = jax_pipeline.ir_deconvolve(jm, je, 1e-4,
                                      backend=None if dtype == np.float32 else "xla")
    for backend in (None if dtype == np.float32 else "xla", "pallas"):
        got = pipeline.ir_deconvolve(tm, te, 1e-4, backend=backend)
        assert got.shape == (2, 3, 1024)
        assert_close(want, got, dtype)


@pytest.mark.parametrize("op", ["ir_convolve_real", "ir_correlate_real",
                                "ir_deconvolve_real"])
def test_real_products_route_to_k16_off_cpu(op):
    """Off the CPU the real per-bin products reach K16's wrappers, which
    refuse the meta device by the kernel's name."""
    a = Split(torch.empty(2, 8, device="meta"), torch.empty(2, 8, device="meta"))
    args = (1e-4,) if op == "ir_deconvolve_real" else ()
    with pytest.raises(ValueError, match="K16 .*CUDA"):
        getattr(spectral, op)(a, a, *args, backend="pallas")


@pytest.mark.parametrize("a_lead,b_lead,expand_a,expand_b", [
    ((2, 3), (3,), False, True),    # b broadcasts only in part: expanded
    ((2, 3), (1,), False, False),   # one row: kept, broadcast by its stride
    ((2, 3), (), False, False),
    ((3,), (2, 3), True, False),
    ((1, 3), (2, 1), True, True),   # each broadcasts only in part
    ((4,), (4,), False, False),     # every row: kept
])
def test_bin_operands_layout(a_lead, b_lead, expand_a, expand_b):
    """K16's operand layout rule: an operand that holds neither one row nor
    every row of the broadcast shape is expanded to every row; the planes
    come back contiguous, and an operand already in the layout is the same
    tensor (no copy)."""
    k = 6
    planes = [torch.randn(*lead, k) for lead in (a_lead, a_lead, b_lead, b_lead)]
    got = hopper_kernels.bin_operands(*planes)
    lead = np.broadcast_shapes(a_lead, b_lead)
    for i, (plane, out) in enumerate(zip(planes, got)):
        expanded = expand_a if i < 2 else expand_b
        assert out.is_contiguous()
        if expanded:
            assert out.shape == lead + (k,)
            assert torch.equal(out, plane.expand(lead + (k,)))
        else:
            assert out is plane


def test_bin_operands_copies_strided_planes():
    """A strided plane in the layout is copied once to a contiguous one."""
    a = torch.randn(3, 2 * 8)[:, ::2]
    b = torch.randn(1, 8)
    got = hopper_kernels.bin_operands(a, a, b, b)
    assert all(t.is_contiguous() for t in got)
    assert torch.equal(got[0], a) and got[2] is b
    with pytest.raises(ValueError, match="K16"):
        hopper_kernels.bin_operands(a, a, torch.randn(2, 8), torch.randn(2, 8))


def test_ir_spike_builds_on_the_card_by_default():
    """ir_spike with no device builds on CUDA (core/types.default_device),
    never silently on the CPU: without a card the call fails in torch's own
    CUDA error. Naming the CPU always works."""
    assert spectral.ir_spike(8, 16, 3.0, device="cpu").re.device.type == "cpu"
    if torch.cuda.is_available():
        assert spectral.ir_spike(8, 16, 3.0).re.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            spectral.ir_spike(8, 16, 3.0)
