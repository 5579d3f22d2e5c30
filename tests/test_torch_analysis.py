"""The port's analysis ops against the JAX package, on the CPU.

``ops/windows``, ``ops/interpolation``, ``ops/table_reader``, ``ops/stft``
(K10w / K11w on a CPU tensor run their plain versions; the JAX side runs its
Pallas kernels in interpret mode with ``backend="pallas"``) and
``ops/smoothing``. Inputs are made from seeded numpy and handed to both.
Tolerances: >= 110 dB SNR in float32 (sums and transcendentals taken in
another order), >= 250 dB in float64, > 140 dB for an STFT round trip
against its input in float64, as the JAX package's own test has it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hisstools_library_tpu.fft import pallas_fft as jpallas
from hisstools_library_tpu.ops import interpolation as jinterp
from hisstools_library_tpu.ops import smoothing as jsmooth
from hisstools_library_tpu.ops import stft as jstft
from hisstools_library_tpu.ops import table_reader as jtable
from hisstools_library_tpu.ops import windows as jwin
from hisstools_library_tpu_torch.fft import hopper_fft
from hisstools_library_tpu_torch.ops import interpolation as tinterp
from hisstools_library_tpu_torch.ops import smoothing as tsmooth
from hisstools_library_tpu_torch.ops import stft as tstft
from hisstools_library_tpu_torch.ops import table_reader as ttable
from hisstools_library_tpu_torch.ops import windows as twin

SNR_F32 = 110.0
SNR_F64 = 250.0
CPU = "cpu"


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def floor_for(dtype):
    return SNR_F64 if dtype in (np.float64, torch.float64) else SNR_F32


# -- windows -------------------------------------------------------------------

def _window_cases():
    cases = [(name, {}, 0, None) for name in twin.WINDOW_NAMES]
    cases += [
        ("kaiser", dict(a0=8.0), 0, None), ("kaiser", dict(a0=20.0), 0, None),
        ("tukey", dict(a0=0.4), 0, None), ("trapezoid", dict(a0=0.2, a1=0.7), 0, None),
        ("trapezoid", dict(a0=0.8, a1=0.1), 0, None), ("sine_taper", dict(a0=3.4), 0, None),
        ("cosine_3_term", dict(a0=0.42, a1=0.5, a2=0.08), 0, None),
        ("cosine_5_term", dict(a0=1.0, a1=1.9, a2=1.3, a3=0.4, a4=0.03), 0, None),
        ("hann", dict(exponent=0.5), 0, None), ("hann", dict(exponent=2.0), 0, None),
        ("kaiser", dict(a0=8.0, exponent=3.5), 0, None), ("blackman", dict(exponent=3.0), 0, None),
        ("hann", {}, 10, 300), ("hamming", {}, 40, 100), ("hann", {}, 50, 40),
    ]
    return cases


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,params,begin,end", _window_cases())
def test_windows_match_jax(name, params, begin, end, dtype):
    """Every window of WINDOW_NAMES, a few parameters and exponents, and
    begin/end clamps (end is clamped to N + 1, begin to end)."""
    n = 255
    want = np.asarray(jwin.generate(name, n, begin, end, jwin.Params(**params),
                                    dtype=getattr(jnp, dtype)))
    got = twin.generate(name, n, begin, end, twin.Params(**params),
                        dtype=getattr(torch, dtype), device=CPU)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert snr_db(want, got.numpy()) >= floor_for(getattr(np, dtype))
    if begin == 0 and end is None and not params:
        fn = getattr(twin, name)
        assert torch.equal(fn(n, dtype=getattr(torch, dtype), device=CPU), got)


def test_windows_indexed_generator():
    gen = twin.indexed_generator()
    assert gen.names == jwin.indexed_generator().names
    got = gen(gen.names.index("blackman"), 63, dtype=torch.float64, device=CPU)
    want = np.asarray(jwin.blackman(63, dtype=jnp.float64))
    assert got.shape == (64,) and snr_db(want, got.numpy()) >= SNR_F64
    with pytest.raises(ValueError, match="unknown window"):
        twin.generate("nope", 8, device=CPU)


# -- table reader and interpolation ---------------------------------------------

@pytest.mark.parametrize("interp", list(ttable.InterpType))
@pytest.mark.parametrize("edges", list(ttable.EdgeMode))
def test_table_read_matches_jax(edges, interp):
    """Every edge mode and interpolator at negative, in-range and
    past-the-end positions, with and without ``bound``, in float64 and
    float32."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal(13)
    pos = np.concatenate([np.linspace(-30.3, 45.7, 97), [-1.0, 0.0, 12.0, 12.5, 13.0]])
    jedges = jtable.EdgeMode[edges.name]
    jint = jinterp.InterpType[interp.name]
    for dtype in (np.float64, np.float32):
        for bound in (False, True):
            want = np.asarray(jtable.table_read(jnp.asarray(table, dtype), jnp.asarray(pos, dtype),
                                                mul=0.5, interp=jint, edges=jedges,
                                                bound=bound, scale=3.0))
            got = ttable.table_read(torch.from_numpy(table.astype(dtype)),
                                    torch.from_numpy(pos.astype(dtype)), mul=0.5,
                                    interp=interp, edges=edges, bound=bound, scale=3.0)
            assert got.shape == want.shape and got.dtype == getattr(torch, np.dtype(dtype).name)
            assert snr_db(want, got.numpy()) >= floor_for(dtype), (dtype, bound)


def test_interpolators_and_edge_indices_match_jax():
    rng = np.random.default_rng(12)
    x, *ys = (rng.standard_normal(50) for _ in range(5))
    assert np.allclose(tinterp.linear_interp(torch.from_numpy(x), *(torch.from_numpy(y) for y in ys[:2])).numpy(),
                       np.asarray(jinterp.linear_interp(x, *ys[:2])), rtol=0, atol=1e-14)
    for t_fn, j_fn in ((tinterp.cubic_hermite_interp, jinterp.cubic_hermite_interp),
                       (tinterp.cubic_lagrange_interp, jinterp.cubic_lagrange_interp),
                       (tinterp.cubic_bspline_interp, jinterp.cubic_bspline_interp)):
        got = t_fn(torch.from_numpy(x), *(torch.from_numpy(y) for y in ys)).numpy()
        assert snr_db(np.asarray(j_fn(x, *ys)), got) >= SNR_F64
    idx = np.arange(-40, 41)
    for edges in ttable.EdgeMode:
        if edges == ttable.EdgeMode.Extrapolate:
            continue
        for size in (1, 2, 7):
            m, z = ttable._edge_indices(torch.from_numpy(idx), size, edges)
            jm, jz = jtable._edge_indices(jnp.asarray(idx), size, jtable.EdgeMode[edges.name])
            assert np.array_equal(m.numpy(), np.asarray(jm)), (edges, size)
            assert (z is None) == (jz is None)
            if z is not None:
                assert np.array_equal(z.numpy(), np.asarray(jz))


# -- stft / istft ----------------------------------------------------------------

# (N, hop, boundary, pad, leading shape)
STFT_CASES = [
    (256, 128, True, True, (3,)), (256, 64, False, True, (2, 3)),
    (1024, 512, True, True, (2, 3)), (1024, 256, False, False, ()),
    (1024, 341, True, True, (2,)), (2048, 1024, True, False, (2,)),
    (2048, 512, False, True, ()), (4096, 2048, True, True, (2,)),
    (4096, 1024, False, True, ()),
    # frames below 32 points (the tiny forms of K10w / K11w on the card)
    (16, 8, True, True, (3,)), (4, 2, False, True, (2,)),
]


def _stft_inputs(n, lead, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal(lead + (4 * n + 123,)).astype(dtype)
    w = np.asarray(jwin.hann(n - 1, dtype=jnp.float64))
    return x, w


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("n,hop,boundary,pad,lead", STFT_CASES)
def test_stft_istft_match_jax(n, hop, boundary, pad, lead, backend):
    """Spectra and resynthesis against the JAX package in float32, with its
    Pallas kernels in interpret mode for "pallas" (K10w/K11w up to N =
    1024, the standard packed transforms at 2048 and 4096). The port's
    "pallas" runs K10w/K11w's plain versions up to 2048 on a CPU tensor.
    Resynthesis is compared where the window covers every sample (outside
    the first and last N samples when ``boundary`` is off, where the
    envelope falls to eps)."""
    x, w = _stft_inputs(n, lead, np.float32)
    L = x.shape[-1]
    S = jstft.stft(jnp.asarray(x), w, n, hop, pad=pad, boundary=boundary, backend=backend)
    y = np.asarray(jstft.istft(S, w, hop, length=L, boundary=boundary, backend=backend))
    St = tstft.stft(torch.from_numpy(x), w, n, hop, pad=pad, boundary=boundary,
                    backend=backend)
    yt = tstft.istft(St, w, hop, length=L, boundary=boundary, backend=backend).numpy()
    assert St.re.shape == S.re.shape and St.re.dtype == torch.float32
    assert snr_db(S.re, St.re.numpy()) >= SNR_F32
    assert snr_db(S.im, St.im.numpy()) >= SNR_F32
    assert yt.shape == y.shape
    keep = slice(None) if boundary else slice(n, -n)
    assert snr_db(y[..., keep], yt[..., keep]) >= SNR_F32
    if boundary and pad:
        assert snr_db(x, yt) >= SNR_F32


@pytest.mark.parametrize("n,hop,boundary,pad,lead", [c for c in STFT_CASES if c[2] or c[1] == 64])
def test_stft_float64_roundtrip(n, hop, boundary, pad, lead):
    """float64: the port against the JAX package (>= 250 dB) and, with full
    coverage, the round trip against the input (> 140 dB); the window comes
    as a tensor here."""
    x, w = _stft_inputs(n, lead, np.float64, seed=1)
    L = x.shape[-1]
    S = jstft.stft(jnp.asarray(x), w, n, hop, pad=pad, boundary=boundary)
    y = np.asarray(jstft.istft(S, w, hop, length=L, boundary=boundary))
    wt = torch.from_numpy(w.copy())
    St = tstft.stft(torch.from_numpy(x), wt, n, hop, pad=pad, boundary=boundary)
    yt = tstft.istft(St, wt, hop, length=L, boundary=boundary).numpy()
    assert St.re.dtype == torch.float64
    assert snr_db(S.re, St.re.numpy()) >= SNR_F64
    assert snr_db(S.im, St.im.numpy()) >= SNR_F64
    keep = slice(None) if boundary else slice(n, -n)
    assert snr_db(y[..., keep], yt[..., keep]) >= SNR_F64
    if boundary and pad:
        assert snr_db(x, yt) > 140


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_windowed_kernels_plain_match_pallas(n):
    """K10w / K11w's plain versions (what their wrappers run on a CPU tensor)
    against the TPU kernels in interpret mode, on frames read as a strided
    view with an odd hop."""
    rng = np.random.default_rng(n)
    sig = rng.standard_normal((2, 6 * n)).astype(np.float32)
    w = np.asarray(jwin.kaiser(n - 1, params=jwin.Params(a0=8.0), dtype=jnp.float64))
    hop = n // 2 + 1
    frames = torch.from_numpy(sig).unfold(-1, n, hop)
    want = jpallas.rfft_small_windowed(jnp.asarray(frames.numpy()), w, interpret=True)
    got = hopper_fft.rfft_small_windowed(frames, torch.from_numpy(w.astype(np.float32)))
    for g, wt in zip(got, want):
        assert g.shape == wt.shape and snr_db(wt, g.numpy()) >= SNR_F32
    scale = 0.5 / n
    want = jpallas.rifft_small_windowed(jnp.asarray(got[0].numpy()), jnp.asarray(got[1].numpy()),
                                        w, scale, interpret=True)
    back = hopper_fft.rifft_small_windowed(*got, torch.from_numpy(w.astype(np.float32)), scale)
    assert back.shape == want.shape and snr_db(want, back.numpy()) >= SNR_F32


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n,kernel,inverse_kernel", [
    (32, "K10w rfft_small_windowed", "K11w rifft_small_windowed"),
    (1024, "K10w rfft_small_windowed", "K11w rifft_small_windowed"),
    (2048, "K10w rfft_small_windowed", "K11w rifft_small_windowed"),
    (4096, "K1 rfft_packed", "K6 rifft_packed"),
    (16, "K10w rfft_tiny_windowed", "K11w rifft_tiny_windowed"),
    (4, "K10w rfft_tiny_windowed", "K11w rifft_tiny_windowed"),
])
def test_stft_routes_off_cpu(n, kernel, inverse_kernel):
    """Off the CPU, "pallas" sends stft / istft to K10w / K11w up to N = 2048
    (their tiny forms below 32) and, above, multiplies by the window and
    calls K1 / K6: each wrapper
    refuses the meta device by its kernel's name, so no torch.fft ran."""
    w = np.hanning(n)
    with pytest.raises(ValueError, match=f"{kernel}: .*CUDA"):
        tstft.stft(_meta(2, 3 * n), w, n, n // 2, backend="pallas")
    with pytest.raises(ValueError, match=f"{inverse_kernel}: .*CUDA"):
        tstft.istft(tstft.Split(_meta(2, 5, n // 2), _meta(2, 5, n // 2)), w, n // 2,
                    backend="pallas")


def test_stft_float64_off_cpu_raises():
    """float64 off the CPU: no float64 kernel is ported, and the error says so."""
    with pytest.raises(NotImplementedError, match="float64"):
        tstft.stft(_meta(2, 4096, dtype=torch.float64), np.hanning(1024), 1024, 512,
                   backend="pallas")


def test_windowed_wrappers_check_window():
    frames = torch.randn(3, 256)
    with pytest.raises(ValueError, match="window"):
        hopper_fft.rfft_small_windowed(frames.to("meta"), torch.ones(128, device="meta"))
    got = hopper_fft.rfft_small_windowed(frames, torch.ones(256))
    want = hopper_fft.rfft_packed_plain(frames)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_stft_helpers_and_empty():
    assert tstft.num_frames(1024, 256, 128) == jstft.num_frames(1024, 256, 128)
    assert tstft.num_frames(100, 256, 128) == 0
    assert tstft.stft_roundtrip_scale_check() == jstft.stft_roundtrip_scale_check()
    S = tstft.stft(torch.zeros(2, 100), np.hanning(256), 256, 128, pad=False)
    assert S.re.shape == (2, 0, 128)


# -- smoothing -------------------------------------------------------------------

def _kernels():
    hann = np.asarray(jwin.hann(63, dtype=jnp.float64))
    return {
        "zero-ends": hann,                       # Zero (SymZero when symmetric)
        "nonzero-ends": np.hamming(31),          # NonZero
        "half-hann": hann[31:],                  # first 1, last 0
        "single": np.array([2.0]),               # one-tap kernel
    }


@pytest.mark.parametrize("kernel", list(_kernels()))
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("edges", list(tsmooth.EdgeMode))
def test_smooth_matches_jax(edges, symmetric, kernel):
    """Every edge mode, symmetric and not, kernels of each end class, on the
    filter-bank path (widths ramping 3 -> 40 over 300 bins), float32 batched
    and float64."""
    k = _kernels()[kernel]
    rng = np.random.default_rng(21)
    x = np.abs(rng.standard_normal((2, 300))) + 0.1
    jedges = jsmooth.EdgeMode[edges.name]
    for dtype in (np.float32, np.float64):
        xs = x.astype(dtype) if dtype == np.float32 else x[0]
        want = np.asarray(jsmooth.smooth(jnp.asarray(xs), k, 3.0, 40.0, symmetric=symmetric,
                                         edges=jedges))
        got = tsmooth.smooth(torch.from_numpy(xs), k, 3.0, 40.0, symmetric=symmetric,
                             edges=edges)
        assert got.shape == want.shape and got.dtype == torch.from_numpy(xs).dtype
        assert snr_db(want, got.numpy()) >= floor_for(dtype), dtype


def test_smooth_bank_chunks(monkeypatch):
    """Above the bank budget the (lead, L, W) product is applied in L-chunks,
    with the same result."""
    rng = np.random.default_rng(22)
    x = np.abs(rng.standard_normal((3, 500))).astype(np.float32)
    k = _kernels()["half-hann"]
    want = np.asarray(jsmooth.smooth(jnp.asarray(x), k, 1.0, 63.0, symmetric=True,
                                     edges=jsmooth.EdgeMode.Extend))
    monkeypatch.setattr(tsmooth, "BANK_BUDGET", 3 * 63 * 37)
    got = tsmooth.smooth(torch.from_numpy(x), k, 1.0, 63.0, symmetric=True,
                         edges=tsmooth.EdgeMode.Extend)
    assert snr_db(want, got.numpy()) >= SNR_F32


@pytest.mark.parametrize("widths,symmetric", [((8200.0, 8200.0), True),
                                              ((8200.0, 8205.0), False)])
def test_smooth_wide_filters_fft_groups(widths, symmetric):
    """Filters wider than 4096 go group by group through the FFT convolution
    (one group, then three), float64."""
    rng = np.random.default_rng(23)
    x = np.abs(rng.standard_normal(9000)) + 0.1
    k = _kernels()["zero-ends"]
    want = np.asarray(jsmooth.smooth(jnp.asarray(x), k, *widths, symmetric=symmetric,
                                     edges=jsmooth.EdgeMode.Mirror))
    got = tsmooth.smooth(torch.from_numpy(x), k, *widths, symmetric=symmetric,
                         edges=tsmooth.EdgeMode.Mirror)
    assert snr_db(want, got.numpy()) >= SNR_F64


@pytest.mark.parametrize("n_out,w", [(40, 9), (700, 41)])
def test_smooth_group_conv_direct_and_fft(n_out, w):
    """The group convolution's two routes (direct FIR below the size
    heuristic, FFT above) against the JAX package's, float64."""
    rng = np.random.default_rng(24)
    seg = rng.standard_normal(n_out + w - 1)
    filt = rng.random(w)
    assert tsmooth._use_fft(n_out, (w + 1) // 2) == jsmooth._use_fft(n_out, (w + 1) // 2)
    want = np.asarray(jsmooth._group_conv(jnp.asarray(seg), filt, n_out, 0.3, None))
    got = tsmooth._group_conv(torch.from_numpy(seg), filt, n_out, 0.3, None)
    assert snr_db(want, got.numpy()) >= SNR_F64


def test_smooth_helpers_match_jax():
    k = _kernels()["half-hann"]
    for ends in tsmooth._Ends:
        for width in (1, 2, 7, 64):
            assert np.array_equal(tsmooth._resample_kernel(k, width, ends),
                                  jsmooth._resample_kernel(k, width, jsmooth._Ends[ends.name]))
    x = np.arange(10.0)
    for edges in tsmooth.EdgeMode:
        got = tsmooth._pad_edges(torch.from_numpy(x), 7, edges).numpy()
        assert np.array_equal(got, np.asarray(jsmooth._pad_edges(jnp.asarray(x), 7,
                                                                 jsmooth.EdgeMode[edges.name])))
    with pytest.raises(ValueError, match="positive maximum"):
        tsmooth.smooth(torch.ones(10), np.zeros(5), 1.0, 3.0)
