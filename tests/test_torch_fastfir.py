"""Port parity: FastFIR and the offline partitioned engine (models/offline.py,
models/partitioned.py).

The same numpy inputs go through the JAX package's ``FastFIR`` (Pallas kernels
in interpret mode, "highest" mode) and the port's (plain PyTorch versions on
the CPU). N = 4096 runs the JAX three-kernel chain, N = 16384 its fused
``fastfir_chain`` (K5), and N = 16384 with HISSTOOLS_FASTFIR_CHAIN=0 its
three-kernel chain again. Tolerances: >= 110 dB SNR against JAX (float32 FFT
and MAC sums taken in another order, ~125 dB measured), >= 100 dB against a
float64 convolution. At 40000 x 30000 taps that oracle is a float64 FFT
convolution (within ~1e-12 of ``np.convolve``): ``np.convolve`` runs
OpenBLAS-threaded dot products above 10 000 taps, which crawl when the test
workers oversubscribe the cores.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.core.types import Split as JSplit  # noqa: E402
from hisstools_library_tpu.fft import pallas_fft  # noqa: E402
from hisstools_library_tpu.models import offline as joff  # noqa: E402
from hisstools_library_tpu.models import partitioned as jpart  # noqa: E402
from hisstools_library_tpu_torch.core.errors import ConvolveError, ConvolveException  # noqa: E402
from hisstools_library_tpu_torch.models import offline as toff  # noqa: E402
from hisstools_library_tpu_torch.models import partitioned as tpart  # noqa: E402

SNR_JAX_DB = 110.0
CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_F64_DB = 100.0
CASES = [(4096, "1"), (16384, "1"), (16384, "0")]


def convolve_f64(x, h, n):
    """conv(x, h)[:n] in float64, through an FFT longer than the full result."""
    size = 1 << (len(x) + len(h) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), size) * np.fft.rfft(h.astype(np.float64), size)
    return np.fft.irfft(spec, size)[:n]


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0x70C4)
    x = rng.standard_normal((2, 40000)).astype(np.float32)
    ir = rng.standard_normal((2, 30000)).astype(np.float32)
    return x, ir


@pytest.fixture(scope="module")
def jax_runs(signals):
    """JAX FastFIR engine and output per (N, HISSTOOLS_FASTFIR_CHAIN), run
    once for the module (interpret mode is the slow part)."""
    x, ir = signals
    cache = {}

    def run(n, chain):
        if (n, chain) not in cache:
            mp = pytest.MonkeyPatch()
            mp.setenv("HISSTOOLS_FASTFIR_CHAIN", chain)
            mode = pallas_fft.get_mode()
            pallas_fft.set_mode("highest")
            try:
                eng = joff.FastFIR(ir, fft_size=n, dtype=jnp.float32, backend="pallas")
                y = joff.FastFIR.apply(eng.spectra, jnp.asarray(x), backend="pallas")
                cache[n, chain] = eng, np.asarray(y)
            finally:
                pallas_fft.set_mode(mode)
                mp.undo()
        return cache[n, chain]
    return run


@pytest.mark.parametrize("n,chain", CASES)
def test_fastfir_matches_jax(signals, jax_runs, n, chain):
    x, ir = signals
    _, y_jax = jax_runs(n, chain)
    eng = toff.FastFIR(ir, fft_size=n, backend="pallas", device=CPU)
    y = eng(torch.from_numpy(x))
    assert y.shape == (2, 40000) and y.dtype == torch.float32
    assert snr_db(y_jax, y) >= SNR_JAX_DB


@pytest.mark.parametrize("n", [4096, 16384])
def test_fastfir_matches_float64_convolve(signals, n):
    x, ir = signals
    y = toff.FastFIR(ir, fft_size=n, backend="pallas", device=CPU)(torch.from_numpy(x)).numpy()
    for c in range(2):
        ref = convolve_f64(x[c], ir[c], 40000)
        assert snr_db(ref, y[c]) >= SNR_F64_DB


def test_from_spectra_jax_to_port(signals, jax_runs):
    """The JAX engine's spectra drive the port's engine."""
    x, _ = signals
    jeng, y_jax = jax_runs(16384, "1")
    eng = toff.FastFIR.from_spectra(np.asarray(jeng.spectra.re),
                                    np.asarray(jeng.spectra.im), backend="pallas",
                                    device=CPU)
    assert eng.fft_size == 16384 and eng.hop == 8192
    assert snr_db(y_jax, eng(torch.from_numpy(x))) >= SNR_JAX_DB


def test_from_spectra_port_to_jax(signals, jax_runs):
    """The port's spectra drive the JAX engine; both spectra agree."""
    x, ir = signals
    jeng, _ = jax_runs(4096, "1")
    eng = toff.FastFIR(ir, fft_size=4096, backend="pallas", device=CPU)
    re, im = eng.spectra_numpy()
    assert re.shape == (2, 15, 2048) and re.dtype == np.float32
    assert snr_db(jeng.spectra.re, re) >= 120.0
    assert snr_db(jeng.spectra.im, im) >= 120.0
    y_jax = joff.FastFIR.apply(JSplit(jnp.asarray(re), jnp.asarray(im)),
                               jnp.asarray(x), backend="pallas")
    assert snr_db(y_jax, eng(torch.from_numpy(x))) >= SNR_JAX_DB


@pytest.mark.parametrize("mac_backend", ["xla", "pallas"])
def test_staged_path_matches_jax_float64(rng, mac_backend):
    """backend=None on the CPU is the staged torch.fft path on both sides
    (JAX's jnp.fft), exact to float64 rounding."""
    x = rng.standard_normal((2, 4000))
    ir = rng.standard_normal((2, 2500))
    y_jax = joff.fast_fir(jnp.asarray(x), ir, fft_size=1024, mac_backend=mac_backend)
    y = toff.fast_fir(torch.from_numpy(x), ir, fft_size=1024, mac_backend=mac_backend)
    assert y.dtype == torch.float64
    assert snr_db(y_jax, y) >= 250.0
    for c in range(2):
        assert snr_db(np.convolve(x[c], ir[c])[:4000], y[c]) >= 180.0


def test_impulse_spectra_matches_jax(rng):
    ir = rng.standard_normal((3, 5000))
    js = jpart.impulse_spectra(ir, 2048, offset=300, length=3000,
                               dtype=jnp.float64, backend="xla")
    ts = tpart.impulse_spectra(ir, 2048, offset=300, length=3000,
                               dtype=torch.float64, backend="xla", device=CPU)
    assert tuple(ts.shape) == tuple(js.shape) == (3, 3, 1024)
    assert snr_db(js.re, ts.re) >= 250.0 and snr_db(js.im, ts.im) >= 250.0


@pytest.mark.parametrize("size,code", [
    (0, ConvolveError.FFT_SIZE_OUT_OF_RANGE),
    (48, ConvolveError.FFT_SIZE_NON_POWER_OF_TWO),
    (16, ConvolveError.FFT_SIZE_OUT_OF_RANGE),
    (1 << 21, ConvolveError.FFT_SIZE_OUT_OF_RANGE),
    (1024, None),
])
def test_validate_fft_size_matches_jax(size, code):
    if code is None:
        assert tpart.validate_fft_size(size) == jpart.validate_fft_size(size) == 10
        return
    with pytest.raises(ConvolveException) as err:
        tpart.validate_fft_size(size)
    assert err.value.code is code
    with pytest.raises(Exception) as jerr:
        jpart.validate_fft_size(size)
    assert jerr.value.code.name == code.name
    assert str(err.value) == str(jerr.value)


def test_choose_fft_size_matches_jax():
    for ir_len in (10, 5000, 100_000, 480_000, 10_000_000):
        assert toff.choose_fft_size(ir_len) == joff.choose_fft_size(ir_len)
    assert toff.choose_fft_size(480_000) == 1 << 16


def _meta_engine(n, p=3):
    re = np.zeros((2, p, n // 2), np.float32)
    return toff.FastFIR.from_spectra(re, re, device="meta")


@pytest.mark.parametrize("kwargs,match", [
    (dict(backend="pallas"), "K10 rfft_small"),       # N = 2048: staged pallas
    (dict(backend="xla", mac_backend="pallas"), "K7 lag_mac_ring"),
])
def test_gpu_staged_path_raises(kwargs, match):
    """Off the CPU the staged path runs on kernels (K10 -> K7 -> K11 at
    N = 2048): a meta tensor takes the GPU branch without a card and reaches
    the first kernel's wrapper, which refuses a device that is not CUDA."""
    eng = _meta_engine(2048)
    x = torch.empty(2, 5000, device="meta")
    with pytest.raises(ValueError, match=f"{match}: .*CUDA"):
        toff.FastFIR.apply(eng.spectra, x, **kwargs)


def test_gpu_float64_raises():
    """float64 off the CPU: the staged path's forward kernel (K1) has no
    float64 form and says so."""
    eng = _meta_engine(4096)
    x = torch.empty(2, 5000, dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="K1 rfft_packed: no float64"):
        toff.FastFIR.apply(eng.spectra, x, backend="pallas")
