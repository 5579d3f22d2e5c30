"""Port parity above real 2^20 / complex 2^19: the sizes K12, K13 and K14
serve on the card up to 2^28 (csrc/fft_large.cuh's long routes).

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's wrappers run their plain PyTorch versions; the JAX package's
"pallas" backend leaves these sizes to its matmul_fft four-step with the
Pallas fft_split core (pallas_fft.py:471, :529, :868), which at complex 2^20
is the XLA-staged matmul_fft itself. Tolerance: >= 110 dB SNR (float32
transforms of 2^20..2^21 points whose sums run in another order; torch's
float32 CPU rfft holds ~113 dB against float64 at 2^21). The kernels are
held against their plain versions on the card in tests/test_torch_cuda.py
and chip_smoke.py; their index maps in tests/test_torch_fft_plan.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import api as jax_api  # noqa: E402
from hisstools_library_tpu.ops import spectral_processor as jax_sp  # noqa: E402
from hisstools_library_tpu_torch.fft import api  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral_processor as sp  # noqa: E402

SNR_MIN_DB = 110.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("call,kernel", [
    (lambda lm: api.rfft(_meta(2, 1 << lm), backend="pallas"), "K13"),
    (lambda lm: api.rifft(_meta(2, 1 << (lm - 1)), _meta(2, 1 << (lm - 1)),
                          backend="pallas"), "K14"),
])
@pytest.mark.parametrize("lm", range(21, 29))
def test_large_real_sizes_route_to_kernels_off_cpu(lm, call, kernel):
    """Off the CPU real N = 2^21..2^28 reach K13 / K14's wrappers, which
    refuse the meta device by the kernel's name: nothing raises for the
    size and nothing calls torch.fft."""
    with pytest.raises(ValueError, match=f"{kernel} .*CUDA"):
        call(lm)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lm", range(20, 29))
def test_large_complex_sizes_route_to_kernels_off_cpu(lm, inverse):
    """The same for complex N = 2^20..2^28 and K12."""
    f = api.ifft if inverse else api.fft
    with pytest.raises(ValueError, match="K12 .*CUDA"):
        f(_meta(2, 1 << lm), _meta(2, 1 << lm), backend="pallas")


def test_rfft_rifft_at_2_21_match_jax(rng):
    """rfft / rifft at real N = 2^21 (the smallest size K13 / K14 serve
    only since the long routes grew): the port against the JAX package, and
    rifft(rfft(x)) against 2N x; a DC-heavy input makes a packed lane-0
    mistake visible."""
    n = 1 << 21
    x = rng.standard_normal((2, n)).astype(np.float32) + 0.25
    jre, jim = jax_api.rfft(jnp.asarray(x), backend="pallas")
    tre, tim = api.rfft(torch.from_numpy(x), backend="pallas")
    assert tre.shape == (2, n // 2) and tre.dtype == torch.float32
    assert snr_db(jre, tre) >= SNR_MIN_DB and snr_db(jim, tim) >= SNR_MIN_DB
    jy = jax_api.rifft(jre, jim, backend="pallas")
    ty = api.rifft(tre, tim, backend="pallas")
    assert ty.shape == x.shape
    assert snr_db(jy, ty) >= SNR_MIN_DB and snr_db(2 * n * x, ty) >= SNR_MIN_DB


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_ifft_at_2_20_match_jax(rng, inverse):
    """fft / ifft at complex N = 2^20 (the smallest size K12 serves only
    since the long routes grew), the port against the JAX package."""
    re, im = rng.standard_normal((2, 2, 1 << 20)).astype(np.float32)
    jf, tf = (jax_api.ifft, api.ifft) if inverse else (jax_api.fft, api.fft)
    jre, jim = jf(jnp.asarray(re), jnp.asarray(im), backend="pallas")
    tre, tim = tf(torch.from_numpy(re), torch.from_numpy(im), backend="pallas")
    assert tre.shape == re.shape
    assert snr_db(jre, tre) >= SNR_MIN_DB and snr_db(jim, tim) >= SNR_MIN_DB


def test_convolve_above_2_20_matches_jax(rng):
    """spectral_processor.convolve of 600 000 by 500 000 samples: a linear
    size of 1 099 999, N = 2^21, the port against the JAX package and
    against a float64 numpy FFT convolution."""
    s1 = rng.standard_normal((2, 600000)).astype(np.float32)
    s2 = rng.standard_normal((2, 500000)).astype(np.float32)
    jy = jax_sp.convolve(jnp.asarray(s1), jnp.asarray(s2), backend="pallas")
    ty = sp.convolve(torch.from_numpy(s1), torch.from_numpy(s2), backend="pallas")
    assert tuple(ty.shape) == (2, 1099999)
    assert snr_db(jy, ty) >= SNR_MIN_DB
    size = 1 << 21
    want = np.fft.irfft(np.fft.rfft(s1.astype(np.float64), size)
                        * np.fft.rfft(s2.astype(np.float64), size), size)[:, :1099999]
    assert snr_db(want, ty) >= SNR_MIN_DB
