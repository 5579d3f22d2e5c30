"""Port parity: the streaming kernels' plain versions against the Pallas kernels.

The same numpy inputs go through the JAX package's Pallas kernel (interpret
mode on the CPU, "highest" mode) and the port's wrapper, which runs its plain
PyTorch version for CPU tensors:

- K10 ``hopper_fft.rfft_small`` (and ``rfft_packed``'s small sizes) against
  ``pallas_fft.rfft_packed`` at N = 128..2048 (the dense-DFT ``_small_fwd_call``);
- K7 ``hopper_kernels.lag_mac_ring`` against ``pallas_kernels.lag_mac_ring``;
- K8 ``hopper_fft.fastfir_chain_stream`` against
  ``pallas_fft.fastfir_chain_stream`` at N = 2^14, with and without lag0,
  at T > P and T < P.

Tolerance: >= 110 dB SNR (float32 transforms and sums taken in another
order, a dense DFT on the TPU side; ~125-140 dB measured).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import pallas_fft, pallas_kernels  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402

SNR_JAX_DB = 110.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.fixture
def highest():
    mode = pallas_fft.get_mode()
    pallas_fft.set_mode("highest")
    yield
    pallas_fft.set_mode(mode)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n", [128, 256, 1024, 2048])
def test_rfft_small_matches_pallas(rng, highest, n):
    x = _f32(rng, 3, 2, n)
    jre, jim = pallas_fft.rfft_packed(jnp.asarray(x), interpret=True)
    re, im = hopper_fft.rfft_small(torch.from_numpy(x))
    assert re.shape == (3, 2, n // 2) and re.dtype == torch.float32
    assert snr_db(jre, re) >= SNR_JAX_DB and snr_db(jim, im) >= SNR_JAX_DB
    # The packed real FFT sends these sizes to K10 on the card; on the CPU it
    # is the same plain version.
    re2, im2 = hopper_fft.rfft_packed(torch.from_numpy(x))
    assert torch.equal(re2, re) and torch.equal(im2, im)


@pytest.mark.parametrize("t,p", [(1, 3), (3, 3), (2, 5)])
def test_lag_mac_ring_matches_pallas(rng, t, p):
    """T = 1, T = P and T < P; bin 0 carries the packed (DC, Nyquist) lane."""
    c, k = 2, 128
    hist = [_f32(rng, c, p, k) for _ in range(2)]
    x = [_f32(rng, c, t, k) for _ in range(2)]
    h = [_f32(rng, c, p, k) for _ in range(2)]
    kept = [a.copy() for a in hist]
    want = pallas_kernels.lag_mac_ring(*map(jnp.asarray, hist + x + h), interpret=True)
    got = hopper_kernels.lag_mac_ring(*map(torch.from_numpy, hist + x + h))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert snr_db(w, g) >= SNR_JAX_DB
    # Bin 0 alone: two real MACs, not a complex one.
    assert snr_db(np.asarray(want[0])[..., 0], got[0][..., 0]) >= SNR_JAX_DB
    assert snr_db(np.asarray(want[1])[..., 0], got[1][..., 0]) >= SNR_JAX_DB
    # The new ring is a new tensor: the input ring is untouched.
    assert all(np.array_equal(a, b) for a, b in zip(kept, hist))


@pytest.mark.parametrize("t,p,lag0", [(3, 2, True), (2, 3, False), (2, 4, True)])
def test_fastfir_chain_stream_matches_pallas(rng, highest, t, p, lag0):
    """N = 2^14, one channel; T > P (spectra leave the ring within the call)
    with lag0, and T < P (part of the old ring survives) without and with
    lag0."""
    c, hop = 1, 8192
    k = hop
    x2d = _f32(rng, c, t, hop)
    prev = _f32(rng, c, hop)
    ring = [_f32(rng, c, p, k) for _ in range(2)]
    h = [_f32(rng, c, p, k) * 1e-3 for _ in range(2)]
    l0 = [_f32(rng, c, k) * 1e-3 for _ in range(2)] if lag0 else [None, None]
    scale = 1.0 / (4.0 * 2 * hop)
    jl0 = [None if a is None else jnp.asarray(a) for a in l0]
    want = pallas_fft.fastfir_chain_stream(
        *map(jnp.asarray, [x2d, prev] + ring + h), scale=scale, interpret=True,
        l0_re=jl0[0], l0_im=jl0[1])
    tl0 = [None if a is None else torch.from_numpy(a) for a in l0]
    got = hopper_fft.fastfir_chain_stream(
        *map(torch.from_numpy, [x2d, prev] + ring + h), scale,
        l0_re=tl0[0], l0_im=tl0[1])
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert snr_db(w, g) >= SNR_JAX_DB
