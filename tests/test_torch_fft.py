"""Port parity: the FFT and MAC kernels (fft/hopper_fft.py,
fft/hopper_kernels.py) and fft/api.py's routing.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's wrappers run their plain PyTorch versions (torch.fft and a lag
loop); the JAX side runs its Pallas kernels in interpret mode, in "highest"
mode. Tolerances: transforms >= 120 dB SNR (float32 FFTs whose sums are taken
in another order give ~130 dB); MAC atol 1e-4 (float32 sums of up to P
products in another order), as tests/test_pallas_mac.py uses. The kernels
themselves are compared with their plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import api as jax_api  # noqa: E402
from hisstools_library_tpu.fft import pallas_fft, pallas_kernels  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.fft import api, hopper_fft, hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral_processor as sp  # noqa: E402

SNR_MIN_DB = 120.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.mark.parametrize("n", [4096, 16384])
def test_rfft_packed_matches_pallas(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    jre, jim = pallas_fft.rfft_packed(jnp.asarray(x), mode="highest")
    tre, tim = hopper_fft.rfft_packed(torch.from_numpy(x))
    assert tre.shape == (3, n // 2) and tre.dtype == torch.float32
    assert snr_db(jre, tre) >= SNR_MIN_DB
    assert snr_db(jim, tim) >= SNR_MIN_DB


@pytest.mark.parametrize("n", [4096, 16384])
def test_rfft_packed_stream_matches_pallas(rng, n):
    """K2 against the JAX K2 (interpret mode) at (C, T) = (2, 4), at T = 1
    (every frame's lower half zero) and at C * T = 15, not a multiple of 4
    (frames that cross channel boundaries)."""
    for c, t in ((2, 4), (2, 1), (3, 5)):
        x2d = rng.standard_normal((c, t, n // 2)).astype(np.float32)
        jre, jim = pallas_fft.rfft_packed_stream(jnp.asarray(x2d), mode="highest")
        tre, tim = hopper_fft.rfft_packed_stream(torch.from_numpy(x2d))
        assert tre.shape == (c, t, n // 2)
        assert snr_db(jre, tre) >= SNR_MIN_DB
        assert snr_db(jim, tim) >= SNR_MIN_DB


@pytest.mark.parametrize("n", [4096, 16384])
def test_rifft_packed_tail_matches_pallas(rng, n):
    re = rng.standard_normal((2, 3, n // 2)).astype(np.float32)
    im = rng.standard_normal((2, 3, n // 2)).astype(np.float32)
    scale = 1.0 / (4.0 * n)
    jy = pallas_fft.rifft_packed_tail(jnp.asarray(re), jnp.asarray(im),
                                      scale=scale, mode="highest")
    ty = hopper_fft.rifft_packed_tail(torch.from_numpy(re), torch.from_numpy(im),
                                      scale)
    assert ty.shape == (2, 3, n // 2)
    assert snr_db(jy, ty) >= SNR_MIN_DB


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2048, 8192])
def test_fft_split_matches_pallas(rng, n, inverse):
    """K12: the unscaled complex DFT and N x IDFT of split planes."""
    re, im = rng.standard_normal((2, 3, n)).astype(np.float32)
    jre, jim = pallas_fft.fft_split(jnp.asarray(re), jnp.asarray(im), inverse=inverse,
                                    interpret=True, mode="highest")
    tre, tim = hopper_fft.fft_split(torch.from_numpy(re), torch.from_numpy(im), inverse)
    assert tre.shape == (3, n) and tre.dtype == torch.float32
    assert snr_db(jre, tre) >= SNR_MIN_DB
    assert snr_db(jim, tim) >= SNR_MIN_DB


def test_packed_split_pair_matches_pallas(rng):
    """K13 and K14 at (1, 2^18): the TPU split-pair kernels in interpret
    mode against the plain versions; a DC-heavy input and a Nyquist-heavy
    spectrum make a packed lane-0 mistake visible."""
    n = 1 << 18
    x = rng.standard_normal((1, n)).astype(np.float32) + 0.5
    jre, jim = pallas_fft._rfft_packed_split(jnp.asarray(x), interpret=True, mode="highest")
    tre, tim = hopper_fft.rfft_packed_split(torch.from_numpy(x))
    assert tre.shape == (1, n // 2)
    assert snr_db(jre, tre) >= SNR_MIN_DB
    assert snr_db(jim, tim) >= SNR_MIN_DB
    re, im = rng.standard_normal((2, 1, n // 2)).astype(np.float32)
    im[:, 0] += 50.0
    jy = pallas_fft._rifft_packed_split(jnp.asarray(re), jnp.asarray(im), interpret=True,
                                        mode="highest")
    ty = hopper_fft.rifft_packed_split(torch.from_numpy(re), torch.from_numpy(im))
    assert ty.shape == (1, n)
    assert snr_db(jy, ty) >= SNR_MIN_DB


@pytest.mark.parametrize("t,p", [(5, 7), (7, 3)])
def test_lag_mac_causal_matches_pallas(rng, t, p):
    """P > T and P < T; a DC-heavy bin 0 makes an error in the packed
    (DC, Nyquist) lane visible."""
    c, k = 2, 256
    xr, xi = rng.standard_normal((2, c, t, k)).astype(np.float32)
    hr, hi = rng.standard_normal((2, c, p, k)).astype(np.float32)
    xr[..., 0] += 8.0
    hr[..., 0] += 8.0
    jr, ji = pallas_kernels.lag_mac_causal(
        *(jnp.asarray(a) for a in (xr, xi, hr, hi)), interpret=True)
    tr, ti = hopper_kernels.lag_mac_causal(
        *(torch.from_numpy(a) for a in (xr, xi, hr, hi)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
    assert not tr[:, 0].any() and not ti[:, 0].any()


@pytest.mark.parametrize("t,p", [(4, 3), (2, 5)])
def test_fastfir_chain_matches_pallas(rng, t, p):
    """K5's plain version (frames, packed rfft, causal MAC, tail inverse)
    against the TPU kernel in interpret mode, with P < T and P > T; a
    DC-heavy signal makes a packed lane-0 mistake visible."""
    n = 16384
    x2d = rng.standard_normal((2, t, n // 2)).astype(np.float32) + 0.5
    hr, hi = rng.standard_normal((2, 2, p, n // 2)).astype(np.float32)
    scale = 1.0 / (4.0 * n)
    jy = pallas_fft.fastfir_chain(jnp.asarray(x2d), jnp.asarray(hr),
                                  jnp.asarray(hi), scale, mode="highest")
    ty = hopper_fft.fastfir_chain(torch.from_numpy(x2d), torch.from_numpy(hr),
                                  torch.from_numpy(hi), scale)
    assert ty.shape == (2, t, n // 2)
    assert snr_db(jy, ty) >= SNR_MIN_DB
    staged = hopper_fft.fastfir_chain_staged(torch.from_numpy(x2d), torch.from_numpy(hr),
                                             torch.from_numpy(hi), scale)
    assert snr_db(ty, staged) >= SNR_MIN_DB


def test_fastfir_chain_stream_matches_pallas_at_2_16(rng):
    """K8's plain version at N = 2^16 (the size its chain family
    instantiation serves) against the TPU kernel in interpret mode, with a
    carried block, ring and lag-0 term: output and new ring."""
    n = 1 << 16
    k = n // 2
    x2d = rng.standard_normal((1, 2, k)).astype(np.float32)
    prev = rng.standard_normal((1, k)).astype(np.float32)
    rr, ri = rng.standard_normal((2, 1, 3, k)).astype(np.float32)
    hr, hi = rng.standard_normal((2, 1, 3, k)).astype(np.float32) * 1e-3
    lr, li = rng.standard_normal((2, 1, k)).astype(np.float32) * 1e-3
    scale = 1.0 / (4.0 * n)
    want = pallas_fft.fastfir_chain_stream(
        *(jnp.asarray(a) for a in (x2d, prev, rr, ri, hr, hi)), scale, mode="highest",
        l0_re=jnp.asarray(lr), l0_im=jnp.asarray(li))
    got = hopper_fft.fastfir_chain_stream(
        *(torch.from_numpy(a) for a in (x2d, prev, rr, ri, hr, hi)), scale,
        torch.from_numpy(lr), torch.from_numpy(li))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert snr_db(w, g) >= SNR_MIN_DB


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_api_xla_backend_matches_jax(rng, dtype):
    """backend=None on the CPU is torch.fft on both sides' "xla" path."""
    x = rng.standard_normal((2, 1024)).astype(dtype)
    jre, jim = jax_api.rfft(jnp.asarray(x), backend="xla")
    tre, tim = api.rfft(torch.from_numpy(x))
    assert tre.dtype == torch.from_numpy(x).dtype
    floor = 120.0 if dtype == np.float32 else 250.0
    assert snr_db(jre, tre) >= floor and snr_db(jim, tim) >= floor
    jy = jax_api.rifft(jre, jim, backend="xla")
    ty = api.rifft(tre, tim, backend="matmul")
    assert snr_db(jy, ty) >= floor
    assert snr_db(2 * 1024 * x, ty) >= floor


def test_backend_resolution():
    assert api._resolve(None, torch.device("cpu")) == "xla"
    assert api._resolve(None, torch.device("cuda")) == "pallas"
    assert api._resolve("matmul", torch.device("cuda")) == "xla"
    assert api._resolve("pallas", torch.device("cpu")) == "pallas"
    with pytest.raises(ValueError):
        api.set_default_backend("cufft")
    try:
        api.set_default_backend("xla")
        assert api.get_default_backend() == "xla"
        assert api._resolve(None, torch.device("cuda")) == "xla"
    finally:
        api.set_default_backend(None)
    assert api.get_default_backend() is None


@pytest.mark.parametrize("n", [0, 3, 1 << 29])
def test_log2_size_errors_match_jax(n):
    with pytest.raises(ValueError) as jerr:
        jax_api._log2_size(n)
    with pytest.raises(ValueError) as terr:
        api._log2_size(n)
    assert str(terr.value) == str(jerr.value)


def test_set_mode():
    assert hopper_fft.get_mode() == "highest"
    try:
        hopper_fft.set_mode("bf16x3")
        assert hopper_fft.get_mode() == "bf16x3"
    finally:
        hopper_fft.set_mode("highest")
    with pytest.raises(ValueError):
        hopper_fft.set_mode("tf32")


@pytest.mark.parametrize("call,match", [
    (lambda: hopper_fft.rfft_packed(torch.empty(2, 4096, dtype=torch.float64,
                                                device="meta")), "float64"),
    # K13 serves 2^18..2^28; above 2^28, the largest FFT size, nothing does.
    (lambda: hopper_fft.rfft_packed(torch.empty(2, 1 << 29, device="meta")), "above 2\\^28"),
    (lambda: hopper_fft.rifft_packed_tail(
        *(torch.empty(2, 3, 1024, device="meta") for _ in range(2))), "K10"),
    (lambda: hopper_kernels.lag_mac_causal(
        *(torch.empty(2, 3, 256, dtype=torch.float64, device="meta")
          for _ in range(4))), "float64"),
    # Above 2^28 the packed inverse has no kernel (K14 serves 2^18..2^28).
    (lambda: hopper_fft.rifft_packed(*(torch.empty(2, 1 << 28, device="meta")
                                       for _ in range(2))), "above 2\\^28"),
    # K12 (with its tiny form) serves complex powers of two N = 1..2^28,
    # float32 only.
    (lambda: hopper_fft.fft_split(*(torch.empty(2, 1 << 29, device="meta") for _ in range(2))),
     "above 2\\^28"),
    (lambda: hopper_fft.fft_split(*(torch.empty(2, 24, device="meta") for _ in range(2))),
     "K12 .*N = 24: not a power of two"),
    (lambda: api.fft(*(torch.empty(2, 4096, dtype=torch.float64, device="meta")
                       for _ in range(2)), backend="pallas"), "float64"),
])
def test_outside_gpu_envelope_raises(call, match):
    """Off the CPU the wrappers launch a kernel or raise; calls outside the
    ported envelope name the kernel still to be ported (a meta tensor takes
    the GPU branch without a card)."""
    with pytest.raises(NotImplementedError, match=match):
        call()


@pytest.mark.parametrize("call,kernel", [
    # A 10 s x 10 s convolution at 48 kHz is N = 2^20: K13 forward, K14 inverse.
    (lambda d: sp.convolve(torch.empty(2, 480000, device=d),
                           torch.empty(2, 480000, device=d), backend="pallas"), "K13"),
    (lambda d: api.rifft(*(torch.empty(2, 1 << 17, device=d) for _ in range(2)),
                         backend="pallas"), "K14"),
    # Complex ops go through K12.
    (lambda d: sp.convolve_complex(*(Split(torch.empty(2, 70000, device=d),
                                           torch.empty(2, 70000, device=d))
                                     for _ in range(2)), backend="pallas"), "K12"),
    (lambda d: api.ifft(*(torch.empty(2, 64, device=d) for _ in range(2)),
                        backend="pallas"), "K12"),
])
def test_spectral_routes_to_kernels_off_cpu(call, kernel):
    """Off the CPU the spectral ops reach the new kernels by size and never
    torch.fft: each wrapper refuses the meta device by its kernel's name."""
    with pytest.raises(ValueError, match=f"{kernel} .*CUDA"):
        call(torch.device("meta"))


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("call,kernel", [
    # Below 32 points K10 / K11 / K12 launch their tiny forms (csrc/fft_tiny.cu).
    (lambda: hopper_fft.rfft_packed(_meta(2, 16)), "K10"),
    (lambda: api.ifft(_meta(2, 16), _meta(2, 16), backend="pallas"), "K12"),
] + [(lambda n=n: api.rfft(_meta(3, n), backend="pallas"), "K10") for n in (2, 4, 8, 16)]
  + [(lambda n=n: api.rifft(_meta(3, n // 2), _meta(3, n // 2), backend="pallas"), "K11")
     for n in (2, 4, 8, 16)]
  + [(lambda n=n, f=f: f(_meta(3, n), _meta(3, n), backend="pallas"), "K12")
     for f in (api.fft, api.ifft) for n in (1, 2, 4, 8, 16)])
def test_small_sizes_route_to_kernels_off_cpu(call, kernel):
    """Off the CPU the small sizes reach a kernel's wrapper (real N = 2..16,
    complex N = 1..16), which refuses the meta device by its kernel's name:
    nothing raises for the size and nothing calls torch.fft."""
    with pytest.raises(ValueError, match=f"{kernel} .*CUDA"):
        call()


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_small_real_sizes_match_jax(rng, n):
    """rfft / rifft at N = 2..16: the port's plain versions (what the tiny
    kernels are held to on the card) against the JAX package's "pallas"
    backend, which serves these sizes by its matmul_fft fallback; a DC-heavy
    input makes a packed lane-0 mistake visible."""
    x = rng.standard_normal((3, 5, n)).astype(np.float32) + 0.5
    jre, jim = jax_api.rfft(jnp.asarray(x), backend="pallas")
    tre, tim = api.rfft(torch.from_numpy(x), backend="pallas")
    assert tre.shape == (3, 5, n // 2)
    assert snr_db(jre, tre) >= SNR_MIN_DB and snr_db(jim, tim) >= SNR_MIN_DB
    jy = jax_api.rifft(jre, jim, backend="pallas")
    ty = api.rifft(tre, tim, backend="pallas")
    assert ty.shape == x.shape
    assert snr_db(jy, ty) >= SNR_MIN_DB and snr_db(2 * n * x, ty) >= SNR_MIN_DB


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_small_complex_sizes_match_jax(rng, n, inverse):
    """fft / ifft at complex N = 1..16 (N = 1 a copy) against the JAX
    package's "pallas" backend (its matmul_fft fallback at these sizes)."""
    re, im = rng.standard_normal((2, 3, n)).astype(np.float32)
    jfn, tfn = (jax_api.ifft, api.ifft) if inverse else (jax_api.fft, api.fft)
    jre, jim = jfn(jnp.asarray(re), jnp.asarray(im), backend="pallas")
    tre, tim = tfn(torch.from_numpy(re), torch.from_numpy(im), backend="pallas")
    assert tre.shape == (3, n)
    assert snr_db(jre, tre) >= SNR_MIN_DB and snr_db(jim, tim) >= SNR_MIN_DB


@pytest.mark.parametrize("n,kernel", [(4096, "K2 rfft_packed_stream"),
                                      (1 << 14, "K5 fastfir_chain"),
                                      (1 << 15, "K5 fastfir_chain"),
                                      (1 << 16, "K5 fastfir_chain"),
                                      (1 << 17, "K5 fastfir_chain")])
def test_offline_chain_routes_off_cpu(n, kernel):
    """Off the CPU the fused offline chain is K5 at N = 2^14..2^17 (at any P,
    here 20) and K2 -> K3 -> K4 at 4096: the first wrapper reached refuses
    the meta device by name."""
    from hisstools_library_tpu_torch.models.partitioned import PartitionedConvolve
    h = n // 2
    spectra = Split(*(torch.empty(2, 20, h, device="meta") for _ in range(2)))
    with pytest.raises(ValueError, match=f"{kernel}: .*CUDA"):
        PartitionedConvolve._process_offline_fused(
            spectra, torch.empty(2, 30 * h, device="meta"), shift=h)


def test_non_cuda_device_is_refused():
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.rfft_packed(torch.empty(2, 4096, device="meta"))
