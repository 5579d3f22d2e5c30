"""Port parity: the mesh-sharded four-step FFT (``parallel/fft_sharded.py``)
on CPU ranks over gloo.

The twin, case for case, of ``tests/test_fft_sharded.py``: the same inputs
(the tests' seed), sizes, meshes (1 x d, d = 1 / 2 / 4 / 8, the first d of 8
ranks) and bars: float64 against ``np.fft`` at a relative error < 1e-12, the
round trip at 1e-12, float32 against the single-rank ``fft.api`` at 1e-5
and against float64 at > 110 dB, the convolution against ``np.convolve`` at
1e-11 of its peak. One spawn of 8 ranks (``parallel.launch.run``) runs every
case (``torch_parallel_cases``, which imports no jax). Each result is also
held against the JAX package's sharded function (jitted, at the JAX test's
mesh) on the same numpy inputs: a relative error < 1e-12 in float64, <
1e-5 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402
from hisstools_library_tpu.parallel import mesh as jmesh_mod  # noqa: E402
from hisstools_library_tpu.parallel.fft_sharded import (  # noqa: E402
    convolve_sharded as jconvolve, fft_sharded as jfft, rfft_sharded as jrfft)
from hisstools_library_tpu_torch.fft import api as fft_api  # noqa: E402
from hisstools_library_tpu_torch.parallel import launch  # noqa: E402
from hisstools_library_tpu_torch.parallel.fft_sharded import (  # noqa: E402
    real_sharded_eligible, sharded_eligible)

SEED = 0x1557
WORLD = 8
REL_F64 = 1e-12
REL_F32 = 1e-5


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got) - np.asarray(ref)) / np.linalg.norm(ref)


def _inputs() -> dict:
    """Each case's inputs from a fresh generator, as the JAX test's ``rng``
    fixture gives them."""
    inp = {}

    def rng():
        return np.random.default_rng(SEED)

    for n in (1 << 10, 1 << 13, 1 << 16):
        r = rng()
        inp[f"forward_{n}"] = (r.standard_normal(n), r.standard_normal(n))
    r = rng()
    inp["roundtrip"] = (r.standard_normal(1 << 12), r.standard_normal(1 << 12))
    r = rng()
    inp["single_chip"] = (r.standard_normal(1 << 14).astype(np.float32),
                          r.standard_normal(1 << 14).astype(np.float32))
    r = rng()
    inp["stays_sharded"] = (r.standard_normal(1 << 12), r.standard_normal(1 << 12))
    for d in (2, 4, 8):
        r = rng()
        inp[f"invariance_{d}"] = (r.standard_normal(1 << 12), r.standard_normal(1 << 12))
    r = rng()
    inp["fallback"] = (r.standard_normal(256), r.standard_normal(256))
    for n in (1 << 8, 1 << 12, 1 << 15):
        inp[f"rfft_{n}"] = rng().standard_normal(n)
    for d in (2, 4, 8):
        inp[f"rifft_{d}"] = rng().standard_normal(1 << 12)
    inp["rfft_f32"] = rng().standard_normal(1 << 14).astype(np.float32)
    for d in (1, 4, 8):
        r = rng()
        inp[f"convolve_{d}"] = (r.standard_normal(20000), r.standard_normal(3000))
    return inp


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    return inp, launch.run(WORLD, cases.fft_cases, inp)[0]


def _jmesh(d):
    return jmesh_mod.make_mesh(channel=1, block=d)


def _put(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(jmesh_mod.BLOCK_AXIS)))


def _jax_fft(d, xr, xi, inverse=False):
    mesh = _jmesh(d)
    fr, fi = jax.jit(lambda a, b: jfft(mesh, a, b, inverse=inverse))(_put(mesh, xr),
                                                                     _put(mesh, xi))
    return np.asarray(fr) + 1j * np.asarray(fi)


@pytest.mark.parametrize("n", [1 << 10, 1 << 13, 1 << 16])
def test_forward_matches_numpy_f64(ranks, n):
    inp, out = ranks
    xr, xi = inp[f"forward_{n}"]
    got = out[f"forward_{n}"]
    assert _rel(got, np.fft.fft(xr + 1j * xi)) < REL_F64
    assert _rel(got, _jax_fft(8, xr, xi)) < REL_F64


def test_inverse_roundtrip_and_scaling(ranks):
    """ifft(fft(x)) == N * x (the unscaled pair), DTensors in and out."""
    inp, out = ranks
    n = 1 << 12
    xr, xi = inp["roundtrip"]
    br, bi = out["roundtrip"]
    np.testing.assert_allclose(br / n, xr, atol=1e-12)
    np.testing.assert_allclose(bi / n, xi, atol=1e-12)


def test_matches_single_chip_path(ranks):
    """Sharded float32 == the single-rank ``fft.api.fft`` to f32 roundoff."""
    inp, out = ranks
    xr, xi = inp["single_chip"]
    rr, ri = fft_api.fft(torch.from_numpy(xr), torch.from_numpy(xi))
    assert _rel(out["single_chip"], rr.numpy() + 1j * ri.numpy()) < REL_F32
    assert _rel(out["single_chip"], _jax_fft(8, xr, xi)) < REL_F32


def test_output_stays_sharded(ranks):
    """Contiguous chunks over the block axis: each rank holds n/8 values."""
    _, out = ranks
    s = out["stays_sharded"]
    assert s["placements"] == ["Replicate()", "Shard(dim=0)"]
    assert s["shape"] == (1 << 12,) and s["local"] == ((1 << 12) // 8,)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_size_invariance(ranks, d):
    inp, out = ranks
    xr, xi = inp[f"invariance_{d}"]
    got = out[f"invariance_{d}"]
    assert _rel(got, np.fft.fft(xr + 1j * xi)) < REL_F64
    assert _rel(got, _jax_fft(d, xr, xi)) < REL_F64


def test_single_device_fallback(ranks):
    inp, out = ranks
    xr, xi = inp["fallback"]
    assert _rel(out["fallback"], np.fft.fft(xr + 1j * xi)) < REL_F64
    mesh = _jmesh(1)
    fr, fi = jfft(mesh, jnp.asarray(xr), jnp.asarray(xi))
    assert _rel(out["fallback"], np.asarray(fr) + 1j * np.asarray(fi)) < REL_F64


@pytest.mark.parametrize("n", [1 << 8, 1 << 12, 1 << 15])
def test_rfft_sharded_matches_packed_api(ranks, n):
    """Packed layout parity (DC in re[0], Nyquist in im[0], x2 forward)."""
    inp, out = ranks
    x = inp[f"rfft_{n}"]
    pr, pi = out[f"rfft_{n}"]
    rr, ri = fft_api.rfft(torch.from_numpy(x))
    np.testing.assert_allclose(pr, rr.numpy(), atol=1e-10 * n)
    np.testing.assert_allclose(pi, ri.numpy(), atol=1e-10 * n)
    mesh = _jmesh(8)
    jr, ji = jax.jit(lambda a: jrfft(mesh, a))(_put(mesh, x))
    assert _rel(np.concatenate([pr, pi]),
                np.concatenate([np.asarray(jr), np.asarray(ji)])) < REL_F64


@pytest.mark.parametrize("d", [2, 4, 8])
def test_rifft_roundtrip_2n_scaling(ranks, d):
    """rifft_sharded(rfft_sharded(x)) == 2 N x: the packed convention every
    downstream scale factor depends on."""
    inp, out = ranks
    n = 1 << 12
    np.testing.assert_allclose(out[f"rifft_{d}"] / (2 * n), inp[f"rifft_{d}"], atol=1e-12)


def test_rfft_sharded_f32_snr(ranks):
    inp, out = ranks
    x = inp["rfft_f32"]
    rr, ri = fft_api.rfft(torch.from_numpy(x).double())
    ref = np.concatenate([rr.numpy(), ri.numpy()])
    got = np.concatenate(out["rfft_f32"]).astype(np.float64)
    snr = 10 * np.log10((ref ** 2).sum() / ((got - ref) ** 2).sum())
    assert snr > 110, snr
    mesh = _jmesh(8)
    jr, ji = jax.jit(lambda a: jrfft(mesh, a))(_put(mesh, x))
    assert _rel(got, np.concatenate([np.asarray(jr), np.asarray(ji)])) < REL_F32


@pytest.mark.parametrize("d", [1, 4, 8])
def test_convolve_sharded_matches_np(ranks, d):
    """Distributed spectral convolution vs np.convolve (full linear), its
    result sharded over the block axis."""
    inp, out = ranks
    x, h = inp[f"convolve_{d}"]
    y, placements, local = out[f"convolve_{d}"]
    ref = np.convolve(x, h)
    assert y.shape == ref.shape
    assert placements == ["Replicate()", "Shard(dim=0)"]
    assert local == (-(-ref.shape[0] // d),)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-11
    mesh = _jmesh(d)
    yj = np.asarray(jax.jit(lambda a, b: jconvolve(mesh, a, b))(jnp.asarray(x),
                                                                jnp.asarray(h)))
    assert np.abs(y - yj).max() / np.abs(yj).max() < 1e-11


def test_eligibility(ranks):
    _, out = ranks
    assert sharded_eligible(1 << 12, 8)
    assert not sharded_eligible(1 << 12, 3)      # non-pow2 devices
    assert not sharded_eligible((1 << 12) + 4, 8)  # non-pow2 size
    assert not sharded_eligible(1 << 5, 8)       # n2 < d
    assert real_sharded_eligible(1 << 12, 8)
    assert not real_sharded_eligible(1 << 5, 8)
    assert out["reject_n32"] == "ValueError: size 32 not distributable over 8 devices"
    assert out["reject_2d"] == "ValueError: fft_sharded operates on 1-D signals"


def test_convolve_sharded_non_pow2_mesh_raises(ranks):
    """A non-power-of-two block axis never satisfies real_sharded_eligible;
    convolve_sharded raises instead of searching FFT sizes forever."""
    _, out = ranks
    assert out["reject_non_pow2"].startswith("ValueError: convolve_sharded needs a "
                                             "power-of-two mesh axis")


def test_launcher_reports_a_failed_rank():
    """A rank that raises stops every rank, and the launch raises with its
    traceback (the other rank waits for it at the barrier)."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run(2, cases.failing_case, 1)
