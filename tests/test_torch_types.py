"""Port parity: split-complex types and packed products (core/types.py).

Inputs are made with numpy from a seed and handed to both the JAX package and
the PyTorch port. Tolerance: np.allclose's (rtol 1e-5) with atol 1e-6; both
sides multiply float32 values in the same order, but XLA may contract a
product and a sum into one FMA where torch does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.core import types as jt  # noqa: E402
from hisstools_library_tpu_torch.core import types as tt  # noqa: E402


def _splits(rng, shape=(3, 5, 64)):
    planes = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    jax_pair = (jt.Split(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
                jt.Split(jnp.asarray(planes[2]), jnp.asarray(planes[3])))
    torch_pair = (tt.Split(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])),
                  tt.Split(torch.from_numpy(planes[2]), torch.from_numpy(planes[3])))
    return planes, jax_pair, torch_pair


def _close(jax_split, torch_split):
    for j, t in ((jax_split.re, torch_split.re), (jax_split.im, torch_split.im)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,scale", [
    ("cmul", None), ("cmul_conj", None),
    ("packed_mul", 1.0), ("packed_mul", 0.25),
    ("packed_mul_conj", 1.0), ("packed_mul_conj", 0.25),
])
def test_products_match_jax(rng, name, scale):
    _, (ja, jb), (ta, tb) = _splits(rng)
    args = () if scale is None else (scale,)
    _close(getattr(jt, name)(ja, jb, *args), getattr(tt, name)(ta, tb, *args))


def test_packed_bin0_lane_is_two_real_products(rng):
    planes, _, (ta, tb) = _splits(rng)
    for fn in (tt.packed_mul, tt.packed_mul_conj):
        out = fn(ta, tb)
        np.testing.assert_array_equal(out.re[..., 0].numpy(),
                                      planes[0][..., 0] * planes[2][..., 0])
        np.testing.assert_array_equal(out.im[..., 0].numpy(),
                                      planes[1][..., 0] * planes[3][..., 0])


def test_split_methods_match_jax(rng):
    _, (ja, jb), (ta, tb) = _splits(rng)
    assert tuple(ta.shape) == tuple(ja.shape)
    assert ta.dtype == torch.float32
    _close(ja + jb, ta + tb)
    _close(ja * 0.5, ta * 0.5)
    _close(ja.conj(), ta.conj())
    wide = ta.astype(torch.float64)
    assert wide.dtype == torch.float64 and wide.re.dtype == wide.im.dtype
    moved = ta.to("cpu")
    assert moved.re.device.type == "cpu"
    np.testing.assert_array_equal(moved.im.numpy(), ta.im.numpy())


def test_entry_points_build_on_the_card_by_default():
    """A call that names no device builds on CUDA, never silently on the CPU:
    with a card the tensors are CUDA tensors; without one the call fails in
    torch's own CUDA error (a CPU-only build raises AssertionError, a CUDA
    build without a card RuntimeError). Naming the CPU always works."""
    from hisstools_library_tpu_torch.models import mono, offline, partitioned

    scheme = mono.PartitionScheme((32, 64), zero_latency=True)
    ir = np.ones((1, 100), np.float32)
    calls = [
        lambda **kw: mono.prepare_ir(scheme, ir, offline_tail=False, **kw).spectra[0].re,
        lambda **kw: offline.FastFIR(ir, fft_size=64, **kw).spectra.re,
        lambda **kw: partitioned.impulse_spectra(ir, 64, **kw).re,
        lambda **kw: tt.Split.zeros((2, 3), **kw).re,
        lambda **kw: tt.tensor_from(np.zeros(3), **kw),
    ]
    assert tt.default_device() == torch.device("cuda")
    for call in calls:
        assert call(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
