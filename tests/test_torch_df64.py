"""Port parity: the double-float FFT (``fft/df64.py``) on the CPU.

The twin, test for test, of ``tests/test_df64.py`` at its bars: > 180 dB
against numpy float64, ``selfcheck() < 1e-10``, ``dd_*`` at rtol 1e-14.
Each output is also held against the JAX package's ``df64`` on the same
numpy inputs: both run the same float32 sequence (TwoSum, Dekker's TwoProd,
the Stockham stages, the bit-reversal gather), so every plane must be
bit-equal. An AST check holds that every public ``def`` of the JAX module
has a twin.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu.fft import df64 as jdf64  # noqa: E402
from hisstools_library_tpu_torch.fft import df64  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(
        np.sum(ref * ref) / max(d, 1e-300))


def assert_planes_bit_equal(jax_planes, port_planes):
    assert len(jax_planes) == len(port_planes)
    for j, t in zip(jax_planes, port_planes):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert t.device.type == CPU
        np.testing.assert_array_equal(np.asarray(j).view(np.uint32),
                                      t.numpy().view(np.uint32))


def test_every_public_def_has_a_twin():
    def defs(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body
                if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}

    jax_defs = defs(ROOT / "hisstools_library_tpu" / "fft" / "df64.py")
    assert {"dd_add", "dd_sub", "dd_mul", "dd_from_f64", "dd_to_f64", "selfcheck",
            "fft_df64", "rfft_df64", "rifft_df64"} <= jax_defs
    assert jax_defs <= defs(ROOT / "hisstools_library_tpu_torch" / "fft" / "df64.py")


def test_fft_package_exports_the_transforms():
    from hisstools_library_tpu_torch.fft import fft_df64, rfft_df64, rifft_df64
    assert (fft_df64, rfft_df64, rifft_df64) == (df64.fft_df64, df64.rfft_df64,
                                                 df64.rifft_df64)


def test_selfcheck_compensation_survives():
    """Catastrophic-cancellation guard: if any TwoSum / TwoProd error term
    were folded the result would collapse to float32 (~1e-7)."""
    got = df64.selfcheck(device=CPU)
    assert got < 1e-10
    assert got == jdf64.selfcheck()


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_rfft_df64_vs_f64_oracle(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    planes = df64.rfft_df64(x, device=CPU)
    re = df64.dd_to_f64(planes[0], planes[1])
    im = df64.dd_to_f64(planes[2], planes[3])
    z = np.fft.rfft(x.astype(np.float64))
    ref_re = 2 * z.real
    ref_im = np.concatenate([ref_re[-1:], 2 * z.imag[1:-1]])
    assert snr_db(ref_re[:-1], re) > 180
    assert snr_db(ref_im, im) > 180
    assert_planes_bit_equal(jdf64.rfft_df64(x), planes)


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_rifft_rfft_identity(rng, n):
    """rifft(rfft(x)) == 2N x, the library identity, at df64 precision."""
    x = rng.standard_normal(n).astype(np.float32)
    y_h, y_l = df64.rifft_df64(*df64.rfft_df64(x, device=CPU))
    y = df64.dd_to_f64(y_h, y_l)
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 180
    assert_planes_bit_equal(jdf64.rifft_df64(*jdf64.rfft_df64(x)), (y_h, y_l))


def test_batched_and_f64_input(rng):
    x = rng.standard_normal((3, 512))  # float64: split hi/lo
    planes = df64.rfft_df64(x, device=CPU)
    re = df64.dd_to_f64(planes[0], planes[1])
    z = np.fft.rfft(x)
    assert snr_db(2 * z.real[..., :-1], re) > 180
    y = df64.dd_to_f64(*df64.rifft_df64(*planes))
    assert snr_db(2.0 * 512 * x, y) > 180
    jplanes = jdf64.rfft_df64(x)
    assert_planes_bit_equal(jplanes, planes)
    # A float64 tensor is split on its own device into the same planes.
    assert_planes_bit_equal(jplanes, df64.rfft_df64(torch.from_numpy(x)))
    assert_planes_bit_equal(jdf64.rifft_df64(*jplanes), df64.rifft_df64(*planes))


def test_fft_df64_complex_and_unscaled_inverse(rng):
    """Complex forward matches np.fft; the inverse follows the library's
    UNSCALED convention (N x IDFT, fft.api.ifft)."""
    n = 1024
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    z = np.zeros_like(re)
    fwd = df64.fft_df64(re, z, im, z, device=CPU)
    ref = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    assert snr_db(ref.real, df64.dd_to_f64(fwd[0], fwd[1])) > 180
    assert snr_db(ref.imag, df64.dd_to_f64(fwd[2], fwd[3])) > 180
    back = df64.fft_df64(*fwd, inverse=True)
    assert snr_db(n * re.astype(np.float64), df64.dd_to_f64(back[0], back[1])) > 180
    assert snr_db(n * im.astype(np.float64), df64.dd_to_f64(back[2], back[3])) > 180
    jfwd = jdf64.fft_df64(re, z, im, z)
    assert_planes_bit_equal(jfwd, fwd)
    assert_planes_bit_equal(jdf64.fft_df64(*jfwd, inverse=True), back)


def test_dd_arithmetic_basics():
    a_h, a_l = df64.dd_from_f64(np.array([1.0 / 3.0]))
    b_h, b_l = df64.dd_from_f64(np.array([np.pi]))
    ta = (torch.from_numpy(a_h), torch.from_numpy(a_l))
    tb = (torch.from_numpy(b_h), torch.from_numpy(b_l))
    s = df64.dd_to_f64(*df64.dd_add(*ta, *tb))
    p = df64.dd_to_f64(*df64.dd_mul(*ta, *tb))
    d = df64.dd_to_f64(*df64.dd_sub(*ta, *tb))
    np.testing.assert_allclose(s, 1.0 / 3.0 + np.pi, rtol=1e-14)
    np.testing.assert_allclose(p, np.pi / 3.0, rtol=1e-14)
    np.testing.assert_allclose(d, 1.0 / 3.0 - np.pi, rtol=1e-14)
    # The host split is the JAX package's, and so is each op's pair.
    for mine, theirs in zip((a_h, a_l, b_h, b_l),
                            jdf64.dd_from_f64(np.array([1.0 / 3.0]))
                            + jdf64.dd_from_f64(np.array([np.pi]))):
        np.testing.assert_array_equal(mine, theirs)
    for op, jop in ((df64.dd_add, jdf64.dd_add), (df64.dd_sub, jdf64.dd_sub),
                    (df64.dd_mul, jdf64.dd_mul)):
        assert_planes_bit_equal(jop(a_h, a_l, b_h, b_l), op(*ta, *tb))


def test_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        df64.fft_df64(*(np.zeros(12, np.float32),) * 4, device=CPU)
