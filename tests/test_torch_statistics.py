"""Port parity: the statistics (ops/statistics.py) and the random number
generators (utils/rng.py).

Every ``stat_*`` reduction takes the same numpy input in the JAX package and
the port, in float64 (relative tolerance 1e-12: the same float64 sums in
another order) and float32 (1e-5), and on a batch of rows where the JAX
function reduces rows independently. Counts keep their dtype rule (bf16
counts in float32, exactly). ``CMWC`` and ``RandomGenerator`` are
bit-equal to the JAX package's numpy classes from the same seeds;
``device_uniform`` / ``device_gaussian`` are held to their range, mean and
variance (they use a ``torch.Generator``, whose numbers differ from
``jax.random``'s).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.ops import statistics as jst  # noqa: E402
from hisstools_library_tpu.utils import rng as jrng  # noqa: E402
from hisstools_library_tpu_torch.ops import statistics as tst  # noqa: E402
from hisstools_library_tpu_torch.utils import rng as trng  # noqa: E402

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
_X = np.random.default_rng(0x57A7).uniform(0.05, 1.0, (3, 200))
_W = np.random.default_rng(0x57A8).uniform(0.0, 2.0, 200)

# (name, extra args). The row-wise JAX functions are checked on the (3, 200)
# batch too; the moments about a centroid and pdf_percentile broadcast a
# per-row value against the row in the JAX package, so they take 1-D input.
STATS = [
    ("stat_length", ()), ("stat_min", ()), ("stat_max", ()),
    ("stat_min_position", ()), ("stat_max_position", ()),
    ("stat_count_above", (0.5,)), ("stat_count_below", (0.5,)),
    ("stat_ratio_above", (0.5,)), ("stat_ratio_below", (0.5,)),
    ("stat_sum", ()), ("stat_sum_abs", ()), ("stat_sum_squares", ()),
    ("stat_sum_logs", ()), ("stat_weighted_sum", ()), ("stat_weighted_sum_abs", ()),
    ("stat_weighted_sum_squares", ()), ("stat_weighted_sum_logs", ()),
    ("stat_product", ()), ("stat_mean", ()), ("stat_mean_squares", ()),
    ("stat_geometric_mean", ()), ("stat_variance", ()), ("stat_standard_deviation", ()),
    ("stat_pdf_percentile", (37.5,)), ("stat_centroid", ()), ("stat_spread", ()),
    ("stat_skewness", ()), ("stat_kurtosis", ()), ("stat_log_centroid", ()),
    ("stat_log_spread", ()), ("stat_log_skewness", ()), ("stat_log_kurtosis", ()),
    ("stat_flatness", ()), ("stat_rms", ()), ("stat_crest", ()),
]
ONE_D_ONLY = {"stat_pdf_percentile", "stat_spread", "stat_skewness", "stat_kurtosis",
              "stat_log_spread", "stat_log_skewness", "stat_log_kurtosis"}


def _compare(name, x, args, rtol):
    want = np.asarray(getattr(jst, name)(jnp.asarray(x), *args))
    got = getattr(tst, name)(torch.from_numpy(x), *args)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("name,args", STATS)
def test_statistic_matches_jax(name, args):
    """Each of the 35 reductions, float64 and float32; float64 row batches
    where the JAX function reduces rows."""
    for dtype in (np.float64, np.float32):
        x = _X.astype(dtype)
        # The product of 200 values below 1 underflows float32: 20 values.
        x1 = x[0, :20] if name == "stat_product" else x[0]
        _compare(name, x1, args, RTOL[dtype])
        if name not in ONE_D_ONLY and dtype == np.float64:
            _compare(name, x[:, :20] if name == "stat_product" else x, args, RTOL[dtype])


@pytest.mark.parametrize("name", ["stat_weighted_sum", "stat_weighted_sum_abs",
                                  "stat_weighted_sum_squares", "stat_weighted_sum_logs"])
def test_weighted_statistics_with_weights_match_jax(name):
    want = getattr(jst, name)(jnp.asarray(_X[0]), jnp.asarray(_W))
    got = getattr(tst, name)(torch.from_numpy(_X[0]), torch.from_numpy(_W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_empty_input_matches_jax():
    empty = np.zeros(0)
    for name in ("stat_min", "stat_max", "stat_min_position", "stat_max_position"):
        want = np.asarray(getattr(jst, name)(jnp.asarray(empty)))
        got = getattr(tst, name)(torch.from_numpy(empty))
        assert float(got) == float(want)
    assert tst.stat_min_position(torch.zeros(0)).dtype == torch.int64


def test_count_dtype_rule_matches_jax():
    """float64 counts in float64; bf16 (integers exact to 2^8) and float32
    in float32, so 300 values above the threshold count exactly."""
    x = np.linspace(0.0, 1.0, 1000)
    assert tst.stat_count_above(torch.from_numpy(x), 0.5).dtype == torch.float64
    xb = torch.ones(1000, dtype=torch.bfloat16)
    xb[:300] = 2.0
    got = tst.stat_count_above(xb, 1.5)
    want = jst.stat_count_above(jnp.asarray(np.asarray(xb.float())).astype(jnp.bfloat16), 1.5)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert float(got) == float(want) == 300.0
    assert tst._count_dtype(torch.float16) == torch.float32


def test_cmwc_bit_equal_to_jax_package():
    for seed in (np.arange(32, dtype=np.uint64), np.arange(1, 33, dtype=np.uint64) * 2654435761):
        j, t = jrng.CMWC(seed), trng.CMWC(seed)
        assert [t() for _ in range(500)] == [j() for _ in range(500)]
    with pytest.raises(ValueError):
        trng.CMWC(np.arange(31, dtype=np.uint64))


def test_random_generator_bit_equal_to_jax_package():
    seed = np.arange(32, dtype=np.uint64) * 7 + 3
    j = jrng.RandomGenerator(seed_vector=seed)
    t = trng.RandomGenerator(seed_vector=seed)
    for _ in range(50):
        assert t.rand_int() == j.rand_int()
        assert t.rand_int(1000) == j.rand_int(1000)
        assert t.rand_int_range(-5, 17) == j.rand_int_range(-5, 17)
        assert t.rand_double() == j.rand_double()
        assert t.rand_double(3.0) == j.rand_double(3.0)
        assert t.rand_double(-2.0, 5.0) == j.rand_double(-2.0, 5.0)
        assert t.rand_gaussian(1.0, 2.0) == j.rand_gaussian(1.0, 2.0)
        assert t.rand_gaussians() == j.rand_gaussians()
        assert t.rand_windowed_gaussian(0.3, 0.2) == j.rand_windowed_gaussian(0.3, 0.2)
    for p in (0.0, 1e-6, 0.01, 0.3, 0.5, 0.97, 0.99999, 1.0):
        assert trng.ltqnorm(p) == jrng.ltqnorm(p)


def test_device_generators_distribution():
    g = torch.Generator().manual_seed(11)
    u = trng.device_uniform(g, (100000,), lo=-2.0, hi=3.0)
    assert u.dtype == torch.float32 and u.device.type == "cpu"
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert abs(float(u.var()) - 25.0 / 12.0) < 0.03
    n = trng.device_gaussian(g, (100000,), dtype=torch.float64, mean=1.0, dev=2.0)
    assert n.dtype == torch.float64 and n.device.type == "cpu"
    assert abs(float(n.mean()) - 1.0) < 0.02
    assert abs(float(n.var()) - 4.0) < 0.08
    again = trng.device_uniform(torch.Generator().manual_seed(11), (100000,), lo=-2.0,
                                hi=3.0)
    torch.testing.assert_close(again, u, rtol=0, atol=0)
