"""Port parity: the time-domain FIR head (models/time_domain.py).

The same numpy inputs go through the JAX package (``lax.conv_general_dilated``
at HIGHEST precision) and the port (a grouped ``conv1d``). Tolerances:
>= 250 dB against JAX in float64 (exact to rounding), >= 110 dB in float32
(sums in another order), >= 250 dB against ``np.convolve`` in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.models import time_domain as jtd  # noqa: E402
from hisstools_library_tpu_torch.core.errors import ConvolveError, ConvolveException  # noqa: E402
from hisstools_library_tpu_torch.models import time_domain as ttd  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.mark.parametrize("dtype,db", [(np.float64, 250.0), (np.float32, 110.0)])
@pytest.mark.parametrize("h_shape", [(3, 128), (128,)])
def test_fir_offline_matches_jax(rng, dtype, db, h_shape):
    """Per-channel taps and one tap set shared by every channel."""
    x = rng.standard_normal((3, 3000)).astype(dtype)
    h = rng.standard_normal(h_shape).astype(dtype)
    want = jtd.fir_offline(jnp.asarray(x), jnp.asarray(h))
    got = ttd.fir_offline(torch.from_numpy(x), torch.from_numpy(h))
    assert got.shape == (3, 3000) and got.dtype == torch.from_numpy(x).dtype
    assert snr_db(want, got) >= db
    if dtype is np.float64:
        hb = np.broadcast_to(h, (3, 128))
        for c in range(3):
            assert snr_db(np.convolve(x[c], hb[c])[:3000], got[c]) >= 250.0


def test_streaming_head_matches_jax_and_offline(rng):
    """TimeDomainConvolve over uneven blocks == JAX's == one offline FIR."""
    ir = rng.standard_normal((2, 5000))
    jeng, teng = jtd.TimeDomainConvolve(length=300), ttd.TimeDomainConvolve(length=300)
    assert teng.set(ir, dtype=torch.float64, device=CPU) is ConvolveError.NONE
    jeng.set(ir, dtype=jnp.float64)
    assert np.array_equal(np.asarray(jeng.taps), teng.taps.numpy())
    jst = jeng.init_state((2,), jnp.float64)
    tst = teng.init_state((2,), torch.float64)
    assert tst.shape == (2, 299)
    xs = [rng.standard_normal((2, n)) for n in (100, 1, 700, 299)]
    ys = []
    for x in xs:
        jst, jy = jtd.TimeDomainConvolve.process(jeng.taps, jst, jnp.asarray(x))
        before = tst.clone()
        new, ty = ttd.TimeDomainConvolve.process(teng.taps, tst, torch.from_numpy(x))
        assert torch.equal(tst, before)  # the given state is left as it was
        tst = new
        assert snr_db(jy, ty) >= 250.0
        assert np.array_equal(np.asarray(jst), tst.numpy())
        ys.append(ty)
    x = np.concatenate(xs, -1)
    off = ttd.fir_offline(torch.from_numpy(x), teng.taps)
    assert snr_db(off, torch.cat(ys, -1)) >= 250.0


def test_empty_block_matches_jax(rng):
    """A block of no samples gives no output and keeps the state, as in the
    JAX package (a grouped conv1d refuses an input shorter than its taps)."""
    ir = rng.standard_normal((2, 5000))
    jeng, teng = jtd.TimeDomainConvolve(length=128), ttd.TimeDomainConvolve(length=128)
    teng.set(ir, dtype=torch.float64, device=CPU)
    jeng.set(ir, dtype=jnp.float64)
    tst = teng.init_state((2,), torch.float64)
    tst, _ = ttd.TimeDomainConvolve.process(teng.taps, tst, torch.from_numpy(ir[:, :300]))
    jst = jnp.asarray(tst.numpy())
    jst, jy = jtd.TimeDomainConvolve.process(jeng.taps, jst, jnp.zeros((2, 0)))
    new, ty = ttd.TimeDomainConvolve.process(teng.taps, tst, torch.zeros(2, 0, dtype=torch.float64))
    assert ty.shape == jy.shape == (2, 0)
    assert np.array_equal(np.asarray(jst), new.numpy())
    assert ttd.fir_offline(torch.zeros(3, 0), teng.taps[0].float()).shape == (3, 0)


def test_make_taps_and_errors(rng):
    ir = rng.standard_normal(3000)
    for off, length in ((0, 0), (100, 50), (2999, 0), (4000, 0)):
        assert np.array_equal(ttd.make_taps(ir, off, length), jtd.make_taps(ir, off, length))
    eng = ttd.TimeDomainConvolve()
    assert eng.set(ir, device=CPU) is ConvolveError.TIME_IMPULSE_TOO_LONG
    assert eng.taps.shape == (ttd.MAX_TAPS,) and ttd.MAX_TAPS == jtd.MAX_TAPS == 2044
    with pytest.raises(ConvolveException) as err:
        ttd.TimeDomainConvolve(length=3000)
    assert err.value.code is ConvolveError.TIME_LENGTH_OUT_OF_RANGE
    with pytest.raises(ValueError, match="rebuild with init_state"):
        ttd.TimeDomainConvolve.process(torch.ones(10), torch.zeros(3), torch.zeros(5))
    st, y = ttd.TimeDomainConvolve.process(torch.zeros(0), torch.zeros(1), torch.ones(5))
    assert torch.equal(y, torch.zeros(5)) and st.shape == (1,)
