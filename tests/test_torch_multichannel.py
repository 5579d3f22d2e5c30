"""Port parity: the multichannel Convolver (models/multichannel.py).

The same numpy IRs and signals go through the JAX package's Convolver and the
port's, on the CPU (the port's kernels run their plain versions there; the
JAX side runs XLA, and its Pallas kernels in interpret mode where a test asks
for "pallas"). Routing cases: N2M with 2 inputs x 3 outputs and parallel with
3 channels, on small zero-latency schemes as tests/test_multichannel.py uses.
Tolerances: >= 250 dB SNR against JAX in float64 (the same float64 arithmetic
in another order), >= 110 dB in float32 (transforms and sums in another
order), > 180 dB against a float64 ``np.convolve``; error codes and host bank
states equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.models import multichannel as jmc  # noqa: E402
from hisstools_library_tpu.models.mono import PartitionScheme as JScheme  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402
from hisstools_library_tpu_torch.models import multichannel as tmc  # noqa: E402
from hisstools_library_tpu_torch.models.mono import PartitionScheme as TScheme  # noqa: E402

SNR_F64_DB = 250.0
SNR_F32_DB = 110.0
SNR_ORACLE_DB = 180.0
CPU = "cpu"
SIZES = (32, 128)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def pair(num_ins, num_outs=None, sizes=SIZES, **kw):
    """The JAX package's Convolver and the port's, configured alike."""
    return (jmc.Convolver(num_ins, num_outs, scheme=JScheme(sizes, True), **kw),
            tmc.Convolver(num_ins, num_outs, scheme=TScheme(sizes, True), device=CPU, **kw))


def prepare64(jc, tc, **kw):
    jc.prepare(dtype=jnp.float64, **kw)
    tc.prepare(dtype=torch.float64, **kw)


def stream(tc, x, jc=None, init="init_state"):
    """One process call on a fresh state of the port, and of the JAX package
    when ``jc`` is given (the outputs must agree)."""
    _, ty = tc.process(getattr(tc, init)(dtype=torch.float64), torch.from_numpy(x))
    if jc is not None:
        _, jy = jc.process(getattr(jc, init)(dtype=jnp.float64), jnp.asarray(x))
        assert snr_db(jy, ty) >= SNR_F64_DB
    return ty.numpy()


def oracle(x, irs, parallel):
    """Each output's float64 np.convolve, summed over inputs for N2M."""
    L = x.shape[-1]
    if parallel:
        return np.stack([np.convolve(x[c], irs[c])[:L] for c in range(len(x))])
    return np.stack([sum(np.convolve(x[i], irs[o, i])[:L] for i in range(len(x)))
                     for o in range(irs.shape[0])])


@pytest.mark.parametrize("mode", ["n2m", "parallel"])
def test_routing_matches_jax(rng, mode):
    """N2M (2 in x 3 out) and parallel (3): streaming output against the
    oracle (the JAX tests' test_n2m_routing and test_parallel_routing), and
    N2M against JAX (the float32 parallel path: the last test here)."""
    if mode == "n2m":
        jc, tc = pair(2, 3)
        irs = rng.standard_normal((3, 2, 200))
        x = rng.standard_normal((2, 64 * 6))
    else:
        jc, tc = pair(3)
        irs = rng.standard_normal((3, 150))
        x = rng.standard_normal((3, 64 * 4))
    assert tc.set_all(irs).name == jc.set_all(irs).name == "NONE"
    prepare64(jc, tc)
    y = stream(tc, x, jc if mode == "n2m" else None)
    assert y.shape == (3, x.shape[-1])
    assert snr_db(oracle(x, irs, mode == "parallel"), y) > SNR_ORACLE_DB


def test_per_pair_set_and_clear(rng):
    jc, tc = pair(2, 3)
    ir = rng.standard_normal(100)
    for args in ((0, 1, ir), (5, 0, ir), (0, 5, ir)):
        assert tc.set(*args).name == jc.set(*args).name
    np.testing.assert_array_equal(tc._bank, jc._bank)
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((2, 64 * 4))
    y = stream(tc, x)
    assert np.allclose(y[0], 0.0) and np.allclose(y[2], 0.0)  # no IR there
    assert snr_db(np.convolve(x[0], ir)[:x.shape[-1]], y[1]) > SNR_ORACLE_DB
    assert tc.clear().name == jc.clear().name == "NONE"
    tc.prepare(dtype=torch.float64)
    assert np.allclose(stream(tc, x), 0.0)


def test_parallel_requires_matching_channels():
    jc, tc = pair(2)
    assert tc.set(0, 1, np.ones(10)).name == jc.set(0, 1, np.ones(10)).name \
        == "IN_CHAN_OUT_OF_RANGE"


def test_offline_equals_streaming(rng):
    """N2M process_offline (lazy tail) against streaming (whose parity with
    JAX test_routing_matches_jax holds; JAX's process_offline against the
    port's: test_prepare_lazy_offline_tail)."""
    _, tc = pair(2, 3)
    tc.set_all(rng.standard_normal((3, 2, 90)))
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((2, 64 * 5))
    yo = tc.process_offline(torch.from_numpy(x)).numpy()
    assert snr_db(stream(tc, x), yo) > SNR_F64_DB


def test_clear_per_pair_validation(rng):
    """N2M clear takes both channels (reference Convolver::clear overloads);
    failed clears leave the bank as it was."""
    jc, tc = pair(2, 3)
    irs = rng.standard_normal((3, 2, 80))
    jc.set_all(irs)
    tc.set_all(irs)
    for kw in (dict(in_chan=1), dict(out_chan=1)):
        with pytest.raises(ValueError):
            tc.clear(**kw)
    for args in ((5, 0), (0, 5), (1, 0)):
        assert tc.clear(*args).name == jc.clear(*args).name
    np.testing.assert_array_equal(tc._bank, jc._bank)
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((2, 64 * 3))
    y = stream(tc, x)
    ref0 = np.convolve(x[0], irs[0, 0])[:x.shape[-1]]  # pair (in 1, out 0) cleared
    assert snr_db(ref0, y[0]) > SNR_ORACLE_DB


def test_clear_parallel_single_channel(rng):
    jc, tc = pair(3)
    irs = rng.standard_normal((3, 80))
    jc.set_all(irs)
    tc.set_all(irs)
    assert tc.clear(1).name == jc.clear(1).name == "NONE"
    assert tc.clear(0, 1).name == jc.clear(0, 1).name == "IN_CHAN_OUT_OF_RANGE"
    np.testing.assert_array_equal(tc._bank, jc._bank)
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((3, 64 * 3))
    y = stream(tc, x)
    assert np.allclose(y[1], 0.0)
    assert snr_db(np.convolve(x[0], irs[0])[:x.shape[-1]], y[0]) > SNR_ORACLE_DB


def test_set_no_resize_clamps(rng):
    """resize=False loads the IR clamped to capacity and reports it."""
    jc, tc = pair(2, max_length=96)
    ir = rng.standard_normal(200)
    assert tc.set(0, 0, ir, resize=False).name == jc.set(0, 0, ir, resize=False).name \
        == "MEM_ALLOC_TOO_SMALL"
    assert tc.set(1, 1, ir[:50], resize=False).name == "NONE"
    jc.set(1, 1, ir[:50], resize=False)
    np.testing.assert_array_equal(tc._bank, jc._bank)
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((2, 64 * 4))
    y = stream(tc, x)
    assert snr_db(np.convolve(x[0], ir[:96])[:x.shape[-1]], y[0]) > SNR_ORACLE_DB
    jc2, tc2 = pair(2, max_length=96)
    bank = rng.standard_normal((2, 200))
    assert tc2.set_all(bank, resize=False).name == jc2.set_all(bank, resize=False).name \
        == "MEM_ALLOC_TOO_SMALL"
    assert tc2._bank_len == jc2._bank_len == 96


def test_prepare_lazy_offline_tail(rng):
    """The lazy tail attaches on the first process_offline and gives the
    eager bank's output exactly (JAX's offline path against the port's:
    test_offline_float32_pallas_matches_jax)."""
    irs = rng.standard_normal((3, 150))
    x = torch.from_numpy(rng.standard_normal((3, 64 * 4)))
    _, tc = pair(3)
    tc.set_all(irs)
    tc.prepare(dtype=torch.float64)
    assert tc.ir.tail is None
    y = tc.process_offline(x)
    assert tc.ir.tail is not None
    eager = tmc.Convolver(3, scheme=TScheme(SIZES, True), device=CPU)
    eager.set_all(irs)
    eager.prepare(dtype=torch.float64, offline_tail=True)
    assert eager.ir.tail is not None
    torch.testing.assert_close(y, eager.process_offline(x), rtol=0, atol=0)
    assert snr_db(oracle(x.numpy(), irs, True), y) > SNR_ORACLE_DB


def test_resize_reserves_capacity(rng):
    jc, tc = pair(2, 2, max_length=64)
    ir = rng.standard_normal(500)
    calls = [("resize", (0, 1, 500)), ("set", (0, 1, ir, False)),
             ("resize", (5, 0, 10)), ("resize", (0, 5, 10))]
    for name, args in calls:
        assert getattr(tc, name)(*args).name == getattr(jc, name)(*args).name
    jp, tp = pair(2)
    for args in ((0, 1, 10), (1, 1, 10)):
        assert tp.resize(*args).name == jp.resize(*args).name


def test_set_and_clear_reject_negative_channels(rng):
    jc, tc = pair(3, 2)
    ir = rng.standard_normal(50)
    for name, args in (("set", (-1, 0, ir)), ("set", (0, -1, ir)), ("clear", (-1, 0)),
                       ("resize", (-1, 0, 10))):
        assert getattr(tc, name)(*args).name == getattr(jc, name)(*args).name


def test_clear_parallel_out_chan_alone(rng):
    jc, tc = pair(3)
    bank = rng.standard_normal((3, 60))
    jc.set_all(bank)
    tc.set_all(bank)
    assert tc.clear(out_chan=1).name == jc.clear(out_chan=1).name == "NONE"
    np.testing.assert_array_equal(tc._bank, jc._bank)
    assert np.allclose(tc._bank[1], 0.0) and not np.allclose(tc._bank[0], 0.0)


def _callbacks(conv, st, x, sizes, lib):
    outs, i = [], 0
    for b in sizes:
        b = min(b, x.shape[-1] - i)
        if b <= 0:
            break
        blk = jnp.asarray(x[:, i:i + b]) if lib == "jax" else torch.from_numpy(x[:, i:i + b])
        st, y = conv.process_any(st, blk)
        outs.append(np.asarray(y))
        i += b
    return st, np.concatenate(outs, axis=-1), i


@pytest.mark.parametrize("mode", ["n2m", "parallel"])
def test_process_any_matches_oracle(rng, mode):
    """Callbacks of any length (tests/test_streaming_subhop.py's multichannel
    cases): parallel 3 on (32, 128), N2M 2 x 2 on (32, 64), held to the
    float64 oracle as the JAX package's own tests hold it (its process_any
    against the port's: test_jax_stream_state_continues_in_port)."""
    if mode == "parallel":
        _, tc = pair(3)
        irs = rng.standard_normal((3, 200))
        x = rng.standard_normal((3, 330))
        sizes = [13, 100, 7, 210]
    else:
        _, tc = pair(2, 2, sizes=(32, 64))
        irs = rng.standard_normal((2, 2, 150))
        x = rng.standard_normal((2, 300))
        sizes = [31, 200, 69]
    tc.set_all(irs)
    tc.prepare(dtype=torch.float64)
    _, ty, n = _callbacks(tc, tc.init_stream_state(dtype=torch.float64), x, sizes, "torch")
    assert n == x.shape[-1]
    assert snr_db(oracle(x, irs, mode == "parallel"), ty) > SNR_F64_DB


def test_per_channel_reset(rng):
    """reset(in_chan=0) zeroes channel 0's history only (the JAX package's
    test_per_channel_reset); host ints (pos) are shared and kept."""
    _, tc = pair(2, sizes=(32, 64))
    irs = rng.standard_normal((2, 100))
    tc.set_all(irs)
    tc.prepare(dtype=torch.float64)
    x1, x2 = rng.standard_normal((2, 2, 128))
    tst, _ = tc.process(tc.init_state(dtype=torch.float64), torch.from_numpy(x1))
    reset = tc.reset(in_chan=0, state=tst)
    assert [s.pos for s in reset.sections] == [s.pos for s in tst.sections]
    assert not reset.sections[0].ring.re[0].any() and tst.sections[0].ring.re[0].any()
    _, ty = tc.process(reset, torch.from_numpy(x2))
    _, y_fresh = tc.process(tc.init_state(dtype=torch.float64), torch.from_numpy(x2))
    np.testing.assert_allclose(ty[0].numpy(), y_fresh[0].numpy(), rtol=1e-12, atol=1e-12)
    assert not np.allclose(ty[1].numpy(), y_fresh[1].numpy())


def test_block_state_two_tier_parallel(rng):
    """init_block_state drives the two-tier path per channel
    (tests/test_two_tier.py's Convolver case), held to the oracle as there."""
    _, tc = pair(2, sizes=(64, 256))
    irs = rng.standard_normal((2, 5000)) * 0.3
    tc.set_all(irs)
    tc.prepare(dtype=torch.float64)
    x = rng.standard_normal((2, tc.ir.far.shape[-1] * 2))
    y = stream(tc, x, init="init_block_state")
    assert snr_db(oracle(x, irs, True), y) > SNR_ORACLE_DB


def test_jax_stream_state_continues_in_port(rng):
    """A JAX N2M stream hands its prepared IR and process_any state over to
    the port (the numpy converters with an (M, N) batch), and both continue
    alike."""
    jc, tc = pair(2, 3)
    irs = rng.standard_normal((3, 2, 200))
    jc.set_all(irs)
    prepare64(jc, tc)
    jst, _ = jc.process_any(jc.init_stream_state(dtype=jnp.float64),
                            jnp.asarray(rng.standard_normal((2, 128))))
    tst = tmono.MonoStreamState.from_numpy(jst, CPU)
    tir = tmono.MonoIR.from_numpy(jc.ir, CPU)
    x = rng.standard_normal((2, 128))
    _, jy = jc.process_any(jst, jnp.asarray(x))
    _, ty = tmc.process_any(tir, tst, torch.from_numpy(x), parallel=False)
    assert ty.shape == (3, 128)
    assert snr_db(jy, ty) >= SNR_F64_DB


def test_offline_float32_pallas_matches_jax(rng):
    """Float32 with the "pallas" backend: the offline tail at N = 16384 is
    K5 on both sides (JAX in interpret mode, the port's plain version),
    parallel 2 channels; and N2M 2 x 2 streaming on the same bank's first
    taps."""
    irs = (rng.standard_normal((2, 66000)) * np.exp(-np.arange(66000) / 12000)
           ).astype(np.float32)
    x = rng.standard_normal((2, 12000)).astype(np.float32)
    jc, tc = pair(2, max_length=1 << 17)
    jc.set_all(irs)
    tc.set_all(irs)
    jc.prepare(dtype=jnp.float32)
    tc.prepare(dtype=torch.float32)
    jy = jc.process_offline(jnp.asarray(x), backend="pallas")
    ty = tc.process_offline(torch.from_numpy(x), backend="pallas")
    assert tc.ir.tail.shape[-1] == 8192 and ty.dtype == torch.float32
    assert snr_db(jy, ty) >= SNR_F32_DB
