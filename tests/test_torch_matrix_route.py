"""The N-in / M-out matrix route (models/multichannel.process ->
mono.process_matrix -> partitioned.process_block_matrix -> K8's matrix form)
on the CPU, against the JAX package's N2M Convolver.

A state whose pairs share one history an input (``Convolver.init_state``'s:
stride-0 views over the output axis) runs the route: each input transformed
once, each output's spectra summed over the inputs before its inverse. Any
other state (after a per-pair reset, from ``from_numpy``) runs the M x N
pairs as one batched engine. Both give the JAX package's outputs and
states. 3 inputs x 4 outputs (M != N, so the axes cannot be confused) on the
Zero preset (final section 16384, hop 8192, from tap 8192), over several
blocks, at P > T, P < T and P = 1. The port's kernels run their plain
versions on the CPU; the JAX side runs XLA.

Tolerances: >= 250 dB SNR against JAX in float64 (the same arithmetic in
another order), >= 110 dB in float32 (transforms and sums in another order),
the plain matrix form against the per-pair plain chain summed over inputs
>= 250 dB in float64; states equal exactly where they are copies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models import multichannel as jmc  # noqa: E402
from hisstools_library_tpu.models.mono import LatencyMode as JLatency  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft as hf  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402
from hisstools_library_tpu_torch.models import multichannel as tmc  # noqa: E402
from hisstools_library_tpu_torch.models.mono import LatencyMode  # noqa: E402

INS, OUTS = 3, 4
HOP = 8192  # the Zero preset's largest hop; its final section starts at tap 8192
SNR_DB = {"float64": 250.0, "float32": 110.0}
# (hops a block, partitions of the final section): P > T, P < T, P = 1
SHAPES = {"p_above_t": (1, 3), "p_below_t": (3, 2), "p_one": (2, 1)}


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _taps(p):
    return HOP + p * HOP - 1000  # the final section's P partitions, the last one partial


def _pair(p, dtype, seed=0):
    """The JAX package's Convolver and the port's on one bank of P
    partitions, prepared in ``dtype``."""
    rng = np.random.default_rng(seed + p)
    bank = rng.standard_normal((OUTS, INS, _taps(p))) / np.sqrt(_taps(p))
    jc = jmc.Convolver(INS, OUTS, latency=JLatency.Zero, max_length=_taps(p))
    tc = tmc.Convolver(INS, OUTS, latency=LatencyMode.Zero, max_length=_taps(p), device="cpu")
    jc.set_all(bank)
    tc.set_all(bank)
    jc.prepare(dtype=getattr(jnp, dtype))
    tc.prepare(dtype=getattr(torch, dtype))
    assert tc.ir.spectra[-1].shape[-2] == p
    return jc, tc


def _blocks(t, count, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((INS, t * HOP)).astype(dtype) for _ in range(count)]


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of K8's matrix form and of the per-pair K8 (their
    wrappers, whose plain versions run here) made with backend="pallas"."""
    calls = {"matrix": 0, "per_pair": 0}
    for name, key in (("fastfir_chain_stream_matrix", "matrix"),
                      ("fastfir_chain_stream", "per_pair")):
        fn = getattr(hf, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(hf, name, counted)
    return calls


# K8's matrix form (its plain version here) serves float32 with "pallas";
# the default backend on the CPU, and float64, take the staged form.
ROUTES = [("float64", None), ("float32", None), ("float32", "pallas")]


@pytest.mark.parametrize("dtype,backend", ROUTES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_shared_route_matches_jax(shape, dtype, backend):
    """From init_state, blocks of T hops through the route against the JAX
    package's N2M Convolver.process; every state it returns shares its
    inputs' history again."""
    t, p = SHAPES[shape]
    jc, tc = _pair(p, dtype)
    jst, tst = jc.init_state(dtype=getattr(jnp, dtype)), tc.init_state(dtype=getattr(torch, dtype))
    assert tmono.shares_inputs(tst)
    for x in _blocks(t, 3, dtype):
        jst, jy = jc.process(jst, jnp.asarray(x))
        tst, ty = tc.process(tst, torch.from_numpy(x), backend=backend)
        assert tmono.shares_inputs(tst) and ty.shape == (OUTS, t * HOP)
        assert snr_db(jy, ty) >= SNR_DB[dtype]
    # the state holds the JAX package's shapes and values
    jnum, tnum = jst, tst.numpy()
    for j, c in zip([jnum.head] + [a for s in jnum.sections for a in (s.prev, s.ring.re)],
                    [tnum.head] + [a for s in tnum.sections for a in (s.prev, s.ring.re)]):
        assert np.shape(j) == np.shape(c)
        assert snr_db(j, c) >= SNR_DB[dtype]


def test_matrix_plain_matches_per_pair_sum():
    """fastfir_chain_stream_matrix's plain version (each input's spectra
    once, the MAC summed over inputs, each output's inverse once) against
    fastfir_chain_stream_plain run for each pair and summed over inputs, in
    float64, at T > P and T < P; the new rings equal each pair's."""
    rng = np.random.default_rng(7)
    h = 64

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    for t, p in ((5, 3), (2, 4)):
        x, prev, rr, ri = r(INS, t, h), r(INS, h), r(INS, p, h), r(INS, p, h)
        hr, hi, lr, li = r(OUTS, INS, p, h), r(OUTS, INS, p, h), r(OUTS, INS, h), r(OUTS, INS, h)
        y, nr, ni = hf.fastfir_chain_stream_matrix_plain(x, prev, rr, ri, hr, hi, 0.25, lr, li)
        assert y.shape == (OUTS, t, h) and nr.shape == (INS, p, h)
        for m in range(OUTS):
            want = 0
            for n in range(INS):
                one = slice(n, n + 1)
                yp, pr, pi = hf.fastfir_chain_stream_plain(
                    x[one], prev[one], rr[one], ri[one], hr[m, one], hi[m, one], 0.25,
                    lr[m, one], li[m, one])
                want = want + yp[0]
                assert torch.equal(pr[0], nr[n]) and torch.equal(pi[0], ni[n])
            assert snr_db(want, y[m]) >= SNR_DB["float64"]


def test_fresh_state_takes_the_matrix_route(routes):
    """init_state's shared state runs K8's matrix form once a call and no
    per-pair K8 (float32, backend "pallas")."""
    _, tc = _pair(2, "float32")
    st = tc.init_state()
    for x in _blocks(2, 2, "float32"):
        st, _ = tc.process(st, torch.from_numpy(x), backend="pallas")
    assert routes == {"matrix": 2, "per_pair": 0}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reset_pair_takes_the_per_pair_route(routes, dtype):
    """After reset(in_chan=1, out_chan=2) each pair holds its own history:
    the per-pair route runs, only pair (2, 1) restarts, and the outputs are
    the JAX package's under the same reset (reference Convolver::reset)."""
    jc, tc = _pair(2, dtype)
    x1, x2, x3 = _blocks(2, 3, dtype)
    jst, _ = jc.process(jc.init_state(dtype=getattr(jnp, dtype)), jnp.asarray(x1))
    tst, _ = tc.process(tc.init_state(dtype=getattr(torch, dtype)), torch.from_numpy(x1),
                        backend="pallas")
    jst = jc.reset(in_chan=1, out_chan=2, state=jst)
    tst = tc.reset(in_chan=1, out_chan=2, state=tst)
    assert not tmono.shares_inputs(tst)
    before = dict(routes)
    for x in (x2, x3):
        jst, jy = jc.process(jst, jnp.asarray(x))
        tst, ty = tc.process(tst, torch.from_numpy(x), backend="pallas")
        assert snr_db(jy, ty) >= SNR_DB[dtype]
    # float64 runs the staged per-pair form, whose K8 is not launched
    assert routes["matrix"] == before["matrix"]
    if dtype == "float32":
        assert routes["per_pair"] == before["per_pair"] + 2


def test_from_numpy_state_takes_the_per_pair_route(routes):
    """A JAX N2M state handed over by from_numpy holds a history a pair: the
    per-pair route continues it as the JAX package does."""
    jc, tc = _pair(3, "float32")
    x1, x2 = _blocks(1, 2, "float32")
    jst, _ = jc.process(jc.init_state(), jnp.asarray(x1))
    tst = tmono.MonoState.from_numpy(jst, "cpu")
    assert not tmono.shares_inputs(tst)
    jst, jy = jc.process(jst, jnp.asarray(x2))
    tst, ty = tc.process(tst, torch.from_numpy(x2), backend="pallas")
    assert routes == {"matrix": 0, "per_pair": 1}
    assert snr_db(jy, ty) >= SNR_DB["float32"]


def _pairs_of(state):
    return [state.head] + [a for s in state.sections for a in (s.prev, s.ring.re, s.ring.im)]


def test_writing_one_pair_leaves_the_others():
    """Zeroing pair (2, 1) of a state that began shared (reset_channel, and
    an indexed write into its copy) changes no other pair's history, leaves
    the shared state as it was, and changes no other output."""
    _, tc = _pair(2, "float64")
    x1, x2 = _blocks(2, 2, "float64")
    st, _ = tc.process(tc.init_state(dtype=torch.float64), torch.from_numpy(x1))
    kept = [a.clone() for a in _pairs_of(st)]
    reset = tmc.reset_channel(st, (2, 1))
    for a, b, k in zip(_pairs_of(st), _pairs_of(reset), kept):
        assert torch.equal(a, k)                      # the shared state is as it was
        assert not b[2, 1].any()
        for m in range(OUTS):
            for n in range(INS):
                if (m, n) != (2, 1):
                    assert torch.equal(b[m, n], k[m, n]) and torch.equal(b[m, n], k[0, n])
    ring = reset.sections[-1].ring.re
    ring[1, 1] = 7.0                                  # a write into the reset state's own copy
    assert torch.equal(st.sections[-1].ring.re, kept[-2]) and not ring[2, 1].any()
    assert torch.equal(ring[0, 1], kept[-2][0, 1]) and torch.equal(ring[3, 1], kept[-2][3, 1])
    ring[1, 1] = kept[-2][1, 1]
    _, y_shared = tc.process(st, torch.from_numpy(x2))
    _, y_reset = tc.process(reset, torch.from_numpy(x2))
    for m in (0, 1, 3):
        assert snr_db(y_shared[m], y_reset[m]) >= SNR_DB["float64"]
    assert snr_db(y_shared[2], y_reset[2]) < 60


def test_shared_state_hands_over_like_jax():
    """A shared state through numpy() / from_numpy keeps the JAX package's
    (M, N, ...) shapes and gives the same next outputs, and handed to
    process_any (stream_state_from_aligned, which gives each pair its own
    copy) continues as the JAX package's stream."""
    jc, tc = _pair(2, "float64")
    x1, x2 = _blocks(1, 2, "float64")
    jst, _ = jc.process(jc.init_state(dtype=jnp.float64), jnp.asarray(x1))
    tst, _ = tc.process(tc.init_state(dtype=torch.float64), torch.from_numpy(x1))
    num = tst.numpy()
    back = tmono.MonoState.from_numpy(num, "cpu")
    for a, j in zip(_pairs_of(num), _pairs_of(jst)):
        assert np.shape(a) == np.shape(j)
    _, y_back = tc.process(back, torch.from_numpy(x2))
    _, y_shared = tc.process(tst, torch.from_numpy(x2))
    jst2, jy = jc.process(jst, jnp.asarray(x2))
    assert snr_db(jy, y_back) >= SNR_DB["float64"]
    assert snr_db(jy, y_shared) >= SNR_DB["float64"]

    sst = tmono.stream_state_from_aligned(tc.ir, tst)
    jsst = jmono.stream_state_from_aligned(jc.ir, jst)
    assert all(t.stride(0) != 0 for s in sst.sections for t in (s.win, s.ring.re))
    rng = np.random.default_rng(5)
    for n in (1000, 7192, 300, 9000):
        x = rng.standard_normal((INS, n))
        sst, ty = tc.process_any(sst, torch.from_numpy(x))
        jsst, jy = jc.process_any(jsst, jnp.asarray(x))
        assert snr_db(jy, ty) >= SNR_DB["float64"]


def test_matrix_route_refuses_other_input_counts():
    """Inputs that are not (N, L) for the bank's N inputs raise, as the
    per-pair route's broadcast does."""
    _, tc = _pair(1, "float32")
    st = tc.init_state()
    for bad in (torch.zeros(INS - 1, HOP), torch.zeros(INS + 1, HOP), torch.zeros(1, INS, HOP)):
        with pytest.raises(ValueError, match="inputs"):
            tc.process(st, bad)
