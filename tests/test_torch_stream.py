"""Port parity: the hop-aligned streaming engine (models/partitioned.py
process_block, models/mono.py block paths, state converters).

The same numpy inputs go through the JAX package and the port. Routes:

- ``process_block`` with ``backend="pallas"`` at N = 2^14: the whole block as
  one chain kernel (JAX K8 in interpret mode, the port's K8 plain version;
  the port takes K8 at every P, the JAX package at P <= 8, and at P = 17 the
  port's K8 is held to its own staged route);
- ``process_block`` with no backend at N = 4096, T <= P: materialised frames,
  the ring MAC (JAX K7 in interpret mode, the port's K7 plain version) and
  the inverse, with the lag-0 term; and with T > P (the JAX package's lag
  loop, the port's K7 at any T), bit for bit against the formula of
  ``lag_mac_plain`` over [ring | X] at T <= P and T > P too;
- a JAX state made by ``step`` (pos != 0) continued by both packages.

The mono block paths at the repo's real preset sizes are in
``tests/test_torch_mono.py``; here a small zero-latency scheme in float64
checks the state hand-offs, the projections between block and per-section
states and ``MonoConvolve``. Tolerances: >= 110 dB SNR against JAX in float32
(transforms and sums in another order), >= 250 dB in float64, >= 100 dB
against a float64 convolution.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.core.types import Split as JSplit  # noqa: E402
from hisstools_library_tpu.fft import pallas_fft  # noqa: E402
from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models import partitioned as jpart  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402
from hisstools_library_tpu_torch.models import partitioned as tpart  # noqa: E402

SNR_JAX_DB = 110.0
SNR_JAX_F64_DB = 250.0
SNR_F64_DB = 100.0
CPU = "cpu"  # the port builds on the card unless a call names the CPU
SMALL = jmono.PartitionScheme((32, 64, 128, 256), zero_latency=True)
SMALL_T = tmono.PartitionScheme((32, 64, 128, 256), zero_latency=True)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def to_jax_state(src):
    """The JAX package's PartitionedState from the port's (numpy view)."""
    return jpart.PartitionedState(jnp.asarray(src.prev),
                                  JSplit(jnp.asarray(src.ring.re), jnp.asarray(src.ring.im)),
                                  jnp.asarray(src.pos, jnp.int32))


def assert_states_close(jst, tst, db):
    assert tst.pos == int(np.asarray(jst.pos))
    assert snr_db(jst.prev, tst.prev) >= db
    assert snr_db(jst.ring.re, tst.ring.re) >= db
    assert snr_db(jst.ring.im, tst.ring.im) >= db


def _spectra(rng, lead, p, k, scale=1e-3):
    re, im = (rng.standard_normal(lead + (p, k)).astype(np.float32) * scale
              for _ in range(2))
    return JSplit(jnp.asarray(re), jnp.asarray(im)), Split(torch.from_numpy(re),
                                                           torch.from_numpy(im))


@pytest.mark.parametrize("route", ["chain", "ring", "loop"])
def test_process_block_matches_jax(rng, route):
    """Three carried calls; every output and the final state agree."""
    if route == "chain":      # K8: pallas, f32, N = 2^14, P = 2, lag0
        c, h, p, t, backend = 1, 8192, 2, 1, "pallas"
    elif route == "ring":     # K7: T <= P, lag0
        c, h, p, t, backend = 2, 2048, 3, 2, None
    else:                     # T > P: JAX's lag loop, the port's K7
        c, h, p, t, backend = 2, 2048, 2, 3, None
    jspec, tspec = _spectra(rng, (c,), p, h)
    jl0, tl0 = _spectra(rng, (c,), 1, h)
    jst = jpart.PartitionedState(jnp.zeros((c, h), jnp.float32),
                                 JSplit.zeros((c, p, h)), jnp.zeros((), jnp.int32))
    tst = tpart.PartitionedState(torch.zeros(c, h), Split.zeros((c, p, h), device=CPU), 0)
    # One compile for the three calls (interpret mode is slow to trace).
    jblock = jax.jit(lambda sp, st, x, l0: jpart.PartitionedConvolve.process_block(
        sp, st, x, backend=backend, lag0=l0))
    mode = pallas_fft.get_mode()
    pallas_fft.set_mode("highest")
    try:
        for _ in range(3):
            x = rng.standard_normal((c, t * h)).astype(np.float32)
            jst, jy = jblock(jspec, jst, jnp.asarray(x), jl0)
            tst_before = tst
            tst, ty = tpart.PartitionedConvolve.process_block(
                tspec, tst, torch.from_numpy(x), backend=backend, lag0=tl0)
            assert ty.shape == (c, t * h) and ty.dtype == torch.float32
            assert snr_db(jy, ty) >= SNR_JAX_DB
            assert tst is not tst_before and tst.ring.re is not tst_before.ring.re
    finally:
        pallas_fft.set_mode(mode)
    assert_states_close(jst, tst, SNR_JAX_DB)


def test_process_block_continues_jax_step_state(rng):
    """A JAX state after three ``step`` hops (pos = 3 of P = 5) continues in
    both packages alike; the port slot-normalises it."""
    h, p = 256, 5
    jspec, tspec = _spectra(rng, (2,), p, h)
    jspec = JSplit(jspec.re.astype(jnp.float64), jspec.im.astype(jnp.float64))
    tspec = tspec.astype(torch.float64)
    jst = jpart.PartitionedState(jnp.zeros((2, h)), JSplit.zeros((2, p, h), jnp.float64),
                                 jnp.zeros((), jnp.int32))
    jstep = jax.jit(jpart.PartitionedConvolve.step)
    for _ in range(3):
        jst, _ = jstep(jspec, jst, jnp.asarray(rng.standard_normal((2, h))))
    assert int(jst.pos) == 3
    tst = tpart.PartitionedState.from_numpy(jst, CPU)
    assert tst.pos == 3 and tst.ring.re.dtype == torch.float64
    x = rng.standard_normal((2, 4 * h))
    jst2, jy = jpart.PartitionedConvolve.process_block(jspec, jst, jnp.asarray(x))
    tst2, ty = tpart.PartitionedConvolve.process_block(tspec, tst, torch.from_numpy(x))
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    assert_states_close(jst2, tst2, SNR_JAX_F64_DB)
    assert tst.pos == 3  # the given state is left as it was


@pytest.fixture(scope="module")
def small_ir():
    rng = np.random.default_rng(0x5E)
    ir = rng.standard_normal((2, 4096)) * np.exp(-np.arange(4096) / 1365.0)
    jir = jmono.prepare_ir(SMALL, ir, dtype=jnp.float64, offline_tail=False)
    tir = tmono.prepare_ir(SMALL_T, ir, dtype=torch.float64, offline_tail=False,
                           device=CPU)
    return ir, jir, tir


def test_small_scheme_ir_and_paths_match_float64(small_ir, rng):
    """prepare_ir agrees with JAX in float64; the two-tier and collapsed paths
    over three blocks agree with np.convolve (their JAX parity is in
    test_state_handoff_both_ways)."""
    ir, jir, tir = small_ir
    for j, t in zip(jir.spectra + (jir.block0, jir.far), tir.spectra + (tir.block0, tir.far)):
        assert tuple(t.shape) == j.shape
        assert snr_db(j.re, t.re) >= SNR_JAX_F64_DB and snr_db(j.im, t.im) >= SNR_JAX_F64_DB
    assert np.array_equal(np.asarray(jir.head_taps), tir.head_taps.numpy())
    h2 = tir.far.shape[-1]
    xs = [rng.standard_normal((2, 2 * h2)) for _ in range(3)]
    for init in (tmono.init_block_state, tmono.init_state):
        st = init(SMALL_T, tir, (2,), torch.float64)
        ys = []
        for x in xs:
            st, y = tmono.process(tir, st, torch.from_numpy(x))
            ys.append(y.numpy())
        y, x = np.concatenate(ys, -1), np.concatenate(xs, -1)
        for c in range(2):
            assert snr_db(np.convolve(x[c], ir[c])[:x.shape[-1]], y[c]) >= 250.0


def _to_jax_block(src):
    return jmono.MonoBlockState(to_jax_state(src.near), to_jax_state(src.far),
                                jnp.asarray(src.hist), jnp.asarray(src.hpos, jnp.int32))


def _to_jax_mono(src):
    return jmono.MonoState(jnp.asarray(src.head),
                           tuple(to_jax_state(s) for s in src.sections))


def _to_jax_ir(src):
    """The JAX package's MonoIR from the port's (numpy view)."""
    def split(s):
        return None if s is None else JSplit(jnp.asarray(s.re), jnp.asarray(s.im))
    return jmono.MonoIR(jnp.asarray(src.head_taps), tuple(split(s) for s in src.spectra),
                        split(src.tail), src.tail_shift, split(src.block0), split(src.far))


@pytest.mark.parametrize("kind", ["block", "aligned"])
def test_state_handoff_both_ways(small_ir, rng, kind):
    """A JAX stream taken after two blocks continues in the port, and a port
    stream taken after two blocks continues in JAX, with the same output.
    The port runs on the JAX package's own prepared IR (MonoIR.from_numpy)."""
    _, jir, _ = small_ir
    tir = tmono.MonoIR.from_numpy(jir, CPU)
    assert tir.far.re.dtype == torch.float64 and tir.tail is None
    init_j = jmono.init_block_state if kind == "block" else jmono.init_state
    init_t = tmono.init_block_state if kind == "block" else tmono.init_state
    to_j = _to_jax_block if kind == "block" else _to_jax_mono
    from_j = tmono.MonoBlockState if kind == "block" else tmono.MonoState
    h2 = jir.far.shape[-1]
    xs = [rng.standard_normal((2, h2)) for _ in range(4)]
    jst = init_j(SMALL, jir, (2,), jnp.float64)
    tst = init_t(SMALL_T, tir, (2,), torch.float64)
    jprocess = jax.jit(lambda i, s, x: jmono.process(i, s, x))
    jys, tys = [], []
    for x in xs:
        jst, jy = jprocess(jir, jst, jnp.asarray(x))
        tst, ty = tmono.process(tir, tst, torch.from_numpy(x))
        jys.append(np.asarray(jy))
        tys.append(ty.numpy())
        assert snr_db(jys[-1], tys[-1]) >= SNR_JAX_F64_DB
        if len(jys) == 2:
            jst_mid, tst_mid = jst, tst
    # JAX -> port after block 2, then blocks 3 and 4 in the port.
    st = from_j.from_numpy(jst_mid, CPU)
    for x, jy in zip(xs[2:], jys[2:]):
        st, y = tmono.process(tir, st, torch.from_numpy(x))
        assert snr_db(jy, y) >= SNR_JAX_F64_DB
    # Port -> JAX after block 2, then blocks 3 and 4 in JAX, on the port's IR
    # carried back through numpy.
    jir_back = _to_jax_ir(tir.numpy())
    st = to_j(tst_mid.numpy())
    for x, ty in zip(xs[2:], tys[2:]):
        st, y = jprocess(jir_back, st, jnp.asarray(x))
        assert snr_db(ty, y) >= SNR_JAX_F64_DB


def test_block_projections_match_jax(small_ir, rng):
    """aligned_state_from_block and block_state_from_hist agree with JAX, and
    the per-section state they give continues the stream."""
    _, jir, tir = small_ir
    h2 = tir.far.shape[-1]
    jst = jmono.init_block_state(SMALL, jir, (2,), jnp.float64)
    tst = tmono.init_block_state(SMALL_T, tir, (2,), torch.float64)
    jprocess = jax.jit(lambda i, s, x: jmono.process(i, s, x))
    for _ in range(3):  # 3 far hops: the history ring wraps (hpos != 0)
        x = rng.standard_normal((2, h2))
        jst, _ = jprocess(jir, jst, jnp.asarray(x))
        tst, _ = tmono.process(tir, tst, torch.from_numpy(x))
    assert tst.hpos == int(jst.hpos) != 0
    ja = jmono.aligned_state_from_block(jir, jst)
    ta = tmono.aligned_state_from_block(tir, tst)
    assert np.array_equal(np.asarray(ja.head), ta.head.numpy())
    for js, ts in zip(ja.sections, ta.sections):
        assert_states_close(js, ts, SNR_JAX_F64_DB)
    x = rng.standard_normal((2, h2))
    _, jy = jmono.process(jir, ja, jnp.asarray(x))
    _, ty = tmono.process(tir, ta, torch.from_numpy(x))
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    hist = rng.standard_normal((2, tst.hist.shape[-2] * tst.hist.shape[-1]))
    jb = jmono.block_state_from_hist(jir, jnp.asarray(hist))
    tb = tmono.block_state_from_hist(tir, torch.from_numpy(hist))
    assert_states_close(jb.near, tb.near, SNR_JAX_F64_DB)
    assert_states_close(jb.far, tb.far, SNR_JAX_F64_DB)
    assert np.array_equal(np.asarray(jb.hist), tb.hist.numpy()) and tb.hpos == 0
    with pytest.raises(ValueError, match="hist must carry"):
        tmono.block_state_from_hist(tir, torch.from_numpy(hist[:, 1:]))


def test_mono_convolve_class(rng):
    """MonoConvolve: set (clamped without a resize, as the JAX package's set
    reports it), block_size, resize, both states against np.convolve."""
    ir = rng.standard_normal(3000)
    conv = tmono.MonoConvolve(max_length=2048, scheme=SMALL_T)
    assert conv.set(ir, dtype=torch.float64, request_resize=False, device=CPU).name == \
        "MEM_ALLOC_TOO_SMALL"
    assert conv.length == 2048 and conv.block_size == 128
    assert conv.resize(4000).name == "NONE" and conv.max_length == 4000
    x = rng.standard_normal(2048)
    ref = np.convolve(x, ir[:2048])[:2048]
    for init in ("init_state", "init_block_state"):
        _, y = conv.process(getattr(conv, init)(dtype=torch.float64), torch.from_numpy(x))
        assert snr_db(ref, y) >= 250.0
    with pytest.raises(Exception, match="no IR set"):
        tmono.MonoConvolve().init_state()


def test_partitioned_convolve_class_matches_jax(rng):
    """PartitionedConvolve.set / init_state / process (per-section path)."""
    ir = rng.standard_normal((2, 5000))
    jeng = jpart.PartitionedConvolve(512, max_length=3000, offset=256)
    teng = tpart.PartitionedConvolve(512, max_length=3000, offset=256)
    assert teng.set(ir, dtype=torch.float64, device=CPU).name == \
        jeng.set(ir, jnp.float64).name
    assert teng.num_partitions == jeng.num_partitions == 12
    x = rng.standard_normal((2, 4 * 256))
    _, jy = jpart.PartitionedConvolve.process(jeng.spectra, jeng.init_state((2,), jnp.float64),
                                              jnp.asarray(x))
    tst = teng.init_state((2,), torch.float64)
    _, ty = tpart.PartitionedConvolve.process(teng.spectra, tst, torch.from_numpy(x))
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    with pytest.raises(ValueError, match="not a multiple of hop"):
        tpart.PartitionedConvolve.process(teng.spectra, tst, torch.zeros(2, 300,
                                                                         dtype=torch.float64))


def test_scheme_plans_match_jax():
    for mode in jmono.LatencyMode:
        js = jmono.PartitionScheme.from_latency(mode)
        ts = tmono.PartitionScheme.from_latency(tmono.LatencyMode[mode.name])
        assert [dataclass_tuple(p) for p in ts.sections()] == \
            [dataclass_tuple(p) for p in js.sections()]
        assert (ts.latency, ts.head_taps) == (js.latency, js.head_taps)
    for budget in (64, 300, 700, 8192, 1 << 20):
        assert tmono.PartitionScheme.for_latency_budget(budget).sizes == \
            jmono.PartitionScheme.for_latency_budget(budget).sizes
    for ir_len in (1000, 140_000, 480_000):
        assert tmono._far_hop(SMALL_T, ir_len) == jmono._far_hop(SMALL, ir_len)
    for bad in ((100,), (64, 32), (32, 64, 128, 256, 512)):
        with pytest.raises(Exception, match="FFT size"):
            tmono.PartitionScheme(bad, True)


def dataclass_tuple(plan):
    return (plan.fft_size, plan.offset, plan.length)


def _meta_spectra(p, k):
    return torch.empty(2, p, k, device="meta"), torch.empty(2, p, k, device="meta")


@pytest.mark.parametrize("p,mac_backend,match", [
    (3, "auto", "K7"),           # "auto" off the CPU is K7
    (3, "pallas", "K7"),
    (5, "auto", "K7"),
    (600, "auto", "K7"),         # above the TPU package's VMEM bound of 512 too
    (3, "xla", None),            # "xla" is the torch loop on any device
])
def test_lag_mac_dispatch_routing_off_cpu(p, mac_backend, match):
    """Off the CPU, the engine's one lag-MAC dispatch (``_ring_mac``)
    launches K7 at any P (a meta tensor takes the GPU branch without a
    card): the K7 routes reach the kernel's wrapper, which refuses a device
    that is not CUDA, and the loop route runs."""
    t, k = 4, 64
    ring, h = Split(*_meta_spectra(p, k)), Split(*_meta_spectra(p, k))
    x = [torch.empty(2, t, k, device="meta") for _ in range(2)]
    if match is None:
        acc_re, _, new_ring = tpart._ring_mac(ring, *x, h, mac_backend)
        assert acc_re.shape == (2, t, k) and acc_re.device.type == "meta"
        assert new_ring.shape == (2, p, k)
        return
    with pytest.raises(ValueError, match=f"{match} lag_mac_ring: .*CUDA"):
        tpart._ring_mac(ring, *x, h, mac_backend)


@pytest.mark.parametrize("p,t", [
    pytest.param(3, 2, id="3"), pytest.param(600, 2, id="600"),
    pytest.param(1, 2, id="1-t2"), pytest.param(3, 8, id="3-t8"),   # T > P
])
def test_process_block_ring_mac_routing_off_cpu(p, t):
    """Off the CPU, process_block's MAC takes K7 at any T and P, above the
    TPU package's bound of 512 partitions and with T > P too: the wrapper
    refuses the meta device by name, so no torch loop ran in its place."""
    h = 32
    spectra = Split(*_meta_spectra(p, h))
    state = tpart.PartitionedState(torch.empty(2, h, device="meta"),
                                   Split(*_meta_spectra(p, h)), 0)
    with pytest.raises(ValueError, match="K7 lag_mac_ring: .*CUDA"):
        tpart.PartitionedConvolve.process_block(
            spectra, state, torch.empty(2, t * h, device="meta"), backend="xla")


@pytest.mark.parametrize("mac_backend", ["auto", "xla"])
@pytest.mark.parametrize("p,t", [(3, 2), (1, 2), (3, 8)])   # T <= P and T > P
def test_process_block_staged_bit_equal_on_cpu(rng, p, t, mac_backend):
    """The staged process_block on the CPU (N = 4096, two carried calls,
    lag0, a ring at pos != 0) is bit for bit the frames' rFFT,
    ``lag_mac_plain`` over [ring | X], the lag-0 product and the kept half
    of the scaled inverse, and its new ring is [ring | X]'s last P rows."""
    from hisstools_library_tpu_torch.core.types import packed_mul
    from hisstools_library_tpu_torch.fft import api as fft_api, hopper_kernels

    c, h = 2, 2048
    _, spec = _spectra(rng, (c,), p, h)
    _, l0 = _spectra(rng, (c,), 1, h)
    ring = Split(*(torch.from_numpy(rng.standard_normal((c, p, h)).astype(np.float32))
                   for _ in range(2)))
    state = tpart.PartitionedState(torch.from_numpy(
        rng.standard_normal((c, h)).astype(np.float32)), ring, p - 1)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((c, t * h)).astype(np.float32))
        new, y = tpart.PartitionedConvolve.process_block(spec, state, x,
                                                         mac_backend=mac_backend, lag0=l0)
        ring = tpart.PartitionedConvolve._slot_normalise(state.ring, state.pos)
        blocks = x.reshape(c, t, h)
        prev_rows = torch.cat([state.prev[:, None, :], blocks[:, :-1, :]], dim=-2)
        xre, xim = fft_api.rfft(torch.cat([prev_rows, blocks], dim=-1))
        v_re, v_im = torch.cat([ring.re, xre], dim=-2), torch.cat([ring.im, xim], dim=-2)
        acc_re, acc_im = hopper_kernels.lag_mac_plain(v_re, v_im, spec.re, spec.im, t)
        prod = packed_mul(Split(xre, xim), l0)
        want = (fft_api.rifft(acc_re + prod.re, acc_im + prod.im) * (1.0 / (4.0 * 2 * h)))
        want = want[..., h:]
        assert torch.equal(y, want.reshape(c, t * h))
        assert torch.equal(new.ring.re, v_re[:, t:]) and torch.equal(new.ring.im, v_im[:, t:])
        assert new.pos == 0 and torch.equal(new.prev, blocks[:, -1])
        state = new


@pytest.mark.parametrize("n,p,t", [
    (1 << 16, 8, 2), (1 << 17, 8, 2), (1 << 17, 1, 2),
    (1 << 14, 17, 8), (1 << 14, 58, 8),   # the 16384 section's P of a 3 s / 10 s IR
    (1 << 16, 64, 2), (1 << 14, 4, 8),    # P above 40; T > P
])
def test_process_block_reaches_k8_at_wide_sizes_off_cpu(n, p, t):
    """At N = 2^14..2^17 in float32, with no lag0 (the two-tier far tier's
    call, P2 > 8 included; a single 2^17 section over a 10 s IR), at any P
    and T, process_block reaches K8's wrapper, which refuses only the meta
    device, by name. The calls with lag0 (the collapsed engine's 16384
    section) are pinned by their launches in test_torch_transform_points."""
    h = n // 2
    spectra = Split(*_meta_spectra(p, h))
    state = tpart.PartitionedState(torch.empty(2, h, device="meta"),
                                   Split(*_meta_spectra(p, h)), 0)
    with pytest.raises(ValueError, match="K8 fastfir_chain_stream: .*CUDA"):
        tpart.PartitionedConvolve.process_block(
            spectra, state, torch.empty(2, t * h, device="meta"), backend="pallas")


def test_process_block_chain_matches_staged_route_on_cpu(rng):
    """At the matrix cell's P = 17 (N = 2^14, 2 channels, 2 hops, lag0)
    process_block with ``backend="pallas"`` (K8's plain version) agrees with
    the torch route (the frames, K7's plain version, the lag-0 product,
    ``torch.fft``) over three carried calls: outputs and the new ring."""
    c, t, p, h = 2, 2, 17, 8192
    _, spec = _spectra(rng, (c,), p, h)
    _, l0 = _spectra(rng, (c,), 1, h)
    st = {b: tpart.PartitionedState(torch.zeros(c, h), Split.zeros((c, p, h), device=CPU), 0)
          for b in ("pallas", "xla")}
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((c, t * h)).astype(np.float32))
        ys = {}
        for b in st:
            st[b], ys[b] = tpart.PartitionedConvolve.process_block(spec, st[b], x, backend=b,
                                                                   lag0=l0)
        assert snr_db(ys["xla"], ys["pallas"]) >= SNR_JAX_DB
    for plane in ("re", "im"):
        assert snr_db(getattr(st["xla"].ring, plane), getattr(st["pallas"].ring, plane)) \
            >= SNR_JAX_DB
    assert torch.equal(st["xla"].prev, st["pallas"].prev) and st["pallas"].pos == 0


@pytest.mark.parametrize("call,match", [
    # K8 serves N = 2^14..2^17, as in the TPU package; above that the staged path.
    (lambda: hopper_fft.fastfir_chain_stream(
        torch.empty(1, 2, 1 << 17, device="meta"), torch.empty(1, 1 << 17, device="meta"),
        *(torch.empty(1, 2, 1 << 17, device="meta") for _ in range(4)), 1.0),
     "K8 fastfir_chain_stream: serves N = 16384..131072; N = 262144"),
    (lambda: hopper_fft.rfft_packed(torch.empty(2, 1 << 29, device="meta")), "above 2\\^28"),
    (lambda: hopper_fft.rfft_small(torch.empty(2, 4096, device="meta")), "K10"),
])
def test_stream_envelopes_raise_off_cpu(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()
