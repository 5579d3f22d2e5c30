"""Port parity: the sample-granular streaming engine (models/partitioned.py
StreamState / step_any / step / stream hand-offs, models/mono.py
process_any) and its kernels' plain versions.

The same numpy inputs go through the JAX package and the port:

- K9 ``hopper_kernels.hop_fire``, K6 ``hopper_fft.rifft_packed`` and K11
  ``hopper_fft.rifft_small`` (their plain versions on the CPU) against the
  Pallas kernels in interpret mode ("highest" mode): ``hop_fire``,
  ``rifft_packed`` at N = 4096 and 16384, ``_rifft_small`` at N = 128 and the
  folded N = 2048;
- ``step_any`` over random block lengths, ``step``, ``stream_from_aligned`` /
  ``stream_to_aligned`` and ``mono.process_any`` at the real Zero preset (one
  channel, 20 000 taps, 64-sample callbacks), in float64 on the ``jnp.fft`` /
  ``torch.fft`` path;
- the block -> stream hand-offs, and a JAX ``MonoStreamState`` whose sections
  hold rings with pos != 0 continued in the port through K9's plain version,
  which slot-normalises such a ring before its first firing.

Tolerances: >= 110 dB SNR in float32 (transforms and sums in another order; a
dense DFT on the TPU side), >= 250 dB in float64 (the same torch.fft /
jnp.fft arithmetic up to rounding), >= 100 dB against a float64 convolution
in float32. Oracles are float64 FFT convolutions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import pallas_fft, pallas_kernels  # noqa: E402
from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models import partitioned as jpart  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402
from hisstools_library_tpu_torch.models import partitioned as tpart  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_JAX_DB = 110.0
SNR_JAX_F64_DB = 250.0
SNR_F64_DB = 100.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def convolve_f64(x, h, n):
    """conv(x, h)[:n] in float64, through an FFT longer than the full result."""
    size = 1 << (len(x) + len(h) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), size) * np.fft.rfft(h.astype(np.float64), size)
    return np.fft.irfft(spec, size)[:n]


@pytest.fixture
def highest():
    mode = pallas_fft.get_mode()
    pallas_fft.set_mode("highest")
    yield
    pallas_fft.set_mode(mode)


def stream(step, state, x, sizes):
    """Drive ``step(state, block) -> (state, y)`` over a block-size schedule
    (cycled) until ``x``'s last axis is used up."""
    outs, i, j = [], 0, 0
    while i < x.shape[-1]:
        b = min(sizes[j % len(sizes)], x.shape[-1] - i)
        state, y = step(state, x[..., i:i + b])
        outs.append(np.asarray(y))
        i += b
        j += 1
    return state, np.concatenate(outs, axis=-1)


def _section(rng, fft_size, taps, lead=(), dtype=np.float64):
    h = fft_size >> 1
    ir = rng.standard_normal(lead + (taps,)).astype(dtype)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jspec = jpart.impulse_spectra(ir, fft_size, offset=h, dtype=jdt, backend="xla")
    tspec = tpart.impulse_spectra(ir, fft_size, offset=h, dtype=tdt, backend="xla",
                                  device=CPU)
    eng = tpart.PartitionedConvolve(fft_size, offset=h)
    eng.spectra = tspec
    jeng = jpart.PartitionedConvolve(fft_size, offset=h)
    jeng.spectra = jspec
    return ir, jspec, tspec, jeng, eng


# -- kernels' plain versions ---------------------------------------------------------

@pytest.mark.parametrize("n,p,shared", [(64, 1, False), (256, 3, True), (1024, 3, False),
                                         (1024, 256, False)])
def test_hop_fire_matches_pallas(rng, highest, n, p, shared):
    """K9 against the TPU kernel: the new ring (oldest leaves, the frame's
    spectrum enters as the newest slot) and the kept output half. ``shared``:
    one (P, K) spectra set broadcast over the channels."""
    c, k = 3, n // 2
    frame = rng.standard_normal((c, n)).astype(np.float32)
    ring = [rng.standard_normal((c, p, k)).astype(np.float32) for _ in range(2)]
    spec = [rng.standard_normal(((p, k) if shared else (c, p, k))).astype(np.float32)
            for _ in range(2)]
    spec[0][..., 0] += 4.0  # a DC-heavy packed lane makes a bin-0 error visible
    want = pallas_kernels.hop_fire(*map(jnp.asarray, [frame] + ring + spec), interpret=True)
    got = hopper_kernels.hop_fire(*map(torch.from_numpy, [frame] + ring + spec))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert snr_db(w, g) >= SNR_JAX_DB
    assert hopper_kernels.hop_fire_eligible(n, p)
    assert not hopper_kernels.hop_fire_eligible(2048, p)
    assert not hopper_kernels.hop_fire_eligible(n, 257)


@pytest.mark.parametrize("n", [4096, 16384])
def test_rifft_packed_matches_pallas(rng, highest, n):
    """K6: the unscaled packed inverse, rifft(rfft(x)) == 2N x."""
    re, im = (rng.standard_normal((3, n // 2)).astype(np.float32) for _ in range(2))
    jy = pallas_fft.rifft_packed(jnp.asarray(re), jnp.asarray(im), interpret=True)
    ty = hopper_fft.rifft_packed(torch.from_numpy(re), torch.from_numpy(im))
    assert ty.shape == (3, n) and ty.dtype == torch.float32
    assert snr_db(jy, ty) >= SNR_JAX_DB
    x = rng.standard_normal((2, n)).astype(np.float32)
    back = hopper_fft.rifft_packed(*hopper_fft.rfft_packed(torch.from_numpy(x)))
    assert snr_db(2 * n * x, back) >= 120.0


@pytest.mark.parametrize("n", [128, 2048])
def test_rifft_small_matches_pallas(rng, highest, n):
    """K11 against the dense small inverse (``_small_inv_call``; N = 2048 is
    the TPU side's folded form); ``rifft_packed`` sends these sizes to it."""
    re, im = (rng.standard_normal((3, 2, n // 2)).astype(np.float32) for _ in range(2))
    jy = pallas_fft._rifft_small(jnp.asarray(re), jnp.asarray(im), True, "highest")
    ty = hopper_fft.rifft_small(torch.from_numpy(re), torch.from_numpy(im))
    assert ty.shape == (3, 2, n) and ty.dtype == torch.float32
    assert snr_db(jy, ty) >= SNR_JAX_DB
    assert torch.equal(hopper_fft.rifft_packed(torch.from_numpy(re), torch.from_numpy(im)), ty)


# -- one section ---------------------------------------------------------------------

def test_step_any_random_blocks_matches_jax(rng):
    """Random callback lengths 1..199 through one section: the port equals
    JAX's step_any and a float64 convolution with the section's IR window."""
    fft_size, h = 128, 64
    ir, jspec, tspec, jeng, eng = _section(rng, fft_size, 500)
    x = rng.standard_normal(2000)
    sizes = [int(b) for b in rng.integers(1, 200, size=40)]
    jstep = jax.jit(jpart.PartitionedConvolve.step_any)
    _, jy = stream(lambda s, b: jstep(jspec, s, jnp.asarray(b)),
                   jeng.init_stream_state(dtype=jnp.float64), x, sizes)
    tst0 = eng.init_stream_state(dtype=torch.float64)
    assert tst0.win.device.type == "cpu" and (tst0.phase, tst0.pos) == (0, 0)
    tst, ty = stream(lambda s, b: tpart.PartitionedConvolve.step_any(
        tspec, s, torch.from_numpy(b)), tst0, x, sizes)
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    masked = np.zeros_like(ir)
    masked[h:] = ir[h:]
    assert snr_db(convolve_f64(x, masked, len(x)), ty) >= SNR_JAX_F64_DB
    assert tst.phase == (len(x) % h) and tst0.phase == 0  # the given state is kept


def test_step_any_equals_step(rng):
    """Hop-sized blocks: step_any == the aligned per-hop step, and the port's
    step == JAX's (its ring cycles: pos != 0)."""
    fft_size, h = 64, 32
    _, jspec, tspec, jeng, eng = _section(rng, fft_size, 300)
    x = rng.standard_normal(h * 10)
    st_a = eng.init_state(dtype=torch.float64)
    st_s = eng.init_stream_state(dtype=torch.float64)
    jst = jeng.init_state(dtype=jnp.float64)
    jstep = jax.jit(jpart.PartitionedConvolve.step)
    for t in range(10):
        blk = x[t * h:(t + 1) * h]
        st_a, ya = tpart.PartitionedConvolve.step(tspec, st_a, torch.from_numpy(blk))
        st_s, ys = tpart.PartitionedConvolve.step_any(tspec, st_s, torch.from_numpy(blk))
        jst, jy = jstep(jspec, jst, jnp.asarray(blk))
        np.testing.assert_allclose(ya.numpy(), ys.numpy(), rtol=1e-12, atol=1e-12)
        assert snr_db(jy, ya) >= SNR_JAX_F64_DB
        assert st_a.pos == int(jst.pos)


def test_stream_from_and_to_aligned(rng):
    """Aligned for half the signal, lifted mid-stream, odd blocks after ==
    the sample-granular engine throughout; on a hop boundary the stream state
    projects back; between boundaries the projection refuses."""
    fft_size, h = 64, 32
    _, jspec, tspec, jeng, eng = _section(rng, fft_size, 400)
    x = rng.standard_normal(h * 12)
    step = (lambda s, b: tpart.PartitionedConvolve.step_any(tspec, s, torch.from_numpy(b)))
    _, y_full = stream(step, eng.init_stream_state(dtype=torch.float64), x, [13, 51, 7])
    split = h * 6
    st_a, y1 = tpart.PartitionedConvolve.process(
        tspec, eng.init_state(dtype=torch.float64), torch.from_numpy(x[:split]))
    st_s = tpart.PartitionedConvolve.stream_from_aligned(tspec, st_a)
    jst_a, _ = jpart.PartitionedConvolve.process(
        jspec, jeng.init_state(dtype=jnp.float64), jnp.asarray(x[:split]))
    jst_s = jpart.PartitionedConvolve.stream_from_aligned(jspec, jst_a)
    assert snr_db(jst_s.out_buf, st_s.out_buf) >= SNR_JAX_F64_DB
    assert snr_db(jst_s.ring.re, st_s.ring.re) >= SNR_JAX_F64_DB and st_s.pos == 0
    st_end, y2 = stream(step, st_s, x[split:], [13, 51, 7])
    assert snr_db(y_full, np.concatenate([y1.numpy(), y2])) >= SNR_JAX_F64_DB
    # Back to the aligned form on a hop boundary, then process_block.
    st_s, y3 = tpart.PartitionedConvolve.step_any(tspec, st_s, torch.from_numpy(x[split:]))
    assert st_s.phase == 0
    back = tpart.PartitionedConvolve.stream_to_aligned(st_s)
    jback = jpart.PartitionedConvolve.stream_to_aligned(
        jpart.PartitionedConvolve.step_any(jspec, jst_s, jnp.asarray(x[split:]))[0])
    tail = rng.standard_normal(h * 4)
    _, jy4 = jpart.PartitionedConvolve.process(jspec, jback, jnp.asarray(tail))
    _, y4 = tpart.PartitionedConvolve.process(tspec, back, torch.from_numpy(tail))
    assert snr_db(jy4, y4) >= SNR_JAX_F64_DB
    with pytest.raises(ValueError, match="phase 0"):
        tpart.PartitionedConvolve.stream_to_aligned(
            tpart.PartitionedConvolve.step_any(tspec, st_end, torch.zeros(5, dtype=torch.float64))[0])


def test_hop_fire_route_matches_generic_float32(rng):
    """float32, three channels: ``backend="pallas"`` (K9's route, its plain
    version here) and ``"xla"`` (rfft, ring insert, _emit) agree and match a
    float64 convolution, at N = 64, 256 and 1024."""
    for fft_size in (64, 256, 1024):
        h = fft_size >> 1
        ir, _, tspec, _, eng = _section(rng, fft_size, 3 * h + 11, (3,), np.float32)
        L = h * 8 + 45
        x = rng.standard_normal((3, L)).astype(np.float32)
        outs = {}
        for be in ("pallas", "xla"):
            st, outs[be] = stream(lambda s, b: tpart.PartitionedConvolve.step_any(
                tspec, s, torch.from_numpy(b), backend=be),
                eng.init_stream_state((3,)), x, [64, 480, 333, 100, 7])
            assert st.pos == 0 or be == "xla"
        assert snr_db(outs["xla"], outs["pallas"]) >= SNR_JAX_DB, fft_size
        for c in range(3):
            masked = np.zeros(ir.shape[-1])
            masked[h:] = ir[c, h:]
            assert snr_db(convolve_f64(x[c], masked, L), outs["pallas"][c]) >= SNR_F64_DB


# -- schemes -------------------------------------------------------------------------

def test_process_any_zero_preset_64_sample_callbacks():
    """The reference's Zero preset (TD head + 256/1024/4096/16384) at one
    channel and 20 000 taps, in 64-sample callbacks across two final-section
    boundaries: the port equals JAX's process_any and the convolution."""
    rng = np.random.default_rng(0x5B)
    ir = rng.standard_normal(20000)
    x = rng.standard_normal(8192 * 2 + 4096)
    jscheme = jmono.PartitionScheme.from_latency(jmono.LatencyMode.Zero)
    tscheme = tmono.PartitionScheme.from_latency(tmono.LatencyMode.Zero)
    jir = jmono.prepare_ir(jscheme, ir, dtype=jnp.float64, offline_tail=False)
    tir = tmono.prepare_ir(tscheme, ir, dtype=torch.float64, offline_tail=False,
                           device=CPU)
    jstep = jax.jit(lambda s, b: jmono.process_any(jir, s, b))
    _, jy = stream(lambda s, b: jstep(s, jnp.asarray(b)),
                   jmono.init_stream_state(jscheme, jir, dtype=jnp.float64), x, [64])
    conv = tmono.MonoConvolve(scheme=tscheme)
    conv.set(ir, dtype=torch.float64, offline_tail=False, device=CPU)
    st = conv.init_stream_state(dtype=torch.float64)
    assert [s.win.shape[-1] for s in st.sections] == [256, 1024, 4096, 16384]
    _, ty = stream(lambda s, b: conv.process_any(s, torch.from_numpy(b)), st, x, [64])
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    assert snr_db(convolve_f64(x, ir, len(x)), ty) >= SNR_JAX_F64_DB
    st2 = tmono.init_stream_state(tscheme, tir, dtype=torch.float64)
    _, ty2 = stream(lambda s, b: tmono.process_any(tir, s, torch.from_numpy(b)), st2,
                    x[:4096], [333])
    assert snr_db(ty[:4096], ty2) >= SNR_JAX_F64_DB


SMALL = jmono.PartitionScheme((32, 64, 128, 256), zero_latency=True)
SMALL_T = tmono.PartitionScheme((32, 64, 128, 256), zero_latency=True)


@pytest.fixture(scope="module")
def small_ir():
    rng = np.random.default_rng(0x5C)
    ir = rng.standard_normal((2, 4096)) * np.exp(-np.arange(4096) / 1365.0)
    jir = jmono.prepare_ir(SMALL, ir, dtype=jnp.float64, offline_tail=False)
    tir = tmono.prepare_ir(SMALL_T, ir, dtype=torch.float64, offline_tail=False,
                           device=CPU)
    return ir, jir, tir


def test_block_to_stream_handoffs_match_jax(small_ir, rng):
    """Two-tier blocks then stream_state_from_block, and collapsed blocks
    then stream_state_from_aligned, each continued with odd callbacks: the
    port equals JAX and the joined output equals the convolution."""
    ir, jir, tir = small_ir
    h2 = tir.far.shape[-1]
    x = rng.standard_normal((2, 3 * h2 + 700))
    head = 3 * h2
    jprocess = jax.jit(lambda s, b: jmono.process(jir, s, b))
    for kind in ("block", "aligned"):
        if kind == "block":
            jst = jmono.init_block_state(SMALL, jir, (2,), jnp.float64)
            tst = tmono.init_block_state(SMALL_T, tir, (2,), torch.float64)
        else:
            jst = jmono.init_state(SMALL, jir, (2,), jnp.float64)
            tst = tmono.init_state(SMALL_T, tir, (2,), torch.float64)
        jst, jy1 = jprocess(jst, jnp.asarray(x[:, :head]))
        tst, ty1 = tmono.process(tir, tst, torch.from_numpy(x[:, :head]))
        if kind == "block":
            jss = jmono.stream_state_from_block(jir, jst)
            tss = tmono.stream_state_from_block(tir, tst)
        else:
            jss = jmono.stream_state_from_aligned(jir, jst)
            tss = tmono.stream_state_from_aligned(tir, tst)
        assert isinstance(tss, tmono.MonoStreamState)
        for js, ts in zip(jss.sections, tss.sections):
            assert snr_db(js.out_buf, ts.out_buf) >= SNR_JAX_F64_DB
            assert ts.pos == 0 and ts.phase == 0
        jstep = jax.jit(lambda s, b: jmono.process_any(jir, s, b))
        _, jy2 = stream(lambda s, b: jstep(s, jnp.asarray(b)), jss, x[:, head:], [97, 33])
        _, ty2 = stream(lambda s, b: tmono.process_any(tir, s, torch.from_numpy(b)), tss,
                        x[:, head:], [97, 33])
        assert snr_db(jy2, ty2) >= SNR_JAX_F64_DB, kind
        y = np.concatenate([ty1.numpy(), ty2], axis=-1)
        for c in range(2):
            assert snr_db(convolve_f64(x[c], ir[c], x.shape[-1]), y[c]) >= SNR_JAX_F64_DB


def test_jax_stream_state_continues_in_port(rng):
    """A JAX MonoStreamState after odd callbacks on the generic path: its
    rings hold pos != 0 (P = 3 at N = 32 and 128, P = 5 at 512). The port
    continues it through K9's route (plain version: the ring is
    slot-normalised before its first firing, pos then 0) and through the
    generic route; both equal the JAX stream and the convolution. The state
    round-trips through numpy."""
    jscheme = jmono.PartitionScheme((32, 128, 512), zero_latency=True)
    tscheme = tmono.PartitionScheme((32, 128, 512), zero_latency=True)
    ir = rng.standard_normal(1500).astype(np.float32)
    x = rng.standard_normal(2600).astype(np.float32)
    jir = jmono.prepare_ir(jscheme, ir, dtype=jnp.float32, offline_tail=False)
    jstep = jax.jit(lambda s, b: jmono.process_any(jir, s, b, backend="xla"))
    jst, jy1 = stream(lambda s, b: jstep(s, jnp.asarray(b)),
                      jmono.init_stream_state(jscheme, jir), x[:1100], [97, 33])
    assert [int(s.pos) for s in jst.sections] == [2, 2, 4]
    jst_end, jy2 = stream(lambda s, b: jstep(s, jnp.asarray(b)), jst, x[1100:], [61, 7])
    tir = tmono.MonoIR.from_numpy(jir, CPU)
    for backend in ("pallas", "xla"):
        tst = tmono.MonoStreamState.from_numpy(jst, CPU)
        assert [s.pos for s in tst.sections] == [int(s.pos) for s in jst.sections]
        tst = tmono.MonoStreamState.from_numpy(tst.numpy(), CPU)
        tst, ty2 = stream(lambda s, b: tmono.process_any(tir, s, torch.from_numpy(b),
                                                         backend=backend),
                          tst, x[1100:], [61, 7])
        assert snr_db(jy2, ty2) >= SNR_JAX_DB, backend
        if backend == "pallas":  # every section of this scheme is within K9's envelope
            assert all(s.pos == 0 for s in tst.sections)
    y = np.concatenate([np.asarray(jy1), ty2])
    assert snr_db(convolve_f64(x, ir, len(x)), y) >= SNR_F64_DB
