"""Port parity: offline scheme processing (models/mono.py process_offline,
section_taps_from_spectra, MonoConvolve's lazy offline tail) and the staged
offline engine's kernels (K15 lag_mac, which ``parallel`` runs; K10 -> K7 ->
K11 at N = 2048).

The same numpy inputs go through the JAX package and the port:

- K15 ``hopper_kernels.lag_mac`` (its plain version on the CPU) against the
  Pallas ``lag_mac`` in interpret mode, with ``lead_skip`` 0 and 1;
- ``mono.process_offline`` at the Zero preset with the offline tail (one
  uniform engine at N = 4096) and without it (head and the 256/1024
  sections as direct FIRs, the 4096/16384 sections through the offline
  engine), in float64 on the ``jnp.fft`` / ``torch.fft`` path, and in float32
  with ``backend="pallas"`` (the fused chain's plain versions in the port,
  the Pallas kernels in interpret mode in JAX);
- ``FastFIR`` at N = 2048, which is outside the fused chain: with
  ``backend="pallas", mac_backend="pallas"`` both packages take the staged
  path (small forward, the lag MAC, small inverse);
- the staged ``process_offline`` and ``FastFIR.apply`` on the CPU, bit for
  bit against the formula they had before they shared process_block's
  stages (``lag_mac_plain`` over zero-padded spectra).

Tolerances: >= 110 dB SNR in float32 (transforms and sums in another order),
>= 250 dB in float64, >= 100 dB against a float64 convolution in float32;
K15 atol 1e-4 (float32 sums of P products in another order, as
tests/test_pallas_mac.py uses). Oracles are float64 FFT convolutions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import pallas_fft, pallas_kernels  # noqa: E402
from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models import offline as joff  # noqa: E402
from hisstools_library_tpu.core.types import Split as JSplit  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import mono as tmono  # noqa: E402
from hisstools_library_tpu_torch.models import offline as toff  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_JAX_DB = 110.0
SNR_JAX_F64_DB = 250.0
SNR_F64_DB = 100.0
IR_LEN, SIG_LEN = 20_000, 30_000


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


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0x0FF)
    ir = rng.standard_normal((2, IR_LEN)) * np.exp(-np.arange(IR_LEN) / 6000.0)
    x = rng.standard_normal((2, SIG_LEN))
    return ir, x


JZERO = jmono.PartitionScheme.from_latency(jmono.LatencyMode.Zero)
TZERO = tmono.PartitionScheme.from_latency(tmono.LatencyMode.Zero)


@pytest.mark.parametrize("t,p,skip", [(5, 7, 0), (7, 3, 1), (1, 4, 1)])
def test_lag_mac_matches_pallas(rng, t, p, skip):
    """K15 over zero-padded spectra: P > T, P < T with an ignored leading
    row, T = 1; a DC-heavy bin 0 makes a packed-lane error visible."""
    c, k = 2, 256
    xr, xi = rng.standard_normal((2, c, skip + t + p, k)).astype(np.float32)
    hr, hi = rng.standard_normal((2, c, p, k)).astype(np.float32)
    xr[..., 0] += 8.0
    hr[..., 0] += 8.0
    jr, ji = pallas_kernels.lag_mac(*(jnp.asarray(a) for a in (xr, xi, hr, hi)), t,
                                    interpret=True, lead_skip=skip)
    tr, ti = hopper_kernels.lag_mac(*(torch.from_numpy(a) for a in (xr, xi, hr, hi)), t,
                                    lead_skip=skip)
    assert tr.shape == (c, t, k) and tr.dtype == torch.float32
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)


@pytest.mark.parametrize("tail", [True, False])
def test_process_offline_matches_jax_float64(signals, tail):
    """The Zero preset offline, with and without the offline tail: the port
    equals JAX and the convolution (the scheme has zero latency)."""
    ir, x = signals
    jir = jmono.prepare_ir(JZERO, ir, dtype=jnp.float64, offline_tail=tail)
    tir = tmono.prepare_ir(TZERO, ir, dtype=torch.float64, offline_tail=tail, device=CPU)
    assert (tir.tail is None) == (not tail) and tir.tail_shift == jir.tail_shift
    if tail:
        assert tuple(tir.tail.shape) == (2, 10, 2048)  # N = 4096 for 20 000 taps
    jy = jmono.process_offline(jir, jnp.asarray(x))
    ty = tmono.process_offline(tir, torch.from_numpy(x))
    assert ty.shape == (2, SIG_LEN) and ty.dtype == torch.float64
    assert snr_db(jy, ty) >= SNR_JAX_F64_DB
    for c in range(2):
        assert snr_db(convolve_f64(x[c], ir[c], SIG_LEN), ty[c]) >= SNR_JAX_F64_DB


@pytest.mark.parametrize("tail", [True, False])
def test_process_offline_pallas_float32(signals, highest, tail):
    """float32 with ``backend="pallas"``: the fused offline chain (K2 -> K3
    -> K4) and, without the tail, the direct sections' taps through the small
    inverse (K11) and the 4096/16384 sections through the chain."""
    ir, x = signals
    ir32, x32 = ir.astype(np.float32), x[:, :12000].astype(np.float32)
    jir = jmono.prepare_ir(JZERO, ir32, dtype=jnp.float32, backend="pallas",
                           offline_tail=tail)
    tir = tmono.prepare_ir(TZERO, ir32, backend="pallas", offline_tail=tail, device=CPU)
    jy = jmono.process_offline(jir, jnp.asarray(x32), backend="pallas")
    ty = tmono.process_offline(tir, torch.from_numpy(x32), backend="pallas")
    assert ty.dtype == torch.float32
    assert snr_db(jy, ty) >= SNR_JAX_DB
    for c in range(2):
        assert snr_db(convolve_f64(x32[c], ir32[c], x32.shape[-1]), ty[c]) >= SNR_F64_DB


def test_section_taps_and_direct_predicate_match_jax(signals):
    ir, _ = signals
    jir = jmono.prepare_ir(JZERO, ir, dtype=jnp.float64, offline_tail=False)
    tir = tmono.prepare_ir(TZERO, ir, dtype=torch.float64, offline_tail=False, device=CPU)
    for js, ts in zip(jir.spectra[:2], tir.spectra[:2]):
        want = jmono.section_taps_from_spectra(js)
        got = tmono.section_taps_from_spectra(ts)
        assert tuple(got.shape) == want.shape
        assert snr_db(want, got) >= SNR_JAX_F64_DB
    for n in (256, 1024, 2048, 4096):
        for p in (1, 3, 7, 58):
            assert tmono._direct_eligible(n, p) == jmono._direct_eligible(n, p)


def test_mono_convolve_lazy_offline_tail(signals):
    """``set`` with ``offline_tail=None`` builds no tail; the first
    process_offline attaches it (the section spectra are kept) and the result
    equals an IR prepared with the tail up front; ``False`` never builds one."""
    ir, x = signals
    xt = torch.from_numpy(x[:, :9000])
    conv = tmono.MonoConvolve(max_length=IR_LEN, scheme=TZERO)
    conv.set(ir, dtype=torch.float64, device=CPU)
    spectra = conv.ir.spectra
    assert conv.ir.tail is None
    y = conv.process_offline(xt)
    assert conv.ir.tail is not None and conv.ir.spectra is spectra
    eager = tmono.prepare_ir(TZERO, ir, dtype=torch.float64, offline_tail=True, device=CPU)
    assert torch.equal(conv.ir.tail.re, eager.tail.re)
    assert snr_db(tmono.process_offline(eager, xt), y) >= SNR_JAX_F64_DB
    never = tmono.MonoConvolve(max_length=IR_LEN, scheme=TZERO)
    never.set(ir, dtype=torch.float64, offline_tail=False, device=CPU)
    y2 = never.process_offline(xt)
    assert never.ir.tail is None
    assert snr_db(y, y2) >= SNR_JAX_F64_DB


def test_fastfir_staged_n2048_matches_jax(highest):
    """FastFIR at N = 2048 is outside the fused chain (N = 4096..2^17): with
    ``backend="pallas", mac_backend="pallas"`` both packages run the staged
    path, small forward -> lag MAC -> small inverse (the port's K10 -> K7 ->
    K11, here their plain versions)."""
    rng = np.random.default_rng(0x2048)
    ir = rng.standard_normal((2, 9000)).astype(np.float32)
    x = rng.standard_normal((2, 12000)).astype(np.float32)
    jeng = joff.FastFIR(ir, fft_size=2048, dtype=jnp.float32, backend="pallas")
    jy = joff.FastFIR.apply(jeng.spectra, jnp.asarray(x), backend="pallas",
                            mac_backend="pallas")
    eng = toff.FastFIR(ir, fft_size=2048, backend="pallas", device=CPU)
    assert eng.spectra.shape[-2] == 9  # P = ceil(9000 / 1024)
    before = hopper_kernels.lag_mac_ring.launches
    ty = eng(torch.from_numpy(x), mac_backend="pallas")
    assert hopper_kernels.lag_mac_ring.launches == before  # the CPU runs the plain version
    assert snr_db(jy, ty) >= SNR_JAX_DB
    assert snr_db(joff.FastFIR.apply(JSplit(jnp.asarray(eng.spectra.re.numpy()),
                                            jnp.asarray(eng.spectra.im.numpy())),
                                     jnp.asarray(x), backend="xla"), ty) >= SNR_JAX_DB
    for c in range(2):
        assert snr_db(convolve_f64(x[c], ir[c], 12000), ty[c]) >= SNR_F64_DB


def _staged_offline_formula(spectra, x):
    """The staged offline form as ``process_offline`` computed it over
    zero-padded spectra: frames, ``lag_mac_plain`` over min(P, T) lags
    behind zero rows, the scaled inverse's kept half."""
    from hisstools_library_tpu_torch.core.types import Split
    from hisstools_library_tpu_torch.fft import api as fft_api

    h = spectra.shape[-1]
    L = x.shape[-1]
    if L % h:
        x = torch.nn.functional.pad(x, (0, h - L % h))
    t = x.shape[-1] // h
    blocks = x.reshape(*x.shape[:-1], t, h)
    prev = torch.cat([torch.zeros_like(blocks[..., :1, :]), blocks[..., :-1, :]], dim=-2)
    X = Split(*fft_api.rfft(torch.cat([prev, blocks], dim=-1)))
    lags = min(spectra.shape[-2], t)
    pad = (0, 0, lags, 0)
    acc_re, acc_im = hopper_kernels.lag_mac_plain(
        torch.nn.functional.pad(X.re, pad), torch.nn.functional.pad(X.im, pad),
        spectra.re[..., :lags, :], spectra.im[..., :lags, :], t)
    y = fft_api.rifft(acc_re, acc_im) * (1.0 / (4.0 * (2 * h)))
    out = y[..., h:]
    return out.reshape(*out.shape[:-2], t * h)[..., :L]


@pytest.mark.parametrize("mac_backend", ["auto", "xla"])
@pytest.mark.parametrize("length,dtype", [
    (3000, torch.float32),     # T = 3 < P = 9, a partial last hop
    (12000, torch.float32),    # T > P
    (9216, torch.float64),     # T = P, whole hops
])
def test_staged_offline_bit_equal_on_cpu(length, dtype, mac_backend):
    """``process_offline``'s staged form (a zero ring through process_block's
    stages) and ``FastFIR.apply``'s (the same with the one-hop look-ahead)
    are bit for bit the zero-padded formula at N = 2048, P = 9."""
    from hisstools_library_tpu_torch.models.partitioned import PartitionedConvolve

    rng = np.random.default_rng(length)
    ir = rng.standard_normal((2, 9000))
    eng = toff.FastFIR(ir, fft_size=2048, dtype=dtype, device=CPU)
    assert eng.spectra.shape[-2] == 9
    x = torch.from_numpy(rng.standard_normal((2, length))).to(dtype)
    y = PartitionedConvolve.process_offline(eng.spectra, x, mac_backend=mac_backend)
    assert torch.equal(y, _staged_offline_formula(eng.spectra, x))
    y = toff.FastFIR.apply(eng.spectra, x, mac_backend=mac_backend)
    want = _staged_offline_formula(eng.spectra, torch.nn.functional.pad(x, (0, 1024)))
    assert torch.equal(y, want[..., 1024:1024 + length])
