"""The ring MAC (``csrc/ring_mac.cu``) on the CPU: its plan mirror and a
float64 numpy model of its item schedule.

One kernel serves K7 ``lag_mac_ring``, K15 ``lag_mac`` and K8's state kernel
(``hopper_fft.stream_state``). No CUDA runs here, so the tests hold the
Python mirror of the plan (``hopper_kernels._ring_mac_plan``) to the
kernel's constants and rules, and replay the kernel block by block in numpy:
the producer warp's bulk copies (which V row each item fetches from which
source, at which element offset, into which stage run, and the bytes each
stage's barrier expects), the consumers' chunks with the sliding window and
the bin-0 lane, the new ring's slot writes, the chunk split above 16 hops,
the narrow tiles below K = 256 and K15's ``lead_skip``.
Tolerances: the model against the plain versions (float64) >= 250 dB, and
the new ring exactly; the model (float32 inputs, float64 sums) against the
TPU package's Pallas kernels in interpret mode >= 110 dB (their float32 sums
in another order); index maps, byte counts and schedules are exact.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.fft import pallas_kernels  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_kernels as hk  # noqa: E402

SRC = Path(hk.__file__).resolve().parents[1] / "csrc" / "ring_mac.cu"
SNR_F64_DB = 250.0
SNR_JAX_DB = 110.0
STATIC_SHARED_MAX = 48 * 1024  # a block's static shared memory
ROWS = hk.RING_MAC_ROWS        # rows of V a row item carries


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


# -----------------------------------------------------------------------------
# The plan mirror

def test_plan_constants_match_the_kernel():
    """hopper_kernels' RING_MAC_* constants are ring_mac.cu's, and
    launch_ring_mac instantiates every chunk length the plan can choose."""
    text = SRC.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(const["kBins"]) == hk.RING_MAC_BINS == 256
    assert const["kThreads"] == "kBins + 32" and hk.RING_MAC_THREADS == 256 + 32
    # the launch: C * K / B blocks of 32 * ceil(B / 32) consumers and the producer warp
    assert "const unsigned grid = (unsigned)(a.channels * (a.k / bins));" in text
    assert "const int threads = (bins + 31) / 32 * 32 + 32;" in text
    assert int(const["kStages"]) == hk.RING_MAC_STAGES
    assert int(const["kMaxHops"]) == hk.RING_MAC_MAX_HOPS
    assert int(const["kMinBins"]) == hk.RING_MAC_MIN_BINS
    assert int(const["kRows"]) == hk.RING_MAC_ROWS
    tus = {int(v) for v in re.findall(r"ring_mac<(\d+)><<<", text)}
    assert tus == {1 << e for e in range(hk.RING_MAC_MAX_HOPS.bit_length())}


def test_matrix_plan_constants_match_the_kernel():
    """The RING_MAC_MATRIX_* constants are ring_mac_matrix's, the launch
    instantiates every chunk length the plan can choose, and the per-channel
    kernel ring_mac is launched by its own entries only."""
    text = SRC.read_text()
    const = dict(re.findall(r"constexpr int (kMx\w+) = ([^;]+);", text))
    assert int(const["kMxBins"]) == hk.RING_MAC_MATRIX_BINS == 128
    assert int(const["kMxGroup"]) == hk.RING_MAC_MATRIX_GROUP == 5
    assert int(const["kMxStages"]) == hk.RING_MAC_MATRIX_STAGES == 5
    assert int(const["kMxHops"]) == hk.RING_MAC_MATRIX_HOPS == 8
    assert const["kMxPlanes"] == "2 * kMxGroup + 2"
    assert "const unsigned grid = (unsigned)(groups * (a.k / kMxBins));" in text
    assert "ring_mac_matrix<TU><<<grid, kMxBins + 32, bytes, st>>>(a, inputs);" in text
    tus = {int(v) for v in re.findall(r"return launch_matrix<(\d+)>", text)}
    assert tus == {1 << e for e in range(hk.RING_MAC_MATRIX_HOPS.bit_length())}


@pytest.mark.parametrize("m,n,t,p,k", [(25, 25, 8, 17, 8192), (4, 3, 1, 3, 8192),
                                       (3, 4, 17, 2, 65536), (1, 1, 5, 1, 128)])
def test_matrix_plan(m, n, t, p, k):
    """Groups of five outputs cover every output once, tiles of 128 bins
    every bin; chunks of the least power of two >= min(T, 8) hops; a row
    item carries up to six rows; the shared memory fits three blocks an SM
    (227 KB) at every chunk length."""
    plan = hk._ring_mac_matrix_plan(m, n, t, p, k)
    assert plan.groups * 5 >= m > (plan.groups - 1) * 5
    assert plan.tiles == plan.groups * k // 128 and plan.threads == 160
    tu = plan.hops_per_chunk
    assert tu & (tu - 1) == 0 and min(t, 8) <= tu <= 8 and tu < 2 * min(t, 8)
    assert plan.chunks == -(-t // tu) and plan.rows_per_item == 6
    assert plan.items == n * sum(-(-min(tu, t - t0) // 6) + p for t0 in range(0, t, tu))
    assert 3 * (plan.shared_bytes + 1024) <= 228 * 1024
    for bad in ((m, n, t, p, k + 64), (0, n, t, p, k), (m, n, 0, p, k), (m, n, t, 0, k)):
        with pytest.raises(ValueError):
            hk._ring_mac_matrix_plan(*bad)


@pytest.mark.parametrize("t", [1, 2, 4, 15, 16, 17, 40, 48])
@pytest.mark.parametrize("k", [16, 32, 64, 128, 256, 768, 1024, 1 << 15])
def test_ring_mac_plan(k, t):
    """Tiles of min(K, 256) bins of one channel cover every (channel, bin)
    once, a consumer thread a bin in whole warps and a producer warp; chunks
    of the least power of two >= min(T, 16) hops; the rows two an item and P
    pairs a chunk; bulk copies of 64-byte multiples; the stages and their
    two mbarriers each in static shared memory."""
    for c in (1, 5, 19, 128):
        for p in (1, 3, 14, 47, 58):
            plan = hk._ring_mac_plan(c, t, p, k)
            bins = plan.bins_per_tile
            assert bins == min(k, 256) and plan.tiles_per_channel * bins == k
            assert plan.tiles == c * plan.tiles_per_channel
            assert (4 * bins) % 64 == 0
            tu = plan.hops_per_chunk
            assert tu & (tu - 1) == 0 and min(t, 16) <= tu <= 16 and tu < 2 * min(t, 16)
            assert plan.chunks == -(-t // tu)
            assert plan.items == sum(-(-min(tu, t - t0) // ROWS)
                                     for t0 in range(0, t, tu)) + plan.chunks * p
            assert plan.stages == 8 and plan.threads == 32 * -(-bins // 32) + 32 <= 288
            assert plan.shared_bytes == 8 * (4 * 256 * 4 + 2 * 8) <= STATIC_SHARED_MAX


@pytest.mark.parametrize("c,t,p,k", [(2, 3, 4, 8), (2, 3, 4, 24), (2, 3, 4, 48), (2, 3, 4, 100),
                                     (2, 3, 4, 384), (2, 0, 4, 256), (2, 3, 0, 256),
                                     (0, 3, 4, 256)])
def test_ring_mac_plan_refuses_other_shapes(c, t, p, k):
    assert not hk.ring_mac_served(k) or min(c, t, p) < 1
    with pytest.raises(ValueError):
        hk._ring_mac_plan(c, t, p, k)


def test_served_sizes():
    """K = 16..128 as powers of two (the sections of N = 32..256) and every
    multiple of 256; nothing else."""
    served = [k for k in range(1, 4097) if hk.ring_mac_served(k)]
    assert served == [16, 32, 64, 128] + list(range(256, 4097, 256))


# -----------------------------------------------------------------------------
# The kernel in numpy: one block at a time, as its threads run it

def Operands(c, t, p, k, s, s_off, s_cs, s_rows, x, x_off, x_cs, h, h_off, h_cs,
             l0=None, l0_cs=0, ring_out=False):
    """The kernel's RingMac struct over flat complex planes: V rows u <
    s_rows from s at element offset s_off, channels s_cs apart, the rest
    from x at x_off, channels x_cs apart; H at h_off, channels h_cs apart;
    optional L0 (channels l0_cs apart); rows k apart everywhere."""
    return SimpleNamespace(**locals())


def _block(a, plan, block, y, ring, writes, log):
    """Runs block ``block`` (tile ``block``: bins b0 .. b0 + B - 1 of one
    channel): the producer's copies into the stages (item g in stage g mod
    8), each consumer item read from the stage it was copied into after its
    copy, and the consumers' MAC, window and stores. Adds Y rows and new
    ring slots to ``y`` / ``ring`` (flat complex), counts ring writes, and
    logs every copy's (plane source, element offset, floats)."""
    t, p, k = a.t, a.p, a.k
    bins, tu = plan.bins_per_tile, plan.hops_per_chunk
    c, tb = divmod(block, plan.tiles_per_channel)
    b0 = tb * bins
    per_chunk = -(-tu // ROWS) + p
    stages = np.full((plan.stages, 4, 256), np.nan)
    held = [None] * plan.stages

    def vrow(ur, slot):
        # V row ur of channel c from its source into planes slot, slot + 1
        first = ur < a.s_rows
        vo = (a.s_off + c * a.s_cs + ur * k + b0 if first
              else a.x_off + c * a.x_cs + (ur - a.s_rows) * k + b0)
        vsrc, tag = (a.s, "s") if first else (a.x, "x")
        return [(vsrc.real, vo, slot, tag), (vsrc.imag, vo, slot + 1, tag)]

    def issue(g):
        # The producer's item g: the bytes the full barrier expects, the copies.
        s = g % plan.stages
        assert held[s] is None           # its last item was read (the empty barrier)
        ci, j = divmod(g, per_chunk)
        t0 = ci * tu
        tc = min(tu, t - t0)
        nx = -(-tc // ROWS)                  # the chunk's row items
        row = j < nx
        rows = min(ROWS, tc - j * ROWS) if row else 1
        q = j - nx
        u = p + t0 + j * ROWS if row else p + t0 - 1 - q
        ho = a.h_off + c * a.h_cs + q * k + b0
        copies = (sum((vrow(u + r, 2 * r) for r in range(rows)), []) if row else
                  [(a.h.real, ho, 0, "h"), (a.h.imag, ho, 1, "h")] + vrow(u, 2))
        landed = 0
        for plane, off, slot, src in copies:
            assert off % 4 == 0                  # 16-byte source addresses
            stages[s, slot, :bins] = plane[off:off + bins]
            landed += bins * 4
            log.append((src, off, bins))
        assert landed == (2 * rows if row else 4) * bins * 4   # the transaction count
        held[s] = g

    for g in range(min(plan.stages, plan.items)):
        issue(g)
    g = 0

    def take(pair):
        nonlocal g
        s = g % plan.stages
        assert held[s] == g             # the stage holds item g: its copy landed
        u = stages[s, 0, :bins] + 1j * stages[s, 1, :bins]
        v = stages[s, 2, :bins] + 1j * stages[s, 3, :bins] if pair else None
        held[s] = None                  # every consumer warp arrived on the empty barrier
        if g + plan.stages < plan.items:
            issue(g + plan.stages)
        g += 1
        return u, v

    binv = b0 + np.arange(bins)
    lane0 = binv == 0
    l0 = np.zeros(bins, complex) if a.l0 is None else a.l0[c * a.l0_cs + binv]

    def mac(vv, hh):
        return np.where(lane0, vv.real * hh.real + 1j * vv.imag * hh.imag, vv * hh)

    rc = c * p * k + binv
    yc = c * t * k + binv
    for ci in range(plan.chunks):
        t0 = ci * tu
        tc = min(tu, t - t0)
        win = [np.zeros(bins, complex) for _ in range(tu)]
        acc = [np.zeros(bins, complex) for _ in range(tu)]
        for i0 in range(0, tc, ROWS):
            pair = take(ROWS > 1 and i0 + 1 < tc)
            for i in range(i0, min(i0 + ROWS, tc)):
                x = pair[i - i0]
                win[i] = x
                acc[i] = mac(x, l0)
                slot = t0 + i - t + p
                if a.ring_out and slot >= 0:
                    ring[rc + slot * k] = x
                    np.add.at(writes, rc + slot * k, 1)
        for q in range(p):
            qq = q % tu
            h, v = take(True)
            win[tu - 1 - qq] = v
            for i in range(tu):
                acc[i] = acc[i] + mac(win[(i - 1 - qq + tu) % tu], h)
            slot = p - 1 - q - t
            if a.ring_out and ci == 0 and slot >= 0:
                ring[rc + slot * k] = v
                np.add.at(writes, rc + slot * k, 1)
        for i in range(tc):
            y[yc + (t0 + i) * k] = acc[i]
    assert g == plan.items and all(s is None for s in held)


def _run(a):
    """The whole launch, one block a tile. Returns Y (C, T, K), the new ring
    (C, P, K) or None, and the copy log."""
    plan = hk._ring_mac_plan(a.c, a.t, a.p, a.k)
    y = np.full(a.c * a.t * a.k, np.nan + 0j)
    ring = np.full(a.c * a.p * a.k, np.nan + 0j)
    writes = np.zeros(a.c * a.p * a.k, int)
    log = []
    for block in range(plan.tiles):
        _block(a, plan, block, y, ring, writes, log)
    assert not np.isnan(y).any()
    if not a.ring_out:
        return y.reshape(a.c, a.t, a.k), None, log
    assert (writes == 1).all()
    return y.reshape(a.c, a.t, a.k), ring.reshape(a.c, a.p, a.k), log


def _ri(z):
    return np.stack([np.real(z), np.imag(z)])


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _h(rng, c, p, k, layout):
    """H as the wrappers pass it: a row slice of a (C, P + 2, K) tensor
    (channels (P + 2) K apart, from row 1) or one plane broadcast over the
    channels (stride 0). Returns (the (C, P, K) view's values, flat planes,
    offset, channel stride)."""
    if layout == "slice":
        full = _cplx(rng, c, p + 2, k)
        return full[:, 1:p + 1], full.reshape(-1), k, (p + 2) * k
    one = _cplx(rng, p, k)
    return np.broadcast_to(one, (c, p, k)), one.reshape(-1), 0, 0


def _planes(z):
    z = np.ascontiguousarray(z)
    return torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())


def _k7(rng, c, t, p, k, layout):
    hist, x = _cplx(rng, c, p, k), _cplx(rng, c, t, k)
    hv, hf, h_off, h_cs = _h(rng, c, p, k, layout)
    a = Operands(c, t, p, k, hist.reshape(-1), 0, p * k, p, x.reshape(-1), 0, t * k,
                 hf, h_off, h_cs, ring_out=True)
    return a, hist, x, hv


def _k15(rng, c, skip, t, p, k, layout):
    tp = skip + t + p
    xpad = _cplx(rng, c, tp, k)
    hv, hf, h_off, h_cs = _h(rng, c, p, k, layout)
    flat = xpad.reshape(-1)
    a = Operands(c, t, p, k, flat, skip * k, tp * k, tp - skip, flat, 0, tp * k,
                 hf, h_off, h_cs)
    return a, xpad, hv


K_MODEL = [16, 32, 256, 1024]
TP_ALL = [(t, p) for t in (1, 4, 40) for p in (1, 3, 17)]
TP_RING = [(t, p) for t, p in TP_ALL if t <= p]


@pytest.mark.parametrize("layout", ["slice", "broadcast"])
@pytest.mark.parametrize("t,p", TP_RING)
@pytest.mark.parametrize("k", K_MODEL)
def test_k7_model_matches_plain(k, t, p, layout):
    """K7's operands (V = [hist | X], two sources; the new ring written)
    through the model equal lag_mac_ring_plain in float64: Y >= 250 dB,
    bin 0 as two real products, the new ring exactly, each slot once."""
    rng = np.random.default_rng(k * 1000 + t * 31 + p)
    c = 3
    a, hist, x, hv = _k7(rng, c, t, p, k, layout)
    y, ring, _ = _run(a)
    want = hk.lag_mac_ring_plain(*_planes(hist), *_planes(x), *_planes(hv))
    wy = want[0].numpy() + 1j * want[1].numpy()
    assert snr_db(_ri(wy), _ri(y)) >= SNR_F64_DB
    assert snr_db(_ri(wy[..., 0]), _ri(y[..., 0])) >= SNR_F64_DB
    assert np.array_equal(ring, want[2].numpy() + 1j * want[3].numpy())


@pytest.mark.parametrize("layout,skip", [("slice", 1), ("broadcast", 0)])
@pytest.mark.parametrize("t,p", TP_ALL)
@pytest.mark.parametrize("k", K_MODEL)
def test_k15_model_matches_plain(k, t, p, layout, skip):
    """K15's operands (V = xpad[S:], one source at an offset of S rows; no
    ring out) through the model equal lag_mac_plain in float64."""
    rng = np.random.default_rng(k * 1000 + t * 31 + p + skip)
    c = 3
    a, xpad, hv = _k15(rng, c, skip, t, p, k, layout)
    y, ring, log = _run(a)
    assert ring is None and all(src in ("s", "h") for src, _, _ in log)
    want = hk.lag_mac_plain(*_planes(xpad), *_planes(hv), t, lead_skip=skip)
    wy = want[0].numpy() + 1j * want[1].numpy()
    assert snr_db(_ri(wy), _ri(y)) >= SNR_F64_DB
    # no copy reads a row before lead_skip
    assert min(off % ((skip + t + p) * k) for src, off, _ in log if src == "s") >= skip * k


@pytest.mark.parametrize("t,p", TP_ALL)
@pytest.mark.parametrize("k", [16, 256])
def test_state_model_matches_plain(k, t, p):
    """K8's state kernel (K7's operands, any T, the lag-0 term from a
    channel-broadcast L0) through the model equals stream_state_plain."""
    rng = np.random.default_rng(k * 7 + t * 3 + p)
    c = 3
    a, ring, x, hv = _k7(rng, c, t, p, k, "broadcast")
    l0 = _cplx(rng, k)
    a.l0, a.l0_cs = l0, 0
    y, new, _ = _run(a)
    want = hopper_fft.stream_state_plain(
        *_planes(x), *_planes(ring), *_planes(hv),
        *(v[None].expand(c, k) for v in _planes(l0)))
    wy = want[0].numpy() + 1j * want[1].numpy()
    assert snr_db(_ri(wy), _ri(y)) >= SNR_F64_DB
    assert np.array_equal(new, want[2].numpy() + 1j * want[3].numpy())


def _matrix_run(m, n, t, p, k, ring, x, h, l0):
    """ring_mac_matrix in numpy, block by block as its threads run it:
    the producer's items (for each chunk and input, row items of up to six
    V rows, then P items of the group's H rows and one V row), each copied
    into stage g mod 5 and taken from there, the bytes each full barrier
    expects; the consumers' accumulators summed apart for each input, then
    into the total; the new rings stored by the first group's blocks. Returns
    Y (M, T, K), the new rings (N, P, K) and each ring slot's write count."""
    plan = hk._ring_mac_matrix_plan(m, n, t, p, k)
    group, bins, rows_per = hk.RING_MAC_MATRIX_GROUP, hk.RING_MAC_MATRIX_BINS, plan.rows_per_item
    tu, stages = plan.hops_per_chunk, hk.RING_MAC_MATRIX_STAGES
    v = np.concatenate([ring, x], axis=1)                # V_n = [ring_n | X_n]
    y = np.full((m, t, k), np.nan + 0j)
    new = np.full((n, p, k), np.nan + 0j)
    writes = np.zeros((n, p, k), int)
    for block in range(plan.tiles):
        tb, gi = divmod(block, plan.groups)
        m0, b0 = gi * group, tb * bins
        gn = min(group, m - m0)
        cols = slice(b0, b0 + bins)
        lane0 = (b0 + np.arange(bins)) == 0
        items = []                                       # (planes, the bytes expected)
        for ci in range(plan.chunks):
            t0 = ci * tu
            tc = min(tu, t - t0)
            for nn in range(n):
                for j0 in range(0, tc, rows_per):
                    rows = min(rows_per, tc - j0)
                    items.append(({2 * r: v[nn, p + t0 + j0 + r, cols] for r in range(rows)},
                                  2 * rows * bins * 4))
                for q in range(p):
                    planes = {2 * o: h[m0 + o, nn, q, cols] for o in range(gn)}
                    planes[2 * group] = v[nn, p + t0 - 1 - q, cols]
                    items.append((planes, 2 * (gn + 1) * bins * 4))
        assert len(items) == plan.items
        assert all(b == 8 * bins * len(pl) for pl, b in items)   # re and im a plane pair
        g = 0

        def mac(vv, hh):
            return np.where(lane0, vv.real * hh.real + 1j * vv.imag * hh.imag, vv * hh)

        for ci in range(plan.chunks):
            t0 = ci * tu
            tc = min(tu, t - t0)
            total = np.zeros((group, tu, bins), complex)
            for nn in range(n):
                acc = np.zeros((group, tu, bins), complex)
                win = [np.zeros(bins, complex) for _ in range(tu)]
                for j0 in range(0, tc, rows_per):
                    stage = items[g][0]
                    g += 1
                    for r in range(min(rows_per, tc - j0)):
                        j = j0 + r
                        xv = stage[2 * r]
                        win[j] = xv
                        for o in range(gn):
                            acc[o, j] += mac(xv, l0[m0 + o, nn, cols])
                        slot = t0 + j - t + p
                        if gi == 0 and slot >= 0:
                            new[nn, slot, cols] = xv
                            writes[nn, slot, cols] += 1
                for q in range(p):
                    stage = items[g][0]
                    g += 1
                    qq = q % tu
                    vv = stage[2 * group]
                    win[tu - 1 - qq] = vv
                    for o in range(gn):
                        for i in range(tu):
                            acc[o, i] += mac(win[(i - 1 - qq + tu) % tu], stage[2 * o])
                    slot = p - 1 - q - t
                    if gi == 0 and ci == 0 and slot >= 0:
                        new[nn, slot, cols] = vv
                        writes[nn, slot, cols] += 1
                total += acc
            for o in range(gn):
                y[m0 + o, t0:t0 + tc, cols] = total[o, :tc]
        assert g == plan.items
    return y, new, writes


@pytest.mark.parametrize("m,n,t,p", [(4, 3, 1, 3), (3, 4, 3, 1), (7, 2, 8, 4), (2, 3, 11, 2),
                                     (6, 1, 2, 9)])
def test_matrix_model_matches_plain(m, n, t, p):
    """The matrix form (blocks tile-major, group-minor; V from each input's
    ring and spectra; H and L0 of the pair) through the model equals
    stream_state_matrix_plain in float64: Y >= 250 dB, bin 0 as two real
    products, the new rings exactly and each slot once; partial groups (M
    not a multiple of five) and chunks above eight hops included."""
    k = 256
    rng = np.random.default_rng(m * 1000 + n * 100 + t * 10 + p)
    ring, x = _cplx(rng, n, p, k), _cplx(rng, n, t, k)
    h, l0 = _cplx(rng, m, n, p, k), _cplx(rng, m, n, k)
    y, new, writes = _matrix_run(m, n, t, p, k, ring, x, h, l0)
    want = hopper_fft.stream_state_matrix_plain(*_planes(x), *_planes(ring), *_planes(h),
                                                *_planes(l0))
    wy = want[0].numpy() + 1j * want[1].numpy()
    assert snr_db(_ri(wy), _ri(y)) >= SNR_F64_DB
    assert snr_db(_ri(wy[..., 0]), _ri(y[..., 0])) >= SNR_F64_DB
    assert (writes == 1).all()
    assert np.array_equal(new, want[2].numpy() + 1j * want[3].numpy())


@pytest.mark.parametrize("c,t,p,k,kind", [(3, 4, 14, 256, "k7"), (19, 16, 58, 16, "k7"),
                                          (3, 40, 17, 1024, "k7"), (2, 48, 47, 256, "k15"),
                                          (11, 17, 3, 32, "state")])
def test_model_moves_the_design_bytes(c, t, p, k, kind):
    """The bytes the model's copies read and its stores write are
    hopper_kernels._ring_mac_design_bytes: every operand once while T <= 16,
    and H and P rows of V again for each further chunk."""
    rng = np.random.default_rng(c + t + p + k)
    if kind == "k15":
        a, _, _ = _k15(rng, c, 1, t, p, k, "slice")
    else:
        a, _, _, _ = _k7(rng, c, t, p, k, "slice")
        if kind == "state":
            a.l0, a.l0_cs = _cplx(rng, c * k), k
    _, _, log = _run(a)
    read = sum(8 * n for _, _, n in log) // 2           # re and im logged apart
    moved = read + 8 * c * t * k + (8 * c * p * k if a.ring_out else 0)
    moved += 8 * c * k if a.l0 is not None else 0
    assert moved == hk._ring_mac_design_bytes(c, t, p, k, a.ring_out, a.l0 is not None)
    if t <= 16:                                           # every source row once
        offs = [(src, off) for src, off, _ in log]
        assert len(set(offs)) == len(offs) // 2


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,p", [(1, 1), (1, 3), (4, 17)])
@pytest.mark.parametrize("k", [256, 1024])
def test_k7_model_matches_pallas(k, t, p):
    """The model on float32 inputs against the TPU package's lag_mac_ring in
    interpret mode (its tiles are multiples of 128 bins, T <= P)."""
    rng = np.random.default_rng(k + 10 * t + p)
    c = 3
    hist = [_f32(rng, c, p, k) for _ in range(2)]
    x = [_f32(rng, c, t, k) for _ in range(2)]
    h = [_f32(rng, c, p, k) for _ in range(2)]
    cz = [np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
          for re, im in (hist, x, h)]
    a = Operands(c, t, p, k, cz[0].reshape(-1), 0, p * k, p, cz[1].reshape(-1), 0, t * k,
                 cz[2].reshape(-1), 0, p * k, ring_out=True)
    y, ring, _ = _run(a)
    want = pallas_kernels.lag_mac_ring(*map(jnp.asarray, hist + x + h), interpret=True)
    assert snr_db(want[0], y.real) >= SNR_JAX_DB and snr_db(want[1], y.imag) >= SNR_JAX_DB
    assert snr_db(np.asarray(want[0])[..., 0], y.real[..., 0]) >= SNR_JAX_DB
    assert snr_db(np.asarray(want[1])[..., 0], y.imag[..., 0]) >= SNR_JAX_DB
    assert np.array_equal(want[2], ring.real) and np.array_equal(want[3], ring.imag)


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("t,p", [(1, 1), (4, 3), (40, 17)])
@pytest.mark.parametrize("k", [256, 1024])
def test_k15_model_matches_pallas(k, t, p, skip):
    """The model on float32 inputs against the TPU package's lag_mac in
    interpret mode, with and without lead_skip."""
    rng = np.random.default_rng(k + 10 * t + p + 100 * skip)
    c, tp = 2, skip + t + p
    xpad = [_f32(rng, c, tp, k) for _ in range(2)]
    h = [_f32(rng, c, p, k) for _ in range(2)]
    xz = (xpad[0].astype(np.float64) + 1j * xpad[1]).reshape(-1)
    hz = (h[0].astype(np.float64) + 1j * h[1]).reshape(-1)
    a = Operands(c, t, p, k, xz, skip * k, tp * k, tp - skip, xz, 0, tp * k, hz, 0, p * k)
    y, _, _ = _run(a)
    want = pallas_kernels.lag_mac(*map(jnp.asarray, xpad + h), t, interpret=True,
                                  lead_skip=skip)
    assert snr_db(want[0], y.real) >= SNR_JAX_DB and snr_db(want[1], y.imag) >= SNR_JAX_DB
