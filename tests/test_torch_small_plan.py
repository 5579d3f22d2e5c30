"""The small real FFTs K10 / K10w (csrc/rfft_small.cu) and the small
inverses K11 / K11w (csrc/rifft_small.cu), both on csrc/reg_fft.cuh,
checked on the CPU.

Two things are held here, in float64 and at small sizes, before any card
time: the Python mirror of the kernels' plan (``hopper_fft._small_plan``),
and a numpy model written to follow the kernel step by step:

* the grid: block b takes rounds [b*R/G, (b+1)*R/G) of F frames each, and
  frame f of a round is row round*F + f (rows past the batch load zeros and
  store nothing);
* the loader: frame (b, t) at base + b*outer_stride + t*row_stride, thread
  tf of a frame loading the points tf + T*m (m < 16) and, for K10w, the
  window values 2(tf + T*m) and 2(tf + T*m) + 1;
* the Stockham stages: DFT q of a radix-r stage on the thread's registers
  q + (16/r)*k, point k times W_N^((j mod Ns) k N/(Ns r)) from the staged
  half table (W_N^(e+M) = -W_N^e), the register DFT (bit reversal, then
  radix-2 passes with the constant twiddles W_16^(j * (8 >> s))), output k
  stored at (j / Ns) Ns r + (j mod Ns) + k Ns in the padded frame;
* the split step: bins k and M-k from the natural-order spectrum, k <= M/2;
* K11 / K11w: the loader (thread tf loading the packed bins tf + T*m, each
  once, and taking bin M - k from thread T - tf, slot 15 - m, or from thread
  0, slot 16 - m), the unpack of the conjugated input, the same stages, and
  the store of the conjugated (even, odd) pairs times scale * w.

K9 hop_fire (csrc/hop_fire.cu) runs both transforms on the same core, so
its plan mirror (``hopper_kernels._fire_plan``) and a float64 model of the
fused firing are held here too: the lane chunks of the old ring's lag sum
(helper warp h taking every H-th lag through a ring of cp.async stages,
ring' rows 0..P-2 stored from the chunks), the padded rows that hand the
helpers' sums and H[0] to warp 0's lanes, Y = E * H[0] + the sums, the
unpack's partner map and the store of the kept half.

The forward model matches ``np.fft.rfft`` in the packed layout, the inverse
one ``np.fft.irfft`` (2N x, and scale * ... * w), to 1e-12 relative to the
largest output; the kernels themselves are held against their plain
versions on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_kernels as hk  # noqa: E402

TOL = 1e-12
SIZES = [1 << k for k in range(5, 12)]   # N = 32..2048
R = hopper_fft.SMALL_POINTS


@pytest.mark.parametrize("n", SIZES)
def test_small_plan_every_size(n):
    """Radices multiply to M, at most two exchanges up to M = 512, a frame
    in one warp up to M = 512 and two at 1024, 256 threads a block, shared
    memory inside the 48 KB of a static allocation (and the 227 KB of a
    block)."""
    m = n // 2
    p = hopper_fft._small_plan(n)
    assert int(np.prod(p.radices)) == m
    assert all(r in (2, 4, 8, 16) for r in p.radices) and p.radices[0] == 16
    assert p.threads_per_frame * R == m
    assert p.frames_per_block * p.threads_per_frame == hopper_fft.SMALL_THREADS
    assert p.warps_per_frame == (1 if m <= 512 else 2)
    if m <= 512:
        assert len(p.radices) - 1 <= 2
    assert p.shared_bytes == 8 * (p.frames_per_block * (m + m // 16) + m)
    assert p.shared_bytes <= 48 * 1024 <= 227 * 1024


@pytest.mark.parametrize("n", [16, 3 << 6, 4096])
def test_small_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="32..2048"):
        hopper_fft._small_plan(n)


# -----------------------------------------------------------------------------
# The numpy model of the kernel


def _w(n, e):
    return np.exp(-2j * np.pi * np.asarray(e) / n)


def _brev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _pad(i):
    return i + (i >> 4)


def _dft_reg(a):
    """dft<R>: bit reversal, then radix-2 DIT passes, W_16^(j * (8 >> s))."""
    r = a.shape[-1]
    lg = r.bit_length() - 1
    a = a[..., [_brev(i, lg) for i in range(r)]].copy()
    for s in range(lg):
        h = 1 << s
        for b in range(r // 2):
            j = b & (h - 1)
            i0 = ((b >> s) << (s + 1)) + j
            u = a[..., i0].copy()
            t = a[..., i0 + h] * _w(16, (j * (8 >> s)) % 16)
            a[..., i0] = u + t
            a[..., i0 + h] = u - t
    return a


def _stages(v, n):
    """hst_reg::Stages on the frames' registers ``v`` (frames, T, 16): the
    Stockham stages through the padded frame slots, each stage storing every
    slot of the frame once. Returns the slots (frames, M + M/16), the
    spectrum in natural order at _pad(k)."""
    p = hopper_fft._small_plan(n)
    m, T = n // 2, p.threads_per_frame
    stw = _w(n, np.arange(m))                          # staged W_N^e, e < M

    def tw_n(e):
        return np.where(e < m, stw[np.minimum(e, m - 1)], -stw[np.maximum(e - m, 0)])

    tf = np.arange(T)
    idx = tf[:, None] + T * np.arange(R)[None, :]      # (T, 16): tf + T*m
    v = v.copy()
    fb = np.full((v.shape[0], m + m // 16), np.nan, complex)
    for s, r in enumerate(p.radices):
        ns, qn = 16 ** s, R // r
        shift = (m.bit_length()) - (ns * r).bit_length() + 1
        fb[:] = np.nan
        for q in range(qn):
            j = tf + q * T
            jm = j & (ns - 1)
            cols = q + qn * np.arange(r)
            a = v[:, :, cols]
            if s > 0:
                a = a * tw_n((jm[:, None] * np.arange(r)[None, :]) << shift)
            a = _dft_reg(a)
            v[:, :, cols] = a
            o = (j // ns) * ns * r + jm
            slots = _pad(o[:, None] + ns * np.arange(r)[None, :])   # (T, r)
            assert np.isnan(fb[:, slots]).all()  # no slot stored twice
            fb[:, slots] = a
        assert not np.isnan(fb[:, _pad(np.arange(m))]).any()
        v = fb[:, _pad(idx)]
    return fb


def _kernel_model(x, base0, outer, row_stride, t, w, batch, n, grid):
    """K10w as the kernel computes it on the flat float64 signal ``x``; K10
    is outer = n, row_stride = 0, t = 1 and w = 1. Returns (re, im) and
    checks that every row is stored once and every stage fills its frame."""
    p = hopper_fft._small_plan(n)
    m, T, F = n // 2, p.threads_per_frame, p.frames_per_block
    stw = _w(n, np.arange(m))                          # staged W_N^e, e < M
    re = np.full((batch, m), np.nan)
    im = np.full((batch, m), np.nan)
    stored = np.zeros(batch, int)
    tf = np.arange(T)
    idx = tf[:, None] + T * np.arange(R)[None, :]      # (T, 16): tf + T*m
    rounds = -(-batch // F)
    for blk in range(grid):
        for rd in range(blk * rounds // grid, (blk + 1) * rounds // grid):
            rows = rd * F + np.arange(F)
            live = rows < batch
            base = np.where(live, (rows // t) * outer + (rows % t) * row_stride, 0)
            off = base0 + base[:, None, None] + 2 * idx[None]
            off = np.where(live[:, None, None], off, 0)
            v = (x[off] * w[2 * idx] + 1j * x[off + 1] * w[2 * idx + 1])
            v = np.where(live[:, None, None], v, 0)    # (F, T, 16)
            z = _stages(v, n)[:, _pad(np.arange(m))]
            for f in np.flatnonzero(live):
                row = rows[f]
                stored[row] += 1
                for k in range(m // 2 + 1):
                    zk = z[f, k]
                    if k == 0:
                        re[row, 0] = 2 * (zk.real + zk.imag)
                        im[row, 0] = 2 * (zk.real - zk.imag)
                        continue
                    zm = z[f, m - k]
                    for kk, a, b in ((k, zk, zm), (m - k, zm, zk)):
                        pk = (a + np.conj(b)) - 1j * stw[kk] * (a - np.conj(b))
                        re[row, kk], im[row, kk] = pk.real, pk.imag
    assert (stored == 1).all()
    return re, im


def _packed_ref(frames):
    z = 2 * np.fft.rfft(frames, axis=-1)
    re = z.real[..., :-1]
    im = np.concatenate([z.real[..., -1:], z.imag[..., 1:-1]], axis=-1)
    return re, im


def _check(re, im, frames):
    want_re, want_im = _packed_ref(frames)
    scale = max(np.abs(want_re).max(), np.abs(want_im).max())
    assert np.abs(re - want_re).max() <= TOL * scale
    assert np.abs(im - want_im).max() <= TOL * scale


# (channels, frames a channel, hop, base offset, blocks): odd hops, odd
# bases, hop >= N, one frame, frame counts that are not a multiple of F,
# one block for all rounds and one block a round.
WINDOWED = [(3, 5, 341, 7, 2), (2, 4, None, 3, 1), (1, 1, 512, 1, 1), (5, 3, 77, 0, 64)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c,t,hop,base0,grid", WINDOWED)
def test_windowed_model_matches_rfft(n, c, t, hop, base0, grid):
    rng = np.random.default_rng(n + 7 * c + t)
    hop = n + 5 if hop is None else hop           # None: hop >= N, a gap
    span = (t - 1) * hop + n
    outer = span + 3                              # channels apart, odd
    x = rng.standard_normal(base0 + c * outer + 2)
    w = np.hanning(n + 1)[:n]
    re, im = _kernel_model(x, base0, outer, hop, t, w, c * t, n, grid)
    frames = np.stack([x[base0 + b * outer + i * hop: base0 + b * outer + i * hop + n] * w
                       for b in range(c) for i in range(t)])
    _check(re, im, frames)


@pytest.mark.parametrize("n", SIZES)
def test_contiguous_model_matches_rfft(n):
    """K10's loader: contiguous rows, a batch of 2F + 3 rows over 2 blocks."""
    batch = 2 * hopper_fft._small_plan(n).frames_per_block + 3
    rng = np.random.default_rng(n)
    x = rng.standard_normal(batch * n)
    re, im = _kernel_model(x, 0, n, 0, 1, np.ones(n), batch, n, 2)
    _check(re, im, x.reshape(batch, n))


@pytest.mark.parametrize("n", SIZES)
def test_stage_stores_hit_distinct_banks(n):
    """Each store of a stage, over the 16 lanes of a half warp (frames that
    share it included), falls in 16 distinct float2 bank slots."""
    p = hopper_fft._small_plan(n)
    m, T = n // 2, p.threads_per_frame
    ld = m + m // 16
    lanes = np.arange(32)
    f, tf = lanes // T, lanes % T
    for s, r in enumerate(p.radices):
        ns, qn = 16 ** s, R // r
        for q in range(qn):
            j = tf + q * T
            o = (j // ns) * ns * r + (j & (ns - 1))
            for k in range(r):
                slot = f * ld + _pad(o + k * ns)
                for half in (slot[:16], slot[16:]):
                    assert len(set(half % 16)) == 16, (s, q, k)


# -----------------------------------------------------------------------------
# K11 / K11w (csrc/rifft_small.cu): the packed inverse on the same core


def _partner(tf, m, T):
    """(thread, slot) of the frame holding bin M - k of k = tf + T*m > 0:
    thread T - tf, slot 15 - m for tf >= 1; thread 0, slot 16 - m for tf = 0."""
    tf, m = np.asarray(tf), np.asarray(m)
    return np.where(tf >= 1, T - tf, 0), np.where(tf >= 1, R - 1 - m, (R - m) % R)


def _inverse_model(re, im, w, scale, n, grid):
    """K11w as the kernel computes it on the packed planes (batch, N/2);
    K11 is w = 1, scale = 1. Each round: thread tf of frame f loads the bins
    tf + T*m of row round*F + f (each bin once), takes bin M - k from its
    partner (a lane of the frame, or the frame's slots at M = 1024), unpacks
    the conjugated input, runs the stages and stores the conjugated pairs
    times scale * w. Returns (batch, N) and checks every output once."""
    batch = re.shape[0]
    p = hopper_fft._small_plan(n)
    m, T, F = n // 2, p.threads_per_frame, p.frames_per_block
    stw = _w(n, np.arange(m))
    tf = np.arange(T)
    idx = tf[:, None] + T * np.arange(R)[None, :]      # (T, 16): bin k = tf + T*m
    st, sm = _partner(tf[:, None], np.arange(R)[None, :], T)
    wr0, wr1 = scale * w[2 * idx], scale * w[2 * idx + 1]   # read in the store
    y = np.full((batch, n), np.nan)
    written = np.zeros((batch, n), int)
    rounds = -(-batch // F)
    for blk in range(grid):
        for rd in range(blk * rounds // grid, (blk + 1) * rounds // grid):
            rows = rd * F + np.arange(F)
            live = rows < batch
            safe = np.where(live, rows, 0)
            pk = re[safe][:, idx] + 1j * im[safe][:, idx]          # (F, T, 16)
            pk = np.where(live[:, None, None], pk, 0)
            q = pk[:, st, sm]                                      # bin M - k
            v = np.conj(pk + np.conj(q) + 1j * np.conj(stw[idx]) * (pk - np.conj(q)))
            p0 = pk[:, 0, 0]
            v[:, 0, 0] = np.conj(p0.real + p0.imag + 1j * (p0.real - p0.imag))
            z = _stages(v, n)[:, _pad(idx)]                        # point tf + T*m
            for f in np.flatnonzero(live):
                row = rows[f]
                y[row, 2 * idx] = z[f].real * wr0
                y[row, 2 * idx + 1] = -z[f].imag * wr1
                written[row, 2 * idx] += 1
                written[row, 2 * idx + 1] += 1
    assert (written == 1).all()
    return y


def _irfft_packed(re, im):
    """rifft of the packed planes by np.fft.irfft: rifft(rfft(x)) = 2N x."""
    n = 2 * re.shape[-1]
    full = np.concatenate([re, im[:, :1]], axis=-1) + 1j * np.concatenate(
        [np.zeros_like(re[:, :1]), im[:, 1:], np.zeros_like(re[:, :1])], axis=-1)
    return np.fft.irfft(full, n, axis=-1) * n


@pytest.mark.parametrize("n", SIZES)
def test_partner_map_covers_each_bin_once(n):
    """The loader's partner map sends every (thread, slot) but the DC /
    Nyquist lane (0, 0) to bin M - k, and covers each bin 1..M-1 of the
    frame exactly once; up to M = 512 the partner is a lane of the frame's
    T lanes at the shuffle's source (T - tf) mod T, its slot 15 - m the
    value that lane offers (tf = 0 takes its own slot 16 - m)."""
    p = hopper_fft._small_plan(n)
    m, T = n // 2, p.threads_per_frame
    tf, slot = np.meshgrid(np.arange(T), np.arange(R), indexing="ij")
    k = tf + T * slot
    st, sm = _partner(tf, slot, T)
    bins = st + T * sm
    rest = k != 0
    assert (bins[rest] == m - k[rest]).all()
    assert np.array_equal(np.bincount(bins[rest], minlength=m), np.r_[0, np.ones(m - 1, int)])
    if T <= 32:
        assert (st[tf >= 1] == ((T - tf) & (T - 1))[tf >= 1]).all()
        assert (sm[tf >= 1] == (R - 1 - slot)[tf >= 1]).all()


@pytest.mark.parametrize("n", SIZES)
def test_inverse_model_matches_irfft(n):
    """K11: 2F + 3 rows over 2 blocks (a ragged last round) against
    np.fft.irfft, 2N x, to 1e-12 of the largest output."""
    batch = 2 * hopper_fft._small_plan(n).frames_per_block + 3
    rng = np.random.default_rng(n + 1)
    re, im = rng.standard_normal((2, batch, n // 2))
    got = _inverse_model(re, im, np.ones(n), 1.0, n, 2)
    want = _irfft_packed(re, im)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("batch,grid", [(5, 1), (385, 3), (7, 64)])
def test_windowed_inverse_model_matches_irfft(n, batch, grid):
    """K11w: scale * rifft(spec) * w over batches that are no multiple of F,
    on one block, a few and more blocks than rounds."""
    rng = np.random.default_rng(3 * n + batch)
    re, im = rng.standard_normal((2, batch, n // 2))
    w = np.hanning(n + 1)[:n]
    scale = 0.5 / n
    got = _inverse_model(re, im, w, scale, n, grid)
    want = _irfft_packed(re, im) * (scale * w)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# -----------------------------------------------------------------------------
# K9 hop_fire (csrc/hop_fire.cu): the fused firing on the same core

FIRE_SRC = Path(hk.__file__).resolve().parents[1] / "csrc" / "hop_fire.cu"
FIRE_SIZES = [1 << k for k in range(5, 11)]   # N = 32..1024
GROUP = hk.FIRE_LANES * hk.FIRE_POINTS        # a frame group's plane row: 512 floats


def test_fire_plan_constants_match_the_kernel():
    """hopper_kernels' FIRE_* constants are hop_fire.cu's, and the launch
    takes ceil(C / F) blocks of 32 (1 + H) threads with the plan's bytes,
    under an opt-in of the most any P = 1..256 asks."""
    text = FIRE_SRC.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(const["kLanes"]) == hk.FIRE_LANES
    assert hk.FIRE_POINTS == R
    assert int(const["kMaxHelpers"]) == hk.FIRE_MAX_HELPERS
    assert int(const["kLagsPerHelper"]) == hk.FIRE_LAGS_PER_HELPER
    assert int(const["kMaxStages"]) == hk.FIRE_MAX_STAGES
    assert int(const["kStageBudget"]) == hk.FIRE_STAGE_BUDGET
    assert int(const["kPlanes"]) == hk.FIRE_PLANES
    assert int(const["kMaxP"]) == hk.HOP_FIRE_MAX_P
    assert "const unsigned blocks = (unsigned)((channels + F - 1) / F);" in text
    assert ("cudaFuncAttributeMaxDynamicSharedMemorySize, fire_max_bytes(LOG_M));"
            in text)
    assert "for (int p = 1; p <= kMaxP; ++p)" in text
    assert "kernel<<<blocks, kLanes * (1 + pl.helpers), pl.bytes, stream>>>" in text
    # no radix-2 pass of smem_fft.cuh is left in K9
    assert not re.search(r"\b(dif|dit)\(", text)


@pytest.mark.parametrize("n", FIRE_SIZES)
@pytest.mark.parametrize("p", [1, 3, 9, 14, 17, 64, 256])
@pytest.mark.parametrize("c", [1, 127, 129, 1000])
def test_fire_plan_every_shape(c, n, p):
    """One warp's lanes a frame group, a helper warp a 4 lags (1..7),
    stages inside the block's budget, and shared memory inside the
    kernel's opt-in and a block's 227 KB."""
    m = n // 2
    pl = hk._fire_plan(c, n, p)
    assert pl.threads_per_frame * R == m
    assert pl.frame_group * pl.threads_per_frame == hk.FIRE_LANES
    assert pl.frame_group * m == GROUP
    assert pl.blocks == -(-c // pl.frame_group)
    assert 1 <= pl.helpers <= hk.FIRE_MAX_HELPERS
    assert pl.threads == 32 * (1 + pl.helpers) <= 256
    lags = p - 1
    assert pl.lags_per_helper == -(-lags // pl.helpers)
    assert (pl.lags_per_helper <= hk.FIRE_LAGS_PER_HELPER
            or pl.helpers == hk.FIRE_MAX_HELPERS)
    if pl.helpers > 1:  # one helper fewer would take more than 4 lags
        assert -(-lags // (pl.helpers - 1)) > hk.FIRE_LAGS_PER_HELPER
    assert pl.stages == min(pl.lags_per_helper, hk.FIRE_MAX_STAGES,
                            hk.FIRE_STAGE_BUDGET // pl.helpers)
    assert pl.helpers * pl.stages <= hk.FIRE_STAGE_BUDGET
    assert pl.shared_bytes <= hk._fire_max_bytes(n) <= 227 * 1024
    assert pl.shared_bytes % 16 == 0


@pytest.mark.parametrize("n", FIRE_SIZES)
def test_fire_opt_in_covers_every_p(n):
    """The kernel's opt-in for dynamic shared memory covers the plan of
    every P = 1..256 and is the plan of four helpers of four stages (P =
    14..17), above the P = 256 plan (seven helpers of two stages): an
    opt-in taken from one P alone would refuse the others' launches."""
    most = hk._fire_max_bytes(n)
    plans = {p: hk._fire_plan(1, n, p) for p in range(1, hk.HOP_FIRE_MAX_P + 1)}
    assert max(pl.shared_bytes for pl in plans.values()) == most <= 227 * 1024
    top = [p for p, pl in plans.items() if pl.shared_bytes == most]
    assert top == [14, 15, 16, 17]
    assert all((plans[p].helpers, plans[p].stages) == (4, 4) for p in top)
    assert plans[256].shared_bytes < most
    assert all(hk._fire_plan(c, n, 17).shared_bytes == most for c in (1, 128, 4099))


def test_fire_plan_path_grid():
    """A C = 128 firing at the Zero preset's P = 3 takes one helper and F
    frames a block: 32 blocks at N = 256, 128 at N = 1024; at P = 64 the
    same blocks with seven helpers."""
    assert hk._fire_plan(128, 256, 3).blocks == 32
    assert hk._fire_plan(128, 1024, 3).blocks == 128
    assert hk._fire_plan(128, 1024, 3).helpers == 1
    for n in FIRE_SIZES:
        assert hk._fire_plan(128, n, 64).blocks == 128 // hk._fire_plan(128, n, 64).frame_group
        assert hk._fire_plan(128, n, 64).helpers == 7
    assert hk._fire_plan(128, 1024, 256).helpers == 7
    assert hk._fire_plan(1000, 256, 64).blocks == 250


@pytest.mark.parametrize("n,p", [(2048, 3), (16, 3), (256, 0), (256, 257), (96, 3)])
def test_fire_plan_refuses_other_shapes(n, p):
    with pytest.raises(ValueError, match="K9 serves"):
        hk._fire_plan(4, n, p)


def _lane_chunks(m):
    """(lane, j) -> (e, frame, bin) of the lane chunks: float e = 4(lane +
    32 j) of a group plane row, frame e >> log2 M, bin e & (M - 1)."""
    e = 4 * (np.arange(hk.FIRE_LANES)[:, None] + hk.FIRE_LANES * np.arange(4)[None, :])
    return e, e // m, e % m


def _fire_model(frame, ring_re, ring_im, h_re, h_im, n):
    """K9 as the kernel computes it, in float64: frame (C, N), ring (C, P,
    M), H (C, P, M). Returns (ring' re, ring' im, y) and checks that every
    element of ring' and y is stored once, each stage holds the item its
    lane reads, and every bin warp 0 reads was written."""
    c, p, m = ring_re.shape
    pl = hk._fire_plan(c, n, p)
    T, F, H, S = pl.threads_per_frame, pl.frame_group, pl.helpers, pl.stages
    ld_fin = m + max(T, 4)
    stw = _w(n, np.arange(m))
    lags = p - 1
    out_re = np.full((c, p, m), np.nan)
    out_im = np.full((c, p, m), np.nan)
    y = np.full((c, m), np.nan)
    n_re = np.zeros((c, p, m), int)
    n_y = np.zeros((c, m), int)
    e, cf, cbin = _lane_chunks(m)
    co = cf * ld_fin + cbin                                 # padded row offsets
    tf = np.arange(T)
    idx = tf[:, None] + T * np.arange(R)[None, :]          # (T, 16): bin tf + T*m
    st, sm = _partner(tf[:, None], np.arange(R)[None, :], T)
    for blk in range(pl.blocks):
        c0 = blk * F
        chans = c0 + np.arange(F)
        live = chans < c
        safe = np.where(live, chans, 0)
        cch, clive = c0 + cf, (c0 + cf) < c                # (32, 4) lane chunks

        def chunk(row):
            """cp.async of the lane chunks of ``row`` (C, M) into a
            512-float plane row (zero fill past the last channel)."""
            out = np.full(GROUP, np.nan)
            for q in range(4):
                out[e + q] = np.where(clive, row[np.where(clive, cch, 0), cbin + q], 0)
            return out

        def padded(plane):
            """A plane row's chunks stored at their padded row offsets."""
            out = np.full(F * ld_fin, np.nan)
            for q in range(4):
                out[co + q] = plane[e + q]
            return out

        # helper h takes lags s = h + H i through S stages of its own
        sums = []
        for h in range(H):
            mine = list(range(h, lags, H))
            slots = {i: mine[i] for i in range(min(S, len(mine)))}  # issued at entry
            ar = np.zeros(GROUP)
            ai = np.zeros(GROUP)
            for i, s in enumerate(mine):
                assert slots[i % S] == s                   # the stage holds item i
                vr, vi = chunk(ring_re[:, s + 1]), chunk(ring_im[:, s + 1])
                hr, hi = chunk(h_re[:, p - 1 - s]), chunk(h_im[:, p - 1 - s])
                for q in range(4):                         # ring' row s from the chunks
                    out_re[cch[clive], s, cbin[clive] + q] = vr[e[clive] + q]
                    out_im[cch[clive], s, cbin[clive] + q] = vi[e[clive] + q]
                    n_re[cch[clive], s, cbin[clive] + q] += 1
                lane0 = np.zeros(GROUP, bool)
                lane0[e[cbin == 0]] = True                 # (DC, Nyquist) lanes
                ar += np.where(lane0, vr * hr, vr * hr - vi * hi)
                ai += np.where(lane0, vi * hi, vr * hi + vi * hr)
                if i + S < len(mine):                      # the refill
                    slots[i % S] = mine[i + S]
            sums.append((padded(ar), padded(ai)))
        h0r, h0i = padded(chunk(h_re[:, 0])), padded(chunk(h_im[:, 0]))  # helper 0
        # warp 0: forward of the frames (frame f: lanes f*T + tf)
        v = frame[safe][:, 2 * idx] + 1j * frame[safe][:, 2 * idx + 1]
        v = np.where(live[:, None, None], v, 0)            # (F, T, 16)
        z = _stages(v, n)[:, _pad(np.arange(m))]
        zk = z[:, idx]
        zm = z[:, (m - idx) % m]
        ev = (zk + np.conj(zm)) - 1j * stw[idx] * (zk - np.conj(zm))
        ev[:, 0, 0] = 2 * (zk[:, 0, 0].real + zk[:, 0, 0].imag) + 2j * (
            zk[:, 0, 0].real - zk[:, 0, 0].imag)
        rd = np.arange(F)[:, None, None] * ld_fin + idx[None]
        # after the barrier: its bins of H[0] and of each helper's sum
        sr = sum(a[rd] for a, _ in sums)
        si = sum(b[rd] for _, b in sums)
        hr0, hi0 = h0r[rd], h0i[rd]
        assert not np.isnan(sr).any() and not np.isnan(hr0).any()
        yv = np.where(idx == 0, ev.real * hr0 + sr + 1j * (ev.imag * hi0 + si),
                      (ev.real * hr0 - ev.imag * hi0 + sr)
                      + 1j * (ev.real * hi0 + ev.imag * hr0 + si))
        # E into padded rows at warp 0's bins; helper 0 stores ring' row P-1
        # from them by lane chunks after the barrier
        erow = np.full((2, F * ld_fin), np.nan)
        erow[0, rd], erow[1, rd] = ev.real, ev.imag
        for q in range(4):
            ok = clive
            out_re[cch[ok], p - 1, cbin[ok] + q] = erow[0, co[ok] + q]
            out_im[cch[ok], p - 1, cbin[ok] + q] = erow[1, co[ok] + q]
            n_re[cch[ok], p - 1, cbin[ok] + q] += 1
        # inverse: K11's loader, the stages, the kept half (frame slots past
        # the last channel run on the zero fill and store nothing)
        assert not yv[~live].any()
        q = yv[:, st, sm]                                  # bin M - k
        vv = np.conj(yv + np.conj(q) + 1j * np.conj(stw[idx]) * (yv - np.conj(q)))
        p0 = yv[:, 0, 0]
        vv[:, 0, 0] = np.conj(p0.real + p0.imag + 1j * (p0.real - p0.imag))
        zz = _stages(vv, n)[:, _pad(idx)]                  # point tf + T*m
        scale = 1.0 / (4.0 * n)
        pts = idx[:, R // 2:]                              # n >= M/2
        for f in np.flatnonzero(live):
            y[c0 + f, 2 * pts - m] = scale * zz[f][:, R // 2:].real
            y[c0 + f, 2 * pts - m + 1] = -scale * zz[f][:, R // 2:].imag
            n_y[c0 + f, 2 * pts - m] += 1
            n_y[c0 + f, 2 * pts - m + 1] += 1
    assert (n_re == 1).all() and (n_y == 1).all()
    return out_re, out_im, y


def _fire_ref(frame, ring_re, ring_im, h_re, h_im, n):
    """The firing by np.fft: the frame's packed spectrum joins the ring as
    its newest slot, Y = sum_s ring'[s] H[P-1-s], y = irfft(Y)[N/2:] / (4N)."""
    p = ring_re.shape[1]
    er, ei = _packed_ref(frame)
    nr = np.concatenate([ring_re[:, 1:], er[:, None]], axis=1)
    ni = np.concatenate([ring_im[:, 1:], ei[:, None]], axis=1)
    yr = np.zeros_like(er)
    yi = np.zeros_like(ei)
    for s in range(p):
        a, b = nr[:, s], ni[:, s]
        c, d = h_re[:, p - 1 - s], h_im[:, p - 1 - s]
        pr, pi = a * c - b * d, a * d + b * c
        pr[:, 0], pi[:, 0] = a[:, 0] * c[:, 0], b[:, 0] * d[:, 0]
        yr, yi = yr + pr, yi + pi
    return nr, ni, _irfft_packed(yr, yi)[:, n // 2:] / (4.0 * n)


@pytest.mark.parametrize("n", FIRE_SIZES)
@pytest.mark.parametrize("p", [1, 3, 20, 256])
def test_fire_model_matches_fft(n, p):
    """The fused firing's model against np.fft at every N: at P 1 over
    4 F + 3 channels, at P 3, 20 and 256 over F + 3 (F frames a block, the
    last block ragged; 2 channels at N >= 512 with P = 256); H broadcast
    over the channels at P = 3; P = 20 takes five helpers of four lags,
    P = 256 seven helpers through two stages each."""
    f = hk._fire_plan(1, n, p).frame_group
    c = 2 if p == 256 and n >= 512 else 4 * f + 3 if p == 1 else f + 3
    rng = np.random.default_rng(n + p)
    m = n // 2
    frame = rng.standard_normal((c, n))
    ring_re, ring_im = rng.standard_normal((2, c, p, m))
    h_re, h_im = rng.standard_normal((2, 1 if p == 3 else c, p, m))
    h_re, h_im = (np.broadcast_to(h, (c, p, m)) for h in (h_re, h_im))
    got = _fire_model(frame, ring_re, ring_im, h_re, h_im, n)
    want = _fire_ref(frame, ring_re, ring_im, h_re, h_im, n)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("n", FIRE_SIZES)
def test_fire_sum_reads_hit_distinct_banks(n):
    """The frame lanes' reads of the padded sum and H[0] rows (frame f's
    bin tf + T*m at f (M + max(T, 4)) + tf + T*m) fall in 32 distinct banks
    for every slot m where T >= 4; at T = 1, 2 (N = 32, 64) at most 4 lanes
    share one. The chunk stores into those rows stay 16-byte aligned."""
    m = n // 2
    T = m // R
    ld = m + max(T, 4)
    lanes = np.arange(32)
    f, tf = lanes // T, lanes % T
    for slot in range(R):
        banks = (f * ld + tf + T * slot) % 32
        worst = np.bincount(banks).max()
        assert worst == 1 if T >= 4 else worst <= 4
    e, cf, cbin = _lane_chunks(m)
    assert ((cf * ld + cbin) % 4 == 0).all()
