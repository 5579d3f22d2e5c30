"""The large FFT routes of the port (csrc/fft_large.cuh) checked on the CPU.

Two things are held here, in float64 and at small sizes, before any card
time: the Python mirror of the kernels' plan (``hopper_fft._plan``, from
which the wrappers size their scratch), and a numpy model of the new routes'
index maps, written to follow the kernels step by step:

* the long two-pass route: the column pass's store Y[k*ncol + col] with the
  inter-pass twiddle split as W_M^(s*(e>>b)) W_M^(e & (s-1)), the row pass's
  pack tiles (slot f of tile t holds row pack_row_of<H>(t, f); bin
  k = j + R*k1 meets its partner in row R-j, column M1-1-k1, row 0: M1-k1);
* the cluster route: block r owns columns r*M1/8.. and, after the
  exchange, rows r*R/8.. (or the pack tile r), gathering column n1 from
  block n1 // (M1/8).
* the routes above complex 2^19 and K14's redesigned first pass: the plan
  mirror at M = 2^17..2^28, the three-pass route (a column pass, a middle
  column pass in place over the first pass's rows, rows through a row map),
  the paired unpack (a block's column slots hold the column pairs (c,
  ncol - c), so each packed bin is loaded once and meets its partner in
  the block's tile) and the float32 error of the twiddles formed from two
  factors;
* K2's loader on K1's one-pass route: frames [x[t-1] | x[t]] read in
  place from the hop blocks, the lower half zero at a channel's first hop;
* the real inverse on K1's one-pass route (K4, K6, K8's inverse): the
  paired unpack at every K1 plan (a block's column slots hold columns n1
  and M1 - n1), the exchange of the paired columns to the rows, and the
  tail and full stores against ``np.fft.irfft``.

Each sub-FFT runs the kernels' in-block four-step (a B-point DFT over
j2 of elements j1 + A*j2, the twiddle W_L^(j1*k2), an A-point DFT giving
k = k2 + B*k1). The model matches ``np.fft.fft`` and the packed ``rfft`` to
1e-12 relative to the largest output; the kernels themselves are held
against their plain versions on the card (tests/test_torch_cuda.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402

TOL = 1e-12

# The two-pass splits that M <= 2^16 kept from before the large routes
# (column length, row length).
TWO_PASS = {11: (64, 32), 12: (64, 64), 13: (128, 64), 14: (128, 128),
            15: (256, 128), 16: (256, 256)}


@pytest.mark.parametrize("lm", range(11, 20))
def test_plan_routes_every_size(lm):
    """Real N = 2^12..2^20 (complex M = N/2 = 2^11..2^19, which K12 asks
    for as _plan(2M)): lengths multiply to M, none above 1024, at most two
    HBM passes; the cluster alone at 2^17, with no scratch."""
    m = 1 << lm
    plan = hopper_fft._plan(2 * m)
    a, b = plan.lengths
    assert a * b == m and a <= 1024 and b <= 1024
    assert plan.hbm_passes <= 2
    if lm <= 16:
        assert plan == ("two-pass", TWO_PASS[lm], 2, 1)
    elif lm == 17:
        assert plan == ("cluster", (512, 256), 1, 0)
    else:
        assert plan.route == "two-pass-long" and plan.hbm_passes == 2
        assert plan.scratch_frames == 1 and a == 512
    assert (plan.scratch_frames == 0) == (plan.route == "cluster")


@pytest.mark.parametrize("lm", range(11, 20))
def test_scratch_follows_plan(lm):
    """The wrappers' scratch: one frame of M float2 per transform with two
    passes, none on the cluster (meta tensors: nothing is allocated)."""
    m = 1 << lm
    s = hopper_fft._scratch(3, m, torch.device("meta"))
    if lm == 17:
        assert s is None
    else:
        assert tuple(s.shape) == (3, 2 * m) and s.dtype == torch.float32


@pytest.mark.parametrize("n", [1 << 10, 3 << 12, 1 << 30])
def test_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="2\\^11..2\\^28"):
        hopper_fft._plan(n)


# -----------------------------------------------------------------------------
# The numpy model of the kernels' index maps


def _w(n, e):
    return np.exp(-2j * np.pi * np.asarray(e) / n)


def _sub_fft(x):
    """The kernels' in-block four-step of each row of x (..., L), L = A*B
    with A = 2^(log2 L // 2): step 1 the B-point DFT over j2 of elements
    j1 + A*j2 times W_L^(j1*k2), step 2 the A-point DFT over j1, output
    k = k2 + B*k1."""
    n = x.shape[-1]
    a = 1 << (n.bit_length() - 1) // 2
    b = n // a
    j1, j2 = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    s1 = np.fft.fft(x[..., j1 + a * j2], axis=-1)          # (..., j1, k2)
    s1 = s1 * _w(n, np.arange(a)[:, None] * np.arange(b)[None, :])
    s2 = np.fft.fft(s1, axis=-2)                              # (..., k1, k2)
    out = np.empty_like(x, dtype=complex)
    k2, k1 = np.meshgrid(np.arange(b), np.arange(a), indexing="xy")
    out[..., k2 + b * k1] = s2
    return out


def _tw_m(m, e, split):
    """W_M^e as the kernels read it: W_M^(split*(e // split)) W_M^(e % split)."""
    return _w(m, split * (e // split)) * _w(m, e % split)


def _pack_row_of(h, tile, f, rows):
    lo = f & (h - 1)
    if f < h:
        return h * tile + lo
    if tile == 0 and lo == 0:
        return rows >> 1
    return rows - (h * tile + lo)


def _pack_tile(z_slots, rows_of, rows, m):
    """The split step over one tile's slots (natural order each): bin
    k = row + R*k1 and its partner in slot f ^ H (rows 0 and R/2: itself),
    column L-1-k1 (row 0: L-k1). Returns {k: P[k]}."""
    h2, l = z_slots.shape
    out = {}
    for sf in range(h2):
        row = rows_of[sf]
        for k1 in range(l):
            k = row + rows * k1
            zk = z_slots[sf, k1]
            if k == 0:
                out[0] = complex(2 * (zk.real + zk.imag), 2 * (zk.real - zk.imag))
                continue
            g = sf if row in (0, rows >> 1) else sf ^ (h2 // 2)
            c = l - k1 if row == 0 else l - 1 - k1
            zm = z_slots[g, c]
            s = zk + np.conj(zm)
            d = zk - np.conj(zm)
            out[k] = s - 1j * _w(2 * m, k) * d
    return out


def _packed_ref(x):
    """The packed layout of rfft(x): N/2 bins x2, Nyquist in im[0]."""
    z = 2 * np.fft.rfft(x)
    p = z[:-1].copy()
    p[0] = complex(z[0].real, z[-1].real)
    return p


def _signal(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2 * m)
    return x, x[0::2] + 1j * x[1::2]


def _close(got, want):
    return np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def _long_route(z, col_len, h, split, pack):
    """The two-pass long route on one frame z (M points): columns of col_len
    points (ncol = M / col_len of them), rows of ncol points, row tiles of
    2h slots. Returns Z (natural order) or, with ``pack``, the packed bins."""
    m = z.size
    ncol = m // col_len
    rows = col_len
    y = np.empty(m, complex)
    for col in range(ncol):                        # the column pass
        out = _sub_fft(z[col + ncol * np.arange(col_len)])
        k = np.arange(col_len)
        y[k * ncol + col] = out * _tw_m(m, (col * k) % m, split)
    res = np.empty(m, complex)
    tiles = rows // (2 * h)
    for tile in range(tiles):                      # the row pass
        rows_of = ([_pack_row_of(h, tile, f, rows) for f in range(2 * h)] if pack
                   else [tile * 2 * h + f for f in range(2 * h)])
        slots = np.stack([_sub_fft(y[r * ncol:(r + 1) * ncol]) for r in rows_of])
        if pack:
            for k, v in _pack_tile(slots, rows_of, rows, m).items():
                res[k] = v
        else:
            for f, r in enumerate(rows_of):
                res[r + rows * np.arange(ncol)] = slots[f]
    return res


def _row_home(k, rows, blocks):
    """fft_large.cuh's row_home: the block and slot that hold row k."""
    h = rows // blocks // 2
    if k == rows // 2:
        return 0, h
    j = k if k < rows // 2 else rows - k
    return j // h, (0 if k < rows // 2 else h) + j % h


def _cluster_route(z, cols, blocks, pack, split=None, push=False):
    """The cluster route on one frame: `cols` columns of M/cols points, block
    r owning columns r*cols/blocks.. in its own memory (lsm[r][f][k2]), then
    2*h = R/blocks row slots a block, each gathered from the owners, or with
    ``push`` (and ``pack``, the one-pass kernel's exchange) stored by the
    owners of the columns into the row tiles of the block that
    :func:`_row_home` names. With ``split`` the inter-pass twiddle is read
    as the kernels read it (:func:`_tw_m`)."""
    m = z.size
    col_len = m // cols
    rows = col_len
    own_c = cols // blocks
    own_r = rows // blocks
    lsm = np.empty((blocks, own_c, col_len), complex)
    for r in range(blocks):                        # 1. each block's columns
        for f in range(own_c):
            col = r * own_c + f
            k = np.arange(col_len)
            tw = _w(m, col * k) if split is None else _tw_m(m, (col * k) % m, split)
            lsm[r, f] = _sub_fft(z[col + cols * np.arange(col_len)]) * tw
    tiles = np.full((blocks, own_r, cols), np.nan, complex)
    if push:                                       # 2. each column's outputs out
        for r in range(blocks):
            for f in range(own_c):
                for k in range(col_len):
                    owner, slot = _row_home(k, rows, blocks)
                    tiles[owner, slot, r * own_c + f] = lsm[r, f, k]
    res = np.empty(m, complex)
    for r in range(blocks):                        # 2-3. gather, rows, store
        rows_of = ([_pack_row_of(own_r // 2, r, f, rows) for f in range(own_r)] if pack
                   else [r * own_r + f for f in range(own_r)])
        if push:
            slots = np.stack([_sub_fft(tiles[r, f]) for f in range(own_r)])
        else:
            slots = np.stack([_sub_fft(np.array([lsm[n1 // own_c, n1 % own_c, row]
                                                 for n1 in range(cols)]))
                              for row in rows_of])
        if pack:
            for k, v in _pack_tile(slots, rows_of, rows, m).items():
                res[k] = v
        else:
            for f, row in enumerate(rows_of):
                res[row + rows * np.arange(cols)] = slots[f]
    return res


@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("rows", [8, 16, 32])
def test_pack_tiles_cover_each_row_once(rows, h):
    """pack_row_of: the tiles of R rows hold every row once, slot f and
    f ^ H partners (R - row), tile 0 the self-paired rows 0 and R/2."""
    seen = []
    for tile in range(rows // (2 * h)):
        got = [_pack_row_of(h, tile, f, rows) for f in range(2 * h)]
        for f in range(h):
            assert (got[f] + got[f + h]) % rows == (0 if (tile, f) != (0, 0) else rows // 2)
        seen += got
    assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("col_len,ncol,h,split", [
    (32, 32, 8, 32),    # 2^10 as 32 x 32, the kernels' 16-slot tiles
    (16, 32, 4, 16),    # 2^9 as 16 x 32: 2^19's ratio, 512 x 1024
    (32, 16, 2, 64),    # more row tiles than one
])
@pytest.mark.parametrize("pack", [False, True])
def test_long_route_model_matches_numpy(col_len, ncol, h, split, pack):
    """The two-pass long route's index maps: Z against np.fft.fft, the pack
    against the packed rfft of the real signal, to 1e-12."""
    m = col_len * ncol
    x, z = _signal(m, seed=m + h)
    got = _long_route(z, col_len, h, split, pack)
    assert _close(got, _packed_ref(x) if pack else np.fft.fft(z))


@pytest.mark.parametrize("cols,m", [(16, 512), (32, 2048)])
@pytest.mark.parametrize("pack", [False, True])
def test_cluster_route_model_matches_numpy(cols, m, pack):
    """The cluster route at 2^9 and 2^11 over 8 blocks (the kernel's ratio:
    columns half as many as their length): column and row ownership and
    the gather across blocks, against np.fft.fft and the packed rfft."""
    x, z = _signal(m, seed=cols)
    got = _cluster_route(z, cols, 8, pack)
    assert _close(got, _packed_ref(x) if pack else np.fft.fft(z))


@pytest.mark.parametrize("m,split", [(1 << 17, 512), (1 << 19, 512), (1 << 12, 64)])
def test_split_twiddle_is_the_twiddle(m, split):
    """W_M^(s*(e//s)) W_M^(e%s) = W_M^e over all e < M (float64)."""
    e = np.arange(m)
    assert np.max(np.abs(_tw_m(m, e, split) - _w(m, e))) < 1e-12


# -----------------------------------------------------------------------------
# K1's one-pass route (csrc/rfft_packed.cu K1Pass on fft_large.cuh's
# fft_onepass): its plan mirror, its index maps and its shared-memory strides

# (M1 columns, M2 points a column, C blocks, threads a block) for complex
# M = 2^11..2^16.
K1_PLAN = {11: (64, 32, 1, 256), 12: (64, 64, 1, 256), 13: (128, 64, 1, 512),
           14: (128, 128, 2, 512), 15: (128, 256, 4, 256), 16: (256, 256, 8, 512)}
SHARED_BYTES_MAX = 227 * 1024


@pytest.mark.parametrize("lm", range(11, 17))
def test_onepass_plan_every_k1_size(lm):
    """K1 at real N = 2^12..2^17: one HBM pass and no scratch at every size,
    one block up to M = 2^13 and a cluster of 2 / 4 / 8 blocks above, each
    block at most 8192 points (64 KB) of the frame, its shared memory within
    the 227 KB a block may use and two blocks within an SM's 228 KB, whole
    rounds of its threads in every step, and a run of at least 32
    consecutive points (256 bytes) of every row loaded by each block."""
    m = 1 << lm
    plan = hopper_fft._onepass_plan(2 * m)
    cols, col_len, blocks, threads = K1_PLAN[lm]
    assert plan.route == "one-pass"
    assert plan.lengths == (col_len, cols) and cols * col_len == m
    assert plan.blocks == blocks and plan.threads == threads
    assert plan.hbm_passes == 1 and plan.scratch_frames == 0
    assert plan.shared_bytes <= SHARED_BYTES_MAX
    assert m // blocks <= 8192 and cols // blocks >= 32
    assert 2 * (plan.shared_bytes + 1024) <= 228 * 1024
    for length, owned in ((col_len, cols // blocks), (cols, col_len // blocks)):
        a = 1 << (length.bit_length() - 1) // 2
        for tasks in (owned * a, owned * (length // a)):
            assert tasks % plan.threads == 0 and tasks >= plan.threads
    def tile(length):  # B groups of A + 1 slots, and one slot more
        a = 1 << (length.bit_length() - 1) // 2
        return length // a * (a + 1) + 1

    frame = max(cols // blocks * (col_len + 1), col_len // blocks * tile(cols))
    assert plan.shared_bytes == 8 * (frame + cols + col_len // blocks + 1024 + m // 512)


@pytest.mark.parametrize("lm", range(11, 17))
def test_k1_route_leaves_make_plan_unchanged(lm):
    """K1's plan is its own (K2, K4, K6 and K8 share it): make_plan's mirror
    for K12 keeps two passes and one scratch frame at every M <= 2^16."""
    m = 1 << lm
    assert hopper_fft._plan(2 * m) == ("two-pass", TWO_PASS[lm], 2, 1)
    assert tuple(hopper_fft._scratch(2, m, torch.device("meta")).shape) == (2, 2 * m)
    assert hopper_fft._onepass_plan(2 * m).route != hopper_fft._plan(2 * m).route


@pytest.mark.parametrize("n", [2048, 3 << 12, 1 << 18])
def test_onepass_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="one-pass"):
        hopper_fft._onepass_plan(n)


@pytest.mark.parametrize("lm", range(11, 17))
def test_onepass_model_matches_numpy_at_k1_sizes(lm):
    """The one-pass route with the split step at every K1 size, with the
    plan's C = 1, 2, 4, 8 and its M1 x M2: the packed bins (DC and Nyquist
    lane included) against the packed rfft, to 1e-12."""
    plan = hopper_fft._onepass_plan(1 << (lm + 1))
    x, z = _signal(1 << lm, seed=lm)
    got = _cluster_route(z, plan.lengths[1], plan.blocks, True, split=512, push=True)
    assert _close(got, _packed_ref(x))


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1 << 8, 1 << 10])
def test_onepass_model_matches_numpy_small(m, blocks):
    """The same index maps at small M over C = 1, 2, 4 and 8 blocks (columns
    and rows as the kernel's ratio M2 = M / M1 >= M1 / 2 keeps them)."""
    cols = 1 << (m.bit_length() - 1) // 2
    x, z = _signal(m, seed=m + blocks)
    got = _cluster_route(z, cols, blocks, True, split=16, push=True)
    assert _close(got, _packed_ref(x))


def _stream_frame(x2d, frame, m):
    """K2's loader (fft_common.cuh load_elem<kLoadStream>) for one frame of
    the (C, T, H) blocks x2d, frame = c * T + t: element idx < M of the
    float2 view z of [x[t-1] | x[t]], read at float2 frame * M/2 + idx - M/2
    of the flat signal, zero for idx < M/2 at a channel's first hop."""
    hops = x2d.shape[1]
    flat = x2d.reshape(-1)
    z2 = flat[0::2] + 1j * flat[1::2]
    half = m // 2
    idx = np.arange(m)
    z = np.zeros(m, complex)
    read = (idx >= half) | (frame % hops != 0)
    z[read] = z2[frame * half + idx[read] - half]
    return z


@pytest.mark.parametrize("c,t,m,blocks", [(2, 1, 1 << 8, 1), (3, 5, 1 << 8, 1),
                                          (3, 5, 1 << 10, 2), (2, 3, 1 << 11, 1)])
def test_stream_loader_model_matches_plain(c, t, m, blocks):
    """K2 on the one-pass route: frames read in place by the loader's index
    map (a channel's first hop with a zero lower half, later hops reading
    the block before, frames crossing channel boundaries at T = 5) through
    the one-pass model, against the plain version in float64."""
    rng = np.random.default_rng(m + t)
    x2d = rng.standard_normal((c, t, m))
    cols = 1 << (m.bit_length() - 1) // 2
    want_re, want_im = hopper_fft.rfft_packed_stream_plain(torch.from_numpy(x2d))
    want = (want_re.numpy() + 1j * want_im.numpy()).reshape(c * t, m)
    for frame in range(c * t):
        got = _cluster_route(_stream_frame(x2d, frame, m), cols, blocks, True, split=16,
                             push=True)
        assert _close(got, want[frame])


@pytest.mark.parametrize("blocks,rows", [(1, 32), (2, 128), (4, 256), (8, 512), (8, 64),
                                         (8, 256), (1, 64)])
def test_row_home_inverts_the_row_slots(blocks, rows):
    """row_home(k) names the block and slot whose row is k in pack_row_of's
    tiles (rows j and R-j in one block, block 0 also R/2)."""
    own = rows // blocks
    for k in range(rows):
        owner, slot = _row_home(k, rows, blocks)
        assert 0 <= owner < blocks and 0 <= slot < own
        assert _pack_row_of(own // 2, owner, slot, rows) == k


def _ways(addrs):
    """The most distinct float2 slots that lanes of one half-warp (64-bit
    accesses) touch in one bank pair (slot mod 16). Lanes that access
    another block's memory (None) are left out."""
    worst = 1
    for half in (addrs[:16], addrs[16:]):
        slots = {}
        for a in half:
            if a is not None:
                slots.setdefault(a % 16, set()).add(a)
        worst = max([worst] + [len(v) for v in slots.values()])
    return worst


@pytest.mark.parametrize("lm", range(11, 17))
def test_onepass_strides_avoid_bank_conflicts(lm):
    """Every shared-memory access of fft_onepass at K1's plans, warp by warp:
    the column tiles (stride M2 + 1, natural order) in step 1's store and
    step 2's read, the exchange's stores into the row tiles (by destination
    block, where a warp's stores also run in one or two contiguous runs),
    the row tiles in step 1's read and store, step 2 and the split step's
    reads, where a row of L = A*B points keeps bin k at
    (k % B)*(A + 1) + k // B of a tile of B*(A + 1) + 1 slots. One lane of
    rank 0 may meet a 2-way conflict in the split step: its row 0 reads
    partner bin L - k1. With the inverse's paired unpack (K4, K6, K8's
    inverse) also: the packed bins' store into the column tiles, the
    partners' reads (2-way at most where column 0 reads its own row
    M2 - j), the W_512 factor's read, and the exchange's stores of the
    paired columns (three runs at most)."""
    plan = hopper_fft._onepass_plan(1 << (lm + 1))
    col_len, cols = plan.lengths
    c, nt = plan.blocks, plan.threads
    own_c, own_r = cols // c, col_len // c

    def split(length):
        a = 1 << (length.bit_length() - 1) // 2
        return a, length // a, length // a * (a + 1) + 1

    ca, cb, _ = split(col_len)
    ldc = col_len + 1
    ra, rb, ldr = split(cols)

    def pos_r(k):
        return k % rb * (ra + 1) + k // rb

    for rank in range(c):
        rows = [_pack_row_of(own_r // 2, rank, f, col_len) for f in range(own_r)]
        for t0 in range(0, 4 * nt, 32):
            lanes = range(t0, t0 + 32)
            if t0 < own_c * ca:
                assert _ways([t % own_c * ldc + cb // 2 * ca + t // own_c for t in lanes]) == 1
            if t0 < own_c * cb:
                assert _ways([t % own_c * ldc + t // own_c * ca + 1 for t in lanes]) == 1
                for k1 in (0, ca - 1):
                    push = [(_row_home(t // own_c + cb * k1, col_len, c),
                             rank * own_c + t % own_c) for t in lanes]
                    for dst in {owner for (owner, _), _ in push}:
                        addrs = [slot * ldr + col if owner == dst else None
                                 for (owner, slot), col in push]
                        assert _ways(addrs) == 1
                        runs = sorted(a for a in addrs if a is not None)
                        assert sum(b != a + 1 for a, b in zip(runs, runs[1:])) <= 1
            if t0 < own_r * ra:
                for j2 in (0, rb - 1):
                    assert _ways([t % own_r * ldr + t // own_r + ra * j2 for t in lanes]) == 1
                assert _ways([t % own_r * ldr + rb // 2 * (ra + 1) + t // own_r
                              for t in lanes]) == 1
            if t0 < own_r * rb:
                assert _ways([t % own_r * ldr + t // own_r * (ra + 1) + 1 for t in lanes]) == 1
            if t0 < nt:
                for k1 in (0, cols // 2 - 1):
                    assert _ways([t % own_r * ldr + pos_r(k1 + t // own_r) for t in lanes]) == 1
                    partner = []
                    for t in lanes:
                        sf = t % own_r
                        row = rows[sf]
                        g = sf if row in (0, col_len // 2) else sf ^ (own_r // 2)
                        q = (cols if row == 0 else cols - 1) - (k1 + t // own_r)
                        # bin 0 (DC and Nyquist) reads no partner
                        partner.append(None if q == cols else g * ldr + pos_r(q))
                    # row 0 reads bin L - k1, one off its neighbours' L-1-k1
                    limit = 2 if any(rows[t % own_r] == 0 for t in lanes) else 1
                    assert _ways(partner) <= limit
        # The paired unpack (kLoadUnpack): slot f holds column col_of(f).
        slots = _onepass_slots(rank, cols, c)
        for t0 in range(0, own_c * ca, 32):
            lanes = range(t0, t0 + 32)
            for j2 in (0, cb - 1):
                assert _ways([t % own_c * ldc + t // own_c + ca * j2 for t in lanes]) == 1
                js = [t // own_c + ca * j2 for t in lanes]
                assert len({j * (256 // col_len) for j in js}) == 1  # W_512: one entry
                partner = []
                for t, j in zip(lanes, js):
                    f = t % own_c
                    col = slots[f]
                    g = _onepass_partner(f, col, cols, c)
                    # bin 0 (DC and Nyquist) reads no partner
                    partner.append(None if col == 0 and j == 0 else
                                   g * ldc + (col_len - j if col == 0 else col_len - 1 - j))
                limit = 2 if any(slots[t % own_c] == 0 for t in lanes) else 1
                assert _ways(partner) <= limit
        for t0 in range(0, own_c * cb, 32):
            lanes = range(t0, t0 + 32)
            for k1 in (0, ca - 1):
                push = [(_row_home(t // own_c + cb * k1, col_len, c), slots[t % own_c])
                        for t in lanes]
                for dst in {owner for (owner, _), _ in push}:
                    addrs = [slot * ldr + col if owner == dst else None
                             for (owner, slot), col in push]
                    assert _ways(addrs) == 1
                    runs = sorted(a for a in addrs if a is not None)
                    assert sum(b != a + 1 for a, b in zip(runs, runs[1:])) <= 2


# -----------------------------------------------------------------------------
# K5's middle phase (csrc/fastfir_chain.cu chain_mid): its plan, the
# cluster's H index map and the chunked MAC with the offline lag skip

# Lags whose ring and H a block holds in shared memory, by row length L.
CHAIN_SMEM_LAGS = {64: 103, 128: 47, 256: 22}


@pytest.mark.parametrize("t", [2, 16, 40])
@pytest.mark.parametrize("p", [1, 15, 22, 23, 47, 48, 103, 104])
@pytest.mark.parametrize("lm", range(13, 17))
def test_chain_plan_every_size(lm, p, t):
    """N = 2^14..2^17 at P up to and past the global-ring threshold: rows
    of L = M1 points (the two-pass split), R/2 row pairs a channel in
    clusters of CHAIN_CLUSTER, chunks of as many rows as the row DFTs keep 256 threads
    busy (L/16 threads a row, at most 32 rows), shared memory inside a
    block's 227 KB with ring and H in it up to CHAIN_SMEM_LAGS."""
    n = 1 << (lm + 1)
    plan = hopper_fft._chain_plan(n, p, t)
    col_len, row_len = hopper_fft._plan(n).lengths
    assert (plan.row_len, plan.rows) == (row_len, col_len)
    assert plan.pairs * 2 == plan.rows and plan.pairs % hopper_fft.CHAIN_CLUSTER == 0
    assert plan.chunk_rows * (row_len // 16) <= 256 and plan.chunk_rows in (16, 32)
    assert plan.chunks == -(-t // (plan.chunk_rows // 2))
    assert plan.ring_in_smem == (p <= CHAIN_SMEM_LAGS[row_len])
    assert plan.shared_bytes <= hopper_fft.SMEM_BLOCK_MAX
    ring = 8 * 4 * p * row_len if plan.ring_in_smem else 0
    tile = 8 * plan.chunk_rows * (row_len + row_len // 16)
    assert plan.shared_bytes == plan.tiles * tile + 8 * 5 * row_len + ring
    assert 1 <= plan.blocks_per_sm <= 2
    assert plan.tiles == 1 or plan.chunks > 1


@pytest.mark.parametrize("n,p,t,tiles,per_sm", [
    (1 << 16, 15, 16, 1, 2),   # the main path: one chunk
    (1 << 16, 15, 40, 1, 2),   # two blocks share an SM
    (1 << 16, 8, 40, 1, 2),
    (1 << 16, 18, 40, 1, 2),
    (1 << 16, 19, 40, 2, 1),   # a block has its SM to itself
    (1 << 16, 25, 40, 2, 1),
    (1 << 16, 25, 16, 1, 1),   # one chunk
    (1 << 16, 39, 40, 1, 1),   # a second tile does not fit
    (1 << 16, 60, 40, 1, 2),   # ring and H in the global scratch
    (1 << 14, 5, 37, 1, 2),
    (1 << 14, 47, 37, 2, 1),
    (1 << 17, 4, 40, 1, 2),
    (1 << 17, 8, 40, 1, 2),
    (1 << 17, 9, 19, 2, 1),
    (1 << 17, 9, 9, 2, 1),     # two chunks, the second of one hop
    (1 << 17, 22, 9, 1, 1),
])
def test_chain_plan_double_buffers(n, p, t, tiles, per_sm):
    """A second FFT tile (the next chunk's rows in flight while this chunk
    computes) where a launch has more than one chunk and a block has its SM
    to itself with one tile, so that no other block covers its row loads;
    ring and H stay in shared memory by the one-tile size."""
    plan = hopper_fft._chain_plan(n, p, t)
    assert (plan.tiles, plan.blocks_per_sm) == (tiles, per_sm)
    assert plan.ring_in_smem == hopper_fft._chain_plan(n, p, 1).ring_in_smem


def _row_copies(chunks, tiles):
    """The order of chain_mid's chunk loop as a list of events: ("copy", c,
    tile) when chunk c's rows are requested, ("wait", k) for
    cp.async.wait_group k (each copy_rows is one group), ("use", c, tile)
    for chunk c's work on a tile from its forward row pass to its store."""
    ev = [("copy", 0, 0)]
    for ci in range(chunks):
        tile = ci % tiles
        if tiles == 1 and ci > 0:
            ev.append(("copy", ci, 0))
        ev.append(("wait", 0))
        if tiles == 2 and ci + 1 < chunks:
            ev.append(("copy", ci + 1, (ci + 1) % 2))
        ev.append(("use", ci, tile))
    return ev


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("chunks", [1, 2, 3, 6])
def test_chain_row_copies_land_before_use(chunks, tiles):
    """Replays the chunk loop's copies and waits: every chunk's rows are
    requested once, into the tile its work uses, have landed when its work
    starts (a wait leaves at most k groups in flight, the newest), no copy
    goes to a tile whose rows are still to be used or still in flight, and
    no copy in flight lands in the tile of the chunk at work; with two
    tiles the next chunk's rows are in flight during each chunk but the
    last."""
    in_flight = []          # (chunk, tile), oldest first
    landed = {}             # tile -> chunk whose rows it holds, not yet used
    copied = []
    overlapped = 0
    for ev in _row_copies(chunks, tiles):
        if ev[0] == "copy":
            assert ev[2] not in landed and all(t != ev[2] for _, t in in_flight)
            in_flight.append(ev[1:])
            copied.append(ev[1])
        elif ev[0] == "wait":
            while len(in_flight) > ev[1]:
                c, tile = in_flight.pop(0)
                landed[tile] = c
        else:
            c, tile = ev[1:]
            assert landed.pop(tile) == c
            assert all(t != tile for _, t in in_flight)
            overlapped += bool(in_flight)
    assert copied == list(range(chunks))
    assert overlapped == (chunks - 1 if tiles == 2 else 0)


def test_chain_plan_main_path():
    """The main path (N = 2^16, P = 15, T = 16): one chunk of 32 rows, ring
    and H in shared memory, two blocks an SM; a single 2^17 section at
    P = 8 also keeps two blocks an SM."""
    main = hopper_fft._chain_plan(1 << 16, 15, 16)
    assert (main.chunk_rows, main.chunks, main.ring_in_smem, main.tiles,
            main.blocks_per_sm) == (32, 1, True, 1, 2)
    assert hopper_fft._chain_plan(1 << 17, 8, 2).blocks_per_sm == 2


def _cluster_bin(i, row_len, p, rows, j0, rank):
    """csrc/fastfir_chain.cu cluster_bin: (owner rank, row, lag, bin) of
    index i, or None for the row no run holds (block 0's R/2)."""
    g = hopper_fft.CHAIN_CLUSTER
    q = row_len // g
    rr = i % g
    rest = i // g
    k1 = rank * q + rest % q
    rest //= q
    lag, side = rest % p, rest // p
    tb = rr if side == 0 else g - 1 - rr
    row = j0 + rr if side == 0 else rows - j0 - (g - 1) + rr
    if side == 1 and j0 + tb == 0:
        return None
    return tb, row, lag, side * row_len + k1


@pytest.mark.parametrize("lm,p", [(13, 3), (14, 2), (15, 1)])
def test_chain_h_copies_land_once_in_their_owners(lm, p):
    """Every (lag, bin) of a channel's H is read by exactly one block of one
    cluster and lands in the slot lag * 2L + side * L + k1 of the block that
    owns its row (row j or R - j of pair j; pair 0 rows 0 and R/2, the
    latter moved by block 0 itself); a block of a cluster of G reads its
    1/G of the columns k1, each (side, lag, k1) as a run of G consecutive
    floats (side 0 aligned to G floats; side 1 runs R-j0-G+1..R-j0, G - 1
    floats at pair 0)."""
    m = 1 << lm
    row_len = hopper_fft._chain_plan(2 * m, p, 1).row_len
    rows = m // row_len
    pairs = rows // 2
    nb = 2 * row_len
    owner = {}
    for j in range(pairs):
        owner[j] = (j, 0)
        owner[rows // 2 if j == 0 else rows - j] = (j, 1)
    landed = np.zeros((pairs, p * nb), int)
    read = np.zeros(p * m, int)
    g = hopper_fft.CHAIN_CLUSTER
    for j in range(pairs):
        rank, j0 = j % g, j - j % g
        runs = {}
        for i in range(2 * p * row_len):
            got = _cluster_bin(i, row_len, p, rows, j0, rank)
            if got is None:
                continue
            tb, row, lag, b = got
            k1 = b % row_len
            assert rank * row_len // g <= k1 < (rank + 1) * row_len // g
            o = lag * m + row + rows * k1
            read[o] += 1
            runs.setdefault((b // row_len, lag, k1), []).append(o)
            dest, side = owner[row]
            assert dest == j0 + tb and side == b // row_len
            landed[dest, lag * nb + b] += 1
        if j == 0:
            for lag in range(p):
                for k1 in range(row_len):
                    read[lag * m + pairs + rows * k1] += 1
                    landed[0, lag * nb + row_len + k1] += 1
        for (side, _, _), offs in runs.items():
            offs = sorted(offs)
            assert offs == list(range(offs[0], offs[0] + len(offs)))
            assert len(offs) == g or (side == 1 and j0 == 0 and len(offs) == g - 1)
            if side == 0:
                assert offs[0] % g == 0
    assert (read == 1).all() and (landed == 1).all()


def _mac_term(v, h, lane0):
    return complex(v.real * h.real, v.imag * h.imag) if lane0 else v * h


def _chain_mac_model(x, h):
    """chain_mid's MAC in float64, chunk by chunk and bin by bin as the
    kernel runs it: x (T, K) hop spectra, h (P, K); the ring starts as NaN
    (never zero-filled: a read of a slot that holds nothing yet shows in the
    output). Returns Y (T, K)."""
    t, k = x.shape
    p = h.shape[0]
    buf = np.full((p, k), np.nan + 1j * np.nan)
    y = np.zeros((t, k), complex)
    for t0 in range(0, t, 8):
        tc = min(8, t - t0)
        lag_end = max(0, min(p, t0 + tc - 1))
        for b in range(k):
            xs = [x[t0 + i, b] if i < tc else 0j for i in range(8)]
            acc = [0j] * 8
            slot = (t0 - 1) % p if p else 0
            win = [buf[slot, b] if lag_end > 0 and t0 >= 1 else 0j] + xs[:7]
            for lag in range(lag_end):
                for i in range(8):
                    acc[i] += _mac_term(win[i], h[lag, b], b == 0)
                win = win[:1] + win[:7]
                slot = p - 1 if slot == 0 else slot - 1
                if lag + 1 < lag_end:
                    win[0] = buf[slot, b] if t0 - 2 - lag >= 0 else 0j
            for i in range(tc):
                buf[(t0 + i) % p, b] = xs[i]
                y[t0 + i, b] = acc[i]
    return y


def _planes(z):
    return torch.from_numpy(np.ascontiguousarray(z.real)), torch.from_numpy(
        np.ascontiguousarray(z.imag))


@pytest.mark.parametrize("t,p", [(1, 3), (5, 7), (8, 8), (9, 15), (16, 15), (21, 4), (17, 20)])
def test_chain_offline_mac_skips_lags_before_hop_0(t, p):
    """Offline, the chunked MAC with lags before hop 0 skipped and no zero
    ring equals the causal MAC (lag_mac_causal_plain) to 1e-12."""
    rng = np.random.default_rng(t * 100 + p)
    k = 6
    x = rng.standard_normal((t, k)) + 1j * rng.standard_normal((t, k))
    h = rng.standard_normal((p, k)) + 1j * rng.standard_normal((p, k))
    got = _chain_mac_model(x, h)
    want = hopper_kernels.lag_mac_causal_plain(*_planes(x[None]), *_planes(h[None]))
    want = want[0][0].numpy() + 1j * want[1][0].numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("t,p", [(3, 5), (12, 4), (17, 9)])
def test_chain_offline_model_matches_fastfir_chain_plain(t, p):
    """The whole offline chain with the model's MAC in place of the causal
    MAC: packed forward of [x[t-1] | x[t]], the chunked MAC (lags before hop
    0 skipped), the tail inverse; equals fastfir_chain_plain in float64."""
    rng = np.random.default_rng(t + 7 * p)
    hop = 32
    n = 2 * hop
    x2d = torch.from_numpy(rng.standard_normal((1, t, hop)))
    h_re, h_im = (torch.from_numpy(rng.standard_normal((1, p, hop))) for _ in range(2))
    scale = 1.0 / (4.0 * n)
    x_re, x_im = hopper_fft.rfft_packed_stream_plain(x2d)
    y = _chain_mac_model(x_re[0].numpy() + 1j * x_im[0].numpy(),
                         h_re[0].numpy() + 1j * h_im[0].numpy())
    got = hopper_fft.rifft_packed_tail_plain(*(v[None] for v in _planes(y)), scale)
    want = hopper_fft.fastfir_chain_plain(x2d, h_re, h_im, scale)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))


# -----------------------------------------------------------------------------
# The long routes at M = 2^17..2^28 (csrc/fft_large.cuh fft_cols_long /
# fft_rows_long): the plan mirror, the three-pass route's index maps and
# twiddle exponents, K14's paired unpack, and the float32 error of the
# twiddles the kernels form from two factors

TILE = 16  # kTile: sub-FFTs a block

# (route, lengths by pass, HBM passes, scratch frames) for complex M = 2^lm.
LONG_PLAN = {
    17: ("cluster", (512, 256), 1, 0),
    18: ("two-pass-long", (512, 512), 2, 1),
    19: ("two-pass-long", (512, 1024), 2, 1),
    20: ("two-pass-long", (1024, 1024), 2, 1),
    21: ("three-pass", (128, 128, 128), 3, 1),
    22: ("three-pass", (256, 128, 128), 3, 1),
    23: ("three-pass", (256, 256, 128), 3, 1),
    24: ("three-pass", (256, 256, 256), 3, 1),
    25: ("three-pass", (512, 256, 256), 3, 1),
    26: ("three-pass", (512, 512, 256), 3, 1),
    27: ("three-pass", (512, 512, 512), 3, 1),
    28: ("three-pass", (1024, 512, 512), 3, 1),
}


def _ab(length):
    """Sub<L>: the step-2 and step-1 DFT sizes A = 2^(log2 L // 2), B = L / A."""
    a = 1 << (length.bit_length() - 1) // 2
    return a, length // a


def _smem_cols(length, unpack):
    """LongTile<L>::smem_cols: the tile, W_L, the slots' twiddle factors and
    the unpack's W_2L and W_N^col."""
    a, b = _ab(length)
    return 8 * (TILE * (length + 1) + length + TILE * (b + 1) + TILE * (a + 1)
                + (length + TILE if unpack else 0))


def _smem_rows(length, pack):
    return 8 * (TILE * (length + 1) + length + (length + TILE if pack else 0))


@pytest.mark.parametrize("lm", range(17, 29))
def test_long_plan_every_size(lm):
    """make_plan's mirror at M = 2^17..2^28 (real N = 2^18..2^28, complex up
    to 2^28): the lengths multiply to M, each 128..1024; every column pass
    has whole tiles of 16 columns and every row pass whole tiles of 16 rows
    (8 row pairs with the pack); a block's shared memory fits the 227 KB a
    block may use (two blocks an SM at L = 512); one scratch frame; and the
    passes' grids stay below 2^31 blocks at 2^31 / (8 M) frames."""
    m = 1 << lm
    plan = hopper_fft._plan(2 * m)
    assert plan == LONG_PLAN[lm]
    assert math.prod(plan.lengths) == m
    if plan.route == "cluster":
        return
    assert all(128 <= length <= 1024 for length in plan.lengths)
    first, last = plan.lengths[0], plan.lengths[-1]
    r1 = m // first
    assert r1 % TILE == 0 and (m // last) % (2 * TILE) == 0
    if plan.route == "three-pass":
        assert last % TILE == 0  # the middle pass: L3 columns in whole tiles
    for length in plan.lengths:
        for smem in (_smem_cols(length, True), _smem_rows(length, True)):
            assert smem <= SHARED_BYTES_MAX
            if length == 512:
                assert 2 * (smem + 1024) <= 228 * 1024
    frames = max(1, (1 << 31) // (8 * m))
    assert frames * r1 // TILE < 2 ** 31 and frames * (m // last) // TILE < 2 ** 31
    assert tuple(hopper_fft._scratch(2, m, torch.device("meta")).shape) == (2, 2 * m)


def test_no_twiddle_table_above_2_18():
    """The long routes read the 2048-entry table, never one of N entries:
    _twiddles refuses to build one above real N = 2^18."""
    with pytest.raises(ValueError, match="_large_twiddles"):
        hopper_fft._twiddles(1 << 19, torch.device("meta"))
    assert hopper_fft._large_twiddles(1 << 18, torch.device("cpu")).shape == (1 << 18, 2)
    for n in (1 << 19, 1 << 21, 1 << 28):
        assert hopper_fft._large_twiddles(n, torch.device("cpu")).shape == (2048, 2)


def _slot_cols(tile, ncol, slots=TILE):
    """slot_col<true>: the columns of column tile `tile` (the cluster's
    block `tile` with ``slots`` = 32) under the unpack, the pairs of
    pack_row_of."""
    return [_pack_row_of(slots // 2, tile, f, ncol) for f in range(slots)]


def _col_pass(z, ncol, length):
    """fft_cols_long over the frames z (F, m), m = ncol * L: Y[k*ncol + col]
    = W_m^(col*k) FFT_L(column col)[k], with the twiddle as the kernels form
    it, W_m^(col*k2) W_m^(col*B*k1) for k = k2 + B*k1 (both exponents
    reduced mod m). Which block computes a column does not change Y."""
    f, m = z.shape
    a, b = _ab(length)
    cols = np.arange(ncol)
    sub = _sub_fft(z[:, cols[:, None] + ncol * np.arange(length)[None, :]])  # (F, ncol, L)
    k = np.arange(length)
    tw = (_w(m, (cols[:, None] * (k % b)[None, :]) % m)
          * _w(m, (cols[:, None] * b * (k // b)[None, :]) % m))
    y = np.empty((f, m), complex)
    y[:, k[None, :] * ncol + cols[:, None]] = sub * tw
    return y


def _row_map(rows, l1):
    """fft_rows_long's memory row of row j: (j % L1) * (R / L1) + j // L1."""
    j = np.arange(rows)
    return (j % l1) * (rows // l1) + j // l1


def _three_pass(z, lengths, pack=False):
    """The three-pass route on one frame z (M points): the column pass, the
    middle column pass in place over the L1 rows of R1 = L2*L3 points, then
    the rows through the row map (natural Z, or the packed bins with the
    pack's tiles of 16 row slots)."""
    l1, l2, l3 = lengths
    m = z.size
    r1 = m // l1
    y = _col_pass(z[None], r1, l1)[0]
    y = _col_pass(y.reshape(l1, r1), l3, l2).reshape(m)
    rows = l1 * l2
    mem = _row_map(rows, l1)
    if not pack:
        out = np.empty(m, complex)
        out[np.arange(rows)[:, None] + rows * np.arange(l3)[None, :]] = _sub_fft(
            y.reshape(rows, l3)[mem])
        return out
    res = np.empty(m, complex)
    for tile in range(rows // TILE):
        rows_of = [_pack_row_of(TILE // 2, tile, f, rows) for f in range(TILE)]
        slots = _sub_fft(y.reshape(rows, l3)[mem[rows_of]])
        for k, v in _pack_tile(slots, rows_of, rows, m).items():
            res[k] = v
    return res


@pytest.mark.parametrize("lengths", [(8, 16, 16), (16, 16, 16), (32, 16, 16), (16, 32, 16)])
@pytest.mark.parametrize("pack", [False, True])
def test_three_pass_model_matches_numpy(lengths, pack):
    """The three-pass route's index maps and twiddle exponents at stand-in
    sizes (16-column tiles and 16-row pack tiles, as in the kernels): Z
    against np.fft.fft, the packed bins against the packed rfft, to 1e-12."""
    m = math.prod(lengths)
    x, z = _signal(m, seed=sum(lengths) + pack)
    got = _three_pass(z, lengths, pack)
    assert _close(got, _packed_ref(x) if pack else np.fft.fft(z))


def test_three_pass_model_at_2_21():
    """The same at the plan's own lengths for complex M = 2^21 (128^3)."""
    lengths = hopper_fft._plan(1 << 22).lengths
    _, z = _signal(1 << 21, seed=21)
    assert _close(_three_pass(z, lengths), np.fft.fft(z))


def _unpack_ref(p):
    """conj(Z'[idx]) of packed bins p (M,), as load_elem<kLoadUnpack> forms
    it from P[idx] and P[M - idx]."""
    m = p.size
    idx = np.arange(m)
    q = np.conj(p[(m - idx) % m])
    zp = (p + q) + 1j * np.conj(_w(2 * m, idx)) * (p - q)
    zp[0] = complex(p[0].real + p[0].imag, p[0].real - p[0].imag)
    return np.conj(zp)


def _unpack_tiles(p, ncol, length, slots=TILE):
    """unpack_pairs over one frame of packed bins p (M = ncol * L), tile by
    tile: a tile loads the bins of its slot columns (pack_row_of pairs)
    once into its tile and reads each partner from that tile (row L-1-j of
    the partner slot; column 0: row L-j of its own), W_N^idx = W_N^col
    W_2L^j. Returns conj(Z') and how often each bin was loaded."""
    m = ncol * length
    out = np.empty(m, complex)
    loads = np.zeros(m, int)
    j = np.arange(length)
    wj = _w(2 * length, j)
    for tile in range(ncol // slots):
        cols = _slot_cols(tile, ncol, slots)
        idx = np.array(cols)[:, None] + ncol * j[None, :]
        s = p[idx]  # the tile: each bin of the slots once
        np.add.at(loads, idx.ravel(), 1)
        for f, col in enumerate(cols):
            g = f if col in (0, ncol // 2) else f ^ (slots // 2)
            assert cols[g] == (ncol - col) % ncol  # the partner is in this tile
            q = np.conj(s[g, (length - j) % length if col == 0 else length - 1 - j])
            w = _w(2 * m, col) * wj
            zc = np.conj((s[f] + q) + 1j * np.conj(w) * (s[f] - q))
            if col == 0:
                zc[0] = complex(s[f, 0].real + s[f, 0].imag, -(s[f, 0].real - s[f, 0].imag))
            out[idx[f]] = zc
    return out, loads


@pytest.mark.parametrize("lm", [17, 18, 19, 20, 21])
def test_paired_unpack_reads_each_bin_once(lm):
    """K14's first pass at the plan's own lengths (the cluster's 8 blocks of
    32 slots at M = 2^17; tiles of 16 slots above): every packed bin is
    loaded once, its partner sits in the same tile, and the unpacked values
    equal load_elem<kLoadUnpack>'s, to 1e-12."""
    m = 1 << lm
    plan = hopper_fft._plan(2 * m)
    length = plan.lengths[0]
    rng = np.random.default_rng(lm)
    p = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    got, loads = _unpack_tiles(p, m // length, length, 32 if lm == 17 else TILE)
    assert (loads == 1).all()
    assert _close(got, _unpack_ref(p))


@pytest.mark.parametrize("lengths", [(512, 512), (16, 16, 16)])
def test_paired_unpack_inverse_matches_numpy(lengths):
    """The whole K14 model: the paired unpack, then the forward passes (two
    at M = 2^18's 512 x 512, three at a stand-in size), conj(Z[k]) as
    samples (2k, 2k+1): equals the unscaled inverse N * irfft, to 1e-12."""
    m = math.prod(lengths)
    rng = np.random.default_rng(m)
    re, im = rng.standard_normal((2, m))
    c, _ = _unpack_tiles(re + 1j * im, m // lengths[0], lengths[0])
    if len(lengths) == 3:
        z = _three_pass(c, lengths)
    else:
        z = _long_route(c, lengths[0], TILE // 2, lengths[0], False)
    got = np.empty(2 * m)
    got[0::2], got[1::2] = z.real, -z.imag
    full = np.concatenate([re, im[:1]]) + 1j * np.concatenate([[0.0], im[1:], [0.0]])
    assert _close(got, np.fft.irfft(full, 2 * m) * 2 * m)


def _cmul32(a, b):
    """The kernels' cmul in float32 (each product and sum rounded)."""
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    br, bi = b.real.astype(np.float32), b.imag.astype(np.float32)
    return (ar * br - ai * bi).astype(np.float64) + 1j * (ar * bi + ai * br).astype(np.float64)


def _f32(w):
    return w.real.astype(np.float32) + 1j * w.imag.astype(np.float32)


@pytest.mark.parametrize("lm", [20, 27])
def test_twiddle_factors_error(lm):
    """The twiddles the long routes form from two float32 factors, each
    rounded once from float64, over sampled exponents at M = 2^lm: the
    first pass's W_M^(c*k) = W_M^(c*k2) W_M^(c*B*k1), the middle pass's
    W_R1, and the unpack's and the pack's W_N^idx = W_N^c W_2L^j. Their worst
    error against float64 stays within 2^-22 (four float32 roundings of 1);
    one rounded entry is within 2^-24."""
    m = 1 << lm
    plan = hopper_fft._plan(2 * m)
    rng = np.random.default_rng(lm)
    worst = 0.0
    lengths = plan.lengths
    frames = [(m, lengths[0])] + ([(m // lengths[0], lengths[1])] if len(lengths) == 3 else [])
    for size, length in frames:
        _, b = _ab(length)
        c = rng.integers(0, size // length, 200000)
        k = rng.integers(0, length, 200000)
        got = _cmul32(_f32(_w(size, (c * (k % b)) % size)),
                      _f32(_w(size, (c * b * (k // b)) % size)))
        worst = max(worst, np.abs(got - _w(size, (c * k) % size)).max())
    length = lengths[0]
    c = rng.integers(0, m // length, 200000)
    j = rng.integers(0, length, 200000)
    w2048 = _f32(_w(2048, np.arange(2048)))
    got = _cmul32(_f32(_w(2 * m, c)), w2048[j * (1024 // length)])
    worst = max(worst, np.abs(got - _w(2 * m, c + (m // length) * j)).max())
    assert worst <= 2.0 ** -22
    assert np.abs(w2048 - _w(2048, np.arange(2048))).max() <= 2.0 ** -24


# -----------------------------------------------------------------------------
# The real inverse on the one-pass route (K4 rifft_packed_tail, K6
# rifft_packed, K8's inverse: fft_onepass with kLoadUnpack and kStoreTail /
# kStoreFull on K1's plan): the paired unpack of its column stage, the
# exchange of the paired columns and the two stores


def _onepass_slots(rank, cols, blocks):
    """fft_onepass's col_of with the unpack: block ``rank``'s column slots,
    slot f column f on one block, pack_row_of<M1/C/2>(rank, f) on a
    cluster."""
    own = cols // blocks
    if blocks == 1:
        return list(range(cols))
    return [_pack_row_of(own // 2, rank, f, cols) for f in range(own)]


def _onepass_partner(f, col, cols, blocks):
    """The slot that holds column M1 - col's bins, as fft_onepass finds it."""
    if blocks == 1:
        return (cols - f) & (cols - 1)
    return f if col in (0, cols // 2) else f ^ (cols // blocks // 2)


def _onepass_unpack(p, cols, blocks):
    """The paired unpack of fft_onepass's column stage over one frame of
    packed bins p (M = M1 * M2, M1 = ``cols``): each block loads the bins of
    its slots' columns once into its column tiles and reads each partner
    P[M - idx] from them (row M2-1-j of the partner slot; column 0: row
    M2 - j of its own), W_N^idx = W_N^col * W_512^(j*256/M2). Returns the
    tiles of conj(Z') (blocks, slots, M2) and how often each bin was
    loaded."""
    m = p.size
    length = m // cols
    own = cols // blocks
    loads = np.zeros(m, int)
    j = np.arange(length)
    wj = _w(512, j * (256 // length))
    out = np.empty((blocks, own, length), complex)
    for r in range(blocks):
        slots = _onepass_slots(r, cols, blocks)
        idx = np.array(slots)[:, None] + cols * j[None, :]
        tile = p[idx]
        np.add.at(loads, idx.ravel(), 1)
        for f, col in enumerate(slots):
            g = _onepass_partner(f, col, cols, blocks)
            assert slots[g] == (cols - col) % cols  # the partner is in this block
            q = np.conj(tile[g, (length - j) % length if col == 0 else length - 1 - j])
            w = _w(2 * m, col) * wj
            zc = np.conj((tile[f] + q) + 1j * np.conj(w) * (tile[f] - q))
            if col == 0:
                zc[0] = complex(tile[f, 0].real + tile[f, 0].imag,
                                -(tile[f, 0].real - tile[f, 0].imag))
            out[r, f] = zc
    return out, loads


def _onepass_inverse(p, cols, blocks):
    """The whole inverse on the one-pass route over one frame of packed bins
    p: the paired unpack, each slot's column FFT times W_M^(col*k) stored at
    element col of row k's tile in the block row_home names, the rows'
    FFTs, and conj(Z[k]) as the samples (2k, 2k+1). Returns the 2M samples
    of the unscaled inverse (kStoreFull; kStoreTail keeps the last M)."""
    m = p.size
    rows = m // cols
    own_r = rows // blocks
    cz, loads = _onepass_unpack(p, cols, blocks)
    assert (loads == 1).all()
    tiles = np.full((blocks, own_r, cols), np.nan, complex)
    k = np.arange(rows)
    for r in range(blocks):
        for f, col in enumerate(_onepass_slots(r, cols, blocks)):
            out = _sub_fft(cz[r, f]) * _tw_m(m, (col * k) % m, 512)
            for kk in range(rows):
                owner, slot = _row_home(kk, rows, blocks)
                assert np.isnan(tiles[owner, slot, col])
                tiles[owner, slot, col] = out[kk]
    assert not np.isnan(tiles).any()  # the rows find every column
    z = np.empty(m, complex)
    for r in range(blocks):
        for f in range(own_r):
            z[_pack_row_of(own_r // 2, r, f, rows) + rows * np.arange(cols)] = _sub_fft(tiles[r, f])
    samples = np.empty(2 * m)
    samples[0::2], samples[1::2] = z.real, -z.imag
    return samples


def _irfft_ref(p):
    """The unscaled inverse N * irfft of packed bins p (2N x of rfft)."""
    m = p.size
    full = (np.concatenate([p.real, p.imag[:1]])
            + 1j * np.concatenate([[0.0], p.imag[1:], [0.0]]))
    return np.fft.irfft(full, 2 * m) * 2 * m


@pytest.mark.parametrize("lm", range(11, 17))
def test_onepass_unpack_reads_each_bin_once(lm):
    """The paired unpack at every K1 plan (M = 2^11..2^16 on 1, 1, 1, 2, 4
    and 8 blocks): every column sits in one slot of one block, every packed
    bin is loaded once, its partner sits in the same block's tiles, and the
    unpacked values equal the unpaired loader's conj(Z'), to 1e-12."""
    m = 1 << lm
    plan = hopper_fft._onepass_plan(2 * m)
    cols, blocks = plan.lengths[1], plan.blocks
    seen = sorted(c for r in range(blocks) for c in _onepass_slots(r, cols, blocks))
    assert seen == list(range(cols))
    rng = np.random.default_rng(lm)
    p = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    cz, loads = _onepass_unpack(p, cols, blocks)
    assert (loads == 1).all()
    got = np.empty(m, complex)
    for r in range(blocks):
        for f, col in enumerate(_onepass_slots(r, cols, blocks)):
            got[col + cols * np.arange(m // cols)] = cz[r, f]
    assert _close(got, _unpack_ref(p))


@pytest.mark.parametrize("store", ["full", "tail"])
@pytest.mark.parametrize("lm", range(11, 17))
def test_onepass_inverse_matches_numpy_at_k1_sizes(lm, store):
    """K6's full store and K4's tail store on the one-pass route at every K1
    plan: the unscaled inverse N * irfft of the packed bins, and its kept
    half [M, 2M) times the overlap-save scale 1/(4N), to 1e-12."""
    m = 1 << lm
    plan = hopper_fft._onepass_plan(2 * m)
    rng = np.random.default_rng(lm + 100)
    re, im = rng.standard_normal((2, m))
    got = _onepass_inverse(re + 1j * im, plan.lengths[1], plan.blocks)
    want = _irfft_ref(re + 1j * im)
    if store == "tail":
        scale = 1.0 / (8.0 * m)
        got, want = got[m:] * scale, want[m:] * scale
    assert _close(got, want)


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1 << 8, 1 << 10])
def test_onepass_inverse_matches_numpy_small(m, blocks):
    """The same index maps at small M over C = 1, 2, 4 and 8 blocks."""
    cols = 1 << (m.bit_length() - 1) // 2
    rng = np.random.default_rng(m + blocks)
    re, im = rng.standard_normal((2, m))
    assert _close(_onepass_inverse(re + 1j * im, cols, blocks), _irfft_ref(re + 1j * im))


def test_onepass_inverse_round_trip():
    """rifft(rfft(x)) = 2N x through the one-pass forward's model and the
    inverse's, at K1's plan of M = 2^14 (a 2-block cluster)."""
    plan = hopper_fft._onepass_plan(1 << 15)
    x, z = _signal(1 << 14, seed=14)
    p = _cluster_route(z, plan.lengths[1], plan.blocks, True, split=512, push=True)
    got = _onepass_inverse(p, plan.lengths[1], plan.blocks)
    assert _close(got, 2 * x.size * x)
