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

Each sub-FFT runs the kernels' in-block four-step (a B-point DFT over
j2 of elements j1 + A*j2, the twiddle W_L^(j1*k2), an A-point DFT giving
k = k2 + B*k1). The model matches ``np.fft.fft`` and the packed ``rfft`` to
1e-12 relative to the largest output; the kernels themselves are held
against their plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

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


@pytest.mark.parametrize("n", [1 << 10, 3 << 12, 1 << 21])
def test_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="2\\^11..2\\^19"):
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


def _cluster_route(z, cols, blocks, pack):
    """The cluster route on one frame: `cols` columns of M/cols points, block
    r owning columns r*cols/blocks.. in its own memory (lsm[r][f][k2]), then
    2*h = R/blocks row slots a block, each gathered from the owners."""
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
            lsm[r, f] = _sub_fft(z[col + cols * np.arange(col_len)]) * _w(m, col * k)
    res = np.empty(m, complex)
    for r in range(blocks):                        # 2-3. gather, rows, store
        rows_of = ([_pack_row_of(own_r // 2, r, f, rows) for f in range(own_r)] if pack
                   else [r * own_r + f for f in range(own_r)])
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
