"""K8's split chain (``csrc/fastfir_stream.cu``) on the CPU: its plan mirror
and a float64 numpy model of its index maps.

The card runs K8 as three launches: the forward of every frame [x[t-1] |
x[t]] on K1's one-pass route with the halves read in place
(``kLoadStreamPrev``), the state kernel (the ring MAC of ``csrc/ring_mac.cu``,
shared with K7 and K15) over contiguous bin ranges, and the inverse on the one-pass route with the unpack in its loader
and K4's tail store (``kStoreTail``). No CUDA runs here, so the tests hold
the Python mirror of the plan (``hopper_fft._stream_plan``) to the kernel's
rules and replay the kernels' index arithmetic in numpy: the state kernel's
item stream (which row each item copies, in which order, and where the new
ring's slots come from), its MAC with the bin-0 lane, the loader's two
source pointers and the tail store's output map. Tolerances: 1e-12 relative
in float64 (the model and the plain versions differ only in the order of
sums); index maps are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402

TOL = 1e-12
SHARED_BYTES_MAX = 227 * 1024  # a block's shared memory on the H100
STATIC_SHARED_MAX = 48 * 1024  # without the opt-in for dynamic shared memory
ONEPASS_BLOCKS = {13: 1, 14: 2, 15: 4, 16: 8}


@pytest.mark.parametrize("t", [1, 2, 4, 15, 16, 17, 40])
@pytest.mark.parametrize("p", [1, 3, 8, 14])
@pytest.mark.parametrize("lm", range(13, 17))
def test_stream_plan_every_shape(lm, p, t):
    """The split form at N = 2^14..2^17: both transforms on K1's one-pass
    route (one block a frame at 2^14, clusters of 2 / 4 / 8 above, shared
    memory inside a block's 227 KB); the state kernel on blocks of 256 bins
    that tile a channel, chunks of the least power of two >= min(T, 16)
    hops, the X rows two an item and P (H, V) pairs a chunk, 8 stages in static shared
    memory with a full and an empty mbarrier each (the ring MAC's plan)."""
    n = 1 << (lm + 1)
    plan = hopper_fft._stream_plan(n, t, p)
    assert plan.form == "split"
    assert plan.transform == hopper_fft._onepass_plan(n)
    assert plan.transform.blocks == ONEPASS_BLOCKS[lm]
    assert plan.transform.hbm_passes == 1 and plan.transform.scratch_frames == 0
    assert plan.transform.shared_bytes <= SHARED_BYTES_MAX
    assert plan.bins_per_block * plan.blocks_per_channel == n // 2
    tu = plan.hops_per_chunk
    assert tu & (tu - 1) == 0 and min(t, 16) <= tu <= 16 and tu < 2 * min(t, 16)
    assert plan.chunks == -(-t // tu)
    rows = hopper_kernels.RING_MAC_ROWS  # X rows an item
    assert plan.items == sum(-(-min(tu, t - t0) // rows) for t0 in range(0, t, tu)) + \
        plan.chunks * p
    assert plan.stages == 8
    assert plan.shared_bytes == 8 * (4 * 256 * 4 + 2 * 8) <= STATIC_SHARED_MAX


@pytest.mark.parametrize("n,t,p", [(1 << 13, 2, 3), (1 << 18, 2, 3), (3 << 14, 2, 3),
                                   (1 << 16, 0, 3), (1 << 16, 2, 0)])
def test_stream_plan_refuses_other_shapes(n, t, p):
    with pytest.raises(ValueError):
        hopper_fft._stream_plan(n, t, p)


def test_stream_design_bytes():
    """The split form's own bytes at chip_smoke's K8 shapes (GB): the
    single 2^17 section, the far tier at 2^16, the near tier with lag0."""
    got = [hopper_fft._stream_design_bytes(128, t, p, n, l0) / 1e9
           for t, p, n, l0 in ((2, 8, 1 << 17, False), (4, 8, 1 << 16, False),
                               (16, 3, 1 << 14, True))]
    assert np.allclose(got, [2.34881024, 1.543503872, 0.822083584])


# -----------------------------------------------------------------------------
# The state kernel (the ring MAC): its item stream and MAC, in float64

def _items(t, p, tu):
    """The producer's items of a block of the state kernel, in order: ("x",
    rows) for the chunk's X rows, RING_MAC_ROWS to an item, ("lag", q,
    source, row) for the pair (H_q, V_{t0-1-q}), V read from X ("x") or the
    old ring ("ring")."""
    rows = hopper_kernels.RING_MAC_ROWS
    chunks = -(-t // tu)
    last = t - (chunks - 1) * tu
    per = -(-tu // rows) + p
    out = []
    for g in range((chunks - 1) * per + -(-last // rows) + p):
        ci, j = divmod(g, per)
        t0 = ci * tu
        tc = min(tu, t - t0)
        nx = -(-tc // rows)
        if j < nx:
            out.append(("x", tuple(range(t0 + j * rows, min(t0 + (j + 1) * rows, t0 + tc)))))
        else:
            q = j - nx
            r = t0 - 1 - q
            out.append(("lag", q, "x", r) if r >= 0 else ("lag", q, "ring", p + r))
    return out


def _mac(v, h, lane0):
    return np.where(lane0, v.real * h.real + 1j * v.imag * h.imag, v * h)


def _state_model(x, ring, h, l0, tu):
    """The state kernel in float64 as its threads run it, every bin at once: the
    consumer's loop over chunks (X items, then lag items with the window
    sliding down one hop a lag) takes the producer's items in order and
    checks each is the row it expects. Returns Y (T, K), the new ring (P,
    K) and the rows each item read, by (source, row)."""
    t, k = x.shape
    p = h.shape[0]
    items = iter(_items(t, p, tu))
    lane0 = np.arange(k) == 0
    l0 = np.zeros(k, complex) if l0 is None else l0
    y = np.full((t, k), np.nan + 0j)
    new = np.full((p, k), np.nan + 0j)
    writes = np.zeros(p, int)
    reads = {}
    for ci in range(-(-t // tu)):
        t0 = ci * tu
        tc = min(tu, t - t0)
        win = [np.zeros(k, complex)] * tu
        acc = [np.zeros(k, complex)] * tu
        step = hopper_kernels.RING_MAC_ROWS
        for i0 in range(0, tc, step):
            kind, rows = next(items)
            assert (kind, rows) == ("x", tuple(range(t0 + i0, t0 + min(i0 + step, tc))))
            for i, row in enumerate(rows, i0):
                reads[("x", row)] = reads.get(("x", row), 0) + 1
                win[i] = x[row]
                acc[i] = _mac(x[row], l0, lane0)
                slot = t0 + i - t + p
                if slot >= 0:
                    new[slot] = x[row]
                    writes[slot] += 1
        for q in range(p):
            kind, qq, src, row = next(items)
            r = t0 - 1 - q
            assert (kind, qq) == ("lag", q)
            assert (src, row) == (("x", r) if r >= 0 else ("ring", p + r))
            v = x[row] if src == "x" else ring[row]
            reads[(src, row)] = reads.get((src, row), 0) + 1
            reads[("h", q)] = reads.get(("h", q), 0) + 1
            win = [v] + win[:-1]
            for i in range(tu):
                acc[i] = acc[i] + _mac(win[i], h[q], lane0)
            slot = p - 1 - q - t
            if ci == 0 and slot >= 0:
                assert src == "ring" and row == slot + t
                new[slot] = v
                writes[slot] += 1
        for i in range(tc):
            y[t0 + i] = acc[i]
    assert next(items, None) is None
    assert (writes == 1).all()
    return y, new, reads


def _planes(z):
    return (torch.from_numpy(np.ascontiguousarray(z.real)),
            torch.from_numpy(np.ascontiguousarray(z.imag)))


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# (T, P): T < P, T = P, T > P, P = 1, T = 1, and T past one chunk of 16.
STATE_SHAPES = [(2, 8), (3, 5), (8, 8), (16, 3), (4, 1), (1, 1), (1, 6), (17, 3), (40, 5),
                (19, 20)]


@pytest.mark.parametrize("lag0", [False, True])
@pytest.mark.parametrize("t,p", STATE_SHAPES)
def test_state_model_matches_plain(t, p, lag0):
    """The item stream and the sliding-window MAC, with the new ring's slots
    copied from the X items (X_t to slot t - T + P) and from chunk 0's lag
    items (the old ring's slot P-1-q to P-1-q-T), equal stream_state_plain
    (the ring MAC's plain version and the lag-0 product) in float64; bin 0
    takes two real products a lag."""
    rng = np.random.default_rng(t * 100 + p * 3 + lag0)
    k = 6
    x, ring, h = _cplx(rng, t, k), _cplx(rng, p, k), _cplx(rng, p, k)
    l0 = _cplx(rng, k) if lag0 else None
    tu = hopper_fft._stream_plan(1 << 14, t, p).hops_per_chunk
    y, new, _ = _state_model(x, ring, h, l0, tu)
    want = hopper_fft.stream_state_plain(
        *(v[None] for v in _planes(x)), *(v[None] for v in _planes(ring)),
        *(v[None] for v in _planes(h)), *((None, None) if l0 is None else
                                          (v[None] for v in _planes(l0))))
    wy = want[0][0].numpy() + 1j * want[1][0].numpy()
    wr = want[2][0].numpy() + 1j * want[3][0].numpy()
    assert np.abs(y - wy).max() <= TOL * max(1.0, np.abs(wy).max())
    assert np.array_equal(new, wr)
    v0 = np.concatenate([ring, x])[:, 0]   # V's bin 0, V_r at row P + r
    last = sum(_mac(v0[p + t - 2 - lag], h[lag, 0], True) for lag in range(p))
    if lag0:
        last += _mac(x[t - 1, 0], l0[0], True)
    assert abs(y[t - 1, 0] - last) <= TOL * max(1.0, abs(last))


@pytest.mark.parametrize("t,p", STATE_SHAPES)
def test_state_rows_move_once(t, p):
    """Every row of the ring, H and X is copied once where T <= 16 (one
    chunk); past that each further chunk reads H and P rows of V again, as
    _stream_design_bytes counts them."""
    k = 2
    zero = np.zeros((max(t, p), k), complex)
    tu = hopper_fft._stream_plan(1 << 14, t, p).hops_per_chunk
    _, _, reads = _state_model(zero[:t], zero[:p], zero[:p], None, tu)
    chunks = -(-t // tu)
    assert sum(reads.values()) == t + 2 * p * chunks
    if chunks == 1:
        assert set(reads) == ({("x", r) for r in range(t)} | {("ring", r) for r in range(p)}
                              | {("h", q) for q in range(p)})
        assert set(reads.values()) == {1}
    assert all(reads[("h", q)] == chunks for q in range(p))


@pytest.mark.parametrize("items", [1, 7, 8, 9, 30])
def test_state_stages_never_overwrite_unread_items(items):
    """The stages' schedule: items 0..7 issued at block start, item g + 8
    into stage g mod 8 once every thread has read item g; each item is read
    from the stage it was copied into, after its copy, waiting on the
    stage's phase parity (g // 8) & 1, and no copy lands in a stage whose
    item is unread."""
    stages = 8
    holds = {}       # stage -> item copied there and not yet read
    uses = {s: 0 for s in range(stages)}
    for g in range(min(stages, items)):
        assert g % stages not in holds
        holds[g % stages] = g
    for g in range(items):
        s = g % stages
        assert holds.pop(s) == g and g // stages == uses[s]  # the phase it waits on
        uses[s] += 1
        if g + stages < items:
            assert s not in holds
            holds[s] = g + stages
    assert not holds


# -----------------------------------------------------------------------------
# The transforms' index maps: the forward's loader, the inverse's tail store

@pytest.mark.parametrize("c,t", [(1, 1), (2, 3), (3, 5)])
def test_stream_loader_reads_both_halves_in_place(c, t):
    """load_elem<kLoadStreamPrev> on the one-pass route: element idx of
    frame f = c*T + t (float2 units, M = N/2 points) is the carried block's
    idx-th pair where t = 0 and idx < M/2 (the channel's block at prev +
    (f / T) * M floats), else x's pair f * M/2 + idx - M/2; that is the
    frame [x[t-1] | x[t]] with x[-1] = prev."""
    hop = 16                  # H floats = M float2 pairs
    m = hop                   # complex points a frame (N = 2H real)
    rng = np.random.default_rng(c * 10 + t)
    x = rng.standard_normal((c, t, hop))
    prev = rng.standard_normal((c, hop))
    x2 = x.reshape(-1, 2)     # the float2 view
    frames = np.empty((c * t, m, 2))
    for f in range(c * t):
        first = f % t == 0
        lo = prev.reshape(-1)[(f // t) * m:].reshape(-1, 2)
        for idx in range(m):
            frames[f, idx] = (lo[idx] if idx < m // 2 and first
                              else x2[f * (m // 2) + idx - m // 2])
    prev_rows = np.concatenate([prev[:, None], x[:, :-1]], axis=1)
    want = np.concatenate([prev_rows, x], axis=-1).reshape(c * t, m, 2)
    assert np.array_equal(frames, want)


def _pack_row_of(h, tile, f, rows):
    lo = f & (h - 1)
    if f < h:
        return h * tile + lo
    if tile == 0 and lo == 0:
        return rows >> 1
    return rows - (h * tile + lo)


@pytest.mark.parametrize("lm", range(13, 17))
def test_tail_store_writes_the_kept_half_once(lm):
    """tail_rows_tile on K8's one-pass routes: over the C blocks of a frame,
    each thread's slot (its row, pack_row_of) and bins k1 = L/2 + k0 +
    it * step, the stored float2 index k - M/2 (k = row + R * k1) covers
    the kept half [0, M/2) once, and each bin is read at its InPlace<L>
    slot (k1 % B) * (A + 1) + k1 / B."""
    n = 1 << (lm + 1)
    plan = hopper_fft._onepass_plan(n)
    rows, row_len = plan.lengths       # R = M2 rows of L = M1 points
    m = rows * row_len
    own = rows // plan.blocks
    h = own // 2
    a = 1 << (row_len.bit_length() - 1) // 2
    b = row_len // a
    step = plan.threads // (2 * h)
    assert (row_len // 2) % step == 0
    hits = np.zeros(m // 2, int)
    for rank in range(plan.blocks):
        for tid in range(plan.threads):
            sf = tid % (2 * h)
            row = _pack_row_of(h, rank, sf, rows)
            for it in range(row_len // 2 // step):
                k1 = row_len // 2 + tid // (2 * h) + it * step
                slot = (k1 % b) * (a + 1) + k1 // b
                assert slot < hopper_fft._inplace_tile(row_len)
                hits[row + rows * k1 - m // 2] += 1
    assert (hits == 1).all()


def test_unpack_loader_and_tail_store_give_the_tail():
    """The inverse's arithmetic: load_elem<kLoadUnpack> gives conj(Z'[idx])
    from the packed planes (W_N^idx, the partner P[M-idx]); the forward DFT
    of that, conjugated and scaled, stored as sample pairs from bin M/2 on,
    is scale * rifft(Y)[H:] (rifft_packed_tail_plain) in float64."""
    rng = np.random.default_rng(5)
    n = 64
    m = n // 2
    re, im = rng.standard_normal((2, 3, m))
    scale = 1.0 / (4.0 * n)
    idx = np.arange(m)
    w = np.exp(-2j * np.pi * idx / n)
    p = re + 1j * im
    q = np.conj(np.concatenate([p[:, :1], p[:, :0:-1]], axis=1))  # conj(P[M - idx])
    s, d = p + q, p - q
    wd = np.conj(w) * d
    z = s + 1j * wd
    z[:, 0] = (re[:, 0] + im[:, 0]) + 1j * (re[:, 0] - im[:, 0])
    loaded = np.conj(z)
    zk = np.fft.fft(loaded, axis=-1)
    out = np.conj(zk[:, m // 2:]) * scale
    got = np.stack([out.real, out.imag], axis=-1).reshape(3, m)
    want = hopper_fft.rifft_packed_tail_plain(torch.from_numpy(re), torch.from_numpy(im),
                                              scale).numpy()
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
