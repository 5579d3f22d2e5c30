"""The small real FFTs K10 / K10w (csrc/rfft_small.cu on csrc/reg_fft.cuh)
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
* the split step: bins k and M-k from the natural-order spectrum, k <= M/2.

The model matches ``np.fft.rfft`` in the packed layout to 1e-12 relative to
the largest output; the kernels themselves are held against their plain
versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

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


def _kernel_model(x, base0, outer, row_stride, t, w, batch, n, grid):
    """K10w as the kernel computes it on the flat float64 signal ``x``; K10
    is outer = n, row_stride = 0, t = 1 and w = 1. Returns (re, im) and
    checks that every row is stored once and every stage fills its frame."""
    p = hopper_fft._small_plan(n)
    m, T, F = n // 2, p.threads_per_frame, p.frames_per_block
    ld = m + m // 16
    stw = _w(n, np.arange(m))                          # staged W_N^e, e < M

    def tw_n(e):
        return np.where(e < m, stw[np.minimum(e, m - 1)], -stw[np.maximum(e - m, 0)])

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
            fb = np.full((F, ld), np.nan, complex)
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
            z = fb[:, _pad(np.arange(m))]
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
