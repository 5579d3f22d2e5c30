"""Double-float ("df64") FFT: ~280 dB transforms carried as float32 pairs.

Counterpart of ``hisstools_library_tpu/fft/df64.py``. Every value is an
unevaluated pair of float32 tensors (hi + lo, Dekker arithmetic) carried
through a Stockham radix-2 FFT:

- element ops use error-free transformations (TwoSum, Dekker's TwoProd with
  the 4097 split), ~2^-48 relative error per op instead of float32's 2^-24;
- twiddles are computed in float64 on the host and stored as (hi, lo) pairs;
- log2(N) stages of slices and element-wise ops, then one bit-reversal
  gather.

The function is the JAX package's, plane for plane: the same float32
sequence, so the planes agree with the JAX package's. It is not a route to
native float64 (``fft.api`` with float64 tensors is that): it is a caller's
double-float surface, for (hi, lo) planes held in float32.

No hand kernel is involved: the JAX version is element-wise XLA, and these
element-wise torch ops are its port. Numerical safety: a compensation
sequence such as ``(a + b) - b`` holds only under exact IEEE float32
semantics, one rounding per op. Each op here is its own eager kernel, so no
compiler can contract ``a * b + c`` into an FMA or reassociate a sum; never
``torch.compile`` or fuse this module. :func:`selfcheck` computes a
catastrophic-cancellation case whose survival proves the compensation held on
the device it ran on.

Work runs on the device of the input tensors; numpy input goes to ``device``
(the card unless named).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..core.types import resolve_device

# -----------------------------------------------------------------------------
# Error-free transformations on float32
# -----------------------------------------------------------------------------

_SPLIT_C = 4097.0  # 2^12 + 1: Dekker splitting constant for float32


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth TwoSum, no magnitude assumption)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """s + e == a + b exactly, assuming |a| >= |b| (Dekker FastTwoSum)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker TwoProd via splitting; no FMA needed)."""
    p = a * b
    ca = a * _SPLIT_C
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * _SPLIT_C
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_add(xh, xl, yh, yl):
    """Double-float addition (~2^-47 relative error)."""
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    """Double-float multiplication (~2^-47 relative error)."""
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def dd_from_f64(a) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of a float64 array into an (hi, lo) float32 pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def dd_to_f64(hi, lo) -> np.ndarray:
    """Host-side recombination (copies tensors from their device)."""
    return _host64(hi) + _host64(lo)


def selfcheck(device=None) -> float:
    """Arithmetic guard on ``device`` (the card unless named): the relative
    error of a df64 sum whose terms cancel catastrophically in plain float32.
    Healthy df64 is ~1e-14; if the compensation were folded it would
    collapse to ~1e-7 (float32). Assert ``selfcheck() < 1e-10`` on any new
    device or toolchain."""
    dev = resolve_device(device)
    pih, pil = (torch.from_numpy(p).to(dev) for p in dd_from_f64(np.full((8,), np.pi)))
    # (pi_hi + pi_lo)^2 accumulated 16 times, minus the closed form: survives
    # only if every TwoSum / TwoProd keeps its error term.
    ph, pl = dd_mul(pih, pil, pih, pil)
    ah = torch.zeros_like(pih)
    al = torch.zeros_like(pih)
    for _ in range(16):
        ah, al = dd_add(ah, al, ph, pl)
    got = dd_to_f64(ah, al)
    want = 16.0 * np.pi * np.pi
    return float(np.max(np.abs(got - want) / want))


# -----------------------------------------------------------------------------
# Complex df64 helpers (split layout: 4 planes)
# -----------------------------------------------------------------------------

def _cadd(a, b):
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    rh, rl = dd_add(arh, arl, brh, brl)
    ih, il = dd_add(aih, ail, bih, bil)
    return rh, rl, ih, il


def _csub(a, b):
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    rh, rl = dd_sub(arh, arl, brh, brl)
    ih, il = dd_sub(aih, ail, bih, bil)
    return rh, rl, ih, il


def _cmul(a, b):
    """(ar + i ai)(br + i bi) in df64."""
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    t1h, t1l = dd_mul(arh, arl, brh, brl)
    t2h, t2l = dd_mul(aih, ail, bih, bil)
    rh, rl = dd_sub(t1h, t1l, t2h, t2l)
    t3h, t3l = dd_mul(arh, arl, bih, bil)
    t4h, t4l = dd_mul(aih, ail, brh, brl)
    ih, il = dd_add(t3h, t3l, t4h, t4l)
    return rh, rl, ih, il


@lru_cache(maxsize=64)
def _stage_twiddles(r: int, sign: float):
    """df64 twiddle pairs exp(sign * 2i pi j / r), j = 0..r/2-1 (host f64)."""
    j = np.arange(r // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * j / r
    wr_h, wr_l = dd_from_f64(np.cos(ang))
    wi_h, wi_l = dd_from_f64(np.sin(ang))
    return wr_h, wr_l, wi_h, wi_l


def _fft_core(z, n: int, sign: float):
    """Stockham-style radix-2 DIF on df64 planes of shape (..., l, r)."""
    log2n = n.bit_length() - 1
    dev = z[0].device
    z = tuple(p.reshape(*p.shape[:-1], 1, n) for p in z)
    for _ in range(log2n):
        r = z[0].shape[-1]
        a = tuple(p[..., : r // 2] for p in z)          # (..., l, r/2)
        b = tuple(p[..., r // 2:] for p in z)
        y0 = _cadd(a, b)
        d = _csub(a, b)
        w = tuple(torch.from_numpy(p).to(dev) for p in _stage_twiddles(r, sign))
        y1 = _cmul(d, w)                                # (r/2,) broadcasts
        # DIF Stockham: output block k of the new l axis pairs (y0_k, y1_k).
        z = tuple(
            torch.stack([p0, p1], dim=-2).reshape(
                *p0.shape[:-2], 2 * p0.shape[-2], r // 2)
            for p0, p1 in zip(y0, y1))
    return tuple(p.reshape(*p.shape[:-2], n) for p in z)


@lru_cache(maxsize=64)
def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _plane(a, device) -> torch.Tensor:
    """A float32 plane: a tensor stays on its device, anything else is
    copied onto ``device`` (the card unless named)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=resolve_device(device))


def fft_df64(re_hi, re_lo, im_hi, im_lo, inverse: bool = False, device=None):
    """Unscaled complex DFT (or unscaled inverse = N x IDFT, matching
    fft.api.ifft's convention) in double-float. Inputs/outputs are four
    float32 planes (re_hi, re_lo, im_hi, im_lo), batched over leading axes."""
    n = re_hi.shape[-1]
    if n & (n - 1) or n < 2:
        raise ValueError(f"size must be a power of two >= 2, got {n}")
    sign = 1.0 if inverse else -1.0
    z = tuple(_plane(p, device) for p in (re_hi, re_lo, im_hi, im_lo))
    out = _fft_core(z, n, sign)
    # DIF Stockham as implemented leaves bit-reversed order; undo with one
    # static gather (host-precomputed permutation).
    perm = torch.from_numpy(_bitrev_perm(n)).to(z[0].device)
    return tuple(torch.index_select(p, -1, perm) for p in out)


def rfft_df64(x, device=None):
    """Packed real FFT in df64: N real samples -> N/2 packed bins with the
    library convention (x2 scale, DC in re[0], Nyquist in im[0] --
    HISSTools_FFT_Core.h:934-988). ``x`` may be float32 (exact) or float64
    (numpy or a tensor, split into (hi, lo) on the host). Returns
    (re_hi, re_lo, im_hi, im_lo)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
        xh = x.to(torch.float32)
        xl = (x - xh.to(torch.float64)).to(torch.float32)
    elif isinstance(x, np.ndarray) and x.dtype == np.float64:
        xh, xl = (_plane(p, device) for p in dd_from_f64(x))
    else:
        xh = _plane(x, device)
        xl = torch.zeros_like(xh)
    n = xh.shape[-1]
    z = torch.zeros_like(xh)
    fr_h, fr_l, fi_h, fi_l = fft_df64(xh, xl, z, z, inverse=False)
    # Packed layout: bins 0..N/2-1, x2 scale, Nyquist (bin N/2, purely real)
    # packed into im[0].
    h = n // 2

    def pack(p_h, p_l, is_im: bool):
        hi2, lo2 = dd_add(p_h, p_l, p_h, p_l)  # x2, exact in df64
        if is_im:
            nyq_h, nyq_l = dd_add(fr_h[..., h:h + 1], fr_l[..., h:h + 1],
                                  fr_h[..., h:h + 1], fr_l[..., h:h + 1])
            return (torch.cat([nyq_h, hi2[..., 1:h]], dim=-1),
                    torch.cat([nyq_l, lo2[..., 1:h]], dim=-1))
        return hi2[..., :h], lo2[..., :h]

    re_hi, re_lo = pack(fr_h, fr_l, False)
    im_hi, im_lo = pack(fi_h, fi_l, True)
    return re_hi, re_lo, im_hi, im_lo


def rifft_df64(re_hi, re_lo, im_hi, im_lo, device=None):
    """Unscaled packed inverse in df64: rifft(rfft(x)) == 2N x (the library
    identity, fft/api.py). Returns (y_hi, y_lo) time-domain planes."""
    re_hi, re_lo, im_hi, im_lo = (_plane(p, device) for p in (re_hi, re_lo, im_hi, im_lo))
    # Unpack to the full Hermitian spectrum (the x2 packing rides through:
    # N * IDFT of the packed values is exactly what fft.api.rifft computes).
    dc = (re_hi[..., :1], re_lo[..., :1])
    nyq = (im_hi[..., :1], im_lo[..., :1])
    z = torch.zeros_like(dc[0])

    full_rh = torch.cat([dc[0], re_hi[..., 1:], nyq[0],
                         torch.flip(re_hi[..., 1:], dims=(-1,))], dim=-1)
    full_rl = torch.cat([dc[1], re_lo[..., 1:], nyq[1],
                         torch.flip(re_lo[..., 1:], dims=(-1,))], dim=-1)
    full_ih = torch.cat([z, im_hi[..., 1:], z, -torch.flip(im_hi[..., 1:], dims=(-1,))],
                        dim=-1)
    full_il = torch.cat([z, im_lo[..., 1:], z, -torch.flip(im_lo[..., 1:], dims=(-1,))],
                        dim=-1)

    # Unscaled inverse via N*IDFT(z) = conj(FFT(conj(z))): the Hermitian
    # input carries the packed x2, so the real output is exactly 2N x (the
    # library identity), no extra scale. The imaginary residue is df64
    # rounding (~1e-14) on a mathematically real signal; drop it.
    cr_h, cr_l, _ci_h, _ci_l = fft_df64(full_rh, full_rl, -full_ih, -full_il, inverse=False)
    return cr_h, cr_l
