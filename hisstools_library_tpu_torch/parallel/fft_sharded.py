"""Mesh-sharded four-step FFT: transforms larger than one device, on
``torch.distributed``.

Counterpart of ``hisstools_library_tpu/parallel/fft_sharded.py``. The
four-step (Bailey) factorisation distributed over a mesh axis of D ranks:

  view x as A[n1, n2] row-major, n1 sharded in contiguous row blocks
  1. all_to_all        -> each rank holds ALL n1 for a slab of m = n2/D columns
  2. local column DFTs -> B[j, k1] through the port's ``fft.api.fft`` (K12 on
                          the card)
  3. local twiddle     -> W_N^{n2 k1}, factorised as a per-rank column phase
                          times a (m, n1) table, so no rank holds an N-sized
                          table
  4. local partial DFT over its n2 slab (a dense complex matmul, outside any
     hand kernel as in the JAX package) + reduce_scatter
     -> D[k1, k2] arrives k2-sharded; the local transpose-flatten is the
        contiguous global output chunk (X laid out k2-major)

Communication: one ``all_to_all_single`` and one ``reduce_scatter_tensor``,
each moving N/D complex elements a rank (re and im travel in one message).

In and out: 1-D split-complex (re, im) of length N in D contiguous chunks
over the axis (the same layout in and out, so pipelines chain without
resharding), as full tensors or DTensors in; DTensors out. Unscaled, as
``fft.api.fft`` / ``ifft``. At D = 1 the transforms are ``fft.api``'s. A rank
outside the mesh gets None.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.types import Split, packed_mul
from ..fft import api as fft_api
from .mesh import BLOCK_AXIS, axis_size, global_tensor, local_shard, member

__all__ = ["fft_sharded", "rfft_sharded", "rifft_sharded",
           "convolve_sharded", "sharded_eligible", "real_sharded_eligible"]


def _split_factors(n: int) -> Tuple[int, int]:
    """n = n1 * n2 with n1 = 2^ceil(log2(n) / 2) (the JAX package's
    ``matmul_fft._split_factors``)."""
    log2n = n.bit_length() - 1
    n1 = 1 << ((log2n + 1) // 2)
    return n1, n // n1


def sharded_eligible(n: int, n_devices: int) -> bool:
    """True when the factorisation supports this (size, device-count)."""
    if n & (n - 1) or n_devices & (n_devices - 1):
        return False
    n1, n2 = _split_factors(n)
    return n1 % n_devices == 0 and n2 % n_devices == 0


@lru_cache(maxsize=32)
def _phase_tables(n: int, d: int, dtype_name: str, inverse: bool):
    """Factorised twiddle / DFT tables, computed in float64 like every other
    table of the FFT stack (the reference generates its twiddles in float64,
    HISSTools_FFT_Core.h:437-444).

    With m = n2 // d and column j_global = dev*m + j:
      W_N^{n2 k1}      = T1[dev, k1] * T2[j, k1]        (step-3 twiddle)
      W_N2^{n2 k2}     = T3[dev, k2] * T4[j, k2]        (step-4 DFT rows)
    Each table is (cos, sin) in the signal's dtype."""
    n1, n2 = _split_factors(n)
    m = n2 // d
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    j = np.arange(m)
    dev = np.arange(d)

    def table(rows, cols, denom):
        # Fold the exponent modulo denom in integers first: rows * cols
        # passes 2^53 for large N.
        prod = np.outer(rows.astype(np.int64), cols.astype(np.int64)) % denom
        ang = sign * 2.0 * np.pi * prod / denom
        dt = np.float32 if dtype_name == "float32" else np.float64
        return np.cos(ang).astype(dt), np.sin(ang).astype(dt)

    return table(dev * m, k1, n), table(j, k1, n), table(dev * m, k2, n2), table(j, k2, n2)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _spec(mesh: DeviceMesh, axis_name: str):
    """1-D tensors sharded over ``axis_name``, replicated over the other axis."""
    return [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def _fft_local(re_l: torch.Tensor, im_l: torch.Tensor, n: int, mesh: DeviceMesh,
               axis_name: str, inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's output chunk of the transform of length ``n`` whose input
    chunk is (re_l, im_l)."""
    d = axis_size(mesh, axis_name)
    if d == 1:
        return (fft_api.ifft if inverse else fft_api.fft)(re_l, im_l)
    n1, n2 = _split_factors(n)
    m = n2 // d
    dev = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    t1, t2, t3, t4 = (tuple(torch.from_numpy(a).to(re_l.device) for a in tab)
                      for tab in _phase_tables(n, d, _dtype_name(re_l), inverse))
    # This rank's chunk is a (n1/d, n2) row block of A. One all_to_all turns
    # it into all rows of a slab of m columns: rank j gets columns j*m.. .
    a0 = torch.stack([re_l, im_l]).reshape(2, n1 // d, d, m).permute(2, 0, 1, 3)
    a = torch.empty_like(a0, memory_format=torch.contiguous_format)
    dist.all_to_all_single(a, a0.contiguous(), group=group)
    a = a.permute(1, 0, 2, 3).reshape(2, n1, m)
    # Column DFTs: rows of the transpose.
    br, bi = (fft_api.ifft if inverse else fft_api.fft)(a[0].T.contiguous(),
                                                        a[1].T.contiguous())  # (m, k1)
    # Twiddle W_N^{n2 k1} = T1[dev] * T2 (factorised).
    twr, twi = _cmul(t1[0][dev][None, :], t1[1][dev][None, :], t2[0], t2[1])
    cr, ci = _cmul(br, bi, twr, twi)
    # Step 4: partial DFT over this rank's n2 slab, summed across the axis
    # straight into k2-sharded form.
    fr, fi = _cmul(t3[0][dev][None, :], t3[1][dev][None, :], t4[0], t4[1])  # (m, n2)
    crt, cit = cr.T, ci.T
    dr = crt @ fr - cit @ fi                                   # (k1, k2) partial
    di = crt @ fi + cit @ fr
    parts = torch.stack([dr, di]).reshape(2, n1, d, m).permute(2, 0, 1, 3)
    out = torch.empty(2 * n1 * m, dtype=dr.dtype, device=dr.device)
    dist.reduce_scatter_tensor(out, parts.reshape(-1), group=group)
    out = out.reshape(2, n1, m)
    # X[k1 + n1*k2]: k2-major flatten -> this rank's chunk is rows
    # [dev*m, (dev+1)*m) of X viewed as (n2, n1).
    return out[0].T.reshape(-1), out[1].T.reshape(-1)


def fft_sharded(mesh: DeviceMesh, re, im, inverse: bool = False,
                axis_name: str = BLOCK_AXIS) -> Optional[Tuple[DTensor, DTensor]]:
    """Unscaled complex (i)DFT of a 1-D split-complex signal sharded over
    ``mesh``'s ``axis_name``; the output has the same contiguous-chunk
    sharding. The bare transform pair, like ``fft.api.fft`` / ``ifft``."""
    if not member(mesh):
        return None
    n = re.shape[-1]
    d = axis_size(mesh, axis_name)
    if re.dim() != 1:
        raise ValueError("fft_sharded operates on 1-D signals")
    if d > 1 and not sharded_eligible(n, d):
        raise ValueError(f"size {n} not distributable over {d} devices")
    spec = _spec(mesh, axis_name)
    fr, fi = _fft_local(local_shard(re, mesh, spec), local_shard(im, mesh, spec), n,
                        mesh, axis_name, inverse)
    return global_tensor(fr, mesh, spec, (n,)), global_tensor(fi, mesh, spec, (n,))


# ---------------------------------------------------------------------------
# Packed real transforms (fft/api conventions: N/2 bins, DC in re[0],
# Nyquist in im[0], forward x2, rifft(rfft(x)) == 2N x) on the sharded
# complex core. The real <-> complex step needs conj(Z[(M-k) % M]), a global
# index mirror: under contiguous-chunk sharding one exchange pairing rank d
# with rank D-1-d, and one element for each chunk's wrap-around lane.
# ---------------------------------------------------------------------------


def real_sharded_eligible(n: int, n_devices: int) -> bool:
    return n >= 4 * n_devices and sharded_eligible(n // 2, n_devices)


def _mirror(z_l: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """Local chunk of mirror[k] = z[(M - k) % M] along the last axis, from
    z's local chunk: [z[first of chunk (D-d) % D], reversed(chunk D-1-d)[:-1]].
    One batch of point-to-point sends (a rank's element to itself is a copy)."""
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    d = len(ranks)
    me = mesh.get_local_rank(axis_name)
    z_l = z_l.contiguous()
    first_src = z_l[..., :1].contiguous()
    recv = torch.empty_like(z_l)
    first = torch.empty_like(first_src)
    ops = [dist.P2POp(dist.isend, z_l, ranks[d - 1 - me], group),
           dist.P2POp(dist.irecv, recv, ranks[d - 1 - me], group)]
    if (d - me) % d == me:
        first.copy_(first_src)
    else:
        ops += [dist.P2POp(dist.isend, first_src, ranks[(d - me) % d], group),
                dist.P2POp(dist.irecv, first, ranks[(d - me) % d], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return torch.cat([first, torch.flip(recv, dims=(-1,))[..., :-1]], dim=-1)


def _half_tw_tables(m: int, d: int, dtype_name: str):
    """W_N^k (N = 2m) factorised as a per-rank scalar times W_N^j."""
    c = m // d
    dt = np.float32 if dtype_name == "float32" else np.float64
    ang_dev = np.pi * (np.arange(d) * c) / m
    ang_j = np.pi * np.arange(c) / m
    t_dev = np.stack([np.cos(ang_dev), -np.sin(ang_dev)], axis=1).astype(dt)
    t_j = np.stack([np.cos(ang_j), -np.sin(ang_j)]).astype(dt)
    return t_dev, t_j


def _half_twiddle(m: int, mesh: DeviceMesh, axis_name: str, like: torch.Tensor):
    t_dev, t_j = _half_tw_tables(m, axis_size(mesh, axis_name), _dtype_name(like))
    dev = mesh.get_local_rank(axis_name)
    t_j = torch.from_numpy(t_j).to(like.device)
    return _cmul(float(t_dev[dev, 0]), float(t_dev[dev, 1]), t_j[0], t_j[1])


def _rfft_local(x_l: torch.Tensor, n: int, mesh: DeviceMesh, axis_name: str):
    m = n // 2
    zr, zi = _fft_local(x_l[0::2].contiguous(), x_l[1::2].contiguous(), m, mesh,
                        axis_name, False)
    mir = _mirror(torch.stack([zr, zi]), mesh, axis_name)
    zr_rev, zi_rev = mir[0], -mir[1]
    ze_r = 0.5 * (zr + zr_rev)
    ze_i = 0.5 * (zi + zi_rev)
    zo_r = 0.5 * (zi - zi_rev)
    zo_i = -0.5 * (zr - zr_rev)
    twr, twi = _half_twiddle(m, mesh, axis_name, x_l)
    pr = 2.0 * (ze_r + (zo_r * twr - zo_i * twi))
    pi = 2.0 * (ze_i + (zo_r * twi + zo_i * twr))
    if mesh.get_local_rank(axis_name) == 0:  # DC / Nyquist packed in lane 0
        pr[0] = 2.0 * (zr[0] + zi[0])
        pi[0] = 2.0 * (zr[0] - zi[0])
    return pr, pi


def rfft_sharded(mesh: DeviceMesh, x, axis_name: str = BLOCK_AXIS
                 ) -> Optional[Tuple[DTensor, DTensor]]:
    """Packed real FFT of a 1-D real signal sharded over ``axis_name``:
    (re, im) of N/2 bins with the same contiguous sharding (DC in re[0],
    Nyquist in im[0], x2 forward scale: ``fft.api.rfft``)."""
    if not member(mesh):
        return None
    n = x.shape[-1]
    d = axis_size(mesh, axis_name)
    if x.dim() != 1:
        raise ValueError("rfft_sharded operates on 1-D signals")
    spec = _spec(mesh, axis_name)
    x_l = local_shard(x, mesh, spec)
    if d == 1:
        pr, pi = fft_api.rfft(x_l)
    elif not real_sharded_eligible(n, d):
        raise ValueError(f"size {n} not distributable over {d} devices")
    else:
        pr, pi = _rfft_local(x_l, n, mesh, axis_name)
    return (global_tensor(pr, mesh, spec, (n // 2,)),
            global_tensor(pi, mesh, spec, (n // 2,)))


def _rifft_local(xr_l: torch.Tensor, xi_l: torch.Tensor, m: int, mesh: DeviceMesh,
                 axis_name: str) -> torch.Tensor:
    lane0 = mesh.get_local_rank(axis_name) == 0
    # X'[m] (Nyquist) lives packed in im[0]; the true imag[0] is 0.
    xi0 = xi_l.clone()
    if lane0:
        xi0[0] = 0.0
    mir = _mirror(torch.stack([xr_l, xi0]), mesh, axis_name)
    xr_rev, xi_rev = mir[0].clone(), -mir[1]
    if lane0:  # mirror[0] is X'[m], the packed im[0]
        xr_rev[0] = xi_l[0]
    ze_r = 0.5 * (xr_l + xr_rev)
    ze_i = 0.5 * (xi0 + xi_rev)
    do_r = 0.5 * (xr_l - xr_rev)
    do_i = 0.5 * (xi0 - xi_rev)
    twr, twi = _half_twiddle(m, mesh, axis_name, xr_l)
    # Zo = conj(W^k) * (X - conj(Xrev)) / 2
    zo_r = do_r * twr + do_i * twi
    zo_i = -do_r * twi + do_i * twr
    wr, wi = _fft_local(ze_r - zo_i, ze_i + zo_r, m, mesh, axis_name, True)
    return 2.0 * torch.stack([wr, wi], dim=-1).reshape(-1)


def rifft_sharded(mesh: DeviceMesh, re, im, axis_name: str = BLOCK_AXIS
                  ) -> Optional[DTensor]:
    """Inverse of :func:`rfft_sharded`, unscaled:
    ``rifft_sharded(rfft_sharded(x)) == 2 N x`` (``fft.api.rifft``)."""
    if not member(mesh):
        return None
    m = re.shape[-1]
    d = axis_size(mesh, axis_name)
    if re.dim() != 1:
        raise ValueError("rifft_sharded operates on 1-D spectra")
    spec = _spec(mesh, axis_name)
    xr_l, xi_l = local_shard(re, mesh, spec), local_shard(im, mesh, spec)
    if d == 1:
        y = fft_api.rifft(xr_l, xi_l)
    elif not real_sharded_eligible(2 * m, d):
        raise ValueError(f"size {2 * m} not distributable over {d} devices")
    else:
        y = _rifft_local(xr_l, xi_l, m, mesh, axis_name)
    return global_tensor(y, mesh, spec, (2 * m,))


def convolve_sharded(mesh: DeviceMesh, x, h, axis_name: str = BLOCK_AXIS
                     ) -> Optional[DTensor]:
    """Distributed linear convolution of two 1-D real signals.

    The mesh-scale form of ``spectral_processor.convolve`` (reference
    SpectralProcessor.hpp:164-184): pad both to a shared power of two,
    rfft_sharded each, multiply the packed spectra bin-wise (DC / Nyquist
    multiply apart: lane 0 of rank 0), rifft_sharded, scale by 0.25/N.
    Returns the full length lx + lh - 1, sharded over ``axis_name`` by
    ``torch.chunk``'s rule (the padded transform's chunks are gathered and
    re-cut: that length is no multiple of the axis)."""
    if not member(mesh):
        return None
    lx, lh = x.shape[-1], h.shape[-1]
    out_len = lx + lh - 1
    d = axis_size(mesh, axis_name)
    if d > 1 and (d & (d - 1)):
        # real_sharded_eligible is False for every n on a non-power-of-two
        # axis; without this guard the size search below would never end.
        raise ValueError(f"convolve_sharded needs a power-of-two mesh axis, "
                         f"got {d} devices")
    n = 1
    while n < out_len or (d > 1 and not real_sharded_eligible(n, d)):
        n <<= 1
    spec = _spec(mesh, axis_name)
    x = x.full_tensor() if isinstance(x, DTensor) else x
    h = h.full_tensor() if isinstance(h, DTensor) else h
    xp = local_shard(torch.nn.functional.pad(x, (0, n - lx)), mesh, spec)
    hp = local_shard(torch.nn.functional.pad(h, (0, n - lh)), mesh, spec)
    if d == 1:
        prod = packed_mul(Split(*fft_api.rfft(xp)), Split(*fft_api.rfft(hp)))
        y = fft_api.rifft(prod.re, prod.im)
    else:
        xr, xi = _rfft_local(xp, n, mesh, axis_name)
        hr, hi = _rfft_local(hp, n, mesh, axis_name)
        pr, pi = _cmul(xr, xi, hr, hi)
        if mesh.get_local_rank(axis_name) == 0:  # DC, Nyquist: real x real
            pr[0] = xr[0] * hr[0]
            pi[0] = xi[0] * hi[0]
        y = _rifft_local(pr, pi, n // 2, mesh, axis_name)
    full = global_tensor(y * (0.25 / n), mesh, spec, (n,)).full_tensor()[:out_len]
    return global_tensor(local_shard(full, mesh, spec), mesh, spec, (out_len,))
