"""Partition-MAC kernels for Hopper: the counterpart of ``fft/pallas_kernels.py``.

============================  ======================================  ======================
function                      replaces (hisstools_library_tpu/...)    CUDA source
============================  ======================================  ======================
:func:`lag_mac_causal` (K3)   fft/pallas_kernels.py: lag_mac_causal   csrc/lag_mac_causal.cu
:func:`lag_mac_ring` (K7)     fft/pallas_kernels.py: lag_mac_ring     csrc/lag_mac_ring.cu
============================  ======================================  ======================

Each wrapper runs its plain PyTorch version (``<name>_plain``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..core.types import Split, packed_mul


def lag_mac_causal_plain(x_re: torch.Tensor, x_im: torch.Tensor,
                         h_re: torch.Tensor, h_im: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Y_t = sum_{p < min(P, t)} X_{t-1-p} * H_p as one packed product per
    lag, over all rows it reaches."""
    t = x_re.shape[-2]
    p = h_re.shape[-2]
    y_re = torch.zeros_like(x_re)
    y_im = torch.zeros_like(x_im)
    for q in range(min(p, t - 1)):
        prod = packed_mul(Split(x_re[..., :t - 1 - q, :], x_im[..., :t - 1 - q, :]),
                          Split(h_re[..., q:q + 1, :], h_im[..., q:q + 1, :]))
        y_re[..., q + 1:, :] += prod.re
        y_im[..., q + 1:, :] += prod.im
    return y_re, y_im


def lag_mac_causal(x_re: torch.Tensor, x_im: torch.Tensor,
                   h_re: torch.Tensor, h_im: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: causal partition MAC over unpadded spectra.

    ``x_*``: (C, T, K) hop spectra; ``h_*``: (C, P, K) packed impulse spectra
    in natural order. Returns (C, T, K) packed-correct accumulations
    Y_t = sum_p X_{t-1-p} * H_p; row 0 is zero. Any P is served."""
    if x_re.device.type == "cpu":
        return lag_mac_causal_plain(x_re, x_im, h_re, h_im)
    kernel = "K3 lag_mac_causal"
    _build.check_tensors(kernel, x_re, x_im, h_re, h_im)
    if x_re.dim() != 3 or x_im.shape != x_re.shape:
        raise ValueError(f"{kernel}: X planes must be (C, T, K) of one shape")
    c, t, k = x_re.shape
    p = h_re.shape[1] if h_re.dim() == 3 else -1
    if h_re.shape != (c, p, k) or h_im.shape != h_re.shape:
        raise ValueError(f"{kernel}: H planes must be (C, P, K) = ({c}, P, {k}), "
                         f"got {tuple(h_re.shape)} and {tuple(h_im.shape)}")
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    if c * t * k == 0:
        return y_re, y_im
    rc = _build.load().hst_lag_mac_causal(
        x_re.data_ptr(), x_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
        y_re.data_ptr(), y_im.data_ptr(), c, t, p, k,
        _build.stream(x_re.device))
    _build.check(rc, kernel)
    lag_mac_causal.launches += 1
    return y_re, y_im


lag_mac_causal.launches = 0


def lag_mac_ring_plain(hist_re: torch.Tensor, hist_im: torch.Tensor,
                       x_re: torch.Tensor, x_im: torch.Tensor,
                       h_re: torch.Tensor, h_im: torch.Tensor):
    """Y_t = sum_p V[P+t-1-p] * H_p over V = [hist | X], one packed product
    per lag; new ring V[T:T+P]. Serves any T (the fused stream chain's plain
    version uses it with T > P)."""
    p = hist_re.shape[-2]
    t = x_re.shape[-2]
    v_re = torch.cat([hist_re, x_re], dim=-2)
    v_im = torch.cat([hist_im, x_im], dim=-2)
    y_re = torch.zeros_like(x_re)
    y_im = torch.zeros_like(x_im)
    for q in range(p):
        s = p - 1 - q
        prod = packed_mul(Split(v_re[..., s:s + t, :], v_im[..., s:s + t, :]),
                          Split(h_re[..., q:q + 1, :], h_im[..., q:q + 1, :]))
        y_re += prod.re
        y_im += prod.im
    return y_re, y_im, v_re[..., t:, :], v_im[..., t:, :]


def lag_mac_ring(hist_re: torch.Tensor, hist_im: torch.Tensor,
                 x_re: torch.Tensor, x_im: torch.Tensor,
                 h_re: torch.Tensor, h_im: torch.Tensor):
    """K7: streaming partition MAC with in-place ring reads.

    ``hist_*``: (C, P, K) oldest-first ring; ``x_*``: (C, T, K) new hop
    spectra; ``h_*``: (C, P, K) packed impulse spectra (a row slice or a
    channel-broadcast view is read in place). Returns (y_re, y_im, new_re,
    new_im): the T outputs Y_t = sum_p V[P+t-1-p] H_p over V = [hist | X] and
    the new ring V[T:T+P], a new tensor (never hist)."""
    if x_re.device.type == "cpu":
        return lag_mac_ring_plain(hist_re, hist_im, x_re, x_im, h_re, h_im)
    kernel = "K7 lag_mac_ring"
    _build.check_tensors(kernel, hist_re, hist_im, x_re, x_im)
    _build.check_tensors(kernel, hist_re, h_re, h_im, contiguous=False)
    if hist_re.dim() != 3 or hist_im.shape != hist_re.shape:
        raise ValueError(f"{kernel}: ring planes must be (C, P, K) of one shape")
    c, p, k = hist_re.shape
    t = x_re.shape[1] if x_re.dim() == 3 else -1
    if x_re.shape != (c, t, k) or x_im.shape != x_re.shape:
        raise ValueError(f"{kernel}: X planes must be (C, T, K) = ({c}, T, {k}), "
                         f"got {tuple(x_re.shape)} and {tuple(x_im.shape)}")
    if h_re.shape != (c, p, k) or h_im.shape != h_re.shape:
        raise ValueError(f"{kernel}: H planes must be (C, P, K) = ({c}, {p}, {k}), "
                         f"got {tuple(h_re.shape)} and {tuple(h_im.shape)}")
    h_re, cs = _build.channel_rows(h_re)
    h_im, cs_im = _build.channel_rows(h_im)
    if cs_im != cs:
        h_re, h_im, cs = h_re.contiguous(), h_im.contiguous(), p * k
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    n_re = torch.empty_like(hist_re)
    n_im = torch.empty_like(hist_im)
    if c * p * k == 0:
        return y_re, y_im, n_re, n_im
    rc = _build.load().hst_lag_mac_ring(
        hist_re.data_ptr(), hist_im.data_ptr(), x_re.data_ptr(), x_im.data_ptr(),
        h_re.data_ptr(), h_im.data_ptr(), cs, y_re.data_ptr(), y_im.data_ptr(),
        n_re.data_ptr(), n_im.data_ptr(), c, t, p, k, _build.stream(x_re.device))
    _build.check(rc, kernel)
    lag_mac_ring.launches += 1
    return y_re, y_im, n_re, n_im


lag_mac_ring.launches = 0
