"""Partition-MAC kernels for Hopper: the counterpart of ``fft/pallas_kernels.py``.

:func:`lag_mac_causal` (K3) replaces ``hisstools_library_tpu/fft/
pallas_kernels.py: lag_mac_causal``; its CUDA source is
``csrc/lag_mac_causal.cu``. The wrapper runs the plain PyTorch version
(:func:`lag_mac_causal_plain`) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. Launches are counted in
``lag_mac_causal.launches``.
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
