"""The plain reference of an N-in / M-out convolution matrix.

Output m is the sum over inputs n of ``x[n] * h[m, n]``, each pair's linear
convolution computed by :func:`convolution.convolve` (plain PyTorch FFTs in
float64, or from bfloat16 operands for the lower-precision control), one
output at a time so that a large matrix fits beside its inputs, with TF32
off. It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from .convolution import convolve


def matrix_convolve(x: torch.Tensor, h: torch.Tensor, start: int, length: int,
                    precision: str = "float64") -> torch.Tensor:
    """``sum_n (x[n] * h[m, n])[start:start + length]`` for each output m:
    ``x`` (N, Lx) inputs, ``h`` (M, N, Lh) impulse responses. Returns float64
    (M, length). In the control's precision each pair's convolution and the
    sum are rounded to bfloat16, as a program computing in it would store
    them."""
    if h.dim() != 3 or h.shape[1] != x.shape[0]:
        raise ValueError(f"h {tuple(h.shape)} is not (M, N, L) for x {tuple(x.shape)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.empty((h.shape[0], length), dtype=torch.float64, device=x.device)
        for m in range(h.shape[0]):
            out[m] = convolve(x, h[m], start, length, precision).sum(dim=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out if precision == "float64" else out.bfloat16().double()
