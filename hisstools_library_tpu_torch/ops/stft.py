"""Windowed STFT analysis and resynthesis, on torch tensors.

Counterpart of ``hisstools_library_tpu/ops/stft.py``: window, frame and
transform, batched over channels and frames, in the library's packed
spectrum convention, so every ``ir_*`` op applies per frame unchanged.

- :func:`stft`  -- frame, window, rfft -> packed Split (..., frames, N/2)
- :func:`istft` -- rifft, synthesis window, overlap-add with COLA
  normalisation (least-squares inversion: divide by the summed squared
  window)

Framing takes no copy: ``x.unfold(-1, N, hop)`` is a view of the padded
signal with a row stride of ``hop``. With the ``"pallas"`` backend on a
float32 tensor and N = 32..2048, :func:`stft` hands that view to K10w
(``hopper_fft.rfft_small_windowed``, the window multiplied in its loader)
and :func:`istft` runs K11w (``rifft_small_windowed``, synthesis window and
0.5/N scale in its store); on a CPU tensor their plain versions run. Above
2048, and in float64, the window multiplies the frames in torch and
``fft_api.rfft`` / ``rifft`` route by size (K1/K6, K13/K14 on a CUDA float32
tensor), as the JAX package routes them. Overlap-add follows the JAX forms:
m shifted block adds when hop | N, otherwise one ``index_add_`` on the
static index map. The window comes as numpy or as a tensor on any device; it
is taken to host float64 once, and the float32 copy the kernels read and the
COLA envelope are cached on the device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import Split
from ..fft import api as fft_api
from ..fft import hopper_fft


def num_frames(length: int, fft_size: int, hop: int) -> int:
    return max(0, 1 + (length - fft_size) // hop) if length >= fft_size else 0


def _window64(window, n: int) -> np.ndarray:
    """The first ``n`` samples of ``window`` as contiguous host float64 (a
    tensor on any device is copied to the host once)."""
    if isinstance(window, torch.Tensor):
        window = window.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(window, np.float64)[:n])


@functools.lru_cache(maxsize=32)
def _window_cached(wbytes: bytes, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(wbytes, np.float64).copy()).to(device, dtype)


def _window_tensor(w64: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The window as a tensor of ``like``'s dtype on its device, cached."""
    return _window_cached(w64.tobytes(), like.dtype, like.device)


@functools.lru_cache(maxsize=16)
def _cola_envelope(n: int, hop: int, t: int, wbytes: bytes, eps: float,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The least-squares normalisation envelope max(sum of shifted w^2, eps),
    built in float64 on the host as in the JAX package and cached on the
    device (at 938 frames of 1024 it is ~4 MB of float64)."""
    wsq = np.frombuffer(wbytes, np.float64) ** 2
    env = np.zeros((t - 1) * hop + n)
    for s in np.arange(t) * hop:
        env[s:s + n] += wsq
    return torch.from_numpy(np.maximum(env, eps)).to(device, dtype)


def _pallas_eligible(backend: Optional[str], x: torch.Tensor, n: int) -> bool:
    """True where the windowed kernels (K10w/K11w) serve the call: the
    "pallas" backend, not float64, N = 32..2048."""
    return (fft_api._resolve(backend, x.device) == "pallas"
            and x.dtype != torch.float64 and hopper_fft.small_eligible(n))


def stft(x: torch.Tensor, window, fft_size: int, hop: int,
         pad: bool = True, boundary: bool = False,
         backend: Optional[str] = None) -> Split:
    """Packed STFT. ``x``: (..., L); ``window``: ``fft_size`` samples as
    numpy or a tensor (e.g. ``windows.hann(N - 1)``, N points). With ``pad``
    the signal is zero-padded so every sample is covered by a whole frame;
    with ``boundary`` it is also padded by ``fft_size - hop`` on the left so
    edge samples get full window coverage (pass the same flag to
    :func:`istft`)."""
    w64 = _window64(window, fft_size)
    L = x.shape[-1]
    if boundary:
        lead_pad = fft_size - hop
        x = F.pad(x, (lead_pad, lead_pad))
        L = x.shape[-1]
    if pad:
        total = int(np.ceil(max(L - fft_size, 0) / hop)) * hop + fft_size
        if total > L:
            x = F.pad(x, (0, total - L))
        L = total
    if num_frames(L, fft_size, hop) == 0:
        empty = x.new_zeros(x.shape[:-1] + (0, fft_size // 2))
        return Split(empty, empty.clone())
    frames = x.unfold(-1, fft_size, hop)  # (..., T, N), row stride hop
    w = _window_tensor(w64, x)
    if _pallas_eligible(backend, x, fft_size):
        return Split(*hopper_fft.rfft_small_windowed(frames, w))
    return Split(*fft_api.rfft(frames * w, backend=backend))


def istft(spec: Split, window, hop: int, length: Optional[int] = None,
          boundary: bool = False, backend: Optional[str] = None,
          eps: float = 1e-10) -> torch.Tensor:
    """Least-squares inverse STFT: synthesis-windowed overlap-add divided by
    the overlapped squared-window envelope (exact for any window and hop
    with full coverage)."""
    bins = spec.shape[-1]
    n = bins * 2
    t = spec.shape[-2]
    w64 = _window64(window, n)
    w = _window_tensor(w64, spec.re)
    if _pallas_eligible(backend, spec.re, n):
        frames = hopper_fft.rifft_small_windowed(spec.re.contiguous(), spec.im.contiguous(),
                                                 w, 0.5 / n)
    else:
        frames = fft_api.rifft(spec.re, spec.im, backend=backend) * (0.5 / n)
        frames = frames * w  # synthesis window

    total = (t - 1) * hop + n
    lead = frames.shape[:-2]
    if n % hop == 0:
        # m shifted block adds: output block b receives frames[b - k][k*hop :
        # (k+1)*hop] for k = 0..m-1.
        m = n // hop
        parts = frames.reshape(lead + (t, m, hop))
        y = frames.new_zeros(lead + (t + m - 1, hop))
        for k in range(m):
            y[..., k:k + t, :] += parts[..., k, :]
        y = y.reshape(lead + (total,))
    else:
        # General hop: one index_add_ on the static index map.
        idx = (torch.arange(t, device=frames.device)[:, None] * hop
               + torch.arange(n, device=frames.device)[None, :]).reshape(-1)
        y = frames.new_zeros(lead + (total,))
        y.index_add_(-1, idx, frames.reshape(lead + (t * n,)))

    y = y / _cola_envelope(n, hop, t, w64.tobytes(), float(eps), frames.dtype,
                           frames.device)
    if boundary:
        y = y[..., n - hop:]
    if length is not None:
        y = y[..., :length]
    return y


def stft_roundtrip_scale_check() -> Tuple[float, float]:
    """The forward x2 packing and the 0.5/N inverse cancel: documented
    identity."""
    return 2.0, 0.5
