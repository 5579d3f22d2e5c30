"""Partition-MAC kernels for Hopper: the counterpart of ``fft/pallas_kernels.py``.

============================  ======================================  ======================
function                      replaces (hisstools_library_tpu/...)    CUDA source
============================  ======================================  ======================
:func:`lag_mac_causal` (K3)   fft/pallas_kernels.py: lag_mac_causal   csrc/lag_mac_causal.cu
:func:`lag_mac_ring` (K7)     fft/pallas_kernels.py: lag_mac_ring     csrc/ring_mac.cu
:func:`hop_fire` (K9)         fft/pallas_kernels.py: hop_fire         csrc/hop_fire.cu
:func:`lag_mac` (K15)         fft/pallas_kernels.py: lag_mac          csrc/ring_mac.cu
:func:`bin_mul` (K16)         none (ops/spectral.py: jnp)             csrc/bin_product.cu
:func:`bin_mul_conj` (K16)    none (ops/spectral.py: jnp)             csrc/bin_product.cu
:func:`bin_deconvolve` (K16)  none (models/pipeline.py: jnp)          csrc/bin_product.cu
:func:`bin_floor` (K16)       none (models/pipeline.py: jnp)          csrc/bin_product.cu
============================  ======================================  ======================

K7, K15 and K8's state kernel (``hopper_fft.stream_state``) are three entry
points of one kernel, the ring MAC (``csrc/ring_mac.cu``): rows of V from one
source or two, H at a channel stride, an optional lag-0 term and an optional
new ring, streamed by bulk copies through shared-memory stages;
:func:`_ring_mac_plan` mirrors its plan. K9 fires a small section in one
launch on the register-DFT core of K10 / K11 (``csrc/reg_fft.cuh``), the old
ring's lag sum staged while the forward runs; :func:`_fire_plan` mirrors its
plan. K16 is one streaming pass over packed bins for the per-bin products
of the spectral ops: ``bin_mul`` (convolution), ``bin_mul_conj``
(correlation) and ``bin_deconvolve`` (the regularised division, its floor
from ``bin_floor``), the TPU package's ``jnp`` steps. Each wrapper runs its
plain PyTorch version (``<name>_plain``) only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Launches are counted in
``<wrapper>.launches``; K9, which transforms, also counts the points of its
forward and inverse transforms (2 x frames x N) in ``hop_fire.points``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..core.types import Split, packed_mul, packed_mul_conj
from ..utils.profiling import span

# K9's envelope: the TPU kernel's sizes (N <= 1024, P <= 256, its unroll
# bound) without its VMEM model; N >= 32 is the engine's smallest FFT size.
HOP_FIRE_MIN_N = 32
HOP_FIRE_MAX_N = 1024
HOP_FIRE_MAX_P = 256

# K9's plan (csrc/hop_fire.cu: kLanes, kR, kMaxHelpers, kLagsPerHelper,
# kMaxStages, kStageBudget, kPlanes; kMaxP is HOP_FIRE_MAX_P): a block serves
# one frame group of 32 lanes (warp 0) with helper warps that sum the old
# ring's lags.
FIRE_LANES = 32           # a frame group: one warp, F = 32 / T frames of T = M/16 lanes
FIRE_POINTS = 16          # points a thread holds (reg_fft.cuh kR)
FIRE_MAX_HELPERS = 7      # helper warps a block (256 threads with warp 0)
FIRE_LAGS_PER_HELPER = 4  # the plan adds a helper a this many lags
FIRE_MAX_STAGES = 4       # cp.async stages a helper
FIRE_STAGE_BUDGET = 16    # helpers x stages a block (128 KB of stages)
FIRE_PLANES = 4           # a stage: ring re, ring im, H re, H im

# The ring MAC (csrc/ring_mac.cu: kBins, kThreads, kStages, kMaxHops, kMinBins, kRows).
RING_MAC_BINS = 256      # the most bins a block (a tile), one a consumer thread
RING_MAC_THREADS = 288   # the most threads a block: 256 consumers and a producer warp
RING_MAC_STAGES = 8      # shared-memory stages, an item each
RING_MAC_MAX_HOPS = 16   # hops a chunk: accumulators a thread
RING_MAC_MIN_BINS = 16   # the least K: 64-byte rows for the bulk copies
RING_MAC_ROWS = 2        # rows of V a row item carries
# The ring MAC's matrix form (csrc/ring_mac.cu ring_mac_matrix, K8's matrix form)
RING_MAC_MATRIX_BINS = 128   # bins a block, one a consumer thread
RING_MAC_MATRIX_GROUP = 5    # outputs a block
RING_MAC_MATRIX_STAGES = 5   # shared-memory stages, an item each
RING_MAC_MATRIX_HOPS = 8     # hops a chunk: accumulators an output


class FirePlan(NamedTuple):
    """How K9 (``csrc/hop_fire.cu``) runs one firing of C channels at real
    size N with P partitions."""
    threads_per_frame: int   # T = M / 16 lanes, M = N/2 <= 512: a frame in one warp
    frame_group: int         # F = 32 / T: warp 0's lanes, the frames a block
    helpers: int             # H: warps 1..H sum the old ring's lags (helper 0: H[0] too)
    threads: int             # 32 (1 + H)
    blocks: int              # ceil(C / F)
    lags_per_helper: int     # ceil((P - 1) / H): helper h takes lags h, h + H, ...
    stages: int              # cp.async stages a helper: min(4, lags a helper, 16 / H)
    shared_bytes: int        # dynamic: H[0], E and the H sums in padded rows,
                             # the stages, the frames, M twiddles


def _fire_plan(c: int, n: int, p: int) -> FirePlan:
    """K9's plan at (C, N, P), as ``csrc/hop_fire.cu``'s ``fire_plan`` and
    launch make it: one frame group of F = 32 / T frames a block (warp 0's
    lanes); a helper warp a 4 of the old ring's P - 1 lags (1..7); up to 4
    stages a helper of four 512-float plane rows, at most 16 stages a
    block."""
    if not hop_fire_eligible(n, p) or c < 1:
        raise ValueError(f"K9 serves C >= 1, N = {HOP_FIRE_MIN_N}..{HOP_FIRE_MAX_N}, "
                         f"P = 1..{HOP_FIRE_MAX_P}; got C = {c}, N = {n}, P = {p}")
    m = n // 2
    t = m // FIRE_POINTS
    f = FIRE_LANES // t
    lags = p - 1
    h = min(max(-(-lags // FIRE_LAGS_PER_HELPER), 1), FIRE_MAX_HELPERS)
    per = -(-lags // h)
    s = min(per, FIRE_MAX_STAGES, FIRE_STAGE_BUDGET // h)
    fin = f * (m + max(t, 4))
    floats = (h + 2) * 2 * fin + h * s * FIRE_PLANES * FIRE_LANES * FIRE_POINTS
    return FirePlan(t, f, h, FIRE_LANES * (1 + h), -(-c // f), per, s,
                    4 * floats + 8 * (f * (m + m // 16) + m))


def _fire_max_bytes(n: int) -> int:
    """K9's opt-in for dynamic shared memory at real size N, as
    ``csrc/hop_fire.cu``'s ``fire_max_bytes`` sets it: the most any P =
    1..256 asks (4 helpers x 4 stages, P = 14..17)."""
    return max(_fire_plan(1, n, p).shared_bytes for p in range(1, HOP_FIRE_MAX_P + 1))


class RingMacPlan(NamedTuple):
    """How the ring MAC runs one call over C channels, T hops, P lags and K
    bins."""
    bins_per_tile: int       # B = min(K, 256) consecutive bins of a channel
    tiles_per_channel: int   # K / B
    tiles: int               # C * K / B: the grid, one block a tile
    hops_per_chunk: int      # TU: the least power of two >= min(T, 16)
    chunks: int              # ceil(T / TU)
    items: int               # streamed a block: T rows of V two an item, P (H, V) pairs a chunk
    stages: int              # shared-memory stages
    threads: int             # a block: 32 * ceil(B / 32) consumers and the producer warp
    shared_bytes: int        # static shared memory a block: stages and mbarriers


def ring_mac_served(k: int) -> bool:
    """True when the ring MAC serves K bins a row: 16, 32, 64, 128 (one
    narrow tile a channel) or a multiple of 256."""
    return k % RING_MAC_BINS == 0 or (RING_MAC_MIN_BINS <= k < RING_MAC_BINS
                                      and k & (k - 1) == 0)


def _ring_mac_plan(c: int, t: int, p: int, k: int) -> RingMacPlan:
    """The ring MAC's plan at (C, T, P, K), as ``csrc/ring_mac.cu`` makes it:
    a block a tile of min(K, 256) bins of one channel, a consumer thread a
    bin and a producer warp; chunks of the least power
    of two >= min(T, 16) hops, each chunk's rows of V (two an item) then P
    (H_q, V) pairs as items through 8 stages of four plane runs of 256
    floats, a full and an empty mbarrier each."""
    if not ring_mac_served(k) or min(c, t, p) < 1:
        raise ValueError(f"the ring MAC serves C, T, P >= 1 and K = 16, 32, 64, 128 or a "
                         f"multiple of 256, got C = {c}, T = {t}, P = {p}, K = {k}")
    bins = min(k, RING_MAC_BINS)
    tu = 1
    while tu < min(t, RING_MAC_MAX_HOPS):
        tu *= 2
    chunks = -(-t // tu)
    last = t - (chunks - 1) * tu
    rows = RING_MAC_ROWS
    items = (chunks - 1) * (-(-tu // rows) + p) + -(-last // rows) + p
    shared = RING_MAC_STAGES * (4 * RING_MAC_BINS * 4 + 2 * 8)
    return RingMacPlan(bins, k // bins, c * (k // bins), tu, chunks, items, RING_MAC_STAGES,
                       -(-bins // 32) * 32 + 32, shared)


class RingMacMatrixPlan(NamedTuple):
    """How the ring MAC's matrix form runs one call over M outputs, N
    inputs, T hops, P lags and K bins."""
    groups: int              # ceil(M / 5): outputs five a block
    tiles: int               # K / 128 * groups: the grid, tile-major, group-minor
    hops_per_chunk: int      # TU: the least power of two >= min(T, 8)
    chunks: int              # ceil(T / TU)
    rows_per_item: int       # V rows a row item carries: 6
    items: int               # a block: for each chunk and input, its row items and P lag items
    threads: int             # 128 consumers and a producer warp
    shared_bytes: int        # dynamic shared memory: 5 stages of 12 runs, the total, mbarriers


def _ring_mac_matrix_plan(m: int, n: int, t: int, p: int, k: int) -> RingMacMatrixPlan:
    """The plan of ``csrc/ring_mac.cu``'s ``ring_mac_matrix`` at (M outputs,
    N inputs, T, P, K): a block a tile of 128 bins and a group of five
    outputs; chunks of the least power of two >= min(T, 8) hops; for each
    chunk and input, row items of up to six V rows, then P lag items (the
    group's H rows and one V row), through 5 stages of 12 plane runs of 128
    floats; a shared-memory total of the group's 5 x TU accumulators."""
    if k % RING_MAC_MATRIX_BINS or min(m, n, t, p) < 1:
        raise ValueError(f"the ring MAC's matrix form serves M, N, T, P >= 1 and K a "
                         f"multiple of 128, got M = {m}, N = {n}, T = {t}, P = {p}, K = {k}")
    group = RING_MAC_MATRIX_GROUP
    tu = 1
    while tu < min(t, RING_MAC_MATRIX_HOPS):
        tu *= 2
    chunks = -(-t // tu)
    rows = group + 1
    items = n * sum(-(-min(tu, t - t0) // rows) + p for t0 in range(0, t, tu))
    groups = -(-m // group)
    runs = RING_MAC_MATRIX_STAGES * (2 * group + 2) + group * tu * 2
    return RingMacMatrixPlan(groups, k // RING_MAC_MATRIX_BINS * groups, tu, chunks, rows,
                             items, RING_MAC_MATRIX_BINS + 32,
                             runs * RING_MAC_MATRIX_BINS * 4 + 2 * RING_MAC_MATRIX_STAGES * 8)


def _ring_mac_design_bytes(c: int, t: int, p: int, k: int, ring_out: bool,
                           lag0: bool) -> int:
    """HBM bytes the ring MAC moves at (C, T, P, K): the P + T rows of V, H
    and the optional L0 read once, Y and the optional new ring written once,
    and H and P rows of V read again for each chunk after the first."""
    plane = 8 * c * k  # one complex row a channel
    chunks = _ring_mac_plan(c, t, p, k).chunks
    return plane * ((p + t) + p + t + (p if ring_out else 0) + (1 if lag0 else 0)
                    + 2 * p * (chunks - 1))


def _ring_mac_shape(kernel: str, k: int) -> None:
    if not ring_mac_served(k):
        raise NotImplementedError(
            f"{kernel}: the ring MAC (csrc/ring_mac.cu) serves K = 16, 32, 64, 128 and "
            f"multiples of 256 bins a row, got K = {k}")


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


@span("kernel.K3.lag_mac_causal")
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


@span("kernel.K7.lag_mac_ring")
def lag_mac_ring(hist_re: torch.Tensor, hist_im: torch.Tensor,
                 x_re: torch.Tensor, x_im: torch.Tensor,
                 h_re: torch.Tensor, h_im: torch.Tensor):
    """K7: streaming partition MAC with in-place ring reads, on the ring MAC.

    ``hist_*``: (C, P, K) oldest-first ring; ``x_*``: (C, T, K) new hop
    spectra; ``h_*``: (C, P, K) packed impulse spectra (a row slice or a
    channel-broadcast view is read in place). Returns (y_re, y_im, new_re,
    new_im): the T outputs Y_t = sum_p V[P+t-1-p] H_p over V = [hist | X] and
    the new ring V[T:T+P], a new tensor (never hist). K = 16, 32, 64, 128 or a
    multiple of 256 on the card."""
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
    y_re = torch.zeros_like(x_re) if p == 0 else torch.empty_like(x_re)
    y_im = torch.zeros_like(x_im) if p == 0 else torch.empty_like(x_im)
    if c * t * p * k == 0:  # nothing to sum, or no hop: the ring moves by T rows
        return y_re, y_im, hist_re.clone(), hist_im.clone()
    _ring_mac_shape(kernel, k)
    n_re = torch.empty_like(hist_re)
    n_im = torch.empty_like(hist_im)
    hist_re, hist_im = _build.aligned(hist_re), _build.aligned(hist_im)
    x_re, x_im = _build.aligned(x_re), _build.aligned(x_im)
    h_re, h_im, cs = _build.aligned_rows(h_re, h_im)
    rc = _build.load().hst_lag_mac_ring(
        hist_re.data_ptr(), hist_im.data_ptr(), x_re.data_ptr(), x_im.data_ptr(),
        h_re.data_ptr(), h_im.data_ptr(), cs, y_re.data_ptr(), y_im.data_ptr(),
        n_re.data_ptr(), n_im.data_ptr(), c, t, p, k, _build.stream(x_re.device))
    _build.check(rc, kernel)
    lag_mac_ring.launches += 1
    return y_re, y_im, n_re, n_im


lag_mac_ring.launches = 0


def lag_mac_plain(xpad_re: torch.Tensor, xpad_im: torch.Tensor,
                  h_re: torch.Tensor, h_im: torch.Tensor, t: int,
                  lead_skip: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Y_t = sum_p V[P-1-p+t] * H_p over V = xpad[..., lead_skip:, :], one
    packed product per lag, accumulated in place. Any leading axes; ``h_*``
    broadcasts against ``xpad_*``'s."""
    p = h_re.shape[-2]
    acc_re = torch.zeros(xpad_re.shape[:-2] + (t, xpad_re.shape[-1]),
                         dtype=xpad_re.dtype, device=xpad_re.device)
    acc_im = torch.zeros_like(acc_re)
    for lag in range(p):
        start = lead_skip + p - 1 - lag
        prod = packed_mul(Split(xpad_re[..., start:start + t, :],
                                xpad_im[..., start:start + t, :]),
                          Split(h_re[..., lag:lag + 1, :], h_im[..., lag:lag + 1, :]))
        acc_re += prod.re
        acc_im += prod.im
    return acc_re, acc_im


@span("kernel.K15.lag_mac")
def lag_mac(xpad_re: torch.Tensor, xpad_im: torch.Tensor, h_re: torch.Tensor,
            h_im: torch.Tensor, t: int, lead_skip: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15: partition MAC over zero-padded spectra, on the ring MAC.

    ``xpad_*``: (C, S+T+P, K), X_t at row S+t+P (P zeros or history in front,
    S = ``lead_skip`` ignored leading rows); ``h_*``: (C, P, K) partition
    spectra (a row slice or a channel-broadcast view is read in place).
    Returns (C, T, K) packed-correct accumulations Y_t = sum_p
    V[P-1-p+t] * H_p, V = xpad[:, S:]. Any T and P; K = 16, 32, 64, 128 or a
    multiple of 256 on the card."""
    if xpad_re.device.type == "cpu":
        return lag_mac_plain(xpad_re, xpad_im, h_re, h_im, t, lead_skip)
    kernel = "K15 lag_mac"
    _build.check_tensors(kernel, xpad_re, xpad_im)
    _build.check_tensors(kernel, xpad_re, h_re, h_im, contiguous=False)
    if xpad_re.dim() != 3 or xpad_im.shape != xpad_re.shape:
        raise ValueError(f"{kernel}: X planes must be (C, S+T+P, K) of one shape")
    c, tp, k = xpad_re.shape
    p = h_re.shape[1] if h_re.dim() == 3 else -1
    if h_re.shape != (c, p, k) or h_im.shape != h_re.shape:
        raise ValueError(f"{kernel}: H planes must be (C, P, K) = ({c}, P, {k}), "
                         f"got {tuple(h_re.shape)} and {tuple(h_im.shape)}")
    if tp != lead_skip + t + p:
        raise ValueError(f"{kernel}: {tp} X rows, but lead_skip + T + P = "
                         f"{lead_skip} + {t} + {p}")
    y_re = torch.empty(c, t, k, dtype=torch.float32, device=xpad_re.device)
    y_im = torch.empty_like(y_re)
    if c * t * p * k == 0:  # no lag to sum: Y is zero
        return y_re.zero_(), y_im.zero_()
    _ring_mac_shape(kernel, k)
    xpad_re, xpad_im = _build.aligned(xpad_re), _build.aligned(xpad_im)
    h_re, h_im, cs = _build.aligned_rows(h_re, h_im)
    rc = _build.load().hst_lag_mac(
        xpad_re.data_ptr(), xpad_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
        cs, y_re.data_ptr(), y_im.data_ptr(), c, tp, t, p, k, lead_skip,
        _build.stream(xpad_re.device))
    _build.check(rc, kernel)
    lag_mac.launches += 1
    return y_re, y_im


lag_mac.launches = 0


def hop_fire_eligible(n: int, p: int) -> bool:
    """True when K9 serves a section of FFT size ``n`` with ``p`` partitions."""
    return (HOP_FIRE_MIN_N <= n <= HOP_FIRE_MAX_N and (n & (n - 1)) == 0
            and 1 <= p <= HOP_FIRE_MAX_P)


def hop_fire_plain(frame: torch.Tensor, ring_re: torch.Tensor, ring_im: torch.Tensor,
                   spec_re: torch.Tensor, spec_im: torch.Tensor):
    """One firing by ``torch.fft`` and a lag loop: the frame's spectrum joins
    the oldest-first ring as its newest slot (the oldest leaves), Y = sum_s
    ring'[s] * H[P-1-s], y = rifft(Y)[N/2:] / (4N)."""
    from .hopper_fft import rfft_packed_plain, rifft_packed_plain

    n = frame.shape[-1]
    p = ring_re.shape[-2]
    xre, xim = rfft_packed_plain(frame)
    new_re = torch.cat([ring_re[..., 1:, :], xre[..., None, :]], dim=-2)
    new_im = torch.cat([ring_im[..., 1:, :], xim[..., None, :]], dim=-2)
    acc_re = torch.zeros_like(xre)
    acc_im = torch.zeros_like(xim)
    for s in range(p):
        prod = packed_mul(Split(new_re[..., s, :], new_im[..., s, :]),
                          Split(spec_re[..., p - 1 - s, :], spec_im[..., p - 1 - s, :]))
        acc_re = acc_re + prod.re
        acc_im = acc_im + prod.im
    y = rifft_packed_plain(acc_re, acc_im)[..., n // 2:] * (1.0 / (4.0 * n))
    return new_re, new_im, y


@span("kernel.K9.hop_fire")
def hop_fire(frame: torch.Tensor, ring_re: torch.Tensor, ring_im: torch.Tensor,
             spec_re: torch.Tensor, spec_im: torch.Tensor):
    """K9: one hop-boundary firing of a small section (N = 32..1024, P <= 256).

    ``frame``: (..., N) the completed [prev | cur] frame, read in place when
    its channels lie a constant stride apart (a slice of a staging buffer);
    ``ring_*``: (..., P, N/2) oldest-first (the pos == 0 layout); ``spec_*``:
    (..., P, N/2) partition spectra (broadcast over the leading axes, read in
    place).
    Returns (new_ring_re, new_ring_im, y) with the new ring in new tensors and
    y (..., N/2) the kept output samples, scaled by 1/(4N)."""
    if frame.device.type == "cpu":
        return hop_fire_plain(frame, ring_re, ring_im, spec_re, spec_im)
    from .hopper_fft import _twiddles

    kernel = "K9 hop_fire"
    n = frame.shape[-1]
    k = n // 2
    p = ring_re.shape[-2]
    if not hop_fire_eligible(n, p):
        raise NotImplementedError(
            f"{kernel}: serves N = {HOP_FIRE_MIN_N}..{HOP_FIRE_MAX_N}, P = 1.."
            f"{HOP_FIRE_MAX_P}; got N = {n}, P = {p}")
    _build.check_tensors(kernel, ring_re, ring_im)
    _build.check_tensors(kernel, ring_re, frame, spec_re, spec_im, contiguous=False)
    lead = frame.shape[:-1]
    c = math.prod(lead)
    rows = frame.reshape(c, n) if frame.stride(-1) == 1 and frame.dim() <= 2 else \
        frame.reshape(c, n).contiguous()
    if ring_re.shape != lead + (p, k) or ring_im.shape != ring_re.shape:
        raise ValueError(f"{kernel}: ring {tuple(ring_re.shape)} does not fit "
                         f"the frame {tuple(frame.shape)} as (..., P, N/2)")
    hr, hi, cs = _build.aligned_rows(spec_re.expand(lead + (p, k)).reshape(c, p, k),
                                     spec_im.expand(lead + (p, k)).reshape(c, p, k))
    ring_re, ring_im = _build.aligned(ring_re), _build.aligned(ring_im)
    new_re = torch.empty_like(ring_re)
    new_im = torch.empty_like(ring_im)
    y = torch.empty(lead + (k,), dtype=torch.float32, device=frame.device)
    if c == 0:
        return new_re, new_im, y
    rc = _build.load().hst_hop_fire(
        rows.data_ptr(), rows.stride(0), ring_re.data_ptr(), ring_im.data_ptr(), hr.data_ptr(),
        hi.data_ptr(), cs, new_re.data_ptr(), new_im.data_ptr(), y.data_ptr(),
        _twiddles(n, frame.device).data_ptr(), c, p, n, 1.0 / (4.0 * n),
        _build.stream(frame.device))
    _build.check(rc, kernel)
    hop_fire.launches += 1
    hop_fire.points += 2 * c * n  # the frame's forward and the inverse
    return new_re, new_im, y


hop_fire.launches = 0
hop_fire.points = 0


# -----------------------------------------------------------------------------
# K16: per-bin products of packed spectra (csrc/bin_product.cu)
# -----------------------------------------------------------------------------

_BIN_CONV, _BIN_CORR, _BIN_DECONV = 0, 1, 2  # csrc/bin_product.cu's epilogues


def bin_mul_plain(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                  b_im: torch.Tensor, scale=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """a * b * scale of packed spectra, DC and Nyquist apart (:func:`packed_mul`)."""
    out = packed_mul(Split(a_re, a_im), Split(b_re, b_im), scale)
    return out.re, out.im


def bin_mul_conj_plain(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                       b_im: torch.Tensor, scale=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """a * conj(b) * scale of packed spectra (:func:`packed_mul_conj`)."""
    out = packed_mul_conj(Split(a_re, a_im), Split(b_re, b_im), scale)
    return out.re, out.im


def bin_floor_plain(x_re: torch.Tensor, x_im: torch.Tensor,
                    regularization: float) -> torch.Tensor:
    """``regularization * max_k |X_k|^2`` over the N/2 + 1 true bins of each
    row of packed planes (their x2 scale undone: DC ``re[0] / 2``, Nyquist
    ``im[0] / 2``), as (..., 1)."""
    power = torch.cat([x_re[..., :1] * x_re[..., :1], x_im[..., :1] * x_im[..., :1],
                       (x_re * x_re + x_im * x_im)[..., 1:]], dim=-1)
    return regularization * (power.amax(dim=-1, keepdim=True) * 0.25)


def bin_deconvolve_plain(y_re: torch.Tensor, y_im: torch.Tensor, x_re: torch.Tensor,
                         x_im: torch.Tensor, regularization: float, scale=1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The regularised quotient ``Y conj(X) / (|X|^2 + floor)`` of the true
    spectra (packed halves), ``floor`` from :func:`bin_floor_plain`, as a
    packed spectrum (x2 scale) times ``scale``; lane 0's DC and Nyquist each
    divided by its own power."""
    floor = bin_floor_plain(x_re, x_im, regularization)
    power = (x_re * x_re + x_im * x_im) * 0.25
    num_re = (y_re * x_re + y_im * x_im) * 0.25
    num_im = (y_im * x_re - y_re * x_im) * 0.25
    dc = (y_re[..., :1] * x_re[..., :1]) * 0.25 / (x_re[..., :1] * x_re[..., :1] * 0.25 + floor)
    nyq = (y_im[..., :1] * x_im[..., :1]) * 0.25 / (x_im[..., :1] * x_im[..., :1] * 0.25 + floor)
    denom = power + floor
    re = torch.cat([dc, (num_re / denom)[..., 1:]], dim=-1)
    im = torch.cat([nyq, (num_im / denom)[..., 1:]], dim=-1)
    return re * (2.0 * scale), im * (2.0 * scale)


def _bin_lead(kernel: str, a_shape, b_shape) -> Tuple[int, ...]:
    """The output's leading shape: the two operands' leading shapes broadcast."""
    try:  # numpy's: torch.broadcast_shapes imports sympy (seconds) on its first call
        return np.broadcast_shapes(tuple(a_shape[:-1]), tuple(b_shape[:-1]))
    except ValueError as e:
        raise ValueError(f"{kernel}: {e}") from None


def _row_stride(lead_of, lead: Tuple[int, ...], k: int):
    """K16's layout rule: an operand's planes (..., K) hold one row,
    broadcast over the output's rows (row stride 0), or every row of the
    output's leading shape ``lead`` (row stride K); None for any other."""
    if math.prod(lead_of) == 1:
        return 0
    return k if tuple(lead_of) == lead else None


def bin_operands(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                 b_im: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The planes of two packed operands in the layout K16 takes: an operand
    that is neither one row nor every row of the broadcast shape is expanded
    to every row, and each plane is made contiguous (copied only where it is
    not)."""
    lead = _bin_lead("K16", a_re.shape, b_re.shape)
    planes = []
    for re, im in ((a_re, a_im), (b_re, b_im)):
        if _row_stride(re.shape[:-1], lead, re.shape[-1]) is None:
            re, im = re.expand(lead + re.shape[-1:]), im.expand(lead + im.shape[-1:])
        planes += [re.contiguous(), im.contiguous()]
    return tuple(planes)


def _bin_layout(kernel: str, a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                b_im: torch.Tensor) -> Tuple[Tuple[int, ...], int, int, int]:
    """K16's operand layout: (the output's leading shape, K, a's row stride,
    b's row stride). Each operand is two contiguous float32 planes (..., K)
    in the layout of :func:`_row_stride`; any other layout raises
    (:func:`bin_operands` makes it)."""
    _build.check_tensors(kernel, a_re, a_im, b_re, b_im)
    k = a_re.shape[-1] if a_re.dim() else 0
    if (a_re.dim() == 0 or b_re.dim() == 0 or a_im.shape != a_re.shape
            or b_im.shape != b_re.shape or b_re.shape[-1] != k):
        raise ValueError(f"{kernel}: planes must be (..., K) with one K and each pair of "
                         f"one shape, got {tuple(a_re.shape)}, {tuple(a_im.shape)}, "
                         f"{tuple(b_re.shape)} and {tuple(b_im.shape)}")
    lead = _bin_lead(kernel, a_re.shape, b_re.shape)
    strides = [_row_stride(t.shape[:-1], lead, k) for t in (a_re, b_re)]
    for t, stride in zip((a_re, b_re), strides):
        if stride is None:
            raise ValueError(f"{kernel}: an operand of {tuple(t.shape)} is neither one row "
                             f"nor every row of {lead + (k,)}; expand it first "
                             f"(bin_operands)")
    return lead, k, strides[0], strides[1]


def _bin_product(wrapper, kernel: str, epilogue: int, a_re, a_im, b_re, b_im, scale,
                 regularization=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16's pass (the division's after :func:`bin_floor` of ``b``), counted
    on ``wrapper``; an empty output launches and counts nothing."""
    lead, k, a_rs, b_rs = _bin_layout(kernel, a_re, a_im, b_re, b_im)
    y_re = torch.empty(lead + (k,), dtype=torch.float32, device=a_re.device)
    y_im = torch.empty_like(y_re)
    rows = math.prod(lead)
    if rows * k == 0:
        return y_re, y_im
    floor = None if regularization is None else bin_floor(b_re, b_im, regularization)
    rc = _build.load().hst_bin_product(
        a_re.data_ptr(), a_im.data_ptr(), a_rs, b_re.data_ptr(), b_im.data_ptr(), b_rs,
        None if floor is None else floor.data_ptr(), 1 if b_rs else 0,
        y_re.data_ptr(), y_im.data_ptr(), rows, k, epilogue, scale,
        _build.stream(a_re.device))
    _build.check(rc, kernel)
    wrapper.launches += 1
    return y_re, y_im


@span("kernel.K16.bin_mul")
def bin_mul(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor, b_im: torch.Tensor,
            scale=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16, convolution: ``a * b * scale`` of packed spectra (N/2 bins, DC in
    re[0], Nyquist in im[0], each multiplied apart) in one pass; ``b`` (or
    ``a``) may be one row broadcast over the other's rows. Returns new
    contiguous planes."""
    if a_re.device.type == "cpu":
        return bin_mul_plain(a_re, a_im, b_re, b_im, scale)
    return _bin_product(bin_mul, "K16 bin_mul", _BIN_CONV, a_re, a_im, b_re, b_im, scale)


bin_mul.launches = 0


@span("kernel.K16.bin_mul_conj")
def bin_mul_conj(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                 b_im: torch.Tensor, scale=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16, correlation: ``a * conj(b) * scale`` of packed spectra, as
    :func:`bin_mul`."""
    if a_re.device.type == "cpu":
        return bin_mul_conj_plain(a_re, a_im, b_re, b_im, scale)
    return _bin_product(bin_mul_conj, "K16 bin_mul_conj", _BIN_CORR, a_re, a_im, b_re, b_im,
                        scale)


bin_mul_conj.launches = 0


# bin_floor's work words (a row's maximum and its count of blocks done), zero
# before a launch and left zero by it, by (device, stream): launches on one
# stream run in turn, and two streams never share them.
_FLOOR_WORK: dict = {}


def _floor_work(rows: int, device: torch.device) -> torch.Tensor:
    key = (device, _build.stream(device))
    work = _FLOOR_WORK.get(key)
    if work is None or work.numel() < 2 * rows:
        work = torch.zeros(max(2 * rows, 256), dtype=torch.int32, device=device)
        _FLOOR_WORK[key] = work
    return work


@span("kernel.K16.bin_floor")
def bin_floor(x_re: torch.Tensor, x_im: torch.Tensor, regularization: float) -> torch.Tensor:
    """K16's reduction: ``regularization * max_k |X_k|^2`` over the N/2 + 1
    true bins of each row of packed planes (..., K), as (..., 1) on the
    device, in one launch."""
    if x_re.device.type == "cpu":
        return bin_floor_plain(x_re, x_im, regularization)
    kernel = "K16 bin_floor"
    _build.check_tensors(kernel, x_re, x_im)
    if x_re.dim() == 0 or x_im.shape != x_re.shape:
        raise ValueError(f"{kernel}: planes must be (..., K) of one shape, got "
                         f"{tuple(x_re.shape)} and {tuple(x_im.shape)}")
    lead, k = tuple(x_re.shape[:-1]), x_re.shape[-1]
    out = torch.empty(lead + (1,), dtype=torch.float32, device=x_re.device)
    rows = math.prod(lead)
    if rows * k == 0:
        return out.zero_()
    rc = _build.load().hst_bin_floor(
        x_re.data_ptr(), x_im.data_ptr(), rows, k, regularization,
        _floor_work(rows, x_re.device).data_ptr(), out.data_ptr(),
        _build.stream(x_re.device))
    _build.check(rc, kernel)
    bin_floor.launches += 1
    return out


bin_floor.launches = 0


@span("kernel.K16.bin_deconvolve")
def bin_deconvolve(y_re: torch.Tensor, y_im: torch.Tensor, x_re: torch.Tensor,
                   x_im: torch.Tensor, regularization: float, scale=1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16, deconvolution: the regularised quotient ``Y conj(X) / (|X|^2 +
    regularization * max|X|^2)`` of the true spectra that the packed planes
    stand for, returned as a packed spectrum times ``scale``, in one pass
    after :func:`bin_floor` (one launch an excitation ``x``). ``x`` may be
    one row broadcast over ``y``'s rows, or a row each."""
    if y_re.device.type == "cpu":
        return bin_deconvolve_plain(y_re, y_im, x_re, x_im, regularization, scale)
    return _bin_product(bin_deconvolve, "K16 bin_deconvolve", _BIN_DECONV, y_re, y_im, x_re,
                        x_im, scale, regularization)


bin_deconvolve.launches = 0
