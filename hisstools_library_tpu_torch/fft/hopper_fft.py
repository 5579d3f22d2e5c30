"""FFT kernels for Hopper: the counterpart of ``fft/pallas_fft.py``.

Each TPU kernel of the ported paths has a hand-written CUDA kernel here
(sources in ``csrc/``, built by :mod:`.._build`) and a plain PyTorch version
beside it, in ``torch.fft``:

=================================  ========================================  ==============================
function                           replaces (hisstools_library_tpu/...)      CUDA source
=================================  ========================================  ==============================
:func:`rfft_packed`          (K1)  fft/pallas_fft.py: rfft_packed            csrc/rfft_packed.cu
:func:`rfft_packed_stream`   (K2)  fft/pallas_fft.py: rfft_packed_stream     csrc/rfft_packed_stream.cu
:func:`rifft_packed_tail`    (K4)  fft/pallas_fft.py: rifft_packed_tail      csrc/rifft_packed_tail.cu
:func:`fastfir_chain`        (K5)  fft/pallas_fft.py: fastfir_chain          csrc/fastfir_chain.cu
:func:`rifft_packed`         (K6)  fft/pallas_fft.py: rifft_packed           csrc/rifft_packed.cu
:func:`fastfir_chain_stream` (K8)  fft/pallas_fft.py: fastfir_chain_stream   csrc/fastfir_stream.cu
:func:`rfft_small`          (K10)  fft/pallas_fft.py: _small_fwd_call        csrc/rfft_small.cu
:func:`rifft_small`         (K11)  fft/pallas_fft.py: _small_inv_call        csrc/rifft_small.cu
:func:`rfft_small_windowed` (K10w) fft/pallas_fft.py: rfft_small_windowed    csrc/rfft_small.cu
:func:`rifft_small_windowed` (K11w) fft/pallas_fft.py: rifft_small_windowed  csrc/rifft_small.cu
:func:`fft_split`           (K12)  fft/pallas_fft.py: fft_split              csrc/fft_split.cu
:func:`rfft_packed_split`   (K13)  fft/pallas_fft.py: _rfft_packed_split     csrc/rfft_packed_split.cu
:func:`rifft_packed_split`  (K14)  fft/pallas_fft.py: _rifft_packed_split    csrc/rifft_packed_split.cu
the tiny forms, N < 32 (5)         fft/pallas_fft.py: matmul_fft fallback    csrc/fft_tiny.cu
=================================  ========================================  ==============================

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises: ``NotImplementedError`` names what
the kernels do not take (float64; sizes above 2^28, the largest FFT size of
the reference and of :mod:`.api`), and no path falls back to ``torch.fft``.
Each wrapper counts its
launches in ``<wrapper>.launches`` and the points they transform (frames x
N) in ``<wrapper>.points``, K8 its forward's and its inverse's.
:func:`rfft_packed` sends N = 32..2048 to
K10, N = 4096..2^17 to K1 and N = 2^18..2^28 to K13, and :func:`rifft_packed`
sends N = 32..2048 to K11, N = 4096..2^17 to K6 and N = 2^18..2^28 to K14, as
the TPU package's ``rfft_packed`` / ``rifft_packed`` send their small sizes to
``_rfft_small`` / ``_rifft_small`` and their large ones to the split pairs.
Below 32 points the TPU package leaves Pallas for its XLA-staged
``matmul_fft``; here K10, K11, K10w, K11w and K12 send real N = 2..16 and
complex N = 1..16 to the tiny forms :func:`rfft_tiny`,
:func:`rifft_tiny`, :func:`rfft_tiny_windowed`, :func:`rifft_tiny_windowed`
and :func:`fft_tiny` (``csrc/fft_tiny.cu``: one thread a frame, the DFT in
registers), so every power of two up to the limits below has a kernel.
:func:`fft_split` (K12) serves complex N = 32..2^28: frames of up to 1024
points in shared memory, 2048..2^16 in two passes over an HBM scratch frame
(``csrc/fft_common.cuh``, whose column pass K5 shares), 2^17 in one pass
on an 8-block thread-block cluster that holds the frame in its shared memory,
2^18..2^20 in two passes of 512..1024-point sub-FFTs and 2^21..2^28 in three
passes of 128..1024-point sub-FFTs (``csrc/fft_large.cuh``, which K13 and
K14 share at real 2^18..2^28). The long routes read no table of N
twiddles: the sub-FFTs' come from a table of 2048 (:func:`_large_twiddles`),
the rest are computed in float64 for each block's columns or rows.
:func:`_plan` mirrors the kernels' plan, and the wrappers size their scratch
from it: one frame per transform for two or three passes (the middle one in
place), none for the cluster. K1, the overlap-save forward K2 and the
inverses K4 and K6 (real 4096..2^17) take one pass at every size, with no
scratch: the frame of M = N/2 points in the shared memory of one block or of
a 2-, 4- or 8-block cluster (``csrc/fft_large.cuh``'s one-pass kernel, the
cluster route's generalisation); :func:`_onepass_plan` mirrors its plan. K2
reads each frame [x[t-1] | x[t]] in place from the hop blocks, its first
half zero at a channel's first hop. The inverses unpack the packed planes in
pairs in its column stage, a block's columns n1 and M1 - n1 together, so
each packed bin is read from HBM once.

The windowed forms K10w and K11w (N = 32..2048, the STFT's frames) are
instantiations of K10's and K11's kernels that multiply by the window in the
loader and the store; K10w reads its frames in place from a strided view (the
padded signal's ``unfold``). K10, K10w, K11 and K11w run on the register-DFT
core ``csrc/reg_fft.cuh`` (16 points a thread, radix-16 stages, one
shared-memory exchange between stages); K11's loader unpacks the packed
bins, each read once, pairing bin k with M - k across the frame's lanes.
:func:`_small_plan` mirrors the plan of all four.

K5 (:func:`fastfir_chain`, ``csrc/fastfir_chain.cu``, N = 2^14..2^17, any
P): the TPU kernel keeps each channel's spectra ring and impulse spectra on
chip (~7.9 MB at the main path's N = 2^16, P = 15), far beyond a Hopper
block's 227 KB, so the chain runs on the two-pass core in three phases (the
forward column pass, then one block per row pair of a channel that walks its
hops through the row pass, the pack, the MAC, the unpack and the inverse's
row pass, then the inverse's column pass), and the hop spectra and
accumulations never reach HBM. :func:`fastfir_chain_staged` is K2 -> K3 ->
K4, the chain at N = 4096..8192. K8 (:func:`fastfir_chain_stream`,
``csrc/fastfir_stream.cu``, N = 2^14..2^17, any P) carries a ring that other
kernels and the state converters read in natural bin order, so it splits the
chain where that state moves: the forward of every frame in one HBM pass on
K1's route, the state kernel :func:`stream_state` (the ring MAC of K7 and
K15, ``csrc/ring_mac.cu``: the ring, H, X and lag 0 by bulk copies over
contiguous bin ranges, each byte once), the inverse in one pass;
:func:`_stream_plan` mirrors its plan. Its matrix form
(:func:`fastfir_chain_stream_matrix`) runs an N-in / M-out matrix whose
pairs share one history an input as the same three launches: each input's
frames forward once, the ring MAC's matrix form (``ring_mac_matrix``:
blocks of 128 bins and five outputs, each output summed over the inputs,
H read once, one ring an input), each output's frames back once.

Precision: :func:`set_mode` keeps the TPU package's knob (``"bf16x3"`` or
``"highest"``). On Hopper both modes run the same FP32 SIMT kernels, with
twiddles computed in float64 and stored as float32; unlike the TPU's
"highest", which leaves 2^20 to the staged matmul path, both serve 2^20 and
above through K13/K14.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..core.types import Split, packed_mul
from ..utils.profiling import span
from .hopper_kernels import (_ring_mac_design_bytes, _ring_mac_plan, _ring_mac_shape,
                             lag_mac_causal, lag_mac_causal_plain, lag_mac_ring_plain)

MIN_REAL_SIZE = 4096
MAX_SINGLE_REAL = 1 << 17    # K1, K4 and K6: one pass
MAX_SPLIT_REAL = 1 << 28     # K13 / K14: N = 2^18..2^28 (csrc/fft_large.cuh)
MIN_COMPLEX = 32             # K12 serves complex N = 32..2^28 (fft_tiny below)
MAX_COMPLEX_SMEM = 1024      # K12 in shared memory up to here
MAX_CLUSTER = 1 << 17        # K12 on one cluster, with the N-entry twiddle table
MAX_COMPLEX = 1 << 28
# Above the kernels' sizes: the reference's and fft.api's own limit.
OVER_MAX = "above 2^28, the largest FFT size (fft.api.MAX_FFT_SIZE_LOG2)"
SMALL_MIN_REAL = 32          # K10 serves N = 32..2048 (rfft_tiny: 2..16)
# K5 and K8 serve N = 2^14..2^17, the TPU package's sizes for both
# (csrc/fastfir_chain.cu and csrc/fastfir_stream.cu).
CHAIN_MIN = 1 << 14
CHAIN_MAX = 1 << 17

_MODE = "highest"  # or "bf16x3"; both run the same FP32 kernels on Hopper


def set_mode(mode: str) -> None:
    """Set the precision mode ("highest" or "bf16x3"). Kept for callers of
    the TPU package; on Hopper both modes run the same FP32 kernels."""
    global _MODE
    if mode not in ("highest", "bf16x3"):
        raise ValueError(f"unknown fft mode {mode!r}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


def real_eligible(n: int) -> bool:
    """True when the real-FFT kernels serve size ``n`` (4096..2^17), the
    streaming forward (K2) and tail inverse (K4) among them: both run one
    pass on K1's plan, the frame in one block's or one cluster's shared
    memory, so no further on-chip memory model limits them."""
    return MIN_REAL_SIZE <= n <= MAX_SINGLE_REAL and (n & (n - 1)) == 0


def small_eligible(n: int) -> bool:
    """True when the small-FFT kernels (K10 / K11, with their tiny forms
    below 32 points) serve real size ``n`` = 2..2048."""
    return 2 <= n < MIN_REAL_SIZE and (n & (n - 1)) == 0


def split_eligible(n: int) -> bool:
    """True when the large real kernels (K13/K14) serve size ``n`` =
    2^18..2^28."""
    return MAX_SINGLE_REAL < n <= MAX_SPLIT_REAL and (n & (n - 1)) == 0


def complex_eligible(n: int) -> bool:
    """True when the complex kernel (K12, with its tiny form below 32
    points) serves size ``n`` = 1..2^28."""
    return 1 <= n <= MAX_COMPLEX and (n & (n - 1)) == 0


def chain_eligible(n: int) -> bool:
    """True for the sizes of the whole-chain kernels, K5 (at any P) and K8
    (N = 2^14..2^17), as the TPU package's ``fastfir_feasible`` and its
    process_block route gate them (less their VMEM models)."""
    return CHAIN_MIN <= n <= CHAIN_MAX and (n & (n - 1)) == 0


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 table tw[e] = exp(-2 pi i e / n), computed in float64.
    Built for the kernels of real N <= 2^18 (complex 2^17) only: the long
    routes above read the 2048-entry table (:func:`_large_twiddles`)."""
    if n > 2 * MAX_CLUSTER:
        raise ValueError(f"no twiddle table of {n} entries: the long routes read "
                         "_large_twiddles' 2048")
    ang = np.arange(n, dtype=np.float64) * (-2.0 * np.pi / n)
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _large_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """The table that ``run_fft_large`` (``csrc/fft_large.cuh``) reads at
    real size ``n`` (complex M = n / 2): the N-entry table on the cluster
    (M = 2^17); on the long routes W_2048^e, e < 2048, from which every
    sub-FFT's W_L (L <= 1024) and the split step's W_2L are read (their
    other twiddles the kernels compute in float64)."""
    return _twiddles(n if n <= 2 * MAX_CLUSTER else 2048, device)


def _check(kernel: str, n: int, *tensors: torch.Tensor) -> None:
    """Raise unless the real kernels of N = 4096..2^17 (K1, K2, K4, K6) take
    these tensors at size ``n``."""
    if not real_eligible(n):
        if n < MIN_REAL_SIZE:
            missing = ("K10 (forward) and K11 (inverse) serve N = 2..2048 through "
                       "rfft_packed / rifft_packed; a small form of this kernel not yet "
                       "ported")
        elif n <= MAX_SPLIT_REAL:
            missing = ("K13/K14 serve N = 2^18..2^28 through rfft_packed / "
                       "rifft_packed; a large form of this kernel not yet ported")
        else:
            missing = OVER_MAX
        raise NotImplementedError(
            f"{kernel}: serves N = {MIN_REAL_SIZE}..{MAX_SINGLE_REAL}; N = {n}: {missing}")
    _build.check_tensors(kernel, *tensors)


def _check_split(kernel: str, n: int, *tensors: torch.Tensor) -> None:
    """Raise unless the large real kernel takes these tensors at ``n``."""
    if not split_eligible(n):
        missing = (OVER_MAX if n > MAX_SPLIT_REAL else
                   "rfft_packed / rifft_packed serve smaller sizes through K1/K6 "
                   "and K10/K11")
        raise NotImplementedError(
            f"{kernel}: serves N = {2 * MAX_SINGLE_REAL}..{MAX_SPLIT_REAL}; N = {n}: "
            f"{missing}")
    _build.check_tensors(kernel, *tensors)


def _check_small(kernel: str, n: int) -> None:
    if not small_eligible(n):
        raise NotImplementedError(
            f"{kernel}: serves N = 2..{MIN_REAL_SIZE // 2}, got N = {n}")


class Plan(NamedTuple):
    """How the multi-pass core serves one complex size M."""
    route: str                # "two-pass", "cluster", "two-pass-long" or
                              # "three-pass"
    lengths: Tuple[int, ...]  # sub-FFT lengths by pass: (column, row), or
                              # (column, middle, row) for three passes
    hbm_passes: int           # times the frame goes through HBM
    scratch_frames: int       # HBM scratch frames of M float2 per transform


def _plan(n: int) -> Plan:
    """The plan of ``make_plan`` (``csrc/fft_common.cuh``) for real size
    ``n``, complex M = n / 2 = 2048..2^28: two passes of sub-FFTs <= 256 up
    to M = 2^16; one pass on an 8-block cluster at 2^17 (512-point columns,
    256-point rows); two passes of 512-point columns and 512- or 1024-point
    rows at 2^18..2^19, 1024 x 1024 at 2^20; above that three passes
    (M = 2^lm): rows of 2^(lm // 3) points, a middle pass of
    2^((lm - lm // 3) // 2) and columns of the rest, one scratch frame (the
    middle pass runs in place)."""
    lm = int(n).bit_length() - 2
    if n & (n - 1) or not 11 <= lm <= 28:
        raise ValueError(f"the multi-pass core serves complex M = 2^11..2^28, got n = {n}")
    if lm <= 16:
        return Plan("two-pass", (1 << (lm - lm // 2), 1 << (lm // 2)), 2, 1)
    if lm == 17:
        return Plan("cluster", (512, 256), 1, 0)
    if lm <= 20:
        first = 1024 if lm == 20 else 512
        return Plan("two-pass-long", (first, (1 << lm) // first), 2, 1)
    last = lm // 3
    mid = (lm - last) // 2
    return Plan("three-pass", (1 << (lm - last - mid), 1 << mid, 1 << last), 3, 1)


class OnePassPlan(NamedTuple):
    """How K1's one-pass route (``csrc/rfft_packed.cu``, ``K1Pass``; also
    K2's, K4's, K6's and K8's transforms) serves one complex size M: the
    frame in the shared memory of ``blocks`` blocks."""
    route: str                # "one-pass"
    lengths: Tuple[int, int]  # (column, row) sub-FFT lengths: M1 columns of
                              # lengths[0] = M2 points, M2 rows of lengths[1] = M1
    blocks: int               # C: 1, or a thread-block cluster of 2..8
    threads: int              # a block
    shared_bytes: int         # dynamic shared memory a block
    hbm_passes: int           # 1
    scratch_frames: int       # 0


def _inplace_tile(length: int) -> int:
    """Slots of one row tile of ``fft_large.cuh``'s InPlace<L>: L = A*B
    (A = 2^(log2 L // 2)) as B groups of A + 1 slots, and one slot more."""
    a = 1 << (length.bit_length() - 1) // 2
    return (length // a) * (a + 1) + 1


def _onepass_plan(n: int) -> OnePassPlan:
    """K1's plan for real size ``n`` = 4096..2^17 (complex M = 2^11..2^16):
    M1 = 64 columns up to M = 2^12, 128 at 2^13..2^15, 256 at 2^16; one
    block up to M = 2^13, above it a cluster of M / 2^13 blocks of 8192
    points each; 256 threads a block at M = 2^11, 2^12 and 2^15, 512 at
    2^13, 2^14 and 2^16. A block's shared memory is its share of the frame
    (its columns of M2 + 1 slots, then its rows, each in a tile of
    :func:`_inplace_tile` slots) and the twiddle tables: the pack's (M1 +
    the block's rows), W_512 and W_M^e for e < 512, and W_M^(512 h)."""
    lm = int(n).bit_length() - 2
    if not real_eligible(n):
        raise ValueError(f"K1's one-pass route serves real N = {MIN_REAL_SIZE}.."
                         f"{MAX_SINGLE_REAL}, got n = {n}")
    m = 1 << lm
    cols = 64 if lm <= 12 else 128 if lm <= 15 else 256
    blocks = 1 if lm <= 13 else 1 << (lm - 13)
    threads = 256 if lm in (11, 12, 15) else 512
    col_len = m // cols
    own_cols, own_rows = cols // blocks, col_len // blocks
    frame = max(own_cols * (col_len + 1), own_rows * _inplace_tile(cols))
    shared = 8 * (frame + cols + own_rows + 2 * 512 + m // 512)
    return OnePassPlan("one-pass", (col_len, cols), blocks, threads, shared, 1, 0)


CHAIN_CLUSTER = 4        # blocks of consecutive row pairs in a cluster
SMEM_BLOCK_MAX = 232448  # shared memory a block can use on the H100
SMEM_SM = 233472         # an SM's shared memory, 1 KB of it reserved a block


class ChainPlan(NamedTuple):
    """How K5's middle phase (``csrc/fastfir_chain.cu`` ``chain_mid``)
    runs one launch: a block per (channel, row pair (j, R-j)) of the
    two-pass split M = R x L, walking the hops in chunks."""
    row_len: int             # L = M1, points a row
    rows: int                # R = M / L
    pairs: int               # blocks a channel: R / 2
    chunk_rows: int          # rows a chunk (two a hop): 256 / (L / 16), at most 32
    chunks: int              # ceil(T / (chunk_rows / 2))
    ring_in_smem: bool       # ring and H in shared memory (else a global scratch)
    tiles: int               # FFT tiles: 2 double-buffers the chunks' rows
    shared_bytes: int        # dynamic shared memory a block
    blocks_per_sm: int       # by shared memory, and at most 2 by registers


def _chain_plan(n: int, p: int, t: int) -> ChainPlan:
    """The middle phase's plan at real size ``n`` = 2^14..2^17 with ``p``
    lags over ``t`` hops, as ``chunk_rows`` / ``mid_smem`` / ``mid_tiles``
    in ``csrc/fastfir_chain.cu`` make it: a chunk of as many rows as the
    row DFTs (L/16 threads a row) keep 256 threads busy, at most 32; shared
    memory for the FFT tiles (their rows in ``reg_fft.cuh``'s padded frames
    of L + L/16), 5L twiddles and, while a block holds them, ring and H (2P
    rows of 2L); ring and H in shared memory where they fit beside one
    tile, and a second tile where there is more than one chunk and a block
    has its SM to itself with one tile."""
    if not chain_eligible(n):
        raise ValueError(f"the chain family serves N = {CHAIN_MIN}..{CHAIN_MAX}, got n = {n}")
    lm = n.bit_length() - 2
    row_len = 1 << (lm // 2)
    rows = (1 << lm) // row_len
    chunk = min(32, SMALL_THREADS // (row_len // SMALL_POINTS))
    chunks = -(-t // (chunk // 2))

    def smem(ring: bool, tiles: int) -> int:
        return 8 * (tiles * chunk * (row_len + row_len // 16) + 5 * row_len
                    + (4 * p * row_len if ring else 0))

    def per_sm(shared: int) -> int:
        return min(2, SMEM_SM // (shared + 1024))

    ring = smem(True, 1) <= SMEM_BLOCK_MAX
    two = smem(ring, 2)
    tiles = 2 if chunks > 1 and two <= SMEM_BLOCK_MAX and per_sm(smem(ring, 1)) == 1 else 1
    shared = smem(ring, tiles)
    return ChainPlan(row_len, rows, rows // 2, chunk, chunks, ring, tiles, shared,
                     per_sm(shared))


class StreamPlan(NamedTuple):
    """How K8 (``csrc/fastfir_stream.cu``) runs one call at real size N over
    T hops with P lags: three launches, the forward and the inverse on K1's
    one-pass route, the state kernel (the ring MAC) between them."""
    form: str               # "split": forward, state kernel, inverse (the only form)
    transform: OnePassPlan  # the forward's and the inverse's one-pass route
    bins_per_block: int     # the state kernel's bins a block (one a consumer thread)
    blocks_per_channel: int  # K / bins_per_block
    hops_per_chunk: int     # TU: the least power of two >= min(T, 16)
    chunks: int             # ceil(T / TU)
    items: int              # rows streamed a block: T X rows, P (H, V) pairs a chunk
    stages: int             # shared-memory stages
    shared_bytes: int       # the state kernel's static shared memory a block


def _stream_plan(n: int, t: int, p: int) -> StreamPlan:
    """K8's plan at real size ``n`` = 2^14..2^17 over ``t`` >= 1 hops with
    ``p`` >= 1 lags, as ``csrc/fastfir_stream.cu`` makes it: the split form
    at every shape (the fused four-step form, which moved the ring and H
    inside the chain's middle phase, measured slower at every shape of one
    A/B call on an H100 and was removed; PERF.md §6); both transforms
    on :func:`_onepass_plan`'s route; the state kernel is the ring MAC
    (``csrc/ring_mac.cu``, :func:`hopper_kernels._ring_mac_plan`): blocks of
    256 bins, chunks of the least power of two >= min(T, 16) hops, 8 stages
    of four plane runs of 256 floats (the X row's two, or H_q's and V's four)
    and their full and empty mbarriers."""
    if not chain_eligible(n):
        raise ValueError(f"K8 serves N = {CHAIN_MIN}..{CHAIN_MAX}, got n = {n}")
    if t < 1 or p < 1:
        raise ValueError(f"K8's state kernel takes T >= 1 and P >= 1, got T = {t}, P = {p}")
    mac = _ring_mac_plan(1, t, p, n // 2)
    return StreamPlan("split", _onepass_plan(n), mac.bins_per_tile, mac.tiles_per_channel,
                      mac.hops_per_chunk, mac.chunks, mac.items, mac.stages, mac.shared_bytes)


def _stream_design_bytes(c: int, t: int, p: int, n: int, lag0: bool) -> int:
    """HBM bytes K8's split form moves at (C, T, P, N): the forward reads
    each frame's two halves (each hop block twice, hop 0's first half from
    the carried block) and writes X; the state kernel reads X, the ring, H
    and L0 and writes Y and the new ring, and re-reads H and the V rows
    once per chunk after the first; the inverse reads Y and writes the kept
    halves."""
    k = n // 2
    spec = 8 * c * t * k                      # one (C, T, N/2) complex plane pair
    state = _ring_mac_design_bytes(c, t, p, k, True, lag0)
    return (2 * 4 * c * t * k + spec) + state + (spec + 4 * c * t * k)


SMALL_POINTS = 16    # K10 / K11 (and windowed): points a thread holds (reg_fft.cuh kR)
SMALL_THREADS = 256  # threads a block


class SmallPlan(NamedTuple):
    """How the register-DFT core (``csrc/reg_fft.cuh``) serves one frame of
    complex size M = N/2 in K10 / K10w and K11 / K11w."""
    radices: Tuple[int, ...]  # Stockham stages, radix 16 then the remainder
    threads_per_frame: int    # T = M / 16
    warps_per_frame: int      # 1 up to M = 512 (32 / T frames a warp), 2 at 1024
    frames_per_block: int     # F = 256 / T
    shared_bytes: int         # F padded frames (M + M/16 float2) and M twiddles


def _small_plan(n: int) -> SmallPlan:
    """The plan of ``hst_reg::Plan`` for real size ``n`` = 32..2048: K10 /
    K10w's and K11 / K11w's, one plan for the forward and the inverse."""
    if not (small_eligible(n) and n >= SMALL_MIN_REAL):
        raise ValueError(f"the register-DFT core serves N = {SMALL_MIN_REAL}.."
                         f"{MIN_REAL_SIZE // 2}, got n = {n}")
    lm = n.bit_length() - 2
    m = 1 << lm
    radices = (16,) * (lm // 4) + ((1 << (lm % 4),) if lm % 4 else ())
    t = m // SMALL_POINTS
    frames = SMALL_THREADS // t
    return SmallPlan(radices, t, -(-t // 32), frames, 8 * (frames * (m + m // 16) + m))


def _scratch(frames: int, m: int, device) -> Optional[torch.Tensor]:
    """HBM scratch of the multi-pass core for ``frames`` complex transforms
    of M = ``m`` points, as :func:`_plan` sizes it: one frame of M float2
    each with two or three passes, None on the cluster (M = 2^17)."""
    per = _plan(2 * m).scratch_frames
    if per == 0:
        return None
    return torch.empty(per * frames, 2 * m, dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# -----------------------------------------------------------------------------
# Plain versions (torch.fft): the CPU path and the kernels' reference
# -----------------------------------------------------------------------------

def rfft_packed_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed real FFT by ``torch.fft``: x2 scale, Nyquist in ``im[0]``."""
    z = torch.fft.rfft(x, dim=-1)
    re = 2.0 * z.real
    im = 2.0 * z.imag
    return (re[..., :-1].contiguous(),
            torch.cat([re[..., -1:], im[..., 1:-1]], dim=-1))


def rifft_packed_plain(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Unscaled packed inverse by ``torch.fft``: rifft(rfft(x)) == 2N x."""
    n = 2 * re.shape[-1]
    zero = torch.zeros_like(re[..., :1])
    full_re = torch.cat([re, im[..., :1]], dim=-1)
    full_im = torch.cat([zero, im[..., 1:], zero], dim=-1)
    return torch.fft.irfft(torch.complex(full_re, full_im), n=n, dim=-1) * n


def rfft_packed_stream_plain(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectrum t = rfft_packed([x2d[t-1] | x2d[t]]), x2d[-1] = 0."""
    prev = torch.cat([torch.zeros_like(x2d[..., :1, :]), x2d[..., :-1, :]], dim=-2)
    return rfft_packed_plain(torch.cat([prev, x2d], dim=-1))


def rifft_packed_tail_plain(re: torch.Tensor, im: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """scale * rifft(Y_t)[H:] per hop."""
    return rifft_packed_plain(re, im)[..., re.shape[-1]:] * scale


# The plain versions of K10, K11, K13 and K14 are the packed real transforms
# themselves.
rfft_small_plain = rfft_packed_plain
rifft_small_plain = rifft_packed_plain
rfft_packed_split_plain = rfft_packed_plain
rifft_packed_split_plain = rifft_packed_plain
rfft_tiny_plain = rfft_packed_plain
rifft_tiny_plain = rifft_packed_plain


def rfft_small_windowed_plain(frames: torch.Tensor, window: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed real FFT of each windowed frame: rfft(frames * window)."""
    return rfft_packed_plain(frames * window)


def rifft_small_windowed_plain(re: torch.Tensor, im: torch.Tensor,
                               window: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * rifft(spec) * window, each frame."""
    return rifft_packed_plain(re, im) * (scale * window)


def fft_split_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled complex DFT (or N x IDFT) of split planes by ``torch.fft``."""
    if inverse:
        re, im = im, re
    z = torch.fft.fft(torch.complex(re, im), dim=-1)
    out_re, out_im = z.real.contiguous(), z.imag.contiguous()
    return (out_im, out_re) if inverse else (out_re, out_im)


rfft_tiny_windowed_plain = rfft_small_windowed_plain
rifft_tiny_windowed_plain = rifft_small_windowed_plain
fft_tiny_plain = fft_split_plain


def fastfir_chain_plain(x2d: torch.Tensor, h_re: torch.Tensor, h_im: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """K5 by ``torch.fft``: frames [x2d[t-1] | x2d[t]] (x2d[-1] = 0), the
    packed rfft X_t, the causal MAC Y_t = sum_{lag < P} X_{t-1-lag} H_lag
    (the bin-0 lane multiplies two real values), scale * rifft(Y_t)[H:]."""
    x_re, x_im = rfft_packed_stream_plain(x2d)
    y_re, y_im = lag_mac_causal_plain(x_re, x_im, h_re, h_im)
    return rifft_packed_tail_plain(y_re, y_im, scale)


def stream_state_plain(x_re, x_im, ring_re, ring_im, h_re, h_im, l0_re=None, l0_im=None):
    """K8's state kernel by the ring MAC's plain version: Y_t = sum_{lag <
    P} V_{t-1-lag} * H_lag over V = [ring | X] (+ X_t * l0), and the new ring
    oldest-first; returns (y_re, y_im, new_ring_re, new_ring_im)."""
    y_re, y_im, n_re, n_im = lag_mac_ring_plain(ring_re, ring_im, x_re, x_im, h_re, h_im)
    if l0_re is not None:
        prod = packed_mul(Split(x_re, x_im), Split(l0_re[:, None, :], l0_im[:, None, :]))
        y_re = y_re + prod.re
        y_im = y_im + prod.im
    return y_re, y_im, n_re, n_im


def fastfir_chain_stream_plain(x2d, prev, ring_re, ring_im, h_re, h_im,
                               scale: float, l0_re=None, l0_im=None):
    """The streaming chain by ``torch.fft`` and the state kernel's plain
    version: spectra of [x2d[t-1] | x2d[t]] (x2d[-1] = prev), Y_t = ring MAC
    over [ring | spectra] (+ X_t * l0), scale * rifft(Y_t)[H:]; returns
    (y, new_ring_re, new_ring_im)."""
    prev_rows = torch.cat([prev[:, None, :], x2d[:, :-1, :]], dim=1)
    x_re, x_im = rfft_packed_plain(torch.cat([prev_rows, x2d], dim=-1))
    y_re, y_im, n_re, n_im = stream_state_plain(x_re, x_im, ring_re, ring_im, h_re, h_im,
                                                l0_re, l0_im)
    return rifft_packed_tail_plain(y_re, y_im, scale), n_re, n_im


def stream_state_matrix_plain(x_re, x_im, ring_re, ring_im, h_re, h_im, l0_re=None,
                              l0_im=None):
    """The matrix form of K8's state kernel by packed products: for inputs
    n < N with spectra ``x_*`` (N, T, K) and rings ``ring_*`` (N, P, K), and
    pairs (m, n) with ``h_*`` (M, N, P, K) and ``l0_*`` optional (M, N, K),
    Y_m,t = sum_n [sum_{lag < P} V_n,t-1-lag H_m,n,lag (+ X_n,t l0_m,n)] over
    V_n = [ring_n | X_n], each lag's products summed over the inputs; returns
    (y_re (M, T, K), y_im, new_ring_re (N, P, K), new_ring_im)."""
    p, t = ring_re.shape[-2], x_re.shape[-2]
    v_re = torch.cat([ring_re, x_re], dim=-2)
    v_im = torch.cat([ring_im, x_im], dim=-2)
    shape = h_re.shape[:1] + x_re.shape[1:]
    y_re = x_re.new_zeros(shape)
    y_im = x_im.new_zeros(shape)
    terms = [(p - 1 - q, h_re[..., q:q + 1, :], h_im[..., q:q + 1, :]) for q in range(p)]
    if l0_re is not None:
        terms.append((p, l0_re[..., None, :], l0_im[..., None, :]))
    for s, hr, hi in terms:
        prod = packed_mul(Split(v_re[..., s:s + t, :], v_im[..., s:s + t, :]), Split(hr, hi))
        y_re += prod.re.sum(dim=1)
        y_im += prod.im.sum(dim=1)
    return y_re, y_im, v_re[..., t:, :], v_im[..., t:, :]


def fastfir_chain_stream_matrix_plain(x2d, prev, ring_re, ring_im, h_re, h_im,
                                      scale: float, l0_re=None, l0_im=None):
    """K8's matrix form by ``torch.fft``: each input's spectra of [x2d[t-1] |
    x2d[t]] (x2d[-1] = prev) once, the state kernel's matrix form
    (:func:`stream_state_matrix_plain`), each output's scale * rifft(Y_t)[H:]
    once; returns (y (M, T, H), new_ring_re (N, P, K), new_ring_im)."""
    prev_rows = torch.cat([prev[:, None, :], x2d[:, :-1, :]], dim=1)
    x_re, x_im = rfft_packed_plain(torch.cat([prev_rows, x2d], dim=-1))
    y_re, y_im, n_re, n_im = stream_state_matrix_plain(x_re, x_im, ring_re, ring_im, h_re,
                                                       h_im, l0_re, l0_im)
    return rifft_packed_tail_plain(y_re, y_im, scale), n_re, n_im


# -----------------------------------------------------------------------------
# Kernel wrappers
# -----------------------------------------------------------------------------

def rfft_packed(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: real FFT -> packed N/2 bins (x2 scale, Nyquist in im[0]), batched
    over the leading axes, natural bin order: one HBM pass, no scratch
    (:func:`_onepass_plan`). N = 2..2048 go to K10, N = 2^18..2^28 to
    K13."""
    if x.device.type == "cpu":
        return rfft_packed_plain(x)
    n = x.shape[-1]
    if small_eligible(n):
        return rfft_small(x)
    if split_eligible(n):
        return rfft_packed_split(x)
    with span("kernel.K1.rfft_packed"):
        _check("K1 rfft_packed", n, x)
        lead = x.shape[:-1]
        b = math.prod(lead)
        re = torch.empty(*lead, n // 2, dtype=torch.float32, device=x.device)
        im = torch.empty_like(re)
        if b == 0:
            return re, im
        rc = _build.load().hst_rfft_packed(
            x.data_ptr(), re.data_ptr(), im.data_ptr(), _twiddles(n, x.device).data_ptr(), b,
            n, _build.stream(x.device))
        _build.check(rc, "K1 rfft_packed")
        rfft_packed.launches += 1
        rfft_packed.points += b * n
        return re, im


rfft_packed.launches = 0
rfft_packed.points = 0


def rfft_packed_resident(n: int) -> int:
    """Frames of real size ``n`` that K1 holds on the current card at once:
    clusters of :func:`_onepass_plan`'s blocks (or blocks, where one holds a
    frame), as ``cudaOccupancyMaxActiveClusters`` counts them."""
    if not real_eligible(n):
        raise ValueError(f"K1 serves real N = {MIN_REAL_SIZE}..{MAX_SINGLE_REAL}, got {n}")
    got = _build.load().hst_rfft_packed_resident(n)
    if got < 0:
        _build.check(-got, "K1 rfft_packed")
    return got


def rfft_packed_stream_resident(n: int) -> int:
    """Frames of real size ``n`` that K2 holds on the current card at once,
    as :func:`rfft_packed_resident` counts K1's."""
    if not real_eligible(n):
        raise ValueError(f"K2 serves real N = {MIN_REAL_SIZE}..{MAX_SINGLE_REAL}, got {n}")
    got = _build.load().hst_rfft_packed_stream_resident(n)
    if got < 0:
        _build.check(-got, "K2 rfft_packed_stream")
    return got


def rfft_small(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: small real FFT (N = 32..2048) -> packed N/2 bins, batched over
    the leading axes, natural bin order; N = 2..16 go to :func:`rfft_tiny`."""
    if x.device.type == "cpu":
        return rfft_small_plain(x)
    kernel = "K10 rfft_small"
    n = x.shape[-1]
    if n < SMALL_MIN_REAL and small_eligible(n):
        return rfft_tiny(x)
    with span("kernel.K10.rfft_small"):
        _check_small(kernel, n)
        _build.check_tensors(kernel, x)
        lead = x.shape[:-1]
        b = math.prod(lead)
        re = torch.empty(*lead, n // 2, dtype=torch.float32, device=x.device)
        im = torch.empty_like(re)
        if b == 0:
            return re, im
        rc = _build.load().hst_rfft_small(
            x.data_ptr(), re.data_ptr(), im.data_ptr(),
            _twiddles(n, x.device).data_ptr(), b, n, _build.stream(x.device))
        _build.check(rc, kernel)
        rfft_small.launches += 1
        rfft_small.points += b * n
        return re, im


rfft_small.launches = 0
rfft_small.points = 0


def rifft_packed(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """K6: unscaled inverse of packed N/2-bin planes, rifft(rfft(x)) == 2N x,
    batched over the leading axes; returns (..., N): one HBM pass on K1's
    plan (:func:`_onepass_plan`), the packed bins unpacked in pairs, no
    scratch. N = 2..2048 go to K11, N = 2^18..2^28 to K14."""
    if re.device.type == "cpu":
        return rifft_packed_plain(re, im)
    n = 2 * re.shape[-1]
    if small_eligible(n):
        return rifft_small(re, im)
    if split_eligible(n):
        return rifft_packed_split(re, im)
    with span("kernel.K6.rifft_packed"):
        kernel = "K6 rifft_packed"
        _check(kernel, n, re, im)
        if im.shape != re.shape:
            raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
        lead = re.shape[:-1]
        b = math.prod(lead)
        out = torch.empty(*lead, n, dtype=torch.float32, device=re.device)
        if b == 0:
            return out
        rc = _build.load().hst_rifft_packed(
            re.data_ptr(), im.data_ptr(), out.data_ptr(), _twiddles(n, re.device).data_ptr(), b,
            n, _build.stream(re.device))
        _build.check(rc, kernel)
        rifft_packed.launches += 1
        rifft_packed.points += b * n
        return out


rifft_packed.launches = 0
rifft_packed.points = 0


def rifft_small(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """K11: small unscaled inverse (N = 32..2048; N = 2..16 go to
    :func:`rifft_tiny`) of packed N/2-bin planes,
    batched over the leading axes; returns (..., N)."""
    if re.device.type == "cpu":
        return rifft_small_plain(re, im)
    kernel = "K11 rifft_small"
    n = 2 * re.shape[-1]
    if n < SMALL_MIN_REAL and small_eligible(n):
        return rifft_tiny(re, im)
    with span("kernel.K11.rifft_small"):
        _check_small(kernel, n)
        _build.check_tensors(kernel, re, im)
        if im.shape != re.shape:
            raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
        lead = re.shape[:-1]
        b = math.prod(lead)
        out = torch.empty(*lead, n, dtype=torch.float32, device=re.device)
        if b == 0:
            return out
        rc = _build.load().hst_rifft_small(
            re.data_ptr(), im.data_ptr(), out.data_ptr(),
            _twiddles(n, re.device).data_ptr(), b, n, _build.stream(re.device))
        _build.check(rc, kernel)
        rifft_small.launches += 1
        rifft_small.points += b * n
        return out


rifft_small.launches = 0
rifft_small.points = 0


def _check_window(kernel: str, window: torch.Tensor, n: int) -> None:
    if tuple(window.shape) != (n,) or not window.is_contiguous():
        raise ValueError(f"{kernel}: window must be a contiguous ({n},) tensor, got "
                         f"{tuple(window.shape)}")


def rfft_small_windowed(frames: torch.Tensor, window: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10w: rfft(frames * window) -> packed N/2 bins for each frame of
    ``frames`` (..., T, N), N = 32..2048 (2..16: :func:`rfft_tiny_windowed`);
    returns contiguous (..., T, N/2)
    planes. The frames are read in place where the leading axes merge into
    one with a last-axis stride of 1 (the padded signal's ``unfold`` view,
    row stride = hop); another layout is copied once. ``window``: (N,)
    float32 on the frames' device."""
    if frames.device.type == "cpu":
        return rfft_small_windowed_plain(frames, window)
    kernel = "K10w rfft_small_windowed"
    t, n = frames.shape[-2], frames.shape[-1]
    if n < SMALL_MIN_REAL and small_eligible(n):
        return rfft_tiny_windowed(frames, window)
    with span("kernel.K10w.rfft_small_windowed"):
        _check_small(kernel, n)
        _build.check_tensors(kernel, frames, window, contiguous=False)
        _check_window(kernel, window, n)
        lead = frames.shape[:-2]
        b = math.prod(lead) * t
        re = torch.empty(*lead, t, n // 2, dtype=torch.float32, device=frames.device)
        im = torch.empty_like(re)
        if b == 0:
            return re, im
        f3 = frames.reshape(-1, t, n)  # a view where the leading axes merge
        if f3.stride(-1) != 1:
            f3 = f3.contiguous()
        rc = _build.load().hst_rfft_small_windowed(
            f3.data_ptr(), f3.stride(0), f3.stride(1), t, window.data_ptr(), re.data_ptr(),
            im.data_ptr(), _twiddles(n, frames.device).data_ptr(), b, n,
            _build.stream(frames.device))
        _build.check(rc, kernel)
        rfft_small_windowed.launches += 1
        rfft_small_windowed.points += b * n
        return re, im


rfft_small_windowed.launches = 0
rfft_small_windowed.points = 0


def rifft_small_windowed(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """K11w: scale * rifft(spec) * window for each packed (..., N/2) frame,
    N = 32..2048; returns (..., N). ``window``: (N,) float32 on the planes'
    device."""
    if re.device.type == "cpu":
        return rifft_small_windowed_plain(re, im, window, scale)
    kernel = "K11w rifft_small_windowed"
    n = 2 * re.shape[-1]
    if n < SMALL_MIN_REAL and small_eligible(n):
        return rifft_tiny_windowed(re, im, window, scale)
    with span("kernel.K11w.rifft_small_windowed"):
        _check_small(kernel, n)
        _build.check_tensors(kernel, re, im, window)
        _check_window(kernel, window, n)
        if im.shape != re.shape:
            raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
        lead = re.shape[:-1]
        b = math.prod(lead)
        out = torch.empty(*lead, n, dtype=torch.float32, device=re.device)
        if b == 0:
            return out
        rc = _build.load().hst_rifft_small_windowed(
            re.data_ptr(), im.data_ptr(), window.data_ptr(), float(scale), out.data_ptr(),
            _twiddles(n, re.device).data_ptr(), b, n, _build.stream(re.device))
        _build.check(rc, kernel)
        rifft_small_windowed.launches += 1
        rifft_small_windowed.points += b * n
        return out


rifft_small_windowed.launches = 0
rifft_small_windowed.points = 0


def _rfft_tiny(kernel: str, frames: torch.Tensor, window: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/fft_tiny.cu``'s packed forward over the (..., T,
    N) frames (a strided view is read in place, as K10w reads it)."""
    t, n = frames.shape[-2], frames.shape[-1]
    _check_small(kernel, n)
    _build.check_tensors(kernel, frames, *(() if window is None else (window,)),
                         contiguous=False)
    if window is not None:
        _check_window(kernel, window, n)
    lead = frames.shape[:-1]
    b = math.prod(lead)
    re = torch.empty(*lead, n // 2, dtype=torch.float32, device=frames.device)
    im = torch.empty_like(re)
    if b == 0:
        return re, im
    f3 = frames.reshape(-1, t, n)  # a view where the leading axes merge
    if f3.stride(-1) != 1:
        f3 = f3.contiguous()
    rc = _build.load().hst_rfft_tiny(
        f3.data_ptr(), f3.stride(0), f3.stride(1), t, _ptr(window), re.data_ptr(),
        im.data_ptr(), b, n, _build.stream(frames.device))
    _build.check(rc, kernel)
    return re, im


@span("kernel.tiny.rfft_tiny")
def rfft_tiny(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's tiny form: real FFT of N = 2..16 -> packed N/2 bins (x2 scale,
    Nyquist in im[0]), batched over the leading axes."""
    if x.device.type == "cpu":
        return rfft_tiny_plain(x)
    out = _rfft_tiny("K10 rfft_tiny", x if x.dim() > 1 else x[None], None)
    rfft_tiny.launches += 1
    rfft_tiny.points += x.numel()
    return out if x.dim() > 1 else (out[0][0], out[1][0])


rfft_tiny.launches = 0
rfft_tiny.points = 0


@span("kernel.tiny.rfft_tiny_windowed")
def rfft_tiny_windowed(frames: torch.Tensor, window: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10w's tiny form: rfft(frames * window) for frames (..., T, N), N =
    2..16, read in place where the leading axes merge."""
    if frames.device.type == "cpu":
        return rfft_tiny_windowed_plain(frames, window)
    out = _rfft_tiny("K10w rfft_tiny_windowed", frames, window)
    rfft_tiny_windowed.launches += 1
    rfft_tiny_windowed.points += frames.numel()
    return out


rfft_tiny_windowed.launches = 0
rfft_tiny_windowed.points = 0


def _rifft_tiny(kernel: str, re: torch.Tensor, im: torch.Tensor,
                window: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """One launch of ``csrc/fft_tiny.cu``'s unscaled packed inverse (times
    scale * window where a window is given)."""
    n = 2 * re.shape[-1]
    _check_small(kernel, n)
    _build.check_tensors(kernel, re, im, *(() if window is None else (window,)))
    if window is not None:
        _check_window(kernel, window, n)
    if im.shape != re.shape:
        raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
    lead = re.shape[:-1]
    b = math.prod(lead)
    out = torch.empty(*lead, n, dtype=torch.float32, device=re.device)
    if b == 0:
        return out
    rc = _build.load().hst_rifft_tiny(re.data_ptr(), im.data_ptr(), _ptr(window),
                                      float(scale), out.data_ptr(), b, n,
                                      _build.stream(re.device))
    _build.check(rc, kernel)
    return out


@span("kernel.tiny.rifft_tiny")
def rifft_tiny(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """K11's tiny form: unscaled inverse (N = 2..16) of packed N/2-bin planes,
    rifft(rfft(x)) == 2N x; returns (..., N)."""
    if re.device.type == "cpu":
        return rifft_tiny_plain(re, im)
    out = _rifft_tiny("K11 rifft_tiny", re, im, None, 1.0)
    rifft_tiny.launches += 1
    rifft_tiny.points += out.numel()
    return out


rifft_tiny.launches = 0
rifft_tiny.points = 0


@span("kernel.tiny.rifft_tiny_windowed")
def rifft_tiny_windowed(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """K11w's tiny form: scale * rifft(spec) * window, N = 2..16."""
    if re.device.type == "cpu":
        return rifft_tiny_windowed_plain(re, im, window, scale)
    out = _rifft_tiny("K11w rifft_tiny_windowed", re, im, window, scale)
    rifft_tiny_windowed.launches += 1
    rifft_tiny_windowed.points += out.numel()
    return out


rifft_tiny_windowed.launches = 0
rifft_tiny_windowed.points = 0


@span("kernel.tiny.fft_tiny")
def fft_tiny(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12's tiny form: unscaled complex DFT (or N x IDFT, by swapped
    planes) of split planes, N = 1..16 (N = 1 a copy)."""
    if re.device.type == "cpu":
        return fft_tiny_plain(re, im, inverse)
    kernel = "K12 fft_tiny"
    n = re.shape[-1]
    if not (1 <= n < MIN_COMPLEX and (n & (n - 1)) == 0):
        raise NotImplementedError(f"{kernel}: serves N = 1..{MIN_COMPLEX // 2}, got N = {n}")
    _build.check_tensors(kernel, re, im)
    if im.shape != re.shape:
        raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
    b = math.prod(re.shape[:-1])
    out_re = torch.empty(re.shape, dtype=torch.float32, device=re.device)
    out_im = torch.empty_like(out_re)
    if b == 0:
        return out_re, out_im
    src, dst = ((im, re), (out_im, out_re)) if inverse else ((re, im), (out_re, out_im))
    rc = _build.load().hst_fft_tiny(src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                                    dst[1].data_ptr(), b, n, _build.stream(re.device))
    _build.check(rc, kernel)
    fft_tiny.launches += 1
    fft_tiny.points += b * n
    return out_re, out_im


fft_tiny.launches = 0
fft_tiny.points = 0


@span("kernel.K13.rfft_packed_split")
def rfft_packed_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: real FFT of N = 2^18..2^28 -> packed N/2 bins (x2 scale, Nyquist
    in im[0]), batched over the leading axes, natural bin order."""
    if x.device.type == "cpu":
        return rfft_packed_split_plain(x)
    kernel = "K13 rfft_packed_split"
    n = x.shape[-1]
    _check_split(kernel, n, x)
    lead = x.shape[:-1]
    b = math.prod(lead)
    re = torch.empty(*lead, n // 2, dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    if b == 0:
        return re, im
    scratch = _scratch(b, n // 2, x.device)
    rc = _build.load().hst_rfft_packed_split(
        x.data_ptr(), re.data_ptr(), im.data_ptr(), _ptr(scratch),
        _large_twiddles(n, x.device).data_ptr(), b, n, _build.stream(x.device))
    _build.check(rc, kernel)
    rfft_packed_split.launches += 1
    rfft_packed_split.points += b * n
    return re, im


rfft_packed_split.launches = 0
rfft_packed_split.points = 0


@span("kernel.K14.rifft_packed_split")
def rifft_packed_split(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """K14: unscaled inverse (N = 2^18..2^28) of packed N/2-bin planes,
    rifft(rfft(x)) == 2N x, batched over the leading axes; returns (..., N)."""
    if re.device.type == "cpu":
        return rifft_packed_split_plain(re, im)
    kernel = "K14 rifft_packed_split"
    n = 2 * re.shape[-1]
    _check_split(kernel, n, re, im)
    if im.shape != re.shape:
        raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
    lead = re.shape[:-1]
    b = math.prod(lead)
    out = torch.empty(*lead, n, dtype=torch.float32, device=re.device)
    if b == 0:
        return out
    scratch = _scratch(b, n // 2, re.device)
    rc = _build.load().hst_rifft_packed_split(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), _ptr(scratch),
        _large_twiddles(n, re.device).data_ptr(), b, n, _build.stream(re.device))
    _build.check(rc, kernel)
    rifft_packed_split.launches += 1
    rifft_packed_split.points += b * n
    return out


rifft_packed_split.launches = 0
rifft_packed_split.points = 0


def fft_split(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: unscaled complex DFT along the last axis of split planes
    (hisstools_fft), or with ``inverse`` the unscaled N x IDFT
    (hisstools_ifft: the forward with the planes swapped in and out, which
    the launch does by swapping pointers, with no copy). Complex N =
    32..2^28, batched over the leading axes, natural order; N = 1..16 go to
    :func:`fft_tiny`."""
    if re.device.type == "cpu":
        return fft_split_plain(re, im, inverse)
    kernel = "K12 fft_split"
    n = re.shape[-1]
    if not complex_eligible(n):
        raise NotImplementedError(
            f"{kernel}: serves N = 1..{MAX_COMPLEX}; N = {n}: "
            + (OVER_MAX if n > MAX_COMPLEX else "not a power of two"))
    if n < MIN_COMPLEX:
        return fft_tiny(re, im, inverse)
    with span("kernel.K12.fft_split"):
        _build.check_tensors(kernel, re, im)
        if im.shape != re.shape:
            raise ValueError(f"{kernel}: re {tuple(re.shape)} and im {tuple(im.shape)} differ")
        lead = re.shape[:-1]
        b = math.prod(lead)
        out_re = torch.empty(re.shape, dtype=torch.float32, device=re.device)
        out_im = torch.empty_like(out_re)
        if b == 0:
            return out_re, out_im
        src, dst = ((im, re), (out_im, out_re)) if inverse else ((re, im), (out_re, out_im))
        scratch = None if n <= MAX_COMPLEX_SMEM else _scratch(b, n, re.device)
        rc = _build.load().hst_fft_split(
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(), dst[1].data_ptr(),
            _ptr(scratch),
            _large_twiddles(2 * n, re.device).data_ptr(), b, n, _build.stream(re.device))
        _build.check(rc, kernel)
        fft_split.launches += 1
        fft_split.points += b * n
        return out_re, out_im


fft_split.launches = 0
fft_split.points = 0


@span("kernel.K2.rfft_packed_stream")
def rfft_packed_stream(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: overlap-save forward. ``x2d``: (..., T, H) hop blocks; returns
    packed planes (..., T, N/2), N = 2H, spectrum t = rfft([x2d[t-1] |
    x2d[t]]) with x2d[-1] = 0: one HBM pass on K1's plan
    (:func:`_onepass_plan`), each frame read in place from the hop blocks,
    no frames buffer and no scratch."""
    if x2d.device.type == "cpu":
        return rfft_packed_stream_plain(x2d)
    t, hop = x2d.shape[-2], x2d.shape[-1]
    n = 2 * hop
    _check("K2 rfft_packed_stream", n, x2d)
    lead = x2d.shape[:-2]
    c = math.prod(lead)
    re = torch.empty(*lead, t, hop, dtype=torch.float32, device=x2d.device)
    im = torch.empty_like(re)
    if c * t == 0:
        return re, im
    rc = _build.load().hst_rfft_packed_stream(
        x2d.data_ptr(), re.data_ptr(), im.data_ptr(), _twiddles(n, x2d.device).data_ptr(),
        c, t, n, _build.stream(x2d.device))
    _build.check(rc, "K2 rfft_packed_stream")
    rfft_packed_stream.launches += 1
    rfft_packed_stream.points += c * t * n
    return re, im


rfft_packed_stream.launches = 0
rfft_packed_stream.points = 0


@span("kernel.K4.rifft_packed_tail")
def rifft_packed_tail(re: torch.Tensor, im: torch.Tensor,
                      scale: float = 1.0) -> torch.Tensor:
    """K4: overlap-save inverse. ``re``/``im``: (..., T, N/2) packed hop
    spectra; returns (..., T, H) = scale * rifft(Y_t)[H:], the kept half:
    one HBM pass on K1's plan (:func:`_onepass_plan`), the packed bins
    unpacked in pairs, no scratch."""
    if re.device.type == "cpu":
        return rifft_packed_tail_plain(re, im, scale)
    hop = re.shape[-1]
    n = 2 * hop
    _check("K4 rifft_packed_tail", n, re, im)
    if im.shape != re.shape:
        raise ValueError(f"K4 rifft_packed_tail: re {tuple(re.shape)} and "
                         f"im {tuple(im.shape)} differ")
    frames = math.prod(re.shape[:-1])
    out = torch.empty(re.shape, dtype=torch.float32, device=re.device)
    if frames == 0:
        return out
    rc = _build.load().hst_rifft_packed_tail(
        re.data_ptr(), im.data_ptr(), out.data_ptr(), _twiddles(n, re.device).data_ptr(),
        frames, n, float(scale), _build.stream(re.device))
    _build.check(rc, "K4 rifft_packed_tail")
    rifft_packed_tail.launches += 1
    rifft_packed_tail.points += frames * n
    return out


rifft_packed_tail.launches = 0
rifft_packed_tail.points = 0


def fastfir_chain_staged(x2d: torch.Tensor, h_re: torch.Tensor, h_im: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The FastFIR chain as K2 -> K3 -> K4, three launches: the offline
    chain at N = 4096..8192, below the chain family's sizes. Arguments and
    result as :func:`fastfir_chain`; ``h_*`` contiguous."""
    x_re, x_im = rfft_packed_stream(x2d)
    y_re, y_im = lag_mac_causal(x_re, x_im, h_re, h_im)
    return rifft_packed_tail(y_re, y_im, scale)


def _check_chain(kernel: str, x2d, h_re, h_im, prev=None, ring=None, lag0=None) -> None:
    """Raise unless the chain kernels take these tensors: x2d (C, T, H),
    H planes (C, P, H), and for K8 prev (C, H), ring (C, P, H), lag0 (C, H)."""
    c, t, hop = x2d.shape
    p = h_re.shape[-2]
    _build.check_tensors(kernel, x2d, *(() if prev is None else (prev, *ring)))
    _build.check_tensors(kernel, x2d, h_re, h_im, *(lag0 or ()), contiguous=False)
    if (h_re.shape != (c, p, hop) or h_im.shape != h_re.shape
            or (prev is not None and (prev.shape != (c, hop) or ring[0].shape != h_re.shape
                                      or ring[1].shape != h_re.shape))
            or (lag0 is not None and (lag0[0].shape != (c, hop)
                                      or lag0[1].shape != (c, hop)))):
        raise ValueError(f"{kernel}: shapes x2d {tuple(x2d.shape)}, H {tuple(h_re.shape)}"
                         + ("" if prev is None else f", prev {tuple(prev.shape)}, ring "
                            f"{tuple(ring[0].shape)}")
                         + " do not fit (C, T, H), (C, P, H), (C, H), (C, P, H)")


@span("kernel.K5.fastfir_chain")
def fastfir_chain(x2d: torch.Tensor, h_re: torch.Tensor, h_im: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """K5: the whole FastFIR chain as one kernel family call. ``x2d``:
    (C, T, H) hop blocks, contiguous; ``h_*``: (C, P, N/2) packed impulse
    spectra (row slices and channel-broadcast views are read in place).
    Returns (C, T, H) = scale * rifft(sum_lag X_{t-1-lag} H_lag)[H:] per hop,
    N = 2^14..2^17, any P. No (C, T, N/2) spectra tensor is allocated."""
    if x2d.device.type == "cpu":
        return fastfir_chain_plain(x2d, h_re, h_im, scale)
    kernel = "K5 fastfir_chain"
    c, t, hop = x2d.shape
    n = 2 * hop
    p = h_re.shape[-2]
    if not chain_eligible(n):
        raise NotImplementedError(
            f"{kernel}: serves N = {CHAIN_MIN}..{CHAIN_MAX}; N = {n}: "
            + ("fastfir_chain_staged (K2 -> K3 -> K4) serves 4096..8192" if n < CHAIN_MIN
               else "above the chain's sizes, as in the TPU package"))
    _check_chain(kernel, x2d, h_re, h_im)
    h_re, h_im, hcs = _build.row_planes(h_re, h_im)
    y = torch.empty_like(x2d)
    if c * t == 0:
        return y
    lib = _build.load()
    scratch = torch.empty(c * t, n, dtype=torch.float32, device=x2d.device)
    # Ring and H live in shared memory while they fit; beyond that the
    # kernel asks for a global scratch of this many float2 a channel.
    ring_floats2 = lib.hst_fastfir_chain_ring_scratch(n, p)
    gring = None
    if ring_floats2:
        gring = torch.empty(c, ring_floats2, 2, dtype=torch.float32, device=x2d.device)
    rc = lib.hst_fastfir_chain(
        x2d.data_ptr(), h_re.data_ptr(), h_im.data_ptr(), hcs, y.data_ptr(), scratch.data_ptr(),
        _ptr(gring), _twiddles(n, x2d.device).data_ptr(), c, t, p, n, float(scale),
        _build.stream(x2d.device))
    _build.check(rc, kernel)
    fastfir_chain.launches += 1
    return y


fastfir_chain.launches = 0


def _state_args(ring, h_re, h_im, lag0):
    """The ring, H and lag-0 operands of K8's state kernel as it reads them:
    the ring contiguous, H and L0 as row planes (slices and channel-broadcast
    views in place) with their channel strides, 16-byte aligned."""
    l0 = (None, None, 0)
    if lag0 is not None:
        l0 = _build.aligned_rows(lag0[0][:, None, :], lag0[1][:, None, :])
    return (_build.aligned(ring[0]), _build.aligned(ring[1]),
            *_build.aligned_rows(h_re, h_im), l0)


@span("kernel.K8.stream_state")
def stream_state(x_re: torch.Tensor, x_im: torch.Tensor, ring_re: torch.Tensor,
                 ring_im: torch.Tensor, h_re: torch.Tensor, h_im: torch.Tensor,
                 l0_re: Optional[torch.Tensor] = None, l0_im: Optional[torch.Tensor] = None):
    """K8's state kernel alone (the ring MAC, ``csrc/ring_mac.cu``; the
    middle of K8's three launches): ``x_*`` (C, T, K) hop spectra, ``ring_*`` (C, P, K)
    the carried ring oldest-first, ``h_*`` (C, P, K) packed impulse spectra
    (row slices and channel-broadcast views read in place), ``l0_*``
    optional (C, K). Returns (y_re, y_im, new_ring_re, new_ring_im): Y_t =
    sum_{lag < P} V_{t-1-lag} H_lag (+ X_t l0) over V = [ring | X], and the
    new ring oldest-first. K = 16, 32, 64, 128 or a multiple of 256."""
    if x_re.device.type == "cpu":
        return stream_state_plain(x_re, x_im, ring_re, ring_im, h_re, h_im, l0_re, l0_im)
    kernel = "K8 stream_state"
    lag0 = None if l0_re is None else (l0_re, l0_im)
    _build.check_tensors(kernel, x_re, x_im, ring_re, ring_im)
    _build.check_tensors(kernel, x_re, h_re, h_im, *(lag0 or ()), contiguous=False)
    c, t, k = x_re.shape
    p = ring_re.shape[1]
    if (x_im.shape != x_re.shape or ring_re.shape != (c, p, k) or ring_im.shape != ring_re.shape
            or h_re.shape != ring_re.shape or h_im.shape != ring_re.shape
            or (lag0 is not None and (l0_re.shape != (c, k) or l0_im.shape != (c, k)))):
        raise ValueError(f"{kernel}: shapes X {tuple(x_re.shape)}, ring {tuple(ring_re.shape)}, "
                         f"H {tuple(h_re.shape)} do not fit (C, T, K), (C, P, K), (C, P, K)")
    if p == 0:
        raise ValueError(f"{kernel}: needs P >= 1 lags")
    _ring_mac_shape(kernel, k)
    y_re, y_im = torch.empty_like(x_re), torch.empty_like(x_im)
    n_re, n_im = torch.empty_like(ring_re), torch.empty_like(ring_im)
    if c * t * k == 0:
        return y_re, y_im, ring_re.clone(), ring_im.clone()
    x_re, x_im = _build.aligned(x_re), _build.aligned(x_im)
    rr, ri, h_re, h_im, hcs, (l0r, l0i, lcs) = _state_args((ring_re, ring_im), h_re, h_im,
                                                            lag0)
    rc = _build.load().hst_stream_state(
        x_re.data_ptr(), x_im.data_ptr(), rr.data_ptr(), ri.data_ptr(), h_re.data_ptr(),
        h_im.data_ptr(), hcs, _ptr(l0r), _ptr(l0i), lcs, y_re.data_ptr(), y_im.data_ptr(),
        n_re.data_ptr(), n_im.data_ptr(), c, t, p, k, _build.stream(x_re.device))
    _build.check(rc, kernel)
    stream_state.launches += 1
    return y_re, y_im, n_re, n_im


stream_state.launches = 0


@span("kernel.K8.fastfir_chain_stream")
def fastfir_chain_stream(x2d: torch.Tensor, prev: torch.Tensor,
                         ring_re: torch.Tensor, ring_im: torch.Tensor,
                         h_re: torch.Tensor, h_im: torch.Tensor, scale: float,
                         l0_re: Optional[torch.Tensor] = None,
                         l0_im: Optional[torch.Tensor] = None):
    """K8: a whole streaming process_block in one call of three launches.

    ``x2d``: (C, T, H) hop blocks; ``prev``: (C, H) the carried previous
    block; ``ring_*``: (C, P, N/2) oldest-first spectra ring; ``h_*``:
    (C, P, N/2) packed impulse spectra; ``l0_*``: optional (C, N/2) zero-delay
    partition multiplied with each hop's own spectrum. Returns (y (C, T, H),
    new_ring_re, new_ring_im) with the new ring oldest-first, in new tensors.
    ``h_*`` and ``l0_*`` may be row slices or channel-broadcast views.
    N = 2^14..2^17 (``csrc/fastfir_stream.cu``, :func:`_stream_plan`): the
    forward of every frame [x[t-1] | x[t]] in one HBM pass (K1's one-pass
    route, the halves read in place), the state kernel (:func:`stream_state`)
    over contiguous bin ranges, the inverse in one pass with K4's tail
    store."""
    if x2d.device.type == "cpu":
        return fastfir_chain_stream_plain(x2d, prev, ring_re, ring_im, h_re,
                                          h_im, scale, l0_re, l0_im)
    kernel = "K8 fastfir_chain_stream"
    c, t, hop = x2d.shape
    n = 2 * hop
    p = h_re.shape[-2]
    if not chain_eligible(n):
        raise NotImplementedError(
            f"{kernel}: serves N = {CHAIN_MIN}..{CHAIN_MAX}; N = {n} is not among them")
    lag0 = None if l0_re is None else (l0_re, l0_im)
    _check_chain(kernel, x2d, h_re, h_im, prev, (ring_re, ring_im), lag0)
    if p == 0:
        raise ValueError(f"{kernel}: needs P >= 1 lags")
    y = torch.empty_like(x2d)
    if c * t == 0:
        return y, ring_re.clone(), ring_im.clone()
    rr, ri, h_re, h_im, hcs, (l0r, l0i, lcs) = _state_args((ring_re, ring_im), h_re, h_im,
                                                            lag0)
    n_re, n_im = torch.empty_like(ring_re), torch.empty_like(ring_im)
    spectra = torch.empty(4, c * t, hop, dtype=torch.float32, device=x2d.device)
    rc = _build.load().hst_fastfir_stream(
        x2d.data_ptr(), prev.data_ptr(), rr.data_ptr(), ri.data_ptr(), h_re.data_ptr(),
        h_im.data_ptr(), hcs, _ptr(l0r), _ptr(l0i), lcs, y.data_ptr(), n_re.data_ptr(),
        n_im.data_ptr(), spectra.data_ptr(), _twiddles(n, x2d.device).data_ptr(), c, t, p, n,
        float(scale), _build.stream(x2d.device))
    _build.check(rc, kernel)
    fastfir_chain_stream.launches += 1
    fastfir_chain_stream.points += 2 * c * t * n  # the frames' forward and inverse
    return y, n_re, n_im


fastfir_chain_stream.launches = 0
fastfir_chain_stream.points = 0


@span("kernel.K8.fastfir_chain_stream_matrix")
def fastfir_chain_stream_matrix(x2d: torch.Tensor, prev: torch.Tensor,
                                ring_re: torch.Tensor, ring_im: torch.Tensor,
                                h_re: torch.Tensor, h_im: torch.Tensor, scale: float,
                                l0_re: Optional[torch.Tensor] = None,
                                l0_im: Optional[torch.Tensor] = None):
    """K8's matrix form: a streaming process_block of an N-in / M-out matrix
    whose pairs share one carried history an input, in one call of three
    launches.

    ``x2d``: (N, T, H) the inputs' hop blocks; ``prev``: (N, H) their carried
    previous blocks; ``ring_*``: (N, P, N_fft/2) their oldest-first spectra
    rings; ``h_*``: (M, N, P, N_fft/2) the pairs' packed impulse spectra;
    ``l0_*``: optional (M, N, N_fft/2) their zero-delay partitions. Returns
    (y (M, T, H), new_ring_re, new_ring_im): y_m = the sum over inputs n of
    :func:`fastfir_chain_stream`'s output for the pair (m, n), the new rings
    one an input, in new tensors. ``csrc/fastfir_stream.cu``'s
    ``hst_fastfir_stream_matrix``: the forward of each input's frames once,
    the ring MAC's matrix form (``csrc/ring_mac.cu``: each output's sum over
    the inputs in its accumulators, the rings read and written once an
    input), the inverse of each output's frames once."""
    if x2d.device.type == "cpu":
        return fastfir_chain_stream_matrix_plain(x2d, prev, ring_re, ring_im, h_re, h_im,
                                                 scale, l0_re, l0_im)
    kernel = "K8 fastfir_chain_stream_matrix"
    ins, t, hop = x2d.shape
    n = 2 * hop
    if not chain_eligible(n):
        raise NotImplementedError(
            f"{kernel}: serves N = {CHAIN_MIN}..{CHAIN_MAX}; N = {n} is not among them")
    if h_re.dim() != 4 or h_re.shape[1] != ins:
        raise ValueError(f"{kernel}: H {tuple(h_re.shape)} is not (M, N, P, H) over the "
                         f"{ins} inputs of x2d {tuple(x2d.shape)}")
    outs, _, p = h_re.shape[:3]
    if p == 0 or outs == 0:
        raise ValueError(f"{kernel}: needs P >= 1 lags and M >= 1 outputs")
    _check_chain(kernel, x2d, ring_re, ring_im, prev, (ring_re, ring_im))
    pairs = outs * ins
    if h_im.shape != h_re.shape or h_re.shape[3] != hop or ring_re.shape[1] != p or (
            l0_re is not None and (l0_re.shape != (outs, ins, hop)
                                   or l0_im.shape != l0_re.shape)):
        raise ValueError(f"{kernel}: H {tuple(h_re.shape)}, ring {tuple(ring_re.shape)} and "
                         f"L0 do not fit (M, N, P, H), (N, P, H) and (M, N, H) at H = {hop}")
    lag0 = None if l0_re is None else (l0_re.reshape(pairs, hop), l0_im.reshape(pairs, hop))
    _build.check_tensors(kernel, x2d, h_re, h_im, *(lag0 or ()), contiguous=False)
    y = x2d.new_empty(outs, t, hop)
    if t == 0:
        return y, ring_re.clone(), ring_im.clone()
    rr, ri, hr, hi, hcs, (l0r, l0i, lcs) = _state_args(
        (ring_re, ring_im), h_re.reshape(pairs, p, hop), h_im.reshape(pairs, p, hop), lag0)
    n_re, n_im = torch.empty_like(ring_re), torch.empty_like(ring_im)
    spectra = torch.empty(2 * (ins + outs) * t, hop, dtype=torch.float32, device=x2d.device)
    rc = _build.load().hst_fastfir_stream_matrix(
        x2d.data_ptr(), prev.data_ptr(), rr.data_ptr(), ri.data_ptr(), hr.data_ptr(),
        hi.data_ptr(), hcs, _ptr(l0r), _ptr(l0i), lcs, y.data_ptr(), n_re.data_ptr(),
        n_im.data_ptr(), spectra.data_ptr(), _twiddles(n, x2d.device).data_ptr(), outs, ins,
        t, p, n, float(scale), _build.stream(x2d.device))
    _build.check(rc, kernel)
    fastfir_chain_stream_matrix.launches += 1
    fastfir_chain_stream_matrix.points += (ins + outs) * t * n  # inputs forward, outputs back
    return y, n_re, n_im


fastfir_chain_stream_matrix.launches = 0
fastfir_chain_stream_matrix.points = 0
