"""Mesh-sharded multichannel partitioned convolution, on ``torch.distributed``.

Counterpart of ``hisstools_library_tpu/parallel/sharded.py``. Channels shard
like data parallelism; the time axis shards into contiguous hop ranges
(sequence parallelism) with a halo of raw input samples from the left
neighbours (:mod:`.halo`). Each partitioned section with FFT size N (hop H =
N/2, P partitions) needs a halo of ``(P + 1) * H`` samples: the overlap half of
the first local frame plus the delay line's history. After it every rank
computes its output shard locally: the forward transform of its hops, the
lag MAC against the (channel-sharded) partition spectra, the inverse. The
N-to-mono reduction (NToMonoConvolve.cpp:35-43) is an ``all_reduce`` over the
channel axis (:func:`n_to_one_offline`).

Inputs are full tensors (every rank holding the same values) or DTensors;
each rank works on its local shard, as code inside the JAX package's
``shard_map`` does, and the outputs are DTensors placed as that package's
``out_specs``. A rank outside the mesh gets None.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.types import Split, packed_mul
from ..fft import api as fft_api
from ..fft import hopper_fft, hopper_kernels
from ..models import mono as mono_mod
from ..models import time_domain as td
from ..utils.checkpoint import leaves, rebuild
from .halo import left_halo
from .mesh import (BLOCK_AXIS, CHANNEL_AXIS, axis_size, channel_sharding,
                   channel_time_sharding, global_tensor, local_shard, member)


def _section_local(spectra: Split, x_local: torch.Tensor, fft_size: int,
                   mesh: DeviceMesh, backend: Optional[str] = None) -> torch.Tensor:
    """Local shard of one uniform section's output. ``x_local``: (..., L_loc)
    with L_loc a multiple of the hop."""
    h = fft_size >> 1
    p = spectra.shape[-2]
    lead = x_local.shape[:-1]
    L = x_local.shape[-1]
    t_loc = L // h

    # Halo: (P + 1) hops of raw input history from the left neighbours.
    x_ext = left_halo(x_local, (p + 1) * h, x_local.dim() - 1, mesh)
    blocks = x_ext.reshape(*lead, t_loc + p + 1, h)

    if fft_api._resolve(backend, x_local.device) == "pallas":
        y = _section_local_fused(spectra, blocks, fft_size, t_loc)
        if y is not None:
            return y.reshape(*lead, L)

    # Frames for local hops tau in [-P, t_loc): frame tau = x[(tau-1)h : (tau+1)h].
    frames = torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)
    X = Split(*fft_api.rfft(frames, backend=backend))  # (..., t_loc + P, bins)

    # Y_t = sum_p X_{t-1-p} Hhat_p ; X_{local tau} sits at ext index tau + P.
    acc_re = x_local.new_zeros(lead + (t_loc, h))
    acc_im = x_local.new_zeros(lead + (t_loc, h))
    for lag in range(p):
        start = p - 1 - lag
        prod = packed_mul(Split(X.re[..., start:start + t_loc, :],
                                X.im[..., start:start + t_loc, :]),
                          Split(spectra.re[..., lag:lag + 1, :],
                                spectra.im[..., lag:lag + 1, :]))
        acc_re = acc_re + prod.re
        acc_im = acc_im + prod.im

    y = fft_api.rifft(acc_re, acc_im, backend=backend) * (1.0 / (4.0 * fft_size))
    return y[..., h:].reshape(*lead, L)


def _section_local_fused(spectra: Split, blocks: torch.Tensor, fft_size: int,
                         t_loc: int) -> Optional[torch.Tensor]:
    """The local section as three kernels over the halo-extended hops: K2
    :func:`hopper_fft.rfft_packed_stream` (frame j = [block j-1 | block j], so
    row 0, with zero history below it, is unused), K15
    :func:`hopper_kernels.lag_mac` with ``lead_skip=1`` (that row skipped in
    the kernel) and K4 :func:`hopper_fft.rifft_packed_tail` with the 1/(4N)
    scale; their plain versions on a CPU tensor. Float32 at the sizes K2 and
    K4 serve, at any P; None otherwise (the caller takes the staged form)."""
    h = fft_size >> 1
    p = spectra.shape[-2]
    lead = blocks.shape[:-2]
    if not hopper_fft.real_eligible(fft_size) or blocks.dtype != torch.float32:
        return None
    c = math.prod(lead)
    t_rows = blocks.shape[-2]                       # t_loc + P + 1
    xr, xi = hopper_fft.rfft_packed_stream(blocks.reshape(c, t_rows, h).contiguous())
    hr = spectra.re.expand(lead + (p, h)).reshape(c, p, h).to(torch.float32)
    hi = spectra.im.expand(lead + (p, h)).reshape(c, p, h).to(torch.float32)
    yre, yim = hopper_kernels.lag_mac(xr, xi, hr, hi, t_loc, lead_skip=1)
    out = hopper_fft.rifft_packed_tail(yre, yim, scale=1.0 / (4.0 * fft_size))
    return out.reshape(*lead, t_loc * h)


def _validate_sharded_shape(mesh: DeviceMesh, scheme: mono_mod.PartitionScheme,
                            x) -> None:
    """Fail early with a clear message instead of a reshape error deep inside
    the per-shard section code."""
    blocks = axis_size(mesh, BLOCK_AXIS)
    channels = axis_size(mesh, CHANNEL_AXIS)
    quantum = blocks * (scheme.sizes[-1] >> 1)
    if x.shape[-1] % quantum:
        raise ValueError(
            f"signal length {x.shape[-1]} must be a multiple of "
            f"block-axis x largest hop = {blocks} x {scheme.sizes[-1] >> 1} "
            f"= {quantum}; pad the signal first")
    if x.dim() >= 2 and x.shape[0] % channels:
        raise ValueError(
            f"channel count {x.shape[0]} must be divisible by the channel "
            f"mesh axis ({channels})")


def _head_local(taps: torch.Tensor, x_local: torch.Tensor,
                mesh: DeviceMesh) -> torch.Tensor:
    """Local shard of the time-domain head output (halo = taps - 1 samples)."""
    t = taps.shape[-1]
    if t == 0:
        return torch.zeros_like(x_local)
    x_ext = left_halo(x_local, t - 1, x_local.dim() - 1, mesh)
    return td.fir_offline(x_ext, taps)[..., t - 1:]


def _section_local_direct(spec: Split, x_local: torch.Tensor,
                          mesh: DeviceMesh) -> torch.Tensor:
    """Small section as a direct FIR over the halo-extended shard (taps
    shared with mono's path; halo = taps - 1 raw samples)."""
    taps = mono_mod.section_taps_from_spectra(spec)
    t_total = taps.shape[-1]
    x_ext = left_halo(x_local, t_total - 1, x_local.dim() - 1, mesh)
    return td.fir_offline(x_ext, taps)[..., t_total - 1:].to(x_local.dtype)


def _scheme_local(ir: mono_mod.MonoIR, scheme_sizes: Tuple[int, ...],
                  x_local: torch.Tensor, mesh: DeviceMesh,
                  backend: Optional[str] = None) -> torch.Tensor:
    out = torch.zeros_like(x_local)
    if ir.head_taps.shape[-1]:
        out = out + _head_local(ir.head_taps, x_local, mesh)
    for spec, fft_size in zip(ir.spectra, scheme_sizes):
        if mono_mod._direct_eligible(fft_size, spec.shape[-2]):
            out = out + _section_local_direct(spec, x_local, mesh)
        else:
            out = out + _section_local(spec, x_local, fft_size, mesh, backend=backend)
    return out


def _chan_local(tree, mesh: DeviceMesh):
    """An IR or state with each tensor leaf of ndim >= 1 replaced by its
    channel shard (dim 0 over the channel axis); scalars and host ints
    (ring positions, phase counters) as they are. Every such leaf of the
    mono IR and state types is channel-major."""
    spec = channel_sharding(mesh)
    return rebuild(tree, [local_shard(v, mesh, spec)
                          if isinstance(v, torch.Tensor) and v.dim() >= 1 else v
                          for v in leaves(tree)])


def _chan_global(tree, mesh: DeviceMesh):
    """The inverse of :func:`_chan_local`: channel-sharded DTensors."""
    spec = channel_sharding(mesh)
    c = axis_size(mesh, CHANNEL_AXIS)
    return rebuild(tree, [global_tensor(v, mesh, spec, (v.shape[0] * c, *v.shape[1:]))
                          if isinstance(v, torch.Tensor) and v.dim() >= 1 else v
                          for v in leaves(tree)])


def scheme_offline_sharded(mesh: DeviceMesh, scheme: mono_mod.PartitionScheme,
                           ir: mono_mod.MonoIR, x,
                           backend: Optional[str] = None) -> Optional[DTensor]:
    """Multichannel scheme convolution sharded (channel x block) over the mesh.

    ``x``: (C, L) with C divisible by the channel-axis size and L by the
    largest hop times the block-axis size. The IR's leaves shard over the
    channel axis. Returns y as a DTensor with x's (channel, block) sharding."""
    if not member(mesh):
        return None
    sizes = tuple(plan.fft_size for plan in scheme.sections())
    _validate_sharded_shape(mesh, scheme, x)
    spec = channel_time_sharding(mesh)
    y = _scheme_local(_chan_local(ir, mesh), sizes, local_shard(x, mesh, spec), mesh,
                      backend=backend)
    return global_tensor(y, mesh, spec, x.shape)


def n_to_one_offline(mesh: DeviceMesh, scheme: mono_mod.PartitionScheme,
                     ir: mono_mod.MonoIR, x,
                     backend: Optional[str] = None) -> Optional[DTensor]:
    """N-input -> mono pipeline: each input channel convolves with its IR and
    the channel sum reduces with an ``all_reduce`` over the channel axis (the
    sharded form of NToMonoConvolve's accumulate loop). x: (N, L) -> (L,),
    sharded over the block axis."""
    if not member(mesh):
        return None
    sizes = tuple(plan.fft_size for plan in scheme.sections())
    _validate_sharded_shape(mesh, scheme, x)
    y = _scheme_local(_chan_local(ir, mesh), sizes,
                      local_shard(x, mesh, channel_time_sharding(mesh)), mesh,
                      backend=backend).sum(dim=0)
    dist.all_reduce(y, group=mesh.get_group(CHANNEL_AXIS))
    return global_tensor(y, mesh, [Replicate(), Shard(0)], x.shape[-1:])


def scheme_stream_sharded(mesh: DeviceMesh, ir: mono_mod.MonoIR,
                          state, x, backend: Optional[str] = None):
    """Channel-data-parallel streaming step over the mesh's channel axis.

    Streaming is sequential in time, so it shards only channels: each rank
    advances its channel shard's state through :func:`mono.process` (any of
    its paths: per-section, collapsed or two-tier, as the state selects)
    with no communication at all. ``ir`` / ``state``: leading channel dim
    divisible by the channel-axis size; ``x``: (C, L) with L a multiple of
    the scheme's block size. Returns (state, y) with the state's tensors and
    y as channel-sharded DTensors."""
    if not member(mesh):
        return None
    spec = channel_sharding(mesh)
    st, y = mono_mod.process(_chan_local(ir, mesh), _chan_local(state, mesh),
                             local_shard(x, mesh, spec), backend=backend)
    return _chan_global(st, mesh), global_tensor(y, mesh, spec, x.shape)


def scheme_stream_any_sharded(mesh: DeviceMesh, ir: mono_mod.MonoIR,
                              state: mono_mod.MonoStreamState, x,
                              backend: Optional[str] = None):
    """Channel-data-parallel sample-granular streaming over the mesh: the
    serving-at-scale form of :func:`mono.process_any`. Each rank advances
    its channel shard's sub-hop state (staging windows, output stores);
    the per-section ``phase`` / ``pos`` counters are host ints, the same on
    every rank. No communication. ``x``: (C, B) with any B >= 1."""
    if not member(mesh):
        return None
    spec = channel_sharding(mesh)
    st, y = mono_mod.process_any(_chan_local(ir, mesh), _chan_local(state, mesh),
                                 local_shard(x, mesh, spec), backend=backend)
    return _chan_global(st, mesh), global_tensor(y, mesh, spec, x.shape)
