"""Halo exchange primitives for time-sharded overlap-save convolution.

Counterpart of ``hisstools_library_tpu/parallel/halo.py``. When the time axis
shards into contiguous hop ranges, each rank needs state that lives on its
left neighbour along the mesh's ``block`` axis: the final input samples (the
overlap half of its first frame) and the partition history feeding the MAC.
Both are non-cyclic shifts along the axis, sent point to point
(``batch_isend_irecv``; the JAX package's ``ppermute``). The reference's dual
staging buffers (PartitionedConvolve.cpp:304-305) are the one-rank case.

Each function takes this rank's local tensor and the mesh, and every rank of
the axis must call it (it pairs sends with receives).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import BLOCK_AXIS, axis_size


def shift_from_left(x: torch.Tensor, mesh: DeviceMesh, axis_name: str = BLOCK_AXIS,
                    fill=0.0, hops: int = 1) -> torch.Tensor:
    """Each rank receives the tensor of the rank ``hops`` to its left along
    ``axis_name``; the first ``hops`` ranks receive ``fill`` (non-cyclic:
    zeros encode "no signal before t = 0"). One batch of point-to-point
    sends and receives, addressed by global rank."""
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if hops >= n:
        return torch.full_like(x, fill)
    i = mesh.get_local_rank(axis_name)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = []
    if i + hops < n:
        ops.append(dist.P2POp(dist.isend, x, ranks[i + hops], group))
    if i >= hops:
        ops.append(dist.P2POp(dist.irecv, out, ranks[i - hops], group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    if i < hops:
        out.fill_(fill)
    return out


def left_halo(x: torch.Tensor, halo: int, axis: int, mesh: DeviceMesh,
              axis_name: str = BLOCK_AXIS) -> torch.Tensor:
    """Concatenate the left neighbours' trailing ``halo`` slices onto the
    front of ``x`` along ``axis``; the first rank gets zeros. A halo wider
    than the local extent chains shifts from ranks further left, as many as
    it needs (beyond rank 0 everything is zero history)."""
    local = x.shape[axis]
    n = axis_size(mesh, axis_name)
    pieces = []
    remaining = halo
    hops = 1
    while remaining > 0 and hops <= n - 1:
        take = min(remaining, local)
        tail = x.narrow(axis, local - take, take)
        pieces.insert(0, shift_from_left(tail, mesh, axis_name, hops=hops))
        remaining -= take
        hops += 1
    if remaining > 0:
        pad_shape = list(x.shape)
        pad_shape[axis] = remaining
        pieces.insert(0, x.new_zeros(pad_shape))
    return torch.cat(pieces + [x], dim=axis)
