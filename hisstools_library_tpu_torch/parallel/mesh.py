"""Device-mesh construction for the audio-DSP workload, on ``torch.distributed``.

Counterpart of ``hisstools_library_tpu/parallel/mesh.py``. The reference
library is single-process; the port scales over a 2-D logical mesh of ranks:

- ``channel`` axis: convolution channels shard like data parallelism (the
  N-to-mono reduction becomes an ``all_reduce`` over this axis),
- ``block`` axis: the time axis shards into contiguous overlap-save hop
  ranges; block boundaries are exchanged by point-to-point shifts
  (:mod:`.halo`).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group (which the caller initialises, e.g. NCCL with
one rank per card, or gloo for CPU ranks: :mod:`.launch`). A sharding is a
list of DTensor placements, one per mesh dim, standing for the JAX package's
``PartitionSpec``. The module also holds the small helpers the sharded
functions share: a tensor's local shard and the DTensor that wraps it back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"


def make_mesh(channel: Optional[int] = None, block: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a (channel, block) mesh over the default process group's ranks,
    laid out row-major (rank = channel index * block + block index), as the
    JAX package reshapes its device list.

    With only one of the factors given the other is inferred; with neither,
    every rank goes to the channel axis (pure channel parallelism). A mesh
    smaller than the world uses the first ``channel * block`` ranks; the
    others take no part in it (the sharded functions return None there).
    ``device_type`` is ``"cuda"`` unless the caller names ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default process group: "
                           "call init_process_group first (parallel.launch.run spawns "
                           "CPU ranks over gloo)")
    n = dist.get_world_size()
    if channel is None and block is None:
        channel, block = n, 1
    elif channel is None:
        if n % block:
            # Inferring channel = n // block would silently idle n % block
            # ranks (block=3 on 8 ranks -> a 2x3 mesh, 2 ranks unused).
            raise ValueError(f"block={block} does not divide {n} devices; "
                             f"pass channel explicitly to use a subset")
        channel = n // block
    elif block is None:
        if n % channel:
            raise ValueError(f"channel={channel} does not divide {n} devices; "
                             f"pass block explicitly to use a subset")
        block = n // channel
    if channel * block > n:
        raise ValueError(f"mesh {channel}x{block} needs more than {n} devices")
    ranks = torch.arange(channel * block).reshape(channel, block)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(CHANNEL_AXIS, BLOCK_AXIS))


def channel_sharding(mesh: DeviceMesh) -> List[Placement]:
    """(C, L) tensors: channels split over the channel axis, time replicated."""
    return [Shard(0), Replicate()]


def channel_time_sharding(mesh: DeviceMesh) -> List[Placement]:
    """(C, L) tensors: channels over the channel axis, time over the block axis."""
    return [Shard(0), Shard(1)]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return [Replicate(), Replicate()]


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The number of ranks along ``axis_name``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def member(mesh: DeviceMesh) -> bool:
    """True when this rank belongs to ``mesh``."""
    return mesh.get_coordinate() is not None


def local_shard(t, mesh: DeviceMesh, placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements``: a DTensor's local
    tensor (redistributed first where it is placed otherwise), or the slice
    of a full tensor (every rank holding the same values) that the placement
    gives this rank, by ``torch.chunk``'s rule as DTensor shards."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements).to_local()
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = torch.chunk(t, mesh.size(i), dim=p.dim)[coord[i]]
    return t


def global_tensor(local: torch.Tensor, mesh: DeviceMesh,
                  placements: Sequence[Placement], shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is ``local``."""
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())
