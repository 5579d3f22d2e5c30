"""Rank-side cases of ``test_torch_parallel.py`` and ``test_torch_fft_sharded.py``.

Each function runs in every CPU rank that ``parallel.launch.run`` spawns (a
gloo process group), so this module imports no jax: the test modules do, and
a rank that imported them would too. The inputs come from the test module
(numpy, made from the tests' seed); rank 0 returns the results as numpy, the
other ranks None. Every rank runs every case, since each mesh's groups are
made by all ranks of the world.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from hisstools_library_tpu_torch.models import mono
from hisstools_library_tpu_torch.models.mono import PartitionScheme
from hisstools_library_tpu_torch.parallel import (
    BLOCK_AXIS, convolve_sharded, fft_sharded, left_halo, make_mesh,
    n_to_one_offline, rfft_sharded, rifft_sharded, scheme_offline_sharded,
    scheme_stream_any_sharded, scheme_stream_sharded, shift_from_left)
from hisstools_library_tpu_torch.parallel import launch
from hisstools_library_tpu_torch.parallel.mesh import global_tensor, local_shard, member

CPU = "cpu"
SCHEME = PartitionScheme((32, 128), zero_latency=True)


def _mesh(channel=None, block=None):
    return make_mesh(channel=channel, block=block, device_type=CPU)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    """A sharded result on every member, as numpy (None off the mesh)."""
    if t is None:
        return None
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


def _placements(t: DTensor):
    return [repr(p) for p in t.placements]


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def parallel_cases(inp: dict) -> dict:
    """Every case of ``test_torch_parallel.py`` on an 8-rank world."""
    out = {}
    m42 = _mesh(channel=4, block=2)
    out["mesh_4x2"] = dict(zip(m42.mesh_dim_names, m42.shape))
    out["mesh_default"] = dict(zip(m42.mesh_dim_names, _mesh().shape))
    out["reject_block3"] = _error(lambda: _mesh(block=3))
    out["reject_channel5"] = _error(lambda: _mesh(channel=5))
    out["mesh_block2_ranks"] = _mesh(block=2).mesh.numel()

    # shift_from_left over a 1 x 8 mesh.
    m18 = _mesh(channel=1, block=8)
    spec = [Replicate(), Shard(0)]
    x = torch.arange(8.0).reshape(8, 1)
    y = shift_from_left(local_shard(x, m18, spec), m18)
    out["shift"] = _np(global_tensor(y, m18, spec, (8, 1)))

    # left_halo over a 1 x 4 mesh (ranks 4-7 are outside it).
    m14 = _mesh(channel=1, block=4)
    for halo in (3, 16, 40):
        if member(m14):
            xl = local_shard(torch.arange(64.0), m14, spec)
            yl = left_halo(xl, halo, 0, m14)
            out[f"halo_{halo}"] = _np(global_tensor(yl, m14, spec,
                                                    (4 * (halo + 16),))).reshape(4, -1)

    # The scheme, float64, against np.convolve (4 x 2), the offline engine
    # (2 x 4) and the N-to-mono sum (4 x 2).
    for key, mesh in (("scheme_single", m42), ("scheme_engine", _mesh(channel=2, block=4))):
        c = inp[key]
        ir = mono.prepare_ir(SCHEME, c["irs"], dtype=torch.float64, device=CPU)
        y = scheme_offline_sharded(mesh, SCHEME, ir, _t(c["x"]))
        out[key] = _np(y)
        out[key + "_placements"] = _placements(y)
        if key == "scheme_engine":
            out[key + "_single"] = mono.process_offline(ir, _t(c["x"])).numpy()
    c = inp["n_to_one"]
    ir = mono.prepare_ir(SCHEME, c["irs"], dtype=torch.float64, device=CPU)
    y = n_to_one_offline(m42, SCHEME, ir, _t(c["x"]))
    out["n_to_one"] = _np(y)
    out["n_to_one_placements"] = _placements(y)

    # An IR whose partition history spans several block shards.
    c = inp["long_ir"]
    scheme = PartitionScheme((32,), zero_latency=True)
    ir = mono.prepare_ir(scheme, c["irs"], dtype=torch.float64, device=CPU)
    out["long_ir"] = _np(scheme_offline_sharded(m18, scheme, ir, _t(c["x"])[None, :]))

    # The fused section (K2 -> K15 -> K4, plain versions here), 2 x 4.
    c = inp["fused"]
    scheme = PartitionScheme((4096,), zero_latency=False)
    ir = mono.prepare_ir(scheme, c["irs"], dtype=torch.float32, device=CPU)
    out["fused"] = _np(scheme_offline_sharded(_mesh(channel=2, block=4), scheme, ir,
                                              _t(c["x"]), backend="pallas"))
    out["fused_single"] = mono.process_offline(ir, _t(c["x"])).numpy()

    # The same sharded call twice (tests/test_determinism.py's sharded case):
    # the fused section on a 2 x 4 mesh, bits compared in the test.
    c = inp["sharded_twice"]
    scheme = PartitionScheme((4096,), zero_latency=False)
    ir = mono.prepare_ir(scheme, c["irs"], offline_tail=False, device=CPU)
    m24 = _mesh(channel=2, block=4)
    out["sharded_twice"] = [_np(scheme_offline_sharded(m24, scheme, ir, _t(c["x"]),
                                                       backend="pallas"))
                            for _ in range(2)]

    # Mesh-shape invariance of one section at N = 512.
    c = inp["invariance"]
    scheme = PartitionScheme((512,), zero_latency=False)
    ir = mono.prepare_ir(scheme, c["irs"], offline_tail=False, device=CPU)
    out["invariance_single"] = mono.process_offline(ir, _t(c["x"])).numpy()
    for ch, blk in ((8, 1), (4, 2), (2, 4), (1, 8)):
        out[f"invariance_{ch}x{blk}"] = _np(scheme_offline_sharded(
            _mesh(channel=ch, block=blk), scheme, ir, _t(c["x"])))

    # Channel-parallel streaming (8 x 1): two calls, the state carried as
    # DTensors from the first into the second.
    m81 = _mesh(channel=8, block=1)
    scheme = PartitionScheme((64, 256), zero_latency=True)
    c = inp["stream"]
    ir = mono.prepare_ir(scheme, c["irs"], offline_tail=False, device=CPU)
    st = mono.init_state(scheme, ir, batch_shape=(8,))
    st, ya = scheme_stream_sharded(m81, ir, st, _t(c["x1"]))
    out["stream_state_is_dtensor"] = isinstance(st.sections[0].ring.re, DTensor)
    _, yb = scheme_stream_sharded(m81, ir, st, _t(c["x2"]))
    out["stream"] = (_np(ya), _np(yb))
    ref = mono.init_state(scheme, ir, batch_shape=(8,))
    ref, ya = mono.process(ir, ref, _t(c["x1"]))
    _, yb = mono.process(ir, ref, _t(c["x2"]))
    out["stream_single"] = (ya.numpy(), yb.numpy())

    # Sample-granular streaming over ragged callbacks.
    c = inp["any"]
    ir = mono.prepare_ir(scheme, c["irs"], offline_tail=False, device=CPU)
    st = mono.init_stream_state(scheme, ir, batch_shape=(8,))
    ref = mono.init_stream_state(scheme, ir, batch_shape=(8,))
    got, want = [], []
    for xb in c["xs"]:
        st, y = scheme_stream_any_sharded(m81, ir, st, _t(xb))
        got.append(_np(y))
        ref, y = mono.process_any(ir, ref, _t(xb))
        want.append(y.numpy())
    out["any"], out["any_single"] = got, want

    # The dry run's body on this world (its own meshes, 2 x 4).
    out["dryrun"] = launch._dryrun_rank(8)
    return out if torch.distributed.get_rank() == 0 else None


def fft_cases(inp: dict) -> dict:
    """Every case of ``test_torch_fft_sharded.py`` on an 8-rank world; the
    1 x d meshes for d < 8 use the first d ranks."""
    out = {}
    meshes = {d: _mesh(channel=1, block=d) for d in (1, 2, 4, 8)}

    def fft(d, xr, xi, inverse=False):
        return fft_sharded(meshes[d], _t(xr), _t(xi), inverse=inverse)

    for n in (1 << 10, 1 << 13, 1 << 16):
        xr, xi = inp[f"forward_{n}"]
        fr, fi = fft(8, xr, xi)
        out[f"forward_{n}"] = _np(fr) + 1j * _np(fi)

    xr, xi = inp["roundtrip"]
    fr, fi = fft(8, xr, xi)
    br, bi = fft_sharded(meshes[8], fr, fi, inverse=True)  # DTensors in
    out["roundtrip"] = (_np(br), _np(bi))

    xr, xi = inp["single_chip"]
    fr, fi = fft(8, xr, xi)
    out["single_chip"] = _np(fr) + 1j * _np(fi)

    xr, xi = inp["stays_sharded"]
    fr, _ = fft(8, xr, xi)
    out["stays_sharded"] = dict(placements=_placements(fr), local=tuple(fr.to_local().shape),
                                shape=tuple(fr.shape))

    for d in (2, 4, 8):
        xr, xi = inp[f"invariance_{d}"]
        res = fft(d, xr, xi)
        if res is not None:
            out[f"invariance_{d}"] = _np(res[0]) + 1j * _np(res[1])

    xr, xi = inp["fallback"]
    res = fft(1, xr, xi)
    if res is not None:
        out["fallback"] = _np(res[0]) + 1j * _np(res[1])

    for n in (1 << 8, 1 << 12, 1 << 15):
        pr, pi = rfft_sharded(meshes[8], _t(inp[f"rfft_{n}"]))
        out[f"rfft_{n}"] = (_np(pr), _np(pi))

    for d in (2, 4, 8):
        res = rfft_sharded(meshes[d], _t(inp[f"rifft_{d}"]))
        if res is not None:
            out[f"rifft_{d}"] = _np(rifft_sharded(meshes[d], *res))

    pr, pi = rfft_sharded(meshes[8], _t(inp["rfft_f32"]))
    out["rfft_f32"] = (_np(pr), _np(pi))

    for d in (1, 4, 8):
        x, h = inp[f"convolve_{d}"]
        y = convolve_sharded(meshes[d], _t(x), _t(h))
        if y is not None:
            out[f"convolve_{d}"] = (_np(y), _placements(y), tuple(y.to_local().shape))

    out["reject_n32"] = _error(lambda: fft_sharded(meshes[8], torch.zeros(32),
                                                   torch.zeros(32)))
    out["reject_2d"] = _error(lambda: fft_sharded(meshes[8], torch.zeros(2, 4096),
                                                  torch.zeros(2, 4096)))
    m13 = _mesh(channel=1, block=3)
    out["reject_non_pow2"] = _error(lambda: convolve_sharded(m13, torch.zeros(1000),
                                                             torch.zeros(100)))
    out["axis"] = BLOCK_AXIS
    return out if torch.distributed.get_rank() == 0 else None


def failing_case(bad_rank: int) -> int:
    """Raises on ``bad_rank`` (the launcher's error path)."""
    if torch.distributed.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return torch.distributed.get_rank()
