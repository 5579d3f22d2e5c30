"""Ranks on the host CPU over gloo, and the multi-rank dry run.

:func:`run` spawns ``n`` processes, joins them in a gloo process group (the
rendezvous is a ``FileStore`` in a temporary directory, so launches running
side by side never compete for a port), calls ``fn(*args)`` in each with
one intra-op thread and returns each rank's result. ``fn`` must be a
module-level function of a module that the ranks can import; the ranks
import neither jax nor the JAX package unless ``fn``'s module does.

:func:`dryrun_multichip` is the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` and of its multi-process dry run: every
rank is a process, so one run covers both. It drives the sharded scheme
(channel x block, halo exchange), the N-to-mono reduction, the fused section
chain, channel-parallel streaming (per-section and two-tier) and
sample-granular serving, and the distributed FFT on ``n`` CPU ranks, each
against the single-rank engine.

    python -m hisstools_library_tpu_torch.parallel.launch [n]
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 300.0


def _rank_main(rank: int, n: int, store_path: str, call_path: str, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        out = fn(*args)
        dist.barrier()  # no rank leaves while another still talks to it
        dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the parent raises it with this traceback
        results.put((rank, False, traceback.format_exc()))


def run(n: int, fn: Callable, *args, timeout: float = RANK_TIMEOUT_S) -> List[Any]:
    """Spawn ``n`` CPU ranks over gloo, call ``fn(*args)`` in each and
    return the results in rank order. Raises RuntimeError with the
    traceback of the first rank that failed or died, TimeoutError past
    ``timeout`` seconds; every rank is stopped before it returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hisstools_ranks_") as tmp:
        # The call goes through a file: a process's own arguments pass
        # through a pipe that the parent fills before the next process
        # starts, so large arguments would start the ranks one by one.
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, os.path.join(tmp, "store"), call_path, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died (exit code "
                                           f"{procs[dead[0]].exitcode})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:  # after a failure the others may wait on it forever
                p.join(timeout=10 if len(got) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n)]


def _rel_err(y, ref) -> float:
    return float((y - ref).abs().max()) / (float(ref.abs().max()) or 1.0)


def _expect(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {msg}")


def _dryrun_rank(n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip` (CPU tensors, float32)."""
    from ..models import mono
    from ..models.mono import PartitionScheme
    from . import (convolve_sharded, make_mesh, n_to_one_offline, rfft_sharded,
                   rifft_sharded, scheme_offline_sharded, scheme_stream_any_sharded,
                   scheme_stream_sharded)

    cpu = "cpu"
    # Factor the rank count into a 2-D mesh (channel x block).
    block_axis = next((c for c in (4, 2, 3) if n_devices % c == 0), 1)
    channel_axis = n_devices // block_axis
    mesh = make_mesh(channel=channel_axis, block=block_axis, device_type=cpu)
    out = {"mesh": (channel_axis, block_axis)}

    scheme = PartitionScheme((32, 64), zero_latency=True)
    hop = scheme.sizes[-1] >> 1
    c = 2 * channel_axis
    length = hop * block_axis * 2
    rng = np.random.default_rng(0)  # the same draws on every rank
    x = torch.from_numpy(rng.standard_normal((c, length)).astype(np.float32))
    irs = rng.standard_normal((c, 150)).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, device=cpu)

    # The sharded scheme: channel-sharded IR, time-sharded signal, halos.
    y = scheme_offline_sharded(mesh, scheme, ir, x).full_tensor()
    _expect(tuple(y.shape) == (c, length), f"shape {tuple(y.shape)}")
    y_ref = mono.process_offline(ir, x)
    out["offline"] = _rel_err(y, y_ref)
    _expect(out["offline"] < 1e-3, f"sharded/single mismatch {out['offline']}")

    # N-to-mono: all_reduce over the channel axis.
    y2 = n_to_one_offline(mesh, scheme, ir, x).full_tensor()
    _expect(tuple(y2.shape) == (length,), f"shape {tuple(y2.shape)}")
    out["n_to_one"] = _rel_err(y2, y_ref.sum(0))
    _expect(out["n_to_one"] < 1e-3, f"n_to_one mismatch {out['n_to_one']}")

    # The fused section chain per shard (K2 -> K15 -> K4's plain versions on
    # the CPU) at a size it serves.
    scheme_f = PartitionScheme((4096,), zero_latency=False)
    xf = torch.from_numpy(rng.standard_normal((c, 2048 * block_axis * 2)).astype(np.float32))
    ir_f = mono.prepare_ir(scheme_f, rng.standard_normal((c, 3 * 2048)).astype(np.float32),
                           device=cpu)
    y3 = scheme_offline_sharded(mesh, scheme_f, ir_f, xf, backend="pallas").full_tensor()
    out["fused"] = _rel_err(y3, mono.process_offline(ir_f, xf))
    _expect(out["fused"] < 1e-3, f"fused sharded/single mismatch {out['fused']}")

    # Channel-parallel streaming, state carried per shard.
    mesh_c = make_mesh(channel=n_devices, block=1, device_type=cpu)
    cs = 2 * n_devices
    ir_s = mono.prepare_ir(scheme, rng.standard_normal((cs, 150)).astype(np.float32),
                           offline_tail=False, device=cpu)
    st = mono.init_state(scheme, ir_s, batch_shape=(cs,))
    xs = torch.from_numpy(rng.standard_normal((cs, hop * 2)).astype(np.float32))
    st, ys = scheme_stream_sharded(mesh_c, ir_s, st, xs)
    _expect(tuple(ys.shape) == (cs, hop * 2), f"shape {tuple(ys.shape)}")

    # The two-tier block path under the channel mesh: sharded == single.
    irs_2t = rng.standard_normal((cs, 3000)).astype(np.float32) * 0.3
    ir_2t = mono.prepare_ir(scheme, irs_2t, offline_tail=False, device=cpu)
    st2 = mono.init_block_state(scheme, ir_2t, batch_shape=(cs,))
    x2t = torch.from_numpy(rng.standard_normal((cs, ir_2t.far.shape[-1])).astype(np.float32))
    _, y2t = scheme_stream_sharded(mesh_c, ir_2t, st2, x2t)
    _, y2t_ref = mono.process(ir_2t, st2, x2t)
    out["two_tier"] = _rel_err(y2t.full_tensor(), y2t_ref)
    _expect(out["two_tier"] < 1e-3, f"two-tier sharded mismatch {out['two_tier']}")

    # Sample-granular serving: ragged callbacks bit-identical to one rank.
    st_any = mono.init_stream_state(scheme, ir_s, batch_shape=(cs,))
    st_ref = mono.init_stream_state(scheme, ir_s, batch_shape=(cs,))
    for blk in (7, 33):
        xa = torch.from_numpy(rng.standard_normal((cs, blk)).astype(np.float32))
        st_any, ya = scheme_stream_any_sharded(mesh_c, ir_s, st_any, xa)
        st_ref, yr = mono.process_any(ir_s, st_ref, xa)
        _expect(torch.equal(ya.full_tensor(), yr), f"sharded process_any mismatch at {blk}")

    # The distributed FFT over every rank: the packed real pair and the
    # whole-signal convolution built on it.
    mesh_f = make_mesh(channel=1, block=n_devices, device_type=cpu)
    nfft = max(4096, 4 * n_devices * n_devices)
    xr = torch.from_numpy(rng.standard_normal(nfft).astype(np.float32))
    pr, pi = rfft_sharded(mesh_f, xr)
    yb = rifft_sharded(mesh_f, pr, pi).full_tensor()
    out["rfft_roundtrip"] = float((yb / (2 * nfft) - xr).abs().max())
    _expect(out["rfft_roundtrip"] < 1e-3, f"sharded rfft roundtrip {out['rfft_roundtrip']}")
    yc = convolve_sharded(mesh_f, xr[:2000], xr[:300])
    _expect(tuple(yc.shape) == (2000 + 300 - 1,), f"shape {tuple(yc.shape)}")
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """Run the sharded pipeline on ``n_devices`` CPU ranks over gloo and
    check each part against the single-rank engine; raises on a mismatch.
    Returns rank 0's errors by part."""
    return run(n_devices, _dryrun_rank, n_devices)[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
