"""Worked example: real-time serving with IR hot-swap under a running stream.

Twin of the JAX repository's ``tools/serve_demo.py``, with the same flags.
Runs the reference's two-thread discipline on the CUDA card (or the CPU with
--cpu): an audio thread streams fixed-size callbacks through
``utils.serving.StreamingServer`` while a loader thread prepares and swaps
new IR banks mid-stream (reference MonoConvolve.cpp:118-140, 179-201).
Prints per-callback wall times (each callback ends when its output is back on
the host, as an audio device needs it), the callbacks over their budget, the
silent-block count (blocks emitted while the loader held the lock), and a
post-swap parity check against np.convolve; exits 1 below 80 dB.

With ``--native-host`` the audio callback itself runs as a NATIVE thread
(``utils.native_rt.AudioHost``): capture and playback move through lock-free
SPSC rings at a fixed block cadence while the Python worker drives the
engine, with overrun/underrun accounting; exits 1 on an overrun or a lost
block.

Usage: python -m hisstools_library_tpu_torch.tools.serve_demo [--cpu]
       [--channels 8] [--block 256] [--swaps 3] [--seconds 2] [--native-host]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch


def make_loader(srv, irs, args, swap_log):
    """The loader-thread body: paced IR prepares + hot swaps with timing
    (shared by the Python-callback and native-host paths)."""
    def loader():
        for k in range(1, args.swaps + 1):
            time.sleep(args.seconds / (args.swaps + 1))
            t0 = time.monotonic()
            srv.set_ir(irs[k])
            swap_log.append((time.monotonic() - t0, k))
            print(f"  loader: swapped to IR {k} "
                  f"(prepare+install {swap_log[-1][0] * 1e3:.1f} ms)",
                  flush=True)
    return loader


def run_native_host(args, srv, x, irs):
    """Stream through the native audio-callback host (rt_runtime.cpp).

    The host thread rasters capture blocks into an SPSC ring and drains
    playback blocks on the same tick; the Python worker pulls, runs the
    engine, and pushes. Block raster layout: (channels, frames) C-order."""
    from ..utils import native_rt as rt

    ch, blk, fs = args.channels, args.block, args.fs
    bf = ch * blk
    n_blocks = x.shape[-1] // blk
    warmup = 2
    src = np.ascontiguousarray(
        x.reshape(ch, n_blocks, blk).transpose(1, 0, 2)).ravel()
    in_ring, out_ring = rt.Ring(8 * bf), rt.Ring(8 * bf)
    host = rt.AudioHost(in_ring, out_ring, src, blk, ch, float(fs),
                        n_blocks, warmup_blocks=warmup)

    swap_log = []
    th = threading.Thread(target=make_loader(srv, irs, args, swap_log))
    th.start()
    done, silent = 0, 0
    deadline = time.time() + 10 * args.seconds + 30
    while done < n_blocks and time.time() < deadline:
        cap = in_ring.read(bf)
        if cap.size < bf:
            time.sleep(0.0002)
            continue
        y, live = srv.process(cap.reshape(ch, blk))
        if not live:
            silent += 1
        out_ring.write(y.cpu().numpy().ravel())
        done += 1
    th.join()
    stats = host.join()
    print(f"native host: {stats['blocks']} callbacks of {blk} samples @ "
          f"{fs} Hz; underruns {stats['underruns']} (after {warmup}-block "
          f"warmup), overruns {stats['overruns']}, worst wake-up lateness "
          f"{stats['late_ns_max'] / 1e6:.2f} ms; {silent} silent blocks "
          f"during swaps", flush=True)
    ok = (stats["blocks"] == n_blocks and stats["overruns"] == 0
          and done == n_blocks)
    print("OK" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions)")
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--swaps", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fs", type=int, default=48000)
    ap.add_argument("--native-host", action="store_true",
                    help="drive the stream from the native audio-callback "
                         "thread (requires the native runtime)")
    args = ap.parse_args(argv)

    from ..core.types import default_device
    from ..models.mono import LatencyMode
    from ..utils.serving import StreamingServer

    dev = torch.device("cpu") if args.cpu else default_device()
    rng = np.random.default_rng(0)
    srv = StreamingServer(args.channels, capacity=1 << 15,
                          latency=LatencyMode.Zero, dtype=torch.float32, device=dev)
    ir0 = (rng.standard_normal((args.channels, 12000)) *
           np.exp(-np.arange(12000) / 4800.0)).astype(np.float32)
    srv.set_ir(ir0)
    print(f"server: {args.channels}ch on {dev}, zero-latency scheme "
          f"{srv.scheme.sizes}, capacity {srv.capacity}", flush=True)

    n_blocks = int(args.seconds * args.fs / args.block)
    x = rng.standard_normal(
        (args.channels, n_blocks * args.block)).astype(np.float32)

    irs = [ir0] + [
        (rng.standard_normal((args.channels, 12000)) *
         np.exp(-np.arange(12000) / 4800.0)).astype(np.float32)
        for _ in range(args.swaps)]
    swap_log = []
    loader = make_loader(srv, irs, args, swap_log)

    # Warm up the step (first launches, allocator) before timing.
    y, live = srv.process(x[:, :args.block])
    y.cpu()

    if args.native_host:
        from ..utils import native_rt
        if not native_rt.available():
            print("native runtime unavailable (no g++)", flush=True)
            return 1
        srv._state = None  # drop the warm-up block from the stream state
        srv._state_version = -1
        return run_native_host(args, srv, x, irs)

    th = threading.Thread(target=loader)
    th.start()
    times, silent = [], 0
    outs = []
    period = args.block / args.fs
    next_deadline = time.monotonic()
    for b in range(n_blocks):
        # Real-time pacing: wake at each callback deadline like an audio
        # device would, so loader swaps interleave with the stream.
        next_deadline += period
        lag = next_deadline - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        t0 = time.monotonic()
        y, live = srv.process(x[:, b * args.block:(b + 1) * args.block])
        y = y.cpu().numpy()
        times.append(time.monotonic() - t0)
        if not live:
            silent += 1
        outs.append((y, live, srv._state_version))
    th.join()

    times_ms = np.asarray(times) * 1e3
    budget_ms = args.block / args.fs * 1e3
    late = int(np.sum(times_ms > budget_ms))
    print(f"{n_blocks} callbacks of {args.block} samples: "
          f"median {np.median(times_ms):.3f} ms, p99 "
          f"{np.percentile(times_ms, 99):.3f} ms (budget {budget_ms:.3f} ms, "
          f"{late} late); {silent} silent blocks during swaps", flush=True)

    # Post-swap parity: the engine state resets on the first block processed
    # with the final IR version; everything from there is the convolution of
    # only the post-swap samples with the final IR.
    final_version = outs[-1][2]
    final_ir = irs[final_version - 1]  # version v was built from irs[v-1]
    last_reset = next(b for b in range(n_blocks) if outs[b][2] == final_version)
    seg = np.concatenate([o[0] for o in outs[last_reset:]], axis=-1)
    xs = x[:, last_reset * args.block:]
    ref = np.convolve(xs[0].astype(np.float64),
                      final_ir[0].astype(np.float64))[:seg.shape[-1]]
    err = seg[0].astype(np.float64) - ref
    snr = 10 * np.log10(np.sum(ref * ref) / max(np.sum(err * err), 1e-300))
    print(f"post-swap parity (ch0 vs np.convolve, final IR): {snr:.1f} dB",
          flush=True)
    ok = snr > 80.0
    print("OK" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
