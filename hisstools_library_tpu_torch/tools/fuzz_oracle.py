"""Randomized oracle fuzzing: the port's engines vs float64 direct convolution.

Twin of the JAX repository's ``tools/fuzz_oracle.py``, with its flags and
its draws (the same configurations for a seed). Draws random (channel count,
signal length, IR length, FFT size, scheme, engine) configurations and checks
every output against numpy float64 ``np.convolve`` to a hard SNR floor.

The default device is flipped: the JAX tool fuzzes on the CPU unless given
``--tpu``; this one fuzzes on the CUDA card (the Hopper kernels) unless given
``--cpu`` (the kernels' plain PyTorch versions, the same routes). As the JAX
tool skips its sharded draw on the accelerator, this one skips it on the
card; with ``--cpu`` the draw runs ``parallel.scheme_offline_sharded`` in an
in-process gloo group of world size 1 (several ranks are the parallel
tests' business). Exits 1 if any draw falls below the floor.

    python -m hisstools_library_tpu_torch.tools.fuzz_oracle --minutes 30 --seed 0
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _gloo_mesh():
    """A (1 x 1) CPU mesh over a world-size-1 gloo group, made here if no
    process group exists (the second value says whether to destroy it)."""
    import torch.distributed as dist

    from ..parallel import make_mesh
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(channel=1, block=1, device_type="cpu"), own


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snr", type=float, default=85.0)
    ap.add_argument("--cpu", action="store_true",
                    help="fuzz on the CPU (the kernels' plain PyTorch versions) "
                         "instead of the CUDA card")
    ap.add_argument("--stages", action="store_true",
                    help="on failure, print a per-stage SNR report "
                         "(utils.debug_stages) to localise the stage that "
                         "lost accuracy")
    args = ap.parse_args(argv)

    from ..core.types import default_device
    from ..models import mono
    from ..models import partitioned as part
    from ..models.mono import PartitionScheme
    from ..models.offline import fast_fir

    dev = torch.device("cpu") if args.cpu else default_device()

    def dt(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def host(y):
        return y.cpu().numpy()

    rng = np.random.default_rng(args.seed)
    deadline = time.time() + args.minutes * 60.0
    n_cases = 0
    failures = []
    mesh = None

    def check(tag, ref, test, cfg, raw=None, stream_raw=None):
        nonlocal n_cases
        n_cases += 1
        ref = np.asarray(ref, np.float64)
        err = np.asarray(test, np.float64) - ref
        d = (err * err).sum()
        snr = np.inf if d == 0 else 10 * np.log10((ref * ref).sum() / d)
        status = "ok" if snr > args.snr else "FAIL"
        print(f"[{status}] {tag} SNR {snr:.1f} dB {cfg}", flush=True)
        if snr <= args.snr:
            failures.append((tag, cfg, snr))
            if args.stages and raw is not None:
                from ..utils import debug_stages
                ir_raw, x_raw = raw
                rep = debug_stages.stage_report(ir_raw, x_raw, backend="pallas",
                                                device=dev)
                print(debug_stages.format_report(rep), flush=True)
            if args.stages and stream_raw is not None:
                # Streaming failure: localise with the streaming stage
                # mirrors (frame_rfft / ring_mac / lag0 / rifft_tail /
                # refresh / subhop_fire / subhop_doling).
                from ..utils import debug_stages
                ir_raw, x_raw, sch = stream_raw
                B = sch.sizes[-1] >> 1
                pad = max(0, 2 * B - x_raw.shape[-1])
                x2 = np.pad(np.asarray(x_raw, np.float32),
                            [(0, 0)] * (x_raw.ndim - 1) + [(0, pad)])
                rep = debug_stages.stream_stage_report(
                    ir_raw, x2[..., :B], x2[..., B:2 * B], scheme=sch,
                    backend="pallas", device=dev)
                print(debug_stages.format_report(rep), flush=True)

    while time.time() < deadline:
        c = int(rng.integers(1, 5))
        L = int(rng.integers(500, 60000))
        irl = int(rng.integers(16, 30000))
        amp = 10.0 ** rng.uniform(-2, 1)
        x = (rng.standard_normal((c, L)) * amp).astype(np.float32)
        ir = (rng.standard_normal((c, irl)) *
              np.exp(-np.arange(irl) / max(irl / 4, 1)) * 0.3).astype(np.float32)
        ref = np.stack([np.convolve(x[i].astype(np.float64),
                                    ir[i].astype(np.float64))[:L]
                        for i in range(c)])

        pick = rng.integers(0, 6)
        if pick == 0:
            log2n = int(rng.integers(part.MIN_FFT_SIZE_LOG2, 18))
            nfft = 1 << log2n
            cfg = f"fast_fir c={c} L={L} ir={irl} N=2^{log2n}"
            y = fast_fir(dt(x), ir, fft_size=nfft, backend="pallas")
            check("fast_fir", ref, host(y), cfg, raw=(ir, x))
        elif pick == 1:
            # random valid ascending scheme
            base = int(rng.integers(5, 9))
            sizes = tuple(1 << (base + 2 * k)
                          for k in range(int(rng.integers(1, 4))))
            zl = bool(rng.integers(0, 2))
            scheme = PartitionScheme(sizes, zero_latency=zl)
            prep = mono.prepare_ir(scheme, ir, device=dev)
            y = mono.process_offline(prep, dt(x), backend="pallas")
            lat = scheme.latency
            ref_l = np.concatenate(
                [np.zeros((c, lat)), ref[:, :L - lat]], axis=-1)
            cfg = f"scheme {sizes} zl={zl} c={c} L={L} ir={irl}"
            check("scheme_offline", ref_l, host(y), cfg, raw=(ir, x))
        elif pick == 3 and args.cpu:
            # Sharded offline on the world-size-1 mesh (1 x 1).
            from ..parallel import scheme_offline_sharded
            if mesh is None:
                mesh, own_group = _gloo_mesh()
            ch_ax, blk_ax = mesh.shape
            sizes = (int(1 << rng.integers(8, 13)),)
            scheme = PartitionScheme(sizes, zero_latency=False)
            hop = sizes[0] >> 1
            cs = ch_ax * int(rng.integers(1, 3))
            quant = blk_ax * hop
            Ls = max(quant, (L // quant) * quant)
            xs = (rng.standard_normal((cs, Ls)) * amp).astype(np.float32)
            irs = (rng.standard_normal((cs, irl)) * 0.2).astype(np.float32)
            prep = mono.prepare_ir(scheme, irs, offline_tail=False, device=dev)
            y = scheme_offline_sharded(mesh, scheme, prep, dt(xs), backend="pallas")
            y_ref = mono.process_offline(prep, dt(xs))
            cfg = (f"sharded mesh={ch_ax}x{blk_ax} c={cs} L={Ls} "
                   f"ir={irl} N={sizes[0]}")
            check("sharded_offline", host(y_ref).astype(np.float64),
                  host(y.full_tensor()), cfg)
        elif pick == 4:
            # Sub-hop streaming: random odd callback sizes through process_any
            # (float32: the fused hop kernel for small sections).
            base = int(rng.integers(5, 8))
            sizes = tuple(1 << (base + 2 * k)
                          for k in range(int(rng.integers(1, 3))))
            scheme = PartitionScheme(sizes, zero_latency=True)
            Ls = min(L, (sizes[-1] >> 1) * 6 + int(rng.integers(0, 777)))
            xs = x[:, :Ls]
            prep = mono.prepare_ir(scheme, ir, offline_tail=False, device=dev)
            st = mono.init_stream_state(scheme, prep, batch_shape=(c,))
            outs = []
            i = 0
            # Cap the callback count, as the JAX tool does.
            lo = max(1, Ls // 12)
            while i < Ls and len(outs) < 16:
                b = min(int(rng.integers(lo, lo + 600)), Ls - i)
                st, yb = mono.process_any(prep, st, dt(xs[:, i:i + b]),
                                          backend="pallas")
                outs.append(host(yb))
                i += b
            y = np.concatenate(outs, axis=-1)
            refs = np.stack([np.convolve(xs[k].astype(np.float64),
                                         ir[k].astype(np.float64))[:i]
                             for k in range(c)])
            cfg = f"subhop {sizes} c={c} Ls={i} ir={irl}"
            check("subhop_any_blocks", refs, y, cfg,
                  stream_raw=(ir, xs, scheme))
        elif pick == 5:
            # Two-tier block streaming: random scheme whose IR extends past
            # the far hop; carried MonoBlockState over two calls.
            base = int(rng.integers(5, 8))
            sizes = tuple(1 << (base + k)
                          for k in range(int(rng.integers(2, 5))))
            zl = bool(rng.integers(0, 2))
            scheme = PartitionScheme(sizes, zero_latency=zl)
            ir2 = ir
            prep = mono.prepare_ir(scheme, ir2, offline_tail=False, device=dev)
            if prep.far is None:
                # IR too short for this scheme's far hop: extend it so the
                # two-tier branch always exercises (random tails, same decay).
                need = mono._far_hop(scheme, max(irl, 4096)) or 4096
                irl2 = int(need * (2 + rng.integers(0, 3)) +
                           rng.integers(1, need))
                ir2 = (rng.standard_normal((c, irl2)) *
                       np.exp(-np.arange(irl2) / max(irl2 / 4, 1))
                       * 0.3).astype(np.float32)
                prep = mono.prepare_ir(scheme, ir2, offline_tail=False, device=dev)
                if prep.far is None:
                    continue
            h2 = prep.far.shape[-1]
            nb = max(2, min(6, L // h2))
            Ls = nb * h2
            xs = (x[:, :Ls] if L >= Ls
                  else np.pad(x, ((0, 0), (0, Ls - L))))
            st = mono.init_block_state(scheme, prep, batch_shape=(c,))
            cut = (nb // 2) * h2
            st, y1 = mono.process(prep, st, dt(xs[:, :cut]), backend="pallas")
            _, y2 = mono.process(prep, st, dt(xs[:, cut:]), backend="pallas")
            y = np.concatenate([host(y1), host(y2)], axis=-1)
            lat = scheme.latency
            refs = np.stack([np.convolve(xs[i].astype(np.float64),
                                         ir2[i].astype(np.float64))[:Ls]
                             for i in range(c)])
            if lat:
                refs = np.concatenate(
                    [np.zeros((c, lat)), refs[:, :Ls - lat]], axis=-1)
            cfg = (f"two_tier {sizes} zl={zl} c={c} Ls={Ls} "
                   f"ir={ir2.shape[-1]} H2={h2}")
            check("two_tier_stream", refs, y, cfg)
        else:
            sizes = (256, 1024)
            scheme = PartitionScheme(sizes, zero_latency=True)
            blk = sizes[-1] >> 1
            Ls = max(blk, (L // blk) * blk)
            xs = x[:, :Ls] if L >= blk else np.pad(x, ((0, 0), (0, blk - L)))
            prep = mono.prepare_ir(scheme, ir, offline_tail=False, device=dev)
            st = mono.init_state(scheme, prep, batch_shape=(c,))
            # split into two calls to exercise state carry
            cut = (Ls // blk // 2) * blk
            st, y1 = mono.process(prep, st, dt(xs[:, :cut]))
            _, y2 = mono.process(prep, st, dt(xs[:, cut:]))
            y = np.concatenate([host(y1), host(y2)], axis=-1)
            refs = np.stack([np.convolve(xs[i].astype(np.float64),
                                         ir[i].astype(np.float64))[:Ls]
                             for i in range(c)])
            cfg = f"stream c={c} Ls={Ls} ir={irl} cut={cut}"
            check("streaming", refs, y, cfg,
                  stream_raw=(ir, xs, scheme))

    if mesh is not None and own_group:
        import torch.distributed as dist
        dist.destroy_process_group()
    print(f"\n{n_cases} cases, {len(failures)} failures", flush=True)
    if failures:
        for f in failures:
            print("FAILED:", f)
        return 1
    print("fuzz: all cases passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
