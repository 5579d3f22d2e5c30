"""GPU smoke run of the PyTorch / Hopper port (hisstools_library_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; imports nothing of JAX. It

1. prints the device, the torch and CUDA versions and the card's name and
   power limit as nvidia-smi reports them;
2. builds the kernels from ``hisstools_library_tpu_torch/csrc`` and prints the
   seconds it took;
3. compares each kernel of the FastFIR path (K1-K4) with its plain PyTorch
   version on the card, at the main path's shapes and at N = 4096, and times
   both with CUDA events (median of a few runs);
4. drives the main path: ``FastFIR`` at 128 channels x 480 000 taps (a 10 s
   IR at 48 kHz, N = 2^16) built from seed 0 as ``bench.py`` builds it, then
   three ``apply`` calls on the 128 x 483 328 signal. It checks that every
   kernel's launch count grew during that run and that channel 0's first
   65 536 samples hold >= 99 dB SNR against a float64 ``np.convolve``;
5. times ten further passes with CUDA events (steady state);
6. compares each kernel of the hop-aligned streaming path (K7 lag_mac_ring,
   K8 fastfir_chain_stream, K10 rfft_small) with its plain PyTorch version on
   the card, at that path's shapes and at a small shape, and times both;
7. drives the streaming path as ``bench.py``'s ``stream`` mode configures it:
   the Zero preset (TD head + 256/1024/4096/16384), ``prepare_ir`` of the same
   128 x 480 000 IRs, then ``mono.process`` on calls of 131 072 samples with
   the state carried, through three paths, each with the launch counts set to
   0 just before it and read just after:
   - two-tier (``init_block_state``, the ``stream`` default): IR preparation
     and three calls; K1, K4, K7, K8 and K10 must each launch;
   - collapsed (``init_state``, ``BENCH_TIER=single``): two calls; K1, K4, K7
     and K10 must each launch;
   - matched (``PartitionScheme.for_latency_budget(8192)``, one section,
     ``BENCH_SCHEME=matched``): IR preparation and two calls; K1, K4 and K7
     must each launch.
   Each path's output (channel 0, every sample) must hold >= 99 dB SNR
   against a float64 FFT convolution; each is then timed over ten further
   calls (CUDA events, median) as ms per call, samples/s and the real-time
   factor (131 072 / 48 000 s of audio per call over the time taken), beside
   the path's peak device memory;
8. checks the time-domain head's grouped conv1d on the card in full FP32
   against float64.

``--profile`` adds a ``torch.profiler`` window over five steady-state calls of
each streaming path and prints each kernel's device time and the device busy
share. Any failed phase exits non-zero. The line before the last is a JSON
object with each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SNR_MIN_KERNEL_DB = 110.0   # kernel vs plain version, f32 sums in another order
SNR_MIN_PATH_DB = 99.0      # main path vs float64 oracle
SNR_MIN_TD_DB = 120.0       # conv1d head vs float64 (TF32 would give ~60 dB)
CHANNELS, FS, IR_LEN, SIG_LEN = 128, 48000, 480000, 483328
STREAM_BLOCK = 131072       # bench.py's stream call: 16 hops of 8192


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def snr_db(ref: torch.Tensor, test: torch.Tensor) -> float:
    ref = ref.double()
    err = test.double() - ref
    den = float((err * err).sum())
    return float("inf") if den == 0 else 10 * np.log10(float((ref * ref).sum()) / den)


def median_ms(fn, runs: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def convolve_f64(x: np.ndarray, h: np.ndarray, n: int) -> np.ndarray:
    """conv(x, h)[:n] in float64 through one FFT longer than the full result."""
    size = 1 << (len(x) + len(h) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), size) * np.fft.rfft(h.astype(np.float64), size)
    return np.fft.irfft(spec, size)[:n]


def compare(name, fn, plain, args, kwargs, big, smi):
    """Kernel vs plain version on the same inputs: SNR, max abs error and, at
    a path shape, both times. Fails below SNR_MIN_KERNEL_DB or on non-finite
    output."""
    got = fn(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    snr = min(snr_db(w, g) for w, g in zip(want, got))
    err = max(float((g - w).abs().max()) for w, g in zip(want, got))
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    print(f"{name} {shapes}{' lag0' if kwargs else ''}: SNR vs plain {snr:.2f} dB, "
          f"max abs err {err:.3e}", flush=True)
    if not (snr >= SNR_MIN_KERNEL_DB and all(bool(torch.isfinite(g).all()) for g in got)):
        fail(f"{name} at {shapes}: SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    out = dict(shapes=shapes, lag0=bool(kwargs), snr_db=snr, max_abs_err=err)
    if big:
        out["ms"] = median_ms(lambda: fn(*args, **kwargs))
        out["plain_ms"] = median_ms(lambda: plain(*args, **kwargs))
        print(f"  time at path shape: kernel {out['ms']:.4f} ms, plain "
              f"{out['plain_ms']:.4f} ms [{smi}]", flush=True)
    return out


def time_calls(step, runs: int = 10):
    """Median and all of ``runs`` calls of ``step`` (CUDA events), after one
    warm-up call."""
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def profile_calls(step, label: str, ms_per_call: float, smi: str, calls: int = 5) -> None:
    """Device time by kernel over ``calls`` calls, and the busy share: device
    time per call over the unprofiled call time ``ms_per_call``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(r[1] for r in rows) / calls / 1e3
    print(f"profile {label}: device busy {busy_ms:.4f} ms/call over {calls} calls; "
          f"busy share {busy_ms / ms_per_call:.3f} of the {ms_per_call:.4f} ms/call "
          f"steady state [{smi}]", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us / calls / 1e3:9.4f} ms/call  x{count // calls:<3d} {key[:90]}",
              flush=True)


def stream_kernels(randn, smi) -> dict:
    """Phase 6: K7, K8 and K10 against their plain versions on the card."""
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels

    def ring(c, t, p, k):
        return tuple(randn(c, r, k) for r in (p, p, t, t, p, p)), {}

    def chain(c, t, p, n, lag0):
        k = n // 2
        kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3) if lag0 else {}
        return (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
                randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n)), kw

    def small(b, n):
        return (randn(b, n),), {}

    # (name, module, source, replaces, input maker, [(shape, at a path shape)]):
    # the two-tier far tier (T = 4, P = 14, K = 32768) and the collapsed final
    # section (T = 16, P = 58, K = 8192) for K7; the near tier (T = 16, H = 8192,
    # P = 3) with and without lag0 for K8; the IR preparation and refresh sizes
    # (384 rows) for K10. The first path shape of each gives ms and plain_ms.
    specs = [
        ("lag_mac_ring", hopper_kernels, "lag_mac_ring.cu", "pallas_kernels.py:566", ring,
         [((2, 3, 5, 1024), False), ((CHANNELS, 4, 14, 32768), True),
          ((CHANNELS, 16, 58, 8192), True)]),
        ("fastfir_chain_stream", hopper_fft, "fastfir_chain_stream.cu", "pallas_fft.py:1943",
         chain, [((2, 3, 2, 1 << 14, True), False), ((CHANNELS, 16, 3, 1 << 14, True), True),
                 ((CHANNELS, 16, 3, 1 << 14, False), True)]),
        ("rfft_small", hopper_fft, "rfft_small.cu", "pallas_fft.py:1079", small,
         [((7, 32), False), ((384, 256), True), ((384, 128), True), ((384, 1024), True),
          ((384, 2048), True)]),
    ]
    results = {}
    for name, mod, src, rep, make, cases in specs:
        entries = []
        for shape, big in cases:
            args, kwargs = make(*shape)
            entries.append(compare(name, getattr(mod, name), getattr(mod, name + "_plain"),
                                   args, kwargs, big, smi))
            del args, kwargs
            torch.cuda.empty_cache()
        main_case = next(e for e in entries if "ms" in e)
        results[name] = dict(
            name=name, route="cuda", source=f"hisstools_library_tpu_torch/csrc/{src}",
            replaces=f"hisstools_library_tpu/fft/{rep}",
            max_abs_err=max(e["max_abs_err"] for e in entries),
            snr_db=min(e["snr_db"] for e in entries),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"], shapes=entries)
    return results


def stream_paths(dev, irs, x, smi, profile) -> dict:
    """Phase 7: mono.process through the two-tier, collapsed and matched
    paths. Returns each path's launch counts."""
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels
    from hisstools_library_tpu_torch.models import mono

    counted = {fn.__name__: fn for fn in (
        hopper_fft.rfft_packed, hopper_fft.rfft_packed_stream, hopper_kernels.lag_mac_causal,
        hopper_fft.rifft_packed_tail, hopper_kernels.lag_mac_ring,
        hopper_fft.fastfir_chain_stream, hopper_fft.rfft_small)}
    blk = STREAM_BLOCK
    xd = torch.from_numpy(np.ascontiguousarray(x[:, :3 * blk])).to(dev)
    blocks = [xd[:, i * blk:(i + 1) * blk].contiguous() for i in range(3)]
    del xd
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    matched = mono.PartitionScheme.for_latency_budget(8192)
    out = {}

    def run(label, scheme, ir, init, calls, need):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if ir is None:
            ir = mono.prepare_ir(scheme, irs, offline_tail=False, device=dev)
            torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        state = init(scheme, ir, batch_shape=(CHANNELS,))
        ys, host_ms = [], []
        for i in range(calls):
            t0 = time.perf_counter()
            state, y = mono.process(ir, state, blocks[i])
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if tuple(y.shape) != (CHANNELS, blk) or not bool(torch.isfinite(y).all()):
                fail(f"{label} call {i}: output shape {tuple(y.shape)}, finite "
                     f"{bool(torch.isfinite(y).all())}")
            ys.append(y[0].cpu().numpy())
            del y
        launches = {k: fn.launches for k, fn in counted.items()}
        print(f"{label}: sections {[tuple(s.shape) for s in ir.spectra]}, far "
              f"{None if ir.far is None else tuple(ir.far.shape)}, IR prep {prep_s:.3f} s, "
              f"calls {[round(v, 3) for v in host_ms]} ms (host clock), launches "
              f"{launches} [{smi}]", flush=True)
        for k in need:
            if launches[k] < 1:
                fail(f"{label}: kernel {k} was not launched")
        n = calls * blk
        lat = scheme.latency
        ref = convolve_f64(x[0, :n], irs[0], n - lat)
        snr = snr_db(torch.from_numpy(ref), torch.from_numpy(np.concatenate(ys)[lat:]))
        if not snr >= SNR_MIN_PATH_DB:
            fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
        carry = {"s": state}

        def step():
            carry["s"], _ = mono.process(ir, carry["s"], blocks[0])

        ms, times = time_calls(step)
        print(f"{label}: SNR vs float64 FFT convolution (ch0, {n} samples) {snr:.2f} dB; "
              f"steady state {ms:.4f} ms/call (CUDA events, median of 10; all "
              f"{[round(v, 4) for v in times]}), {CHANNELS * blk / (ms * 1e-3):.6e} "
              f"samples/s, real-time factor {blk / FS / (ms * 1e-3):.2f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
        if profile:
            profile_calls(step, label, ms, smi)
        out[label] = launches
        del carry, state
        return ir

    k_all = ("rfft_packed", "rifft_packed_tail", "lag_mac_ring")
    ir = run("two-tier", zero, None, mono.init_block_state, 3,
             k_all + ("fastfir_chain_stream", "rfft_small"))
    run("collapsed", zero, ir, mono.init_state, 2, k_all + ("rfft_small",))
    del ir
    torch.cuda.empty_cache()
    run("matched", matched, None, mono.init_state, 2, k_all)
    torch.cuda.empty_cache()
    return out


def time_domain_check(dev, smi) -> None:
    """Phase 8: the head's grouped conv1d in full FP32 on the card."""
    from hisstools_library_tpu_torch.models import time_domain

    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, STREAM_BLOCK)).astype(np.float32)
    h = rng.standard_normal((4, 128)).astype(np.float32)
    y = time_domain.fir_offline(torch.from_numpy(x).to(dev), torch.from_numpy(h).to(dev))
    snr = min(snr_db(torch.from_numpy(convolve_f64(x[c], h[c], x.shape[-1])), y[c].cpu())
              for c in range(4))
    print(f"time-domain head: conv1d (4 x {STREAM_BLOCK}, 128 taps) on the card, SNR vs "
          f"float64 {snr:.2f} dB (TF32 off) [{smi}]", flush=True)
    if not snr >= SNR_MIN_TD_DB:
        fail(f"time-domain head SNR {snr:.2f} dB < {SNR_MIN_TD_DB}: TF32 still on?")


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "hisstools_library_tpu_torch", "csrc")):
        fail(f"no hisstools_library_tpu_torch/csrc beside {__file__}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, root)
    from hisstools_library_tpu_torch import _build
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels
    from hisstools_library_tpu_torch.models.offline import FastFIR

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    print(smi, flush=True)  # the card as nvidia-smi names it: "name, power limit"

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()} [{smi}]",
          flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():  # written by this run's build: one line per kernel
        entry = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # Main-path shapes: N = 2^16, hop H = 32768, C = 128 channels,
    # T = ceil((SIG_LEN + H) / H) = 16 hops, P = ceil(IR_LEN / H) = 15
    # partitions and min(P, T - 1) = 15 lags. The small shape (N = 4096) has
    # more partitions than hops.
    n_main = 1 << 16
    hop = n_main // 2
    t_main = -(-(SIG_LEN + hop) // hop)
    p_main = -(-IR_LEN // hop)

    def inputs(name, n, big):
        c, t, lags = ((CHANNELS, t_main, min(p_main, t_main - 1)) if big
                      else (2, 5, 7))
        k = n // 2
        if name == "rfft_packed":
            return (randn(c * p_main if big else 3, n),)
        if name == "rfft_packed_stream":
            return (randn(c, t, k),)
        if name == "lag_mac_causal":
            return (randn(c, t, k), randn(c, t, k), randn(c, lags, k),
                    randn(c, lags, k))
        return (randn(c, t, k), randn(c, t, k), 1.0 / (4.0 * n))

    kernels = {
        "rfft_packed": dict(
            fn=hopper_fft.rfft_packed, plain=hopper_fft.rfft_packed_plain,
            source="hisstools_library_tpu_torch/csrc/rfft_packed.cu",
            replaces="hisstools_library_tpu/fft/pallas_fft.py:461"),
        "rfft_packed_stream": dict(
            fn=hopper_fft.rfft_packed_stream,
            plain=hopper_fft.rfft_packed_stream_plain,
            source="hisstools_library_tpu_torch/csrc/rfft_packed_stream.cu",
            replaces="hisstools_library_tpu/fft/pallas_fft.py:1368"),
        "lag_mac_causal": dict(
            fn=hopper_kernels.lag_mac_causal,
            plain=hopper_kernels.lag_mac_causal_plain,
            source="hisstools_library_tpu_torch/csrc/lag_mac_causal.cu",
            replaces="hisstools_library_tpu/fft/pallas_kernels.py:231"),
        "rifft_packed_tail": dict(
            fn=hopper_fft.rifft_packed_tail, plain=hopper_fft.rifft_packed_tail_plain,
            source="hisstools_library_tpu_torch/csrc/rifft_packed_tail.cu",
            replaces="hisstools_library_tpu/fft/pallas_fft.py:1440"),
    }

    results = {}
    for name, k in kernels.items():
        for n, big in ((4096, False), (n_main, True)):
            args = inputs(name, n, big)
            got = k["fn"](*args)
            want = k["plain"](*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            snr = min(snr_db(w, g) for w, g in zip(want, got))
            err = max(float((g - w).abs().max()) for w, g in zip(want, got))
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            print(f"{name} N={n} {shapes}: SNR vs plain {snr:.2f} dB, "
                  f"max abs err {err:.3e}", flush=True)
            if not (snr >= SNR_MIN_KERNEL_DB and all(torch.isfinite(g).all() for g in got)):
                fail(f"{name} at N={n}: SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
            if big:
                ms = median_ms(lambda: k["fn"](*args))
                plain_ms = median_ms(lambda: k["plain"](*args))
                print(f"  time at main-path shape: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms [{smi}]", flush=True)
                results[name] = dict(name=name, route="cuda", source=k["source"],
                                     replaces=k["replaces"], max_abs_err=err,
                                     snr_db=snr, ms=ms, plain_ms=plain_ms)
            del args, got, want
        torch.cuda.empty_cache()

    # Main path, built from seed 0 as bench.py builds it.
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((CHANNELS, IR_LEN)) *
           np.exp(-np.arange(IR_LEN) / (0.5 * FS))).astype(np.float32)
    x = rng.standard_normal((CHANNELS, SIG_LEN)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    counted = (hopper_fft.rfft_packed, hopper_fft.rfft_packed_stream,
               hopper_kernels.lag_mac_causal, hopper_fft.rifft_packed_tail)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    eng = FastFIR(irs, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    pass_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        y = FastFIR.apply(eng.spectra, xd)
        torch.cuda.synchronize()
        pass_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"main path: FastFIR N={eng.fft_size}, P={eng.spectra.shape[-2]}, "
          f"IR prep {prep_s:.3f} s, passes {[round(v, 3) for v in pass_ms]} ms, "
          f"launches {launches} [{smi}]", flush=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = count

    if tuple(y.shape) != (CHANNELS, SIG_LEN) or not bool(torch.isfinite(y).all()):
        fail(f"main path output: shape {tuple(y.shape)}, finite "
             f"{bool(torch.isfinite(y).all())}")
    check = 1 << 16
    ref = np.convolve(x[0, :check].astype(np.float64),
                      irs[0, :check].astype(np.float64))[:check]
    snr = snr_db(torch.from_numpy(ref), y[0, :check].cpu())
    ms = float(np.median(pass_ms))
    print(f"main path: SNR vs float64 np.convolve (ch0, {check} samples) "
          f"{snr:.2f} dB; {ms:.3f} ms/pass (median of 3), "
          f"{CHANNELS * SIG_LEN / (ms * 1e-3):.6e} samples/s [{smi}]", flush=True)
    if not snr >= SNR_MIN_PATH_DB:
        fail(f"main path SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
    steady = median_ms(lambda: FastFIR.apply(eng.spectra, xd), runs=10)
    print(f"main path steady state: {steady:.4f} ms/pass (CUDA events, median "
          f"of 10 after a warm-up), {CHANNELS * SIG_LEN / (steady * 1e-3):.6e} "
          f"samples/s [{smi}]", flush=True)
    by_path = {"fastfir": launches}
    del eng, y, xd
    torch.cuda.empty_cache()

    results.update(stream_kernels(randn, smi))
    by_path.update(stream_paths(dev, irs, x, smi, profile))
    time_domain_check(dev, smi)

    order = ("rfft_packed", "rfft_packed_stream", "lag_mac_causal", "rifft_packed_tail",
             "lag_mac_ring", "fastfir_chain_stream", "rfft_small")
    for name in order:
        results[name]["launches_by_path"] = {p: c.get(name, 0) for p, c in by_path.items()}
        results[name]["launches"] = sum(results[name]["launches_by_path"].values())
    print(json.dumps({"kernels": [results[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
