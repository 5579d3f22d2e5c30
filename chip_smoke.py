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
5. times ten further passes with CUDA events (steady state).

Any failed phase exits non-zero. The line before the last is a JSON object
with each kernel's launches, error and times; the last line is
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
CHANNELS, FS, IR_LEN, SIG_LEN = 128, 48000, 480000, 483328


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


def main() -> None:
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
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()}",
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
          f"launches {launches}", flush=True)
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

    order = ("rfft_packed", "rfft_packed_stream", "lag_mac_causal", "rifft_packed_tail")
    print(json.dumps({"kernels": [results[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
