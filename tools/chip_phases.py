"""Phases of ``chip_smoke.py`` from one checkout, for an A/B run.

    python3 tools/chip_phases.py [--small | --k1 | --k2 | --k4 | --k5 | --k7 | --k8m | --k9
        | --k14 | --k16 | --large] CHECKOUT

Runs, from the checkout at CHECKOUT (its ``chip_smoke.py`` and its
``hisstools_library_tpu_torch``, kernels built under its own ``build/``), on
one CUDA card:

* by default phase 14 (K12, K13 and K14 against their plain versions, with
  their times at the path shapes) and phase 15 (the spectral layer at 128
  channels: ms per call, peak memory and SNR against float64), then the
  device ms of K1 and K6 at the 1 s convolve's (128, 2^17);
* with ``--small`` phase 16 (K10w and K11w against their plain versions,
  with their times at the STFT's 128 x 938 frames of 1024, hop 512, and
  ``torch.stft`` beside K10w) and phase 17 (the STFT round trip: ms per
  pass and SNR), then K10 against its plain version with its times at
  (384, 256), (384, 1024) and (384, 2048), and K11 at (128, 256), (128,
  1024) and (6144, 2048): device ms (``torch.profiler``), event ms and SNR
  against its plain version, ``torch.fft.irfft`` on the same input beside
  each;
* with ``--k1`` K1 rfft_packed at (1920, 2^16) (the FastFIR IR
  preparation's frames) and at (128, N) for every N = 4096..2^17: device ms
  (``torch.profiler``), event ms, SNR against its plain version and the
  frames resident at once where the checkout reports them, with
  ``torch.fft.rfft`` timed on the same input beside each; the device ms of
  the kernels that share K1's FFT code (K2, K4, K5, K6, K8, K12 at complex
  2^16 and 2^17, K13 and K14 at real 2^18) at path shapes; and the paths
  that launch K1: the FastFIR IR preparation (128 x 480 000 taps), the
  two-tier ``mono.process`` (ms per 131 072-sample call) and the 1 s
  spectral convolve (128 x 48 000);
* with ``--k2`` K2 rfft_packed_stream at its path shape (128, 236, 2^11)
  (``process_offline``'s 4096 section without the tail), at (128, 16, 2^15)
  and at 128 channels of every N = 4096..2^17 at that path's 236 hops:
  device ms (``torch.profiler``), event ms, SNR against the plain version
  (taken 16 channels at a time), the bound (bytes: x once and the packed
  spectra, 12 H bytes a hop) and the TB/s those bytes reach in the device
  time, the frames resident at once where the checkout reports them, and
  ``torch.stft`` (a rectangular window, the signal padded by one hop in
  front) on the same input beside each; then the device ms of the kernels
  that share its one-pass kernel at their path shapes (K1 at (1920, 2^16)
  and (128, 4096); K4 at (128, 16, 2^15), (128, 4, 2^15), (128, 16, 2^13)
  and (128, 236, 2^11); K6 at (128, 2^14) and (128, 4096); K8's three
  launches at chip_smoke's four shapes); the staged chain K2 -> K3 -> K4
  (``fastfir_chain_staged``) at that section's (128, 236, 2^11) with its
  P = 3: device ms and the peak memory a call adds above its inputs; and
  ``mono.process_offline`` without the tail at 128 channels (Zero preset,
  the 10 s IRs), ms per call, the peak memory a call adds and its device
  time by kernel (``torch.profiler``);
* with ``--k4`` the real inverses on the one-pass route: the shapes K4
  rifft_packed_tail and K6 rifft_packed launch at on the streaming and
  offline paths at 128 channels (two-tier, collapsed, matched, the two
  block -> stream hand-offs, ``process_offline`` without the tail),
  recorded by wrapping the wrappers, with each path's ms per call; K4 at
  the main path's (128, 16, 2^15) and at every recorded shape, K6 at
  (128, 2^14) and (128, 4096): device ms (``torch.profiler``), event ms,
  SNR against the plain version, ``torch.fft.irfft`` on the same input
  beside each; K8 fastfir_chain_stream at chip_smoke's four 128-channel
  shapes, each of its three launches' device ms (its inverse is K4's
  kernel); and the 1 s spectral convolve (K1, K6 at (128, 2^17));
* with ``--k5`` K5 fastfir_chain at the main path's (128, 16, P 15, 2^16)
  and at 40 hops (several chunks a block) with P 15 and P 8: the device ms
  of its three launches and their sum (``torch.profiler``) and event ms,
  with the staged K2 -> K3 -> K4 on the same inputs beside them; K5 at the
  shapes of ``CHAIN_CASES`` in this tool's own ``tests/test_torch_cuda.py``
  (read from the file, not imported); K8 fastfir_chain_stream
  at chip_smoke's four 128-channel shapes (the device ms of each launch and
  their sum, event ms) with the staged path (frames, K1 -> K7 (+ the lag-0
  product) -> K4, which process_block keeps for the shapes K8 does not
  serve) on the same inputs and the SNR between the two, both also at the
  two-tier far tier (128, T 4, P, 2^16) for P = 8, 14, 20, 28, 40 and at
  the benchmark's collapsed 16384 sections with lag0, render's (128, T 8,
  P 58, 2^14) and the matrix's (625, T 8, P 17, 2^14) (where K8 and the
  staged path would cross); the FastFIR main path (ms/pass),
  ``mono.process_offline`` with the offline tail, the ``Convolver``'s
  offline paths (parallel 128, N2M 8 x 8); K2, K4 and K6 (which share
  ``fft_common.cuh``);
* with ``--k7`` the ring MAC: the shapes K7 lag_mac_ring launches at on
  the streaming paths at 128 channels (two-tier, collapsed, matched, the two
  block -> stream hand-offs), recorded by wrapping the wrapper, with each
  path's ms per call; K7 at the two-tier far tier (128, T 4, P 14, 2^15), the
  collapsed section (128, T 16, P 58, 2^13) and every recorded shape: device
  ms (``torch.profiler``), event ms, SNR against ``lag_mac_ring_plain`` and
  the bound (bytes), and at the narrow tiles (128, T 4, P 14, K 64 / 16)
  and (2, T 4, P 625, K 32), and at the staged FastFIR's (128, T 48, P 47,
  1024) and (2, T 938, P 625, K 32), a zero ring; K15 lag_mac at those two
  shapes (the staged FastFIR's before it took K7) with ``lead_skip`` 0 and
  1; K8 fastfir_chain_stream at chip_smoke's
  four 128-channel shapes, each of its three launches' device ms (its state
  kernel is the ring MAC);
* with ``--k8m`` phase 6b of a checkout that has it (K8's matrix form
  against its plain version at the matrix cell's 25 x 25, T 8, P 17, 2^14,
  with its three launches beside its state kernel's design bytes, then K8
  at render's (128, T 8, P 58, 2^14, lag0)); a checkout without it times
  K8 at render's shape alone;
* with ``--k9`` K9 hop_fire: at the sample-granular paths' (128, 256, P 3)
  and (128, 1024, P 3), at (128, 256, P 64) and (128, 1024, P 256), and at
  the hop_fire shapes of ``SLICE_CASES`` in this tool's own
  ``tests/test_torch_cuda.py``: device ms (``torch.profiler``), the device
  ms of a launch in a CUDA graph (20 launches replayed between CUDA
  events), event ms, SNR against ``hop_fire_plain`` and the bound (bytes);
  the device ms with L2 cold (``torch.profiler``, K9's kernel alone, each of
  20 launches after a 256 MB write, so its inputs come from HBM, as the
  byte bound assumes; the repeated launches of the other timings find their
  inputs in the 50 MB L2 where they fit);
  beside them the device time of an empty kernel launch (built here from
  a one-line source: the floor any launch pays); then ``process_any`` at
  128 channels (Zero preset, the 10 s IRs, 256-sample callbacks): ms per
  callback (CUDA events over 128 callbacks) and device busy per callback
  with K9's share (``torch.profiler`` over 64 callbacks);
* with ``--k14`` K14 rifft_packed_split and K13 rfft_packed_split at (128,
  N), N = 2^18, 2^19 and 2^20: device ms (``torch.profiler``) and event ms,
  each launch's device ms and the TB/s it reaches (a complex frame of N/2
  points in and out per transform), SNR against the plain version, and
  ``torch.fft.irfft`` / ``rfft`` on the same input beside them; then the
  spectral ``convolve`` of 128 x 10 s signals (N = 2^20);
* with ``--k16`` phase 14b where the checkout has it (K16, the per-bin
  products of packed spectra, against its plain versions and timed at its
  two path shapes), then the benchmark cells' two calls on seeded noise:
  ``spectral_processor.convolve`` of 128 x 960 000 samples with 128 x
  480 000 taps (N = 2^21) and ``pipeline.ir_deconvolve`` of 128 x 2 880 000
  samples by one 2 400 000-sample excitation (N = 2^22): event ms (median
  of 5), device ms and launches a call, the top device operations
  (``torch.profiler``) and the peak memory a call adds. On a checkout
  without K16 the top operations are the torch glue K16 replaced;
* with ``--large`` phases 22 and 23 of a checkout that has them (K12 at
  complex 2^20..2^28 and K13 / K14 at real 2^21..2^28 against their plain
  versions, with their times; the 20 s convolve and the 30 s deconvolve).

To compare two commits, unpack the older one into a directory that
``.gitignore`` lists and run both in one call on the card, in turns:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 tools/chip_phases.py $r; done

Imports nothing of JAX. Exits non-zero without a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    args = sys.argv[1:]
    small = "--small" in args
    k1 = "--k1" in args
    k2 = "--k2" in args
    k4 = "--k4" in args
    k5 = "--k5" in args
    k7 = "--k7" in args
    k8m = "--k8m" in args
    k9 = "--k9" in args
    k14 = "--k14" in args
    k16 = "--k16" in args
    large = "--large" in args
    args = [a for a in args
            if a not in ("--small", "--k1", "--k2", "--k4", "--k5", "--k7", "--k8m", "--k9",
                         "--k14", "--k16", "--large")]
    if len(args) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA device")
    root = os.path.abspath(args[0])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from hisstools_library_tpu_torch import _build
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels

    print(f"checkout {root}", flush=True)
    mods = {"hopper_fft": hopper_fft, "hopper_kernels": hopper_kernels}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if k1:
        k1_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k2:
        k2_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k4:
        k4_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k5:
        k5_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k7:
        k7_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k8m:
        k8m_phase(cs, mods, randn, smi)
        return
    if k9:
        k9_phase(cs, hopper_kernels, randn, dev, smi)
        return
    if k14:
        k14_phase(cs, hopper_fft, randn, dev, smi)
        return
    if k16:
        k16_phase(cs, mods, randn, dev, smi)
        return
    if small:
        cs.windowed_kernels(randn, mods, smi)
        cs.stft_path(dev, cs.Launches(mods), smi, False)
        cs.check_kernels([("rfft_small", [
            ((lambda n=n: ((randn(384, n),), {})), True) for n in (256, 1024, 2048)])],
            mods, smi)
        k11_shapes(cs, hopper_fft, randn, smi)
        return
    # The IRs and signal of chip_smoke.py's main(), from seed 0.
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((cs.CHANNELS, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    if large:
        results = {k: dict(max_abs_err=0.0, snr_db=float("inf"))
                   for k in ("fft_split", "rfft_packed_split", "rifft_packed_split")}
        cs.large_kernels(randn, mods, smi, results)
        cs.large_paths(dev, irs, cs.Launches(mods), smi)
        return
    x = rng.standard_normal((cs.CHANNELS, cs.SIG_LEN)).astype(np.float32)
    cs.spectral_kernels(randn, mods, smi)
    cs.spectral_paths(dev, irs, x, cs.Launches(mods), smi)
    sig = randn(cs.CHANNELS, 1 << 17)
    re, im = hopper_fft.rfft_packed(sig)
    for name, call in (("K1 rfft_packed", lambda: hopper_fft.rfft_packed(sig)),
                       ("K6 rifft_packed", lambda: hopper_fft.rifft_packed(re, im))):
        print(f"{name} (128, 2^17): device {cs.device_ms(call):.4f} ms, events "
              f"{cs.median_ms(call):.4f} ms [{smi}]", flush=True)


def _device_events(prof) -> list:
    """The profiler's averages of what ran on the card, less the port's
    ``hst::`` spans (which carry the device time of the kernels they hold;
    chip_smoke.device_events, which older checkouts lack)."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.device_time_total > 0 and not e.key.startswith("hst::")]


def k1_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k1`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.models.offline import FastFIR
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    resident = getattr(hf, "rfft_packed_resident", None)
    for b, n in [(1920, 1 << 16)] + [(cs.CHANNELS, 1 << e) for e in range(12, 18)]:
        x = randn(b, n)
        got = hf.rfft_packed(x)
        want = hf.rfft_packed_plain(x)
        snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
        res = "not reported" if resident is None else resident(n)
        print(f"K1 ({b}, {n}): device {cs.device_ms(lambda: hf.rfft_packed(x)):.4f} ms, "
              f"events {cs.median_ms(lambda: hf.rfft_packed(x)):.4f} ms; torch.fft.rfft "
              f"device {cs.device_ms(lambda: torch.fft.rfft(x, dim=-1)):.4f} ms, events "
              f"{cs.median_ms(lambda: torch.fft.rfft(x, dim=-1)):.4f} ms; SNR vs plain "
              f"{snr:.2f} dB; frames resident {res} [{smi}]", flush=True)
        del x, got, want
        torch.cuda.empty_cache()

    c, k = cs.CHANNELS, 1 << 15
    others = {
        "K2 rfft_packed_stream (128, 16, 2^15)":
            (hf.rfft_packed_stream, lambda: (randn(c, 16, k),)),
        "K4 rifft_packed_tail (128, 16, 2^15)":
            (hf.rifft_packed_tail, lambda: (randn(c, 16, k), randn(c, 16, k), 1.0 / (8 * k))),
        "K5 fastfir_chain (128, 16, P 15, 2^16)":
            (hf.fastfir_chain, lambda: (randn(c, 16, k), randn(c, 15, k) * 1e-3,
                                        randn(c, 15, k) * 1e-3, 1.0 / (8 * k))),
        "K6 rifft_packed (128, 2^14)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 13), randn(c, 1 << 13))),
        "K6 rifft_packed (128, 2^17)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 16), randn(c, 1 << 16))),
        "K8 fastfir_chain_stream (128, T 2, P 8, 2^17)":
            (hf.fastfir_chain_stream,
             lambda: (randn(c, 2, 1 << 16), randn(c, 1 << 16), randn(c, 8, 1 << 16),
                      randn(c, 8, 1 << 16), randn(c, 8, 1 << 16) * 1e-3,
                      randn(c, 8, 1 << 16) * 1e-3, 1.0 / (1 << 19))),
        "K12 fft_split (128, 2^16)":
            (hf.fft_split, lambda: (randn(c, 1 << 16), randn(c, 1 << 16))),
        "K12 fft_split (128, 2^17)":
            (hf.fft_split, lambda: (randn(c, 1 << 17), randn(c, 1 << 17))),
        "K13 rfft_packed_split (128, 2^18)":
            (hf.rfft_packed_split, lambda: (randn(c, 1 << 18),)),
        "K14 rifft_packed_split (128, 2^18)":
            (hf.rifft_packed_split, lambda: (randn(c, 1 << 17), randn(c, 1 << 17))),
    }
    for label, (fn, make) in others.items():
        args = make()
        print(f"{label}: device {cs.device_ms(lambda: fn(*args)):.4f} ms [{smi}]", flush=True)
        del args
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    x = rng.standard_normal((c, cs.SIG_LEN)).astype(np.float32)
    print(f"FastFIR IR preparation (128 x {cs.IR_LEN} taps, N = 2^16): "
          f"{cs.median_ms(lambda: FastFIR(irs, device=dev)):.4f} ms (events, host copy "
          f"included) [{smi}]", flush=True)
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    block = torch.from_numpy(np.ascontiguousarray(x[:, :cs.STREAM_BLOCK])).to(dev)
    carry = {"s": mono.init_block_state(zero, ir, batch_shape=(c,))}

    def step():
        carry["s"], _ = mono.process(ir, carry["s"], block)

    ms, _ = cs.time_calls(step)
    print(f"two-tier mono.process: {ms:.4f} ms/call (events, median of 10) [{smi}]",
          flush=True)
    del ir, carry, block
    s1 = torch.from_numpy(np.ascontiguousarray(x[:, :cs.FS])).to(dev)
    h1 = torch.from_numpy(np.ascontiguousarray(irs[:, :cs.FS])).to(dev)
    print(f"spectral-convolve-1s: {cs.median_ms(lambda: sp.convolve(s1, h1)):.4f} ms/call "
          f"(events, median of 5) [{smi}]", flush=True)


def k2_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k2`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.models import mono

    c, t = cs.CHANNELS, cs.K2_PATH_SHAPE[0]
    resident = getattr(hf, "rfft_packed_stream_resident", None)
    shapes = [(c, t, 1 << 11), (c, 16, 1 << 15)] + [(c, t, 1 << e) for e in range(12, 17)]
    for shape in shapes:
        h = shape[-1]
        x = randn(*shape)
        got = hf.rfft_packed_stream(x)
        err = ref = 0.0
        for c0 in range(0, c, 16):
            want = hf.rfft_packed_stream_plain(x[c0:c0 + 16])
            for w, g in zip(want, got):
                err += float(((g[c0:c0 + 16].double() - w.double()) ** 2).sum())
                ref += float((w.double() ** 2).sum())
            del want
        del got
        snr = float("inf") if err == 0 else 10 * np.log10(ref / err)
        call = lambda: hf.rfft_packed_stream(x)  # noqa: E731
        dev_ms, ev_ms = cs.device_ms(call), cs.median_ms(call)
        nbytes = 12 * x.numel()  # 12 H a hop: x once (4 H), two packed planes (8 H)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        sig = torch.nn.functional.pad(x.reshape(c, -1), (h, 0))
        win = torch.ones(2 * h, device=dev)
        lib = lambda: torch.stft(sig, 2 * h, hop_length=h, window=win,  # noqa: E731
                                 center=False, return_complex=True)
        res = "not reported" if resident is None else resident(2 * h)
        print(f"K2 rfft_packed_stream {shape}: device {dev_ms:.4f} ms, events {ev_ms:.4f} ms; "
              f"bound {bound:.4f} ms (bytes, {nbytes / 1e9:.3f} GB), "
              f"{nbytes / dev_ms / 1e9:.3f} TB/s; torch.stft device "
              f"{cs.device_ms(lib):.4f} ms, events {cs.median_ms(lib):.4f} ms; SNR vs plain "
              f"{snr:.2f} dB; frames resident {res} [{smi}]", flush=True)
        del x, sig
        torch.cuda.empty_cache()

    others = {
        "K1 rfft_packed (1920, 2^16)": (hf.rfft_packed, lambda: (randn(1920, 1 << 16),)),
        "K1 rfft_packed (128, 4096)": (hf.rfft_packed, lambda: (randn(c, 4096),)),
        "K6 rifft_packed (128, 2^14)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 13), randn(c, 1 << 13))),
        "K6 rifft_packed (128, 4096)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 11), randn(c, 1 << 11))),
    }
    for tk in ((16, 1 << 15), (4, 1 << 15), (16, 1 << 13), (t, 1 << 11)):
        others[f"K4 rifft_packed_tail {(c, *tk)}"] = (
            hf.rifft_packed_tail,
            lambda tk=tk: (randn(c, *tk), randn(c, *tk), 1.0 / (8.0 * tk[1])))
    for label, (fn, make) in others.items():
        args = make()
        print(f"{label}: device {cs.device_ms(lambda: fn(*args)):.4f} ms [{smi}]", flush=True)
        del args
        torch.cuda.empty_cache()
    k8_shapes(cs, hf, randn, smi)

    def peak_gib(call):
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    a = (randn(c, t, 1 << 11), randn(c, 3, 1 << 11) * 1e-3, randn(c, 3, 1 << 11) * 1e-3,
         1.0 / (1 << 14))
    staged = lambda: hf.fastfir_chain_staged(*a)  # noqa: E731
    print(f"staged K2 -> K3 -> K4 {(c, t, 1 << 11)} P 3: device {cs.device_ms(staged):.4f} ms, "
          f"peak memory above its inputs {peak_gib(staged):.3f} GiB [{smi}]", flush=True)
    del a
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    xd = torch.from_numpy(rng.standard_normal((c, cs.SIG_LEN)).astype(np.float32)).to(dev)
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    offline = lambda: mono.process_offline(ir, xd)  # noqa: E731
    peak = peak_gib(offline)
    ms, _ = cs.time_calls(offline, runs=5)
    print(f"offline-no-tail mono.process_offline: {ms:.4f} ms/call (events, median of 5), "
          f"peak memory above its inputs {peak:.3f} GiB [{smi}]", flush=True)
    cs.profile_calls(offline, "offline-no-tail", ms, smi)


def path_shapes(cs, dev, smi, mod, names, shape_of, offline=True) -> dict:
    """Runs the streaming paths at 128 channels (and ``process_offline``
    without the tail where ``offline``), the wrappers ``names`` of ``mod``
    wrapped to record the shapes (``shape_of(args)``) they are called at;
    prints each path's shapes and ms per call. Returns {shape: name}."""
    from collections import Counter

    from hisstools_library_tpu_torch.models import mono

    c, blk = cs.CHANNELS, cs.STREAM_BLOCK
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    x = rng.standard_normal((c, cs.SIG_LEN)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    block = xd[:, :blk].contiguous()
    seen = Counter()
    wrapped = {name: getattr(mod, name) for name in names}

    def recorder(name):
        def call(*args, **kw):
            seen[(name, shape_of(args))] += 1
            return wrapped[name](*args, **kw)
        call.launches = 0  # the wrapper counts its launches on the module's name
        return call

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    matched = mono.PartitionScheme.for_latency_budget(8192)
    ir_zero = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    ir_matched = mono.prepare_ir(matched, irs, offline_tail=False, device=dev)
    shapes = {}

    def run(label, step):
        seen.clear()
        for name in wrapped:
            setattr(mod, name, recorder(name))
        try:
            step()
            torch.cuda.synchronize()
        finally:
            for name, fn in wrapped.items():
                setattr(mod, name, fn)
        ms, _ = cs.time_calls(step, runs=5)
        print(f"{label}: {ms:.4f} ms/call (events, median of 5); {' / '.join(names)} calls "
              f"{dict(sorted(seen.items()))} [{smi}]", flush=True)
        for (name, shape) in seen:
            shapes[shape] = name

    for label, ir, scheme, init in (("two-tier", ir_zero, zero, mono.init_block_state),
                                    ("collapsed", ir_zero, zero, mono.init_state),
                                    ("matched", ir_matched, matched, mono.init_state)):
        carry = {"s": init(scheme, ir, batch_shape=(c,))}

        def step(ir=ir, carry=carry):
            carry["s"], _ = mono.process(ir, carry["s"], block)

        run(label, step)
    for label, init, lift in (("handoff-two-tier", mono.init_block_state,
                               mono.stream_state_from_block),
                              ("handoff-collapsed", mono.init_state,
                               mono.stream_state_from_aligned)):
        def step(init=init, lift=lift):
            st, _ = mono.process(ir_zero, init(zero, ir_zero, batch_shape=(c,)), block)
            ss = lift(ir_zero, st)
            for i in range(4):
                ss, _ = mono.process_any(
                    ir_zero, ss, xd[:, blk + i * 256:blk + (i + 1) * 256].contiguous())

        run(label, step)
    if offline:
        run("offline-no-tail", lambda: mono.process_offline(ir_zero, xd))
    return shapes


def k4_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k4`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    shapes = path_shapes(cs, dev, smi, hf, ("rifft_packed_tail", "rifft_packed"),
                         lambda a: tuple(a[0].shape))
    c = cs.CHANNELS
    cases = [("rifft_packed_tail", (c, 16, 1 << 15))]
    cases += [("rifft_packed_tail", s) for s, n in sorted(shapes.items())
              if n == "rifft_packed_tail" and s != (c, 16, 1 << 15)]
    cases += [("rifft_packed", (c, 1 << 13)), ("rifft_packed", (c, 1 << 11))]
    for name, shape in cases:
        re, im = randn(*shape), randn(*shape)
        n = 2 * shape[-1]
        args = (re, im, 1.0 / (4.0 * n)) if name == "rifft_packed_tail" else (re, im)
        fn = getattr(hf, name)
        got, want = fn(*args), getattr(hf, name + "_plain")(*args)
        snr = cs.snr_db(want, got)
        del got, want
        full = cs._complex_of_packed(re, im)
        lib = lambda: torch.fft.irfft(full, n=n, dim=-1)  # noqa: E731
        call = lambda: fn(*args)  # noqa: E731
        label = "K4 rifft_packed_tail" if name == "rifft_packed_tail" else "K6 rifft_packed"
        print(f"{label} {shape}: device {cs.device_ms(call):.4f} ms, events "
              f"{cs.median_ms(call):.4f} ms; irfft device {cs.device_ms(lib):.4f} ms, events "
              f"{cs.median_ms(lib):.4f} ms; SNR vs plain {snr:.2f} dB [{smi}]", flush=True)
        del re, im, args, full
        torch.cuda.empty_cache()
    k8_shapes(cs, hf, randn, smi)
    s1, h1 = randn(c, cs.FS), randn(c, cs.FS)
    print(f"spectral-convolve-1s: {cs.median_ms(lambda: sp.convolve(s1, h1)):.4f} ms/call "
          f"(events, median of 5), device {cs.device_ms(lambda: sp.convolve(s1, h1)):.4f} "
          f"ms [{smi}]", flush=True)


def k8_shapes(cs, hf, randn, smi) -> None:
    """K8 at chip_smoke's four 128-channel shapes: each launch's device ms,
    their sum, event ms and SNR against the plain version."""
    c = cs.CHANNELS
    for t, p, n, lag0 in ((16, 3, 1 << 14, True), (16, 3, 1 << 14, False),
                          (2, 8, 1 << 17, False), (4, 8, 1 << 16, False)):
        k = n // 2
        kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3) if lag0 else {}
        a = (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
             randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n))
        shape = f"(128, T {t}, P {p}, {n}{', lag0' if lag0 else ''})"
        got = hf.fastfir_chain_stream(*a, **kw)
        want = hf.fastfir_chain_stream_plain(*a, **kw)
        snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
        del got, want
        split = cs.k8_launches(lambda: hf.fastfir_chain_stream(*a, **kw), smi,
                               f"K8 fastfir_chain_stream {shape}")
        print(f"K8 fastfir_chain_stream {shape}: device {sum(split.values()):.4f} ms, events "
              f"{cs.median_ms(lambda: hf.fastfir_chain_stream(*a, **kw)):.4f} ms; SNR vs "
              f"plain {snr:.2f} dB [{smi}]", flush=True)
        del a, kw
        torch.cuda.empty_cache()


def k8m_phase(cs, mods, randn, smi) -> None:
    """K8's matrix form (chip_smoke's phase 6b) where the checkout has it,
    else K8 at render's (128, T 8, P 58, 2^14, lag0) alone."""
    if hasattr(cs, "stream_matrix_kernel"):
        cs.stream_matrix_kernel(randn, mods, smi)
        return
    hf = mods["hopper_fft"]
    c, t, p, n = cs.CHANNELS, 8, 58, 1 << 14
    k = n // 2
    a = (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
         randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n))
    kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3)
    split = cs.k8_launches(lambda: hf.fastfir_chain_stream(*a, **kw), smi,
                           "fastfir_chain_stream render (128, T 8, P 58, 16384, lag0)")
    print(f"fastfir_chain_stream render (128, T 8, P 58, 16384, lag0): device "
          f"{sum(split.values()):.4f} ms, events "
          f"{cs.median_ms(lambda: hf.fastfir_chain_stream(*a, **kw)):.4f} ms [{smi}]",
          flush=True)


def k11_shapes(cs, hf, randn, smi) -> None:
    """K11 rifft_small at its path shapes: the hand-offs' and direct
    sections' (128, 256) and (128, 1024), the staged FastFIR's 6144 frames
    of 2048; device ms, event ms, SNR against the plain version and
    ``torch.fft.irfft`` on the same input beside each."""
    for b, n in ((cs.CHANNELS, 256), (cs.CHANNELS, 1024), (6144, 2048)):
        re, im = randn(b, n // 2), randn(b, n // 2)
        snr = cs.snr_db(hf.rifft_small_plain(re, im), hf.rifft_small(re, im))
        full = cs._complex_of_packed(re, im)
        lib = lambda: torch.fft.irfft(full, n=n, dim=-1)  # noqa: E731
        call = lambda: hf.rifft_small(re, im)  # noqa: E731
        print(f"K11 rifft_small ({b}, {n}): device {cs.device_ms(call):.4f} ms, events "
              f"{cs.median_ms(call):.4f} ms; irfft device {cs.device_ms(lib):.4f} ms, events "
              f"{cs.median_ms(lib):.4f} ms; SNR vs plain {snr:.2f} dB [{smi}]", flush=True)
        del re, im, full
        torch.cuda.empty_cache()


def k7_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k7`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.fft import hopper_kernels as hk

    # (C, T, P, K) of each K7 call: X is (C, T, K), the ring (C, P, K).
    shapes = path_shapes(cs, dev, smi, hk, ("lag_mac_ring",),
                         lambda a: (*a[2].shape[:2], *a[0].shape[1:]), offline=False)
    c = cs.CHANNELS
    cases = [(c, 4, 14, 1 << 15), (c, 16, 58, 1 << 13)]
    cases += [s for s in sorted(shapes) if s not in cases]
    # the narrow tiles (K < 256): the far tier's (T, P) at K = 64 and 16, and
    # process_block at N = 64 over a 20 000-tap IR (P = 625)
    cases += [(c, 4, 14, 64), (c, 4, 14, 16), (2, 4, 625, 32)]
    # the staged FastFIR at N = 2048 and at N = 64 over a 20 000-tap IR
    cases += [(c, 48, 47, 1024), (2, 938, 625, 32)]
    for cc, t, p, k in cases:
        a = (randn(cc, p, k), randn(cc, p, k), randn(cc, t, k), randn(cc, t, k),
             randn(cc, p, k) * 1e-3, randn(cc, p, k) * 1e-3)
        got, want = hk.lag_mac_ring(*a), hk.lag_mac_ring_plain(*a)
        snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
        b_ms, b_by = cs.bound("lag_mac_ring", a, {}, got)
        del got, want
        call = lambda: hk.lag_mac_ring(*a)  # noqa: E731
        print(f"K7 lag_mac_ring ({cc}, T {t}, P {p}, K {k}): device {cs.device_ms(call):.4f} "
              f"ms, events {cs.median_ms(call):.4f} ms; bound {b_ms:.4f} ms ({b_by}); SNR vs "
              f"plain {snr:.2f} dB [{smi}]", flush=True)
        del a
        torch.cuda.empty_cache()
    # K15 at the staged FastFIR's shapes of before it took K7 (above)
    for cc, t, p, k, skip in ((c, 48, 47, 1024, 0), (c, 48, 47, 1024, 1), (2, 938, 625, 32, 0)):
        a = (randn(cc, skip + t + p, k), randn(cc, skip + t + p, k), randn(cc, p, k) * 1e-3,
             randn(cc, p, k) * 1e-3, t)
        kw = dict(lead_skip=skip)
        got, want = hk.lag_mac(*a, **kw), hk.lag_mac_plain(*a, **kw)
        snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
        b_ms, b_by = cs.bound("lag_mac", a, kw, got)
        del got, want
        call = lambda: hk.lag_mac(*a, **kw)  # noqa: E731
        print(f"K15 lag_mac ({cc}, T {t}, P {p}, K {k}, lead_skip {skip}): device "
              f"{cs.device_ms(call):.4f} ms, events {cs.median_ms(call):.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}); SNR vs plain {snr:.2f} dB [{smi}]", flush=True)
        del a
        torch.cuda.empty_cache()
    k8_shapes(cs, hf, randn, smi)


def k14_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k14`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    c = cs.CHANNELS
    for e in (18, 19, 20):
        n = 1 << e
        x = randn(c, n)
        pr, pi = hf.rfft_packed_split(x)
        full = cs._complex_of_packed(pr, pi)
        for label, fn, plain, lib in (
                ("K14 rifft_packed_split", lambda: hf.rifft_packed_split(pr, pi),
                 lambda: hf.rifft_packed_split_plain(pr, pi),
                 lambda: torch.fft.irfft(full, n=n, dim=-1)),
                ("K13 rfft_packed_split", lambda: hf.rfft_packed_split(x),
                 lambda: hf.rfft_packed_split_plain(x), lambda: torch.fft.rfft(x, dim=-1))):
            got, want = fn(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
            del got, want
            print(f"{label} ({c}, 2^{e}): device {cs.device_ms(fn):.4f} ms, events "
                  f"{cs.median_ms(fn):.4f} ms; library device {cs.device_ms(lib):.4f} ms; "
                  f"SNR vs plain {snr:.2f} dB [{smi}]", flush=True)
            cs.pass_rates(f"{label} ({c}, 2^{e})", fn, 4 * n * c, smi)
        del x, pr, pi, full
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    x = rng.standard_normal((c, cs.SIG_LEN)).astype(np.float32)
    sig = torch.from_numpy(np.ascontiguousarray(x[:, :cs.IR_LEN])).to(dev)
    ird = torch.from_numpy(irs).to(dev)
    print(f"spectral-convolve (128 x 10 s, N = 2^20): "
          f"{cs.median_ms(lambda: sp.convolve(sig, ird)):.4f} ms/call (events, median of 5), "
          f"device {cs.device_ms(lambda: sp.convolve(sig, ird)):.4f} ms [{smi}]", flush=True)


def k16_phase(cs, mods, randn, dev, smi) -> None:
    """The ``--k16`` mode (see the module docstring). The cells' calls use
    only what the parent checkouts also have, so the same mode times
    either."""
    from torch.profiler import ProfilerActivity, profile

    from hisstools_library_tpu_torch.models import pipeline
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    if hasattr(cs, "bin_kernels"):
        cs.bin_kernels(randn, mods, smi)
    c = cs.CHANNELS
    calls = {}
    x, h = randn(c, 960000), randn(c, 480000)
    calls["convolve (128 x 960 000, N = 2^21)"] = (lambda: sp.convolve(x, h), (x, h))
    cap, sweep = randn(c, 2880000), randn(2400000)
    calls["ir_deconvolve (128 x 2 880 000, N = 2^22)"] = (
        lambda: pipeline.ir_deconvolve(cap, sweep, 1e-4), (cap, sweep))
    for label, (call, _) in calls.items():
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cs.median_ms(call)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 3e3, e.count // 3) for e in _device_events(prof)]
        busy = sum(r[1] for r in rows)
        print(f"{label}: {ms:.4f} ms/call (events, median of 5), device {busy:.4f} ms in "
              f"{sum(r[2] for r in rows)} launches, peak memory above the inputs "
              f"{peak} bytes [{smi}]", flush=True)
        for key, dms, count in sorted(rows, key=lambda r: -r[1])[:10]:
            print(f"  {dms:9.4f} ms x{count:<3d} {key[:90]}", flush=True)
        torch.cuda.empty_cache()


def card_test_cases(name: str) -> list:
    """The list ``name`` of this tool's own ``tests/test_torch_cuda.py``, read
    from the file's text (an expression of int literals and ``<<``), so that
    the same shapes serve whichever checkout is timed."""
    path = Path(__file__).resolve().parents[1] / "tests" / "test_torch_cuda.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None)
                                             for t in node.targets] == [name]:
            expr = compile(ast.Expression(node.value), str(path), "eval")
            return eval(expr, {"__builtins__": {}, "range": range})
    raise SystemExit(f"chip_phases: no {name} in {path}")


EMPTY_SRC = """__global__ void hst_empty_kernel() {}
extern "C" int hst_empty(void* stream) {
  hst_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch(dev):
    """A call that launches one empty kernel (one block of 32 threads), built
    here with nvcc under ``build/empty_launch/``: the floor any launch pays."""
    import ctypes
    import shutil

    out = Path(__file__).resolve().parents[1] / "build" / "empty_launch"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "empty.cu", out / "libempty.so"
    src.write_text(EMPTY_SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", str(src), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    so.hst_empty.argtypes = [ctypes.c_void_p]

    def call():
        if so.hst_empty(torch.cuda.current_stream(dev).cuda_stream):
            raise SystemExit("chip_phases: the empty kernel did not launch")
    return call


def k9_phase(cs, hk, randn, dev, smi) -> None:
    """The ``--k9`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from layouts import graph_ms
    from torch.profiler import ProfilerActivity, profile

    from hisstools_library_tpu_torch.models import mono

    def cold_ms(call, runs: int = 20) -> float:
        """K9's own device ms a launch, each launch after a write of more
        than the L2 holds."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in _device_events(prof)
                   if "hop_fire" in e.key) / runs / 1e3

    flush = torch.empty(1 << 26, device=dev)  # 256 MB
    empty = empty_launch(dev)
    print(f"empty kernel launch: device {cs.device_ms(empty):.4f} ms, graph "
          f"{graph_ms(empty):.4f} ms, events {cs.median_ms(empty):.4f} ms [{smi}]", flush=True)
    c = cs.CHANNELS
    cases = [(c, 256, 3, False), (c, 1024, 3, False), (c, 256, 64, False),
             (c, 1024, 256, False)]
    cases += [s for name, s in card_test_cases("SLICE_CASES") if name == "hop_fire"]
    for cc, n, p, shared, *layout in cases:
        k = n // 2
        lead = () if shared else (cc,)
        frame = randn(cc, n)
        if layout == ["slice"]:
            frame = randn(cc, n + 38)[:, 6:6 + n]
        elif layout == ["odd"]:
            frame = randn(cc, n + 37)[:, 5:5 + n]
        a = (frame, randn(cc, p, k), randn(cc, p, k), randn(*lead, p, k) * 1e-3,
             randn(*lead, p, k) * 1e-3)
        got, want = hk.hop_fire(*a), hk.hop_fire_plain(*a)
        snr = min(cs.snr_db(w, g) for w, g in zip(want, got))
        b_ms, b_by = cs.bound("hop_fire", a, {}, got)
        del got, want
        call = lambda: hk.hop_fire(*a)  # noqa: E731
        tag = f"{', H broadcast' if shared else ''}{', ' + layout[0] if layout else ''}"
        print(f"K9 hop_fire ({cc}, {n}, P {p}{tag}): device {cs.device_ms(call):.4f} ms, graph "
              f"{graph_ms(call):.4f} ms, events {cs.median_ms(call):.4f} ms, L2 cold "
              f"{cold_ms(call):.4f} ms; bound {b_ms:.4f} ms ({b_by}); SNR vs plain {snr:.2f} dB "
              f"[{smi}]", flush=True)
        del a
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    calls, cb = 128, cs.CALLBACK
    xd = torch.from_numpy(rng.standard_normal((c, calls * cb)).astype(np.float32)).to(dev)
    blocks = [xd[:, i * cb:(i + 1) * cb].contiguous() for i in range(calls)]
    carry = {"s": mono.init_stream_state(zero, ir, batch_shape=(c,))}

    def run(n_calls):
        for blk in blocks[:n_calls]:
            carry["s"], _ = mono.process_any(ir, carry["s"], blk)

    run(calls)  # warm-up: every section fires
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run(calls)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(64)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total) for e in _device_events(prof)]
    busy = sum(t for _, t in rows) / 64 / 1e3
    fire = sum(t for key, t in rows if "hop_fire" in key) / 64 / 1e3
    print(f"process_any (128 channels, 256-sample callbacks): {ms:.4f} ms/callback (events "
          f"over {calls}), device busy {busy:.4f} ms/callback, K9 {fire:.4f} ms/callback "
          f"(profiler over 64) [{smi}]", flush=True)


def k5_phase(cs, hf, randn, dev, smi) -> None:
    """The ``--k5`` mode (see the module docstring). Uses only what the
    parent checkouts also have, so the same mode times either."""
    from hisstools_library_tpu_torch.core.types import Split, packed_mul
    from hisstools_library_tpu_torch.fft import hopper_kernels as hk
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.models.multichannel import Convolver
    from hisstools_library_tpu_torch.models.offline import FastFIR

    def staged_stream(x2d, prev, rr, ri, hr, hi, scale, l0_re=None, l0_im=None):
        # process_block's staged path: the frames [prev | cur] materialised,
        # K1, K7, the lag-0 product in torch ops, K4.
        frames = torch.cat([torch.cat([prev[:, None], x2d[:, :-1]], 1), x2d], -1)
        xre, xim = hf.rfft_packed(frames)
        yre, yim, _, _ = hk.lag_mac_ring(rr, ri, xre, xim, hr, hi)
        if l0_re is not None:
            prod = packed_mul(Split(xre, xim), Split(l0_re[:, None], l0_im[:, None]))
            yre, yim = yre + prod.re, yim + prod.im
        return hf.rifft_packed_tail(yre, yim, scale)

    c, k = cs.CHANNELS, 1 << 15
    for t, p in ((16, 15), (40, 15), (40, 8)):
        args = (randn(c, t, k), randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (8 * k))
        for label, fn in (("K5 fastfir_chain", hf.fastfir_chain),
                          ("staged K2 -> K3 -> K4", hf.fastfir_chain_staged)):
            shape = f"(128, {t}, P {p}, 2^16)"
            phases = cs.phase_ms(lambda: fn(*args), smi, f"{label} {shape}")
            print(f"{label} {shape}: device {sum(phases.values()):.4f} ms, events "
                  f"{cs.median_ms(lambda: fn(*args)):.4f} ms [{smi}]", flush=True)
        del args
        torch.cuda.empty_cache()
    for cc, t, p, n in card_test_cases("CHAIN_CASES"):
        a = (randn(cc, t, n // 2), randn(cc, p, n // 2) * 1e-3, randn(cc, p, n // 2) * 1e-3,
             1.0 / (4.0 * n))
        got, want = hf.fastfir_chain(*a), hf.fastfir_chain_plain(*a)
        print(f"K5 ({cc}, {t}, P {p}, {n}): device {cs.device_ms(lambda: hf.fastfir_chain(*a)):.4f}"
              f" ms, SNR vs plain {cs.snr_db(want, got):.2f} dB [{smi}]", flush=True)
    # chip_smoke's four shapes, the two-tier far tier at P 14..40, and the
    # collapsed 16384 section of the benchmark's render (128 channels, P 58)
    # and matrix (625 pairs, P 17) cells, 8 hops a call with lag0.
    for cc, t, p, n, lag0 in ((c, 16, 3, 1 << 14, True), (c, 16, 3, 1 << 14, False),
                              (c, 2, 8, 1 << 17, False), (c, 4, 8, 1 << 16, False),
                              *((c, 4, p, 1 << 16, False) for p in (14, 20, 28, 40)),
                              (c, 8, 58, 1 << 14, True), (625, 8, 17, 1 << 14, True)):
        kk = n // 2
        kw = dict(l0_re=randn(cc, kk) * 1e-3, l0_im=randn(cc, kk) * 1e-3) if lag0 else {}
        a = (randn(cc, t, kk), randn(cc, kk), randn(cc, p, kk), randn(cc, p, kk),
             randn(cc, p, kk) * 1e-3, randn(cc, p, kk) * 1e-3, 1.0 / (4.0 * n))
        shape = f"({cc}, T {t}, P {p}, {n}{', lag0' if lag0 else ''})"
        for label, fn in (("K8 fastfir_chain_stream", hf.fastfir_chain_stream),
                          ("staged frames -> K1 -> K7 -> K4", staged_stream)):
            phases = cs.phase_ms(lambda: fn(*a, **kw), smi, f"{label} {shape}")
            print(f"{label} {shape}: device {sum(phases.values()):.4f} ms, events "
                  f"{cs.median_ms(lambda: fn(*a, **kw)):.4f} ms [{smi}]", flush=True)
        snr = cs.snr_db(staged_stream(*a, **kw).cpu(),
                        hf.fastfir_chain_stream(*a, **kw)[0].cpu())
        print(f"K8 against the staged path {shape}: SNR {snr:.2f} dB [{smi}]", flush=True)
        del a, kw
        torch.cuda.empty_cache()
    others = {
        "K2 rfft_packed_stream (128, 16, 2^15)":
            (hf.rfft_packed_stream, lambda: (randn(c, 16, k),)),
        "K4 rifft_packed_tail (128, 16, 2^15)":
            (hf.rifft_packed_tail, lambda: (randn(c, 16, k), randn(c, 16, k), 1.0 / (8 * k))),
        "K6 rifft_packed (128, 2^14)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 13), randn(c, 1 << 13))),
        "K6 rifft_packed (128, 2^17)":
            (hf.rifft_packed, lambda: (randn(c, 1 << 16), randn(c, 1 << 16))),
    }
    for label, (fn, make) in others.items():
        a = make()
        print(f"{label}: device {cs.device_ms(lambda: fn(*a)):.4f} ms [{smi}]", flush=True)
        del a
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((c, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    x = rng.standard_normal((c, cs.SIG_LEN)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    eng = FastFIR(irs, device=dev)
    print(f"FastFIR (128 x {cs.SIG_LEN}, N = 2^16): "
          f"{cs.median_ms(lambda: FastFIR.apply(eng.spectra, xd), runs=10):.4f} ms/pass "
          f"(events, median of 10) [{smi}]", flush=True)
    del eng
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    ir = mono.prepare_ir(zero, irs, offline_tail=True, device=dev)
    print(f"mono.process_offline (tail): "
          f"{cs.median_ms(lambda: mono.process_offline(ir, xd), runs=5):.4f} ms/pass (events, "
          f"median of 5) [{smi}]", flush=True)
    del ir
    torch.cuda.empty_cache()
    conv = Convolver(c, scheme=zero, device=dev)
    conv.set_all(irs)
    conv.prepare()
    print(f"Convolver parallel 128 process_offline: "
          f"{cs.median_ms(lambda: conv.process_offline(xd), runs=5):.4f} ms/call [{smi}]",
          flush=True)
    del conv
    torch.cuda.empty_cache()
    n2m = 8
    conv = Convolver(n2m, n2m, scheme=zero, device=dev)
    conv.set_all(irs[:n2m * n2m].reshape(n2m, n2m, cs.IR_LEN))
    conv.prepare()
    xin = xd[:n2m].contiguous()
    print(f"Convolver N2M 8 x 8 process_offline: "
          f"{cs.median_ms(lambda: conv.process_offline(xin), runs=5):.4f} ms/call [{smi}]",
          flush=True)


if __name__ == "__main__":
    main()
