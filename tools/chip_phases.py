"""Phases of ``chip_smoke.py`` from one checkout, for an A/B run.

    python3 tools/chip_phases.py [--small] CHECKOUT

Runs, from the checkout at CHECKOUT (its ``chip_smoke.py`` and its
``hisstools_library_tpu_torch``, kernels built under its own ``build/``), on
one CUDA card:

* by default phase 14 (K12, K13 and K14 against their plain versions, with
  their times at the path shapes) and phase 15 (the spectral layer at 128
  channels: ms per call, peak memory and SNR against float64), then the
  device ms of the two-pass K1 and K6 at the 1 s convolve's (128, 2^17);
* with ``--small`` phase 16 (K10w and K11w against their plain versions,
  with their times at the STFT's 128 x 938 frames of 1024, hop 512, and
  ``torch.stft`` beside K10w) and phase 17 (the STFT round trip: ms per
  pass and SNR), then K10 against its plain version with its times at
  (384, 256), (384, 1024) and (384, 2048).

To compare two commits, unpack the older one into a directory that
``.gitignore`` lists and run both in one call on the card, in turns:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 tools/chip_phases.py $r; done

Imports nothing of JAX. Exits non-zero without a card.
"""

import os
import subprocess
import sys

import numpy as np
import torch


def main() -> None:
    args = sys.argv[1:]
    small = "--small" in args
    args = [a for a in args if a != "--small"]
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

    if small:
        cs.windowed_kernels(randn, mods, smi)
        cs.stft_path(dev, cs.Launches(mods), smi, False)
        cs.check_kernels([("rfft_small", [
            ((lambda n=n: ((randn(384, n),), {})), True) for n in (256, 1024, 2048)])],
            mods, smi)
        return
    # The IRs and signal of chip_smoke.py's main(), from seed 0.
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((cs.CHANNELS, cs.IR_LEN)) *
           np.exp(-np.arange(cs.IR_LEN) / (0.5 * cs.FS))).astype(np.float32)
    x = rng.standard_normal((cs.CHANNELS, cs.SIG_LEN)).astype(np.float32)
    cs.spectral_kernels(randn, mods, smi)
    cs.spectral_paths(dev, irs, x, cs.Launches(mods), smi)
    sig = randn(cs.CHANNELS, 1 << 17)
    re, im = hopper_fft.rfft_packed(sig)
    for name, call in (("K1 rfft_packed", lambda: hopper_fft.rfft_packed(sig)),
                       ("K6 rifft_packed", lambda: hopper_fft.rifft_packed(re, im))):
        print(f"{name} (128, 2^17): device {cs.device_ms(call):.4f} ms, events "
              f"{cs.median_ms(call):.4f} ms [{smi}]", flush=True)


if __name__ == "__main__":
    main()
