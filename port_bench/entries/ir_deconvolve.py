"""``pipeline.ir_deconvolve``: sweep captures back to impulse responses.

Set-up plays the configuration's log sweep, at its rate, through the seeded
IR bank (HIRT's measurement) and adds seeded noise ``noise_db`` below the capture's RMS, once for each of the
``pool`` captures; the calls deconvolve them in turn with the float32 sweep.
The answer is each channel's regularised deconvolution at N, the smallest
power of two that holds the capture.
"""

from __future__ import annotations

import torch

from .. import roofline, signals
from ..entry import Entry as _Entry
from ..reference import convolution


class Entry(_Entry):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from hisstools_library_tpu_torch.models import pipeline

        self.pipeline = pipeline
        self.reg = float(cfg["regularization"])
        rate = int(cfg["sample_rate"])
        self.taps = int(cfg["ir_taps"])
        self.length = int(traffic["capture_seconds"] * rate)
        self.bank = signals.ir_bank(seed, self.channels, self.taps, device)
        sweep = signals.log_sweep(int(cfg["sweep_seconds"] * rate), rate,
                                  float(cfg["sweep_low_hz"]), float(cfg["sweep_high_hz"]),
                                  device)
        self.sweep = sweep.float()
        base = signals.capture(sweep, self.bank, self.length)
        del sweep
        scale = float(base.square().mean().sqrt()) * 10.0 ** (traffic["noise_db"] / 20.0)
        self.pool = signals.noise(seed, "noise",
                                  (int(traffic["pool"]), self.channels, self.length), device,
                                  scale)
        self.pool += base
        del base
        self.samples_per_call = self.channels * self.length

    def call(self, k):
        return self.pipeline.ir_deconvolve(self.pool[k % self.pool.shape[0]], self.sweep,
                                           self.reg)

    def release(self):
        self.pipeline = None

    def reference(self, k, rows, precision):
        return convolution.deconvolve(self.pool[k % self.pool.shape[0], rows], self.sweep,
                                      self.reg, precision)

    def work(self):
        c, n_in, n_ex = self.channels, self.length, self.sweep.shape[-1]
        n = convolution.fft_size(max(n_in, n_ex))
        nbytes = roofline.F32 * (c * n_in + n_ex + c * n)  # captures, sweep, output
        # the captures' and the sweep's transforms, the inverses, and the
        # product and division (8 operations a bin)
        return nbytes, roofline.fft_flops(n, 2 * c + 1) + 8.0 * c * (n // 2 + 1)
