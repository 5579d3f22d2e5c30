"""``Convolver.process_offline``: whole files, each convolved with its IR.

The files come from a seeded pool of ``pool`` files on the device, in turn;
the answer is the first ``file_samples`` samples of each channel's linear
convolution (the Zero scheme has no delay). The lazily prepared offline tail
is made by the first call, a warm-up call.
"""

from __future__ import annotations

import torch

from .. import roofline, signals
from ..entry import Entry as _Entry
from ..reference import convolution


class Entry(_Entry):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from hisstools_library_tpu_torch.models.mono import LatencyMode
        from hisstools_library_tpu_torch.models.multichannel import Convolver

        self.taps = int(cfg["ir_taps"])
        self.length = int(traffic["file_samples"])
        self.bank = signals.ir_bank(seed, self.channels, self.taps, device)
        self.pool = signals.noise(seed, "signal",
                                  (int(traffic["pool"]), self.channels, self.length), device)
        self.samples_per_call = self.channels * self.length
        self.conv = Convolver(self.channels, latency=LatencyMode[cfg["latency"]],
                              max_length=self.taps, device=device)
        self.conv.set_all(self.bank.double().cpu().numpy())
        self.conv.prepare(dtype=getattr(torch, cfg["dtype"]))

    def call(self, k):
        return self.conv.process_offline(self.pool[k % self.pool.shape[0]])

    def release(self):
        self.conv = None

    def reference(self, k, rows, precision):
        x = self.pool[k % self.pool.shape[0], rows]
        return convolution.convolve(x, self.bank[rows], 0, self.length, precision)

    def work(self):
        c, n, m = self.channels, self.length, self.taps
        nbytes = roofline.F32 * c * (n + m + n)  # file, taps, output
        return nbytes, roofline.convolution_flops(c, n, m, n, history=False, ir_in_call=False)
