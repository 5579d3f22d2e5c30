"""``spectral_processor.convolve``: signals with the IR bank, one FFT each.

The signals come from a seeded pool of ``pool`` signals on the device, in
turn; the answer is each channel's whole linear convolution with its IR
(EdgeMode Linear), the IR transformed inside the call.
"""

from __future__ import annotations

from .. import roofline, signals
from ..entry import Entry as _Entry
from ..reference import convolution


class Entry(_Entry):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from hisstools_library_tpu_torch.ops import spectral_processor

        if cfg["edge_mode"] != "Linear":
            raise ValueError("the reference computes EdgeMode Linear only")
        self.sp = spectral_processor
        self.mode = spectral_processor.EdgeMode[cfg["edge_mode"]]
        self.taps = int(cfg["ir_taps"])
        self.length = int(traffic["signal_seconds"] * cfg["sample_rate"])
        self.bank = signals.ir_bank(seed, self.channels, self.taps, device)
        self.pool = signals.noise(seed, "signal",
                                  (int(traffic["pool"]), self.channels, self.length), device)
        self.samples_per_call = self.channels * self.length

    def call(self, k):
        return self.sp.convolve(self.pool[k % self.pool.shape[0]], self.bank, self.mode)

    def release(self):
        self.sp = None

    def reference(self, k, rows, precision):
        x = self.pool[k % self.pool.shape[0], rows]
        return convolution.convolve(x, self.bank[rows], 0, self.length + self.taps - 1,
                                    precision)

    def work(self):
        c, n, m = self.channels, self.length, self.taps
        nbytes = roofline.F32 * c * (n + m + n + m - 1)  # signal, taps, output
        return nbytes, roofline.convolution_flops(c, n, m, n + m - 1, history=False,
                                                  ir_in_call=True)
