"""``Convolver.process``: a multichannel stream in blocks, the state carried.

The input is a seeded pool of ``pool_blocks`` blocks on the device, read in
turn as one endless stream; the stream starts from ``Convolver.init_state``,
so before the first block its history is zero. Block k's answer is samples
[kB, (k+1)B) of the stream convolved with each channel's IR.
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
        self.block = int(traffic["block"])
        self.bank = signals.ir_bank(seed, self.channels, self.taps, device)
        self.pool = signals.noise(seed, "signal",
                                  (int(traffic["pool_blocks"]), self.channels, self.block),
                                  device)
        self.samples_per_call = self.channels * self.block
        self.conv = Convolver(self.channels, latency=LatencyMode[cfg["latency"]],
                              max_length=self.taps, device=device)
        self.conv.set_all(self.bank.double().cpu().numpy())
        self.conv.prepare(dtype=getattr(torch, cfg["dtype"]))
        self.state = self.conv.init_state(dtype=getattr(torch, cfg["dtype"]))
        self.next = 0

    def _process(self, state, x):
        return self.conv.process(state, x)

    def call(self, k):
        if k != self.next:
            raise ValueError(f"stream block {k} asked for, {self.next} is next")
        self.next += 1
        self.state, y = self._process(self.state, self.pool[k % self.pool.shape[0]])
        return y

    def release(self):
        self.conv = self.state = None

    def _block(self, k, rows):
        if k < 0:
            return torch.zeros_like(self.pool[0, rows])
        return self.pool[k % self.pool.shape[0], rows]

    def reference(self, k, rows, precision):
        back = -(-(self.taps - 1) // self.block)  # earlier blocks the IR reaches
        x = torch.cat([self._block(j, rows) for j in range(k - back, k + 1)], dim=-1)
        return convolution.convolve(x, self.bank[rows], back * self.block, self.block,
                                    precision)

    def work(self):
        c, b, n = self.channels, self.block, self.taps
        # input, taps, history read, output, history written
        nbytes = roofline.F32 * c * (b + n + (n - 1) + b + min(b, n - 1))
        return nbytes, roofline.convolution_flops(c, b, n, b, history=True, ir_in_call=False)
