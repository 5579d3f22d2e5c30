"""``Convolver.process`` in N-in / M-out routing: a matrix of IRs over a stream.

The ``ins`` inputs come from a seeded pool of ``pool_blocks`` blocks on the
device, read in turn as one endless stream from ``Convolver.init_state``;
every (out, in) pair has its own seeded IR. Block k's answer is, for each of
the ``outs`` outputs, samples [kB, (k+1)B) of the sum over inputs of the
input's stream convolved with the pair's IR. The window also collects the
program's transform-point counters (``<wrapper>.points``) for
``transform_points_per_call``.
"""

from __future__ import annotations

import torch

from .. import roofline_matrix, signals
from ..entry import Entry as _Entry
from ..metrics.transform_points_per_call import total_points
from ..reference import matrix
from .convolver_stream import Entry as _Stream


class Entry(_Stream):
    def __init__(self, cfg, traffic, seed, device):
        _Entry.__init__(self, cfg, traffic, seed, device)
        from hisstools_library_tpu_torch.models.mono import LatencyMode
        from hisstools_library_tpu_torch.models.multichannel import Convolver

        self.ins, self.outs = int(cfg["ins"]), int(cfg["outs"])
        if self.channels != self.outs:
            raise ValueError("channels (the outputs the check walks) must equal outs")
        self.taps = int(cfg["ir_taps"])
        self.block = int(traffic["block"])
        self.bank = signals.ir_bank(seed, self.outs * self.ins, self.taps, device).reshape(
            self.outs, self.ins, self.taps)
        self.pool = signals.noise(seed, "signal",
                                  (int(traffic["pool_blocks"]), self.ins, self.block), device)
        self.samples_per_call = self.ins * self.block
        self.conv = Convolver(self.ins, self.outs, latency=LatencyMode[cfg["latency"]],
                              max_length=self.taps, device=device)
        self.conv.set_all(self.bank.double().cpu().numpy())
        self.conv.prepare(dtype=getattr(torch, cfg["dtype"]))
        self.state = self.conv.init_state(dtype=getattr(torch, cfg["dtype"]))
        self.next = 0

    def reference(self, k, rows, precision):
        back = -(-(self.taps - 1) // self.block)  # earlier blocks the IR reaches
        x = torch.cat([self._block(j, slice(None)) for j in range(k - back, k + 1)], dim=-1)
        return matrix.matrix_convolve(x, self.bank[rows], back * self.block, self.block,
                                      precision)

    def work(self):
        args = (self.ins, self.outs, self.block, self.taps)
        return (roofline_matrix.matrix_stream_bytes(*args),
                roofline_matrix.matrix_stream_flops(*args))

    def window(self, k, seconds, offsets, slots, run):
        before = total_points()
        kept, k = super().window(k, seconds, offsets, slots, run)
        if before is not None:
            run.extra["transform_points"] = total_points() - before
        return kept, k
