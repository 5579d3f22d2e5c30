"""The least work of one block of an N-in / M-out convolution matrix.

What any implementation has to do for a stream block of B samples through
an (M, N) matrix of IRs of L taps: read each input's new samples once,
forward-transform each input's frames once (not once a pair), multiply and
accumulate every (output, input) pair's spectra, inverse-transform each
output's frames once (the sum over inputs taken before the inverse), write
each output once, read the taps once, and carry one input history a input
(not one a pair). The operations are the fewest of uniformly partitioned
overlap-save at any power-of-two size, as ``roofline.convolution_flops``
counts them for one channel.
"""

from __future__ import annotations

import math

from .roofline import F32, fft_flops


def matrix_stream_bytes(ins: int, outs: int, block: int, taps: int) -> float:
    """Bytes of a block: the inputs, the taps of every pair, each input's
    history read, the outputs, and each input's history written."""
    history = taps - 1
    return F32 * (ins * block + outs * ins * taps + ins * history + outs * block
                  + ins * min(block, history))


def matrix_stream_flops(ins: int, outs: int, block: int, taps: int) -> float:
    """The fewest operations of a block, over uniformly partitioned
    overlap-save at every power-of-two FFT size: forward transforms of each
    input's new frames, inverse transforms of each output's frames, and 8
    operations a bin for each (frame, partition) product of every pair (a
    carried history meets every partition)."""
    best = math.inf
    for log2n in range(2, 27):
        n = 1 << log2n
        s = n >> 1
        parts = -(-taps // s)
        frames = -(-block // s)
        ops = (fft_flops(n, frames * (ins + outs))
               + 8.0 * (s + 1) * frames * parts * outs * ins)
        best = min(best, ops)
    return best
