"""Inputs drawn from a run's seed, made on the device in a few large calls.

The same seed gives the same inputs: each kind of input has a generator of
its own, seeded from (seed, tag), so a traffic mix that draws more or less
of one input leaves the others as they were.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAGS = {"bank": 1, "signal": 2, "noise": 3, "sample": 4}


def generator(seed: int, tag: str, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), TAGS[tag]]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def numpy_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), TAGS[tag]])


def noise(seed: int, tag: str, shape, device, scale: float = 1.0) -> torch.Tensor:
    """Gaussian noise of ``shape`` in float32, drawn on ``device``."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, scale, generator=generator(seed, tag, device))


def ir_bank(seed: int, channels: int, taps: int, device) -> torch.Tensor:
    """(channels, taps) float32 impulse responses: white noise of unit energy
    a channel, so every tap of a long IR weighs alike in the output."""
    return noise(seed, "bank", (channels, taps), device, 1.0 / math.sqrt(taps))


def log_sweep(length: int, rate: int, f1: float, f2: float, device) -> torch.Tensor:
    """A float64 exponential sweep of ``length`` samples from f1 to f2 Hz at
    ``rate`` (frozen copy of ``chip_smoke.py`` ``sweep_capture``'s sweep,
    ``chip_smoke.py:1649-1660``, made on the device)."""
    t = torch.arange(length, dtype=torch.float64, device=device) / rate
    dur = length / rate
    lr = math.log(f2 / f1)
    return torch.sin(2 * math.pi * f1 * dur / lr * (torch.exp(t * lr / dur) - 1.0))


def capture(sweep: torch.Tensor, bank: torch.Tensor, length: int,
            rows: int = 16) -> torch.Tensor:
    """The sweep played through each IR of ``bank``: the linear convolution
    cut at ``length`` samples, in float64, stored float32 (C, length) (the
    capture of ``chip_smoke.py`` ``sweep_capture``, ``:1661-1667``)."""
    n = 1 << (sweep.shape[-1] + bank.shape[-1] - 2).bit_length()
    spec_s = torch.fft.rfft(sweep.double(), n)
    out = torch.empty(bank.shape[0], length, dtype=torch.float32, device=bank.device)
    for i in range(0, bank.shape[0], rows):
        spec = torch.fft.rfft(bank[i:i + rows].double(), n) * spec_s
        out[i:i + rows] = torch.fft.irfft(spec, n)[:, :length].float()
    return out
