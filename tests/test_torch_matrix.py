"""The port's N-in / M-out Convolver against a direct sum of ``np.convolve``
(output m = the sum over inputs n of x_n * IR[m, n], in float64), on the CPU
at 3 in x 4 out with 3000-tap IRs on the Zero preset, through ``process``
(the collapsed block engine), ``process_any`` (callbacks of uneven lengths)
and ``process_offline`` (the lazy offline tail).

Limits on the largest output's ||y - ref|| / ||ref||: 1e-10 in float64
(rounding alone), 1e-5 in float32 (float32 transforms, their error summed
over the three inputs); the sum computed from bfloat16 operands reads above
the float32 limit, so a program computing in bfloat16 would fail it.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.models.mono import LatencyMode  # noqa: E402
from hisstools_library_tpu_torch.models.multichannel import Convolver  # noqa: E402

INS, OUTS, TAPS = 3, 4, 3000
BLOCK = 8192  # the Zero preset's largest hop
LENGTH = 3 * BLOCK
CALLBACKS = (100, 700, 1500, 333, 4096, 8000, 9847)  # sum to LENGTH
LIMITS = {"float64": 1e-10, "float32": 1e-5}


def _bank():
    rng = np.random.default_rng(0x27)
    return rng.standard_normal((OUTS, INS, TAPS)) / np.sqrt(TAPS)


def _inputs():
    return np.random.default_rng(0x28).standard_normal((INS, LENGTH))


def _reference(x, bank):
    return np.stack([sum(np.convolve(x[n], bank[m, n])[:LENGTH] for n in range(INS))
                     for m in range(OUTS)])


@functools.cache
def _want():
    return _reference(_inputs(), _bank())


def _bfloat16(a):
    return torch.from_numpy(a).bfloat16().double().numpy()


def _relative_errors(got, want):
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


def _run(path, dtype, x, bank):
    conv = Convolver(INS, OUTS, latency=LatencyMode.Zero, max_length=TAPS, device="cpu")
    conv.set_all(bank)
    conv.prepare(dtype=dtype)
    xt = torch.from_numpy(x).to(dtype)
    if path == "process_offline":
        return conv.process_offline(xt)
    if path == "process":
        state, cuts = conv.init_state(dtype), [BLOCK] * (LENGTH // BLOCK)
        step = conv.process
    else:
        state, cuts = conv.init_stream_state(dtype), CALLBACKS
        step = conv.process_any
    ys, at = [], 0
    for n in cuts:
        state, y = step(state, xt[:, at:at + n])
        assert y.shape == (OUTS, n)
        ys.append(y)
        at += n
    assert at == LENGTH
    return torch.cat(ys, dim=-1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("path", ["process", "process_any", "process_offline"])
def test_n2m_matches_the_matrix_reference(path, dtype):
    x, bank = _inputs(), _bank()
    got = _run(path, getattr(torch, dtype), x, bank)
    assert got.dtype == getattr(torch, dtype) and got.shape == (OUTS, LENGTH)
    err = _relative_errors(got.double().numpy(), _want())
    assert float(err.max()) <= LIMITS[dtype], err


def test_bfloat16_reference_fails_the_float32_limit():
    low = _relative_errors(_bfloat16(_reference(_bfloat16(_inputs()), _bfloat16(_bank()))),
                           _want())
    assert float(low.min()) > 10 * LIMITS["float32"], low


def test_n2m_routes_every_input_into_every_output():
    """One IR pair at a time: the output row of its pair holds that input
    convolved with it, every other output is zero."""
    x = _inputs()
    for m, n in ((0, 0), (3, 1), (2, 2)):
        bank = np.zeros((OUTS, INS, TAPS))
        bank[m, n, :5] = [1.0, -0.5, 0.25, 0.0, 2.0]
        got = _run("process", torch.float64, x, bank).numpy()
        want = np.convolve(x[n], bank[m, n, :5])[:LENGTH]
        np.testing.assert_allclose(got[m], want, rtol=0, atol=1e-12)
        assert not np.delete(got, m, axis=0).any()
