"""The plain reference, the roofline arithmetic and the trace reader."""

import math

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import roofline, signals, trace
from port_bench.reference import convolution


@pytest.mark.parametrize("lx,lh,start,length", [(50, 7, 0, 56), (37, 64, 10, 30),
                                                 (300, 1, 0, 300), (1, 1, 0, 1)])
def test_convolve_matches_np_convolve(lx, lh, start, length):
    rng = np.random.default_rng(lx * 1000 + lh)
    x = rng.standard_normal((3, lx)).astype(np.float32)
    h = rng.standard_normal((3, lh)).astype(np.float32)
    got = convolution.convolve(torch.from_numpy(x), torch.from_numpy(h), start, length)
    for c in range(3):
        want = np.convolve(x[c].astype(np.float64), h[c].astype(np.float64))
        np.testing.assert_allclose(got[c].numpy(), want[start:start + length],
                                   rtol=0, atol=1e-12)


def test_convolve_refuses_samples_outside():
    x, h = torch.ones(1, 4), torch.ones(1, 3)
    with pytest.raises(ValueError):
        convolution.convolve(x, h, 2, 5)


def test_deconvolve_matches_a_direct_division():
    """Against the formula written out bin by bin in numpy, and, with a tiny
    regularisation, the IR the capture was made with."""
    rng = np.random.default_rng(7)
    ex = rng.standard_normal(200)
    ir = rng.standard_normal((2, 30))
    cap = np.stack([np.convolve(ex, ir[c])[:230] for c in range(2)])
    n = 256
    got = convolution.deconvolve(torch.from_numpy(cap), torch.from_numpy(ex), 1e-4).numpy()
    X = np.fft.rfft(ex, n)
    power = np.abs(X) ** 2
    for c in range(2):
        Y = np.fft.rfft(cap[c], n)
        want = np.fft.irfft(Y * np.conj(X) / (power + 1e-4 * power.max()), n)
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-12)
    exact = convolution.deconvolve(torch.from_numpy(cap), torch.from_numpy(ex), 1e-14).numpy()
    np.testing.assert_allclose(exact[:, :30], ir, atol=1e-6)


def test_control_precision_is_lower():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 500)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32))
    want = convolution.convolve(x, h, 0, 579)
    low = convolution.convolve(x, h, 0, 579, "bfloat16")
    err = convolution.relative_errors(low, want)
    assert (err > 1e-4).all() and (err < 3e-2).all()
    with pytest.raises(ValueError):
        convolution.convolve(x, h, 0, 10, "float16")


def test_relative_errors():
    want = torch.tensor([[3.0, 4.0], [1.0, 0.0]], dtype=torch.float64)
    got = torch.tensor([[3.0, 4.5], [1.0, 0.0]])
    np.testing.assert_allclose(convolution.relative_errors(got, want).numpy(), [0.1, 0.0])


def test_fft_flops_and_bound():
    assert roofline.fft_flops(1024, 3) == 2.5 * 1024 * 10 * 3
    assert roofline.least_seconds(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.least_seconds(1.0, 67e12) == (1.0, "operations")


def test_convolution_flops_known_counts():
    # one channel, 4 taps, 4 new samples with history: at N = 4 (s = 2) two
    # frames, two partitions: 4 transforms of 2.5*4*2 = 20, 4 products of 8*3
    ops4 = roofline.fft_flops(4, 4) + 8 * 3 * 4
    # at N = 8 (s = 4): 2 transforms of 2.5*8*3 = 60, 1 product of 8*5
    ops8 = roofline.fft_flops(8, 2) + 8 * 5
    assert roofline.convolution_flops(1, 4, 4, 4, history=True, ir_in_call=False) == \
        min(ops4, ops8, roofline.fft_flops(16, 2) + 8 * 9)
    assert roofline.convolution_flops(2, 4, 4, 4, True, False) == \
        2 * roofline.convolution_flops(1, 4, 4, 4, True, False)
    # without history frame f meets partition p only where 0 <= f - p < J
    assert roofline._pairs(3, 2, 2, history=False) == 4
    assert roofline._pairs(3, 2, 2, history=True) == 6


def test_cell_work_counts():
    """The bytes of each cell's call, from its shapes: render reads its block,
    the taps and the history and writes its block and the newest history."""
    c, b, n = 128, 65536, 480000
    assert 4 * c * (b + n + (n - 1) + b + b) == 592182784


def test_seeded_inputs():
    a = signals.ir_bank(2**33 + 5, 2, 100, "cpu")
    b = signals.ir_bank(2**33 + 5, 2, 100, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.double().square().sum(-1).mean()) - 1.0) < 0.3
    s = signals.log_sweep(4800, 48000, 20.0, 20000.0, "cpu")
    assert s.dtype == torch.float64 and float(s.abs().max()) <= 1.0


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reading():
    events = [
        _event("user_annotation", trace.WINDOW, 100.0, 100.0),
        _event("cpu_op", "aten::add", 105.0, 10.0),
        _event("cpu_op", "aten::cat", 150.0, 20.0),
        _event("cpu_op", "aten::cat_inner", 155.0, 5.0),
        _event("kernel", "void fft_onepass<K1Pass>(float*)", 110.0, 20.0),
        _event("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 125.0, 10.0),
        _event("gpu_memset", "Memset (Device)", 170.0, 10.0),
        _event("kernel", "outside", 300.0, 10.0),
    ]
    t = trace.from_chrome(events)
    assert math.isclose(t.window_s, 100e-6)
    assert len(t.device_ops) == 3
    assert math.isclose(t.busy_s, 35e-6)  # 110-135 and 170-180
    assert t.gaps() == [(100.0, 110.0), (135.0, 170.0), (180.0, 200.0)]
    assert t.host_doing(157.0) == "aten::cat_inner"
    assert t.host_doing(140.0) == "host between operations"
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "void fft_onepass<K1Pass>(float*)"
    assert math.isclose(bd["device_ops"][0][1], 20e-6)
    assert [k for k, _ in bd["idle_gaps"]] == ["aten::cat", "host between operations",
                                               "aten::add"]
    names = frozenset({"fft_onepass", "ring_mac"})
    assert trace.is_port_kernel(t.device_ops[0][0], names)
    assert not trace.is_port_kernel(t.device_ops[1][0], names)
    with pytest.raises(ValueError):
        trace.from_chrome(events[1:])


def test_trace_keeps_every_event_of_the_window_with_its_args():
    copy = {**_event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120.0, 5.0),
            "args": {"bytes": 4096}}
    flow = {"ph": "s", "cat": "ac2g", "name": "launch", "ts": 130.0, "id": 1}
    events = [_event("user_annotation", trace.WINDOW, 100.0, 100.0), copy, flow,
              _event("kernel", "before", 10.0, 5.0), {"ph": "M", "name": "process_name"}]
    t = trace.from_chrome(events)
    assert copy in t.events and flow in t.events and len(t.events) == 3
    assert sum(e.get("args", {}).get("bytes", 0) for e in t.events
               if e.get("cat") == "gpu_memcpy") == 4096


def test_kernel_names_of_the_program():
    names = trace.kernel_names(ROOT / "hisstools_library_tpu_torch" / "csrc")
    assert {"fft_onepass", "ring_mac", "hop_fire_kernel", "chain_mid"} <= names
    assert not any(n.startswith("__") for n in names)
