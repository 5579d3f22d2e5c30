"""The N-in / M-out matrix cell at tiny sizes on the port's CPU paths: the
matrix reference against a direct sum of ``np.convolve``, the roofline count
of the matrix's least work, planted faults, and the cell's two readers
(``matrix_reduce_ms_per_call``, ``transform_points_per_call``) with and
without what they read.

The entry's tiny sizes join the table that ``conftest.tiny_cell`` reads when
this module is collected, so that the runs of every cell in
``test_port_bench_run.py`` take them too: run that file with this one."""

import math
import time

import numpy as np
import pytest
import torch

import conftest
from conftest import ROOT, tiny_cell
from port_bench import harness, roofline, roofline_matrix, trace as trace_mod
from port_bench.metrics import matrix_reduce_ms_per_call, transform_points_per_call
from port_bench.reference import convolution, matrix

conftest.TINY.setdefault("convolver_matrix_stream",
                         ({"ins": 3, "outs": 4, "channels": 4}, {"block": 8192,
                                                                 "pool_blocks": 3}))

CPU = torch.device("cpu")
SEED = 2**33 + 7  # beyond 32 signed bits, as a run's seed may be
MATRIX = "hoa25x25_ir3s.matrix_render"


# -- the matrix's reference and its least work --------------------------------

@pytest.mark.parametrize("ins,outs,lx,lh,start,length", [
    (3, 2, 50, 7, 0, 56), (2, 4, 37, 64, 10, 30), (1, 1, 300, 1, 0, 300), (5, 3, 20, 20, 5, 20)])
def test_matrix_reference_is_the_sum_of_np_convolve(ins, outs, lx, lh, start, length):
    rng = np.random.default_rng(ins * 100 + outs * 10 + lx)
    x = rng.standard_normal((ins, lx)).astype(np.float32)
    h = rng.standard_normal((outs, ins, lh)).astype(np.float32)
    got = matrix.matrix_convolve(torch.from_numpy(x), torch.from_numpy(h), start, length)
    assert got.dtype == torch.float64 and got.shape == (outs, length)
    for m in range(outs):
        want = sum(np.convolve(x[n].astype(np.float64), h[m, n].astype(np.float64))
                   for n in range(ins))
        np.testing.assert_allclose(got[m].numpy(), want[start:start + length], rtol=0,
                                   atol=1e-11)


def test_matrix_reference_refuses_a_bank_of_another_shape():
    with pytest.raises(ValueError):
        matrix.matrix_convolve(torch.ones(3, 10), torch.ones(2, 2, 4), 0, 5)


def test_matrix_control_precision_is_lower_and_tf32_left_as_it_was():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 400)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 3, 60)).astype(np.float32))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    want = matrix.matrix_convolve(x, h, 0, 459)
    low = matrix.matrix_convolve(x, h, 0, 459, "bfloat16")
    err = convolution.relative_errors(low, want)
    assert (err > 1e-4).all() and (err < 3e-2).all()
    assert torch.equal(low, low.bfloat16().double())  # stored as bfloat16 would be
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_matrix_least_work_counts_inputs_and_outputs_once():
    """Bytes: inputs, every pair's taps, one history a input, outputs. The
    operations at one input and one output are one channel's fewest
    (``roofline.convolution_flops`` for a stream block) plus the products of
    the other pairs, and grow with the pairs, not with pairs x transforms."""
    n_in, n_out, b, taps = 25, 25, 65536, 144000
    nbytes = roofline_matrix.matrix_stream_bytes(n_in, n_out, b, taps)
    assert nbytes == 4 * (25 * 65536 + 625 * 144000 + 25 * 143999 + 25 * 65536 + 25 * 65536)
    one = roofline_matrix.matrix_stream_flops(1, 1, b, taps)
    assert one == pytest.approx(roofline.convolution_flops(1, b, taps, b, history=True,
                                                           ir_in_call=False))
    flops = roofline_matrix.matrix_stream_flops(n_in, n_out, b, taps)
    assert n_in * one < flops < n_in * n_out * one
    # by hand at N = 2^17 (hop 65536: one frame in, one out, 3 partitions)
    n, s = 1 << 17, 1 << 16
    at_n = 2.5 * n * math.log2(n) * 50 + 8.0 * (s + 1) * 3 * 625
    assert flops <= at_n


# -- the readers ----------------------------------------------------------------

def _trace_run(span_names):
    """A synthetic traced window of one call: two device operations launched
    inside the given spans (nested, outermost first), and one launched
    inside an engine span beside them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace_mod.WINDOW, "pid": 1, "tid": 1,
           "ts": 0.0, "dur": 1000.0, "args": {}},
          {"ph": "X", "cat": "user_annotation", "name": "hst::entry.Convolver.process",
           "pid": 1, "tid": 1, "ts": 10.0, "dur": 900.0, "args": {}},
          {"ph": "X", "cat": "user_annotation", "name": "hst::engine.mono.process",
           "pid": 1, "tid": 1, "ts": 20.0, "dur": 100.0, "args": {}}]
    for k, name in enumerate(span_names):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": 1,
                   "ts": 200.0 + k, "dur": 300.0 - 2 * k, "args": {}})
    for corr, at, lo, hi in ((1, 50, 100, 140), (2, 300, 400, 425), (3, 310, 430, 436)):
        ev.append({"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512>",
                   "pid": 0, "tid": 7, "ts": float(lo), "dur": float(hi - lo),
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                   "tid": 1, "ts": float(at), "dur": 2.0, "args": {"correlation": corr}})
    run = harness.Run(setup_s=0.0)
    run.trace = trace_mod.from_chrome(ev)
    run.traced_calls = 1
    run.port_kernels = frozenset()
    return run


def test_matrix_reduce_reads_the_matrix_spans_operations():
    run = _trace_run(["hst::engine.matrix.process", "hst::engine.matrix.reduce"])
    assert matrix_reduce_ms_per_call.read(run) == pytest.approx(0.031)  # 25 + 6 us


def test_matrix_reduce_reads_zero_where_the_spans_launch_nothing():
    run = _trace_run(["hst::engine.matrix.process"])
    for e in run.trace.events:  # the two launches move into the engine span
        if e.get("cat") == "cuda_runtime":
            e["ts"] = 60.0
    assert matrix_reduce_ms_per_call.read(run) == 0.0


@pytest.mark.parametrize("spans", [[], ["hst::engine.mono.other"]], ids=["none", "others"])
def test_matrix_reduce_is_none_without_a_matrix_span(spans):
    assert matrix_reduce_ms_per_call.read(_trace_run(spans)) is None
    assert matrix_reduce_ms_per_call.read(harness.Run(setup_s=0.0)) is None


def test_transform_points_reads_the_windows_counters():
    run = harness.Run(setup_s=0.0, calls=4)
    assert transform_points_per_call.read(run) is None  # nothing collected
    run.extra["transform_points"] = 1000
    assert transform_points_per_call.read(run) == 250.0
    run.calls = 0
    assert transform_points_per_call.read(run) is None


def test_transform_points_is_none_without_counters(monkeypatch):
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels

    total = transform_points_per_call.total_points()
    assert isinstance(total, int)
    for mod in (hopper_fft, hopper_kernels):
        for name in dir(mod):
            fn = getattr(mod, name)
            if callable(fn) and hasattr(fn, "points"):
                monkeypatch.delattr(fn, "points")
    assert transform_points_per_call.total_points() is None
    cell = tiny_cell(harness.load_json(ROOT / "BENCHMARK.json"), MATRIX)
    result = harness.run_cell(cell, SEED, 0.1, True, CPU, time.perf_counter())
    assert result["correct"] is True
    assert "transform_points_per_call" not in result["metrics"]


def test_matrix_window_collects_the_counters(bench):
    """On the CPU no kernel launches, so the window counts 0 points; the
    reader reports them (the card's count: PERF.md §3)."""
    cell = tiny_cell(bench, MATRIX)
    result = harness.run_cell(cell, SEED, 0.1, True, CPU, time.perf_counter())
    assert result["metrics"]["transform_points_per_call"]["value"] == 0.0
    assert result["metrics"]["transform_points_per_call"]["unit"] == "points"
    assert "matrix_reduce_ms_per_call" not in result["metrics"]  # no device trace


# -- the entry: inputs, faults --------------------------------------

def test_matrix_entry_routes_every_input_into_every_output(bench):
    cell = tiny_cell(bench, MATRIX)
    entry = harness.entry_class(cell.traffic)(cell.config, cell.traffic, SEED, CPU)
    assert entry.conv.num_ins == 3 and entry.conv.num_outs == 4 and not entry.conv.parallel
    assert entry.bank.shape == (4, 3, 3000) and entry.pool.shape == (3, 3, 8192)
    assert entry.samples_per_call == 3 * 8192
    outs = [entry.call(k) for k in range(3)]
    assert all(o.shape == (4, 8192) for o in outs)
    for k in (0, 2):
        want = entry.reference(k, slice(0, 4), "float64")
        assert float(convolution.relative_errors(outs[k], want).max()) < 1e-5


def _faulty(cls, fault):
    class Faulty(cls):
        def _process(self, state, x):
            if fault == "input_dropped":  # the last input left out of every output
                x = x.clone()
                x[-1] = 0
            return super()._process(state, x)

        def call(self, k):
            if fault == "state_unchanged":  # the stream step keeps its old state
                state = self.state
                out = super().call(k)
                self.state = state
                return out
            return super().call(k)
    return Faulty


@pytest.mark.parametrize("fault", ["input_dropped", "state_unchanged"])
def test_planted_fault_is_not_correct(bench, fault):
    cell = tiny_cell(bench, MATRIX)
    cls = _faulty(harness.entry_class(cell.traffic), fault)
    result = harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(), entry_cls=cls)
    assert result["correct"] is False and result["failed"] >= 1
