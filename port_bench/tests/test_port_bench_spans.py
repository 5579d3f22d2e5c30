"""``port_bench/spans.py`` and its four readers on a synthetic Chrome trace
whose answers are known: device operations joined to their launches by
correlation (one by its ``External id`` alone), nested program spans on two
threads, an operation no span owns, and idle gaps that partly overlap the
entry spans."""

import pytest

from port_bench import harness, spans, trace as trace_mod

CALLS = 2
PORT = frozenset({"port_k"})
# (name, start, end) of the program's spans, by thread
SPANS = {
    1: [("hst::entry.Convolver.process", 100, 400),
        ("hst::engine.mono.process", 110, 390),
        ("hst::fft.rfft", 120, 200),
        ("hst::kernel.K1.rfft_packed", 130, 160),
        ("hst::entry.Convolver.process", 600, 700)],
    2: [("hst::fft.rifft", 640, 660)],  # the second thread, inside thread 1's entry
}
# (correlation, launching thread, launch time, device name, category, start,
# end, the owner's layer): a runtime launch event for each but the one with
# no correlation (it has an External id that names an operator)
OPS = [
    (1, 1, 140, "void hst::port_k<1>(hst::Args)", "kernel", 300, 350, "kernel"),
    (2, 1, 150, "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>",
     "kernel", 350, 360, "kernel"),
    (3, 1, 170, "void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>", "kernel",
     360, 380, "fft"),
    (4, 1, 250, "void at::native::CatArrayBatchedCopy<float>", "kernel", 380, 420, "engine"),
    (5, 1, 395, "Memcpy DtoD (Device -> Device)", "gpu_memcpy", 420, 425, "entry"),
    (None, 1, 255, "void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>",
     "kernel", 430, 440, "engine"),
    (6, 1, 620, "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>",
     "kernel", 700, 730, "entry"),
    (7, 2, 650, "void at::native::CatArrayBatchedCopy<float>", "kernel", 730, 740, "fft"),
    (8, 1, 800, "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>",
     "kernel", 800, 806, None),
]


def _events(with_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace_mod.WINDOW, "pid": 1, "tid": 1,
           "ts": 0.0, "dur": 1000.0, "args": {"External id": 1000}}]
    if with_spans:
        for tid, rows in SPANS.items():
            for k, (name, lo, hi) in enumerate(rows):
                ev.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
                           "tid": tid, "ts": float(lo), "dur": float(hi - lo),
                           "args": {"External id": 100 * tid + k}})
    # the operator that launched the uncorrelated operation
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 1, "tid": 1,
               "ts": 255.0, "dur": 3.0, "args": {"External id": 99}})
    for corr, tid, at, name, cat, lo, hi, _ in OPS:
        args = {"External id": 99} if corr is None else {"correlation": corr,
                                                         "External id": 500 + corr}
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": float(lo),
                   "dur": float(hi - lo), "args": args})
        if corr is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": tid, "ts": float(at), "dur": 2.0,
                       "args": {"correlation": corr, "External id": 500 + corr}})
            ev.append({"ph": "s", "cat": "ac2g", "id": corr, "pid": 1, "tid": tid,
                       "ts": float(at)})
    return ev


def _run(with_spans=True):
    run = harness.Run(setup_s=0.0)
    run.trace = trace_mod.from_chrome(_events(with_spans))
    run.traced_calls = CALLS
    run.port_kernels = PORT
    return run


def _glue_ms(layers):
    us = sum(hi - lo for _, _, _, name, _, lo, hi, layer in OPS
             if layer in layers and "port_k" not in name)
    return us * 1e-3 / CALLS


READERS = ["engine_glue_ms_per_call", "fft_glue_ms_per_call", "wrapper_glue_ms_per_call",
           "idle_in_program_share"]


def test_each_operation_has_the_innermost_span_of_its_launching_thread():
    att = spans.attribute(_run().trace)
    owners = [owner for *_, owner in att.ops]
    assert owners == ["hst::kernel.K1.rfft_packed", "hst::kernel.K1.rfft_packed",
                      "hst::fft.rfft", "hst::engine.mono.process",
                      "hst::entry.Convolver.process", "hst::engine.mono.process",
                      "hst::entry.Convolver.process", "hst::fft.rifft", None]
    assert [spans.layer(o) if o else None for o in owners] == [op[-1] for op in OPS]
    assert att.spans == 6 and att.entries == [(100.0, 400.0), (600.0, 700.0)]


@pytest.mark.parametrize("reader,want", [
    ("engine_glue_ms_per_call", _glue_ms(("entry", "engine"))),  # 85 us in 2 calls
    ("fft_glue_ms_per_call", _glue_ms(("fft",))),                # 30 us
    ("wrapper_glue_ms_per_call", _glue_ms(("kernel",))),         # 10 us, not the port's kernel
    # idle [0, 300] and [440, 700] of the window's 1000 us meet the entry
    # spans for 200 and 100 us
    ("idle_in_program_share", 30.0),
])
def test_reader_values(reader, want):
    assert harness.metric_reader(reader)(_run()) == pytest.approx(want)


def test_the_split_adds_up_to_the_glue_by_name_less_the_unowned():
    run = _run()
    split = sum(harness.metric_reader(m)(run) for m in READERS[:3])
    unowned_ms = 6e-3 / CALLS
    assert split + unowned_ms == pytest.approx(harness.metric_reader("glue_ms_per_call")(run))
    assert harness.metric_reader("device_idle_share")(run) == pytest.approx(100 - 18.1)


def test_the_log_names_the_unowned_share_and_the_spans(capsys):
    spans.of(_run())
    err = capsys.readouterr().err
    assert "spans: 3.00 program spans a traced call" in err
    assert f"{100 * 6 / 181:.4f}% of busy time" in err
    assert "hst::kernel.K1.rfft_packed: kernels 0.0250, glue 0.0050 (fill 0.0050)" in err
    assert "(no span): kernels 0.0000, glue 0.0030 (fill 0.0030)" in err


@pytest.mark.parametrize("reader", READERS)
def test_no_program_span_no_value(reader):
    """The parent's program opens no span: the metric is left out."""
    assert harness.metric_reader(reader)(_run(with_spans=False)) is None
    run = _run()
    run.trace = None
    assert harness.metric_reader(reader)(run) is None


@pytest.mark.parametrize("name,cat,want", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, "
     "float, float, at::native::binary_internal::MulFunctor<float> > >", "kernel", "mul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >", "kernel", "add"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "kernel", "cat"),
    ("Memset (Device)", "gpu_memset", "memset"),
])
def test_kind(name, cat, want):
    assert spans.kind(name, cat) == want
