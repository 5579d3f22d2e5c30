"""The port's spans (``utils/profiling.span``) on the CPU: at tiny sizes, each
benchmarked entry (the Convolver's N-in / M-out routing and its
sample-granular ``process_any`` among them) under ``torch.profiler`` opens
its ``hst::`` spans with the layer prefixes and nesting of PERF.md §3, every operator of a call lies
inside the call's entry span, and with no profiler recording no span calls
``record_function``. The flag the spans test (``torch.autograd.profiler.
_is_profiler_enabled``) is private to torch: a test pins it."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from hisstools_library_tpu_torch.models import pipeline  # noqa: E402
from hisstools_library_tpu_torch.models.mono import LatencyMode  # noqa: E402
from hisstools_library_tpu_torch.models.multichannel import Convolver  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral_processor as sp  # noqa: E402
from hisstools_library_tpu_torch.utils import profiling  # noqa: E402

LAYERS = ("entry", "engine", "fft", "kernel")  # outermost first
CHANNELS, TAPS = 3, 3000


def _convolver(seed, taps=TAPS):
    rng = np.random.default_rng(seed)
    conv = Convolver(CHANNELS, latency=LatencyMode.Zero, max_length=taps, device="cpu")
    conv.set_all(rng.standard_normal((CHANNELS, taps)) / np.sqrt(taps))
    conv.prepare(dtype=torch.float32)
    return conv


def _signal(seed, length, channels=CHANNELS):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(channels, length, generator=g)


def _process():
    conv = _convolver(1)
    state = conv.init_state(torch.float32)
    blocks = [_signal(2 + k, 8192) for k in range(2)]
    state, _ = conv.process(state, blocks[0])
    return lambda: conv.process(state, blocks[1])[1]


def _process_offline():
    # a tail at N = 4096: the fused chain's staged form, K2 -> K3 -> K4
    conv = _convolver(3, taps=20000)
    x = _signal(4, 30000)
    conv.process_offline(x, backend="pallas")  # attaches the lazy offline tail
    return lambda: conv.process_offline(x, backend="pallas")


def _convolve():
    x, ir = _signal(5, 4000), _signal(6, 900)
    return lambda: sp.convolve(x, ir, sp.EdgeMode.Linear)


def _correlate():
    x, ir = _signal(7, 4000), _signal(8, 900)
    return lambda: sp.correlate(x, ir, sp.EdgeMode.Fold)


def _deconvolve(backend=None):
    excitation = _signal(9, 3000, 1)[0]
    measured = _signal(10, 4000)
    return lambda: pipeline.ir_deconvolve(measured, excitation, 1e-4, backend=backend)


# The kernels' route on CPU tensors (the wrappers run their plain versions):
# K16's spans, which the card's default route opens.
def _convolve_kernels():
    x, ir = _signal(5, 4000), _signal(6, 900)
    return lambda: sp.convolve(x, ir, sp.EdgeMode.Linear, backend="pallas")


def _correlate_kernels():
    x, ir = _signal(7, 4000), _signal(8, 900)
    return lambda: sp.correlate(x, ir, sp.EdgeMode.Wrap, backend="pallas")


def _n2m_convolver(seed, taps=TAPS, outs=2):
    rng = np.random.default_rng(seed)
    conv = Convolver(CHANNELS, outs, latency=LatencyMode.Zero, max_length=taps, device="cpu")
    conv.set_all(rng.standard_normal((outs, CHANNELS, taps)) / np.sqrt(taps))
    conv.prepare(dtype=torch.float32)
    return conv


def _n2m_process():
    conv = _n2m_convolver(11)
    state = conv.init_state(torch.float32)
    blocks = [_signal(12 + k, 8192) for k in range(2)]
    state, _ = conv.process(state, blocks[0])
    return lambda: conv.process(state, blocks[1])[1]


def _n2m_process_any():
    conv = _n2m_convolver(14)
    state, _ = conv.process_any(conv.init_stream_state(torch.float32), _signal(15, 300))
    x = _signal(16, 700)
    return lambda: conv.process_any(state, x)[1]


def _n2m_process_offline():
    conv = _n2m_convolver(17, taps=20000)
    x = _signal(18, 30000)
    conv.process_offline(x)  # attaches the lazy offline tail
    return lambda: conv.process_offline(x)


def _process_any(backend=None):
    # a callback that fires the 256, 1024 and 4096 sections after one that
    # left each of them between hop boundaries
    conv = _convolver(19, taps=20000)
    state, _ = conv.process_any(conv.init_stream_state(torch.float32), _signal(20, 300),
                                backend=backend)
    x = _signal(21, 2100)
    return lambda: conv.process_any(state, x, backend=backend)[1]


# each entry's call, the spans it opens on the CPU, and for some of them the
# span that holds them
CASES = {
    "process": (_process, {
        "entry.Convolver.process": None,
        "engine.mono.process": "entry.Convolver.process",
        "engine.mono.collapsed": "engine.mono.process",
        "engine.partitioned.process_block": "engine.mono.collapsed",
        "engine.mono.refresh_section": "engine.mono.collapsed",
        "kernel.K7.lag_mac_ring": "engine.partitioned.process_block",
        "fft.rfft": None, "fft.rifft": "engine.partitioned.process_block"}),
    "process_offline": (_process_offline, {
        "entry.Convolver.process_offline": None,
        "engine.mono.process_offline": "entry.Convolver.process_offline",
        "engine.mono.tail_offline": "engine.mono.process_offline",
        "engine.partitioned.offline_fused": "engine.mono.tail_offline",
        "kernel.K2.rfft_packed_stream": "engine.partitioned.offline_fused",
        "kernel.K3.lag_mac_causal": "engine.partitioned.offline_fused",
        "kernel.K4.rifft_packed_tail": "engine.partitioned.offline_fused"}),
    "convolve": (_convolve, {
        "entry.spectral_processor.convolve": None,
        "fft.rfft_padded": "entry.spectral_processor.convolve",
        "fft.rfft": "fft.rfft_padded",
        "engine.spectral.ir_convolve_real": "entry.spectral_processor.convolve",
        "fft.rifft": "entry.spectral_processor.convolve",
        "engine.spectral.arrange_convolve": "entry.spectral_processor.convolve"}),
    "correlate_fold": (_correlate, {
        "entry.spectral_processor.correlate": None,
        "engine.spectral.fold_pad": "entry.spectral_processor.correlate",
        "fft.rfft_padded": "entry.spectral_processor.correlate",
        "fft.rfft": "fft.rfft_padded",
        "engine.spectral.ir_correlate_real": "entry.spectral_processor.correlate",
        "fft.rifft": "entry.spectral_processor.correlate",
        "engine.spectral.arrange_correlate": "entry.spectral_processor.correlate"}),
    "ir_deconvolve": (_deconvolve, {
        "entry.pipeline.ir_deconvolve": None,
        "fft.rfft_padded": "entry.pipeline.ir_deconvolve",
        "fft.rfft": "fft.rfft_padded",
        "engine.deconvolve.divide": "entry.pipeline.ir_deconvolve",
        "fft.rifft": "entry.pipeline.ir_deconvolve"}),
    "convolve_kernels": (_convolve_kernels, {
        "entry.spectral_processor.convolve": None,
        "engine.spectral.ir_convolve_real": "entry.spectral_processor.convolve",
        "kernel.K16.bin_mul": "engine.spectral.ir_convolve_real"}),
    "correlate_kernels": (_correlate_kernels, {
        "entry.spectral_processor.correlate": None,
        "engine.spectral.ir_correlate_real": "entry.spectral_processor.correlate",
        "kernel.K16.bin_mul_conj": "engine.spectral.ir_correlate_real"}),
    "ir_deconvolve_kernels": (lambda: _deconvolve("pallas"), {
        "entry.pipeline.ir_deconvolve": None,
        "engine.deconvolve.divide": "entry.pipeline.ir_deconvolve",
        "kernel.K16.bin_deconvolve": "engine.deconvolve.divide",
        "fft.rifft": "entry.pipeline.ir_deconvolve"}),
    "process_any": (_process_any, {
        "entry.Convolver.process_any": None,
        "engine.mono.process_any": "entry.Convolver.process_any",
        "engine.partitioned.step_any": "engine.mono.process_any",
        "engine.partitioned.fire": "engine.partitioned.step_any",
        "engine.partitioned.emit": "engine.partitioned.fire"}),
    "process_any_kernels": (lambda: _process_any("pallas"), {
        "entry.Convolver.process_any": None,
        "engine.mono.process_any": "entry.Convolver.process_any",
        "engine.partitioned.step_any": "engine.mono.process_any",
        "engine.partitioned.fire": "engine.partitioned.step_any",
        "kernel.K9.hop_fire": "engine.partitioned.fire",
        "engine.partitioned.emit": "engine.partitioned.fire"}),
    "n2m_process": (_n2m_process, {
        "entry.Convolver.process": None,
        "engine.matrix.process": "entry.Convolver.process",
        "engine.mono.process": "engine.matrix.process",
        "engine.mono.collapsed": "engine.mono.process",
        "engine.matrix.reduce": "engine.matrix.process"}),
    "n2m_process_any": (_n2m_process_any, {
        "entry.Convolver.process_any": None,
        "engine.matrix.process": "entry.Convolver.process_any",
        "engine.mono.process_any": "engine.matrix.process",
        "engine.partitioned.step_any": "engine.mono.process_any",
        "engine.partitioned.fire": "engine.partitioned.step_any",
        "engine.matrix.reduce": "engine.matrix.process"}),
    "n2m_process_offline": (_n2m_process_offline, {
        "entry.Convolver.process_offline": None,
        "engine.matrix.process": "entry.Convolver.process_offline",
        "engine.mono.process_offline": "engine.matrix.process",
        "engine.matrix.reduce": "engine.matrix.process"}),
}


def _traced(call, tmp_path):
    """The complete events of one profiled call: (name, cat, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e.get("cat"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and "dur" in e]


def _spans(events):
    return sorted(((n[len(profiling.SPAN_PREFIX):], lo, hi) for n, c, lo, hi in events
                   if c == "user_annotation" and n.startswith(profiling.SPAN_PREFIX)),
                  key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The innermost span that holds span i (None at the top): of the spans
    sorted by start, outer first, the last before i that holds it."""
    _, lo, hi = spans[i]
    return next((n for n, a, b in reversed(spans[:i]) if a <= lo and hi <= b), None)


@pytest.mark.parametrize("case", list(CASES))
def test_spans_name_and_nest_by_layer(case, tmp_path):
    make, expected = CASES[case]
    spans = _spans(_traced(make(), tmp_path))
    names = {s[0] for s in spans}
    assert set(expected) <= names, sorted(names)
    assert all(n.split(".", 1)[0] in LAYERS for n in names), sorted(names)
    entries = [s for s in spans if s[0].startswith("entry.")]
    assert len(entries) == 1 and spans[0] == entries[0]  # the call's identifier
    for i, (name, _, _) in enumerate(spans):
        parent = _parent(spans, i)
        if name.startswith("entry."):
            assert parent is None
            continue
        # no span lies in one of a deeper layer: entry > engine > fft > kernel
        assert LAYERS.index(parent.split(".", 1)[0]) <= LAYERS.index(name.split(".", 1)[0])
        if expected.get(name):
            assert parent == expected[name], (name, parent)


@pytest.mark.parametrize("case", list(CASES))
def test_every_operator_lies_in_the_entry_span(case, tmp_path):
    events = _traced(CASES[case][0](), tmp_path)
    (_, lo, hi), = [s for s in _spans(events) if s[0].startswith("entry.")]
    ops = [(n, a, b) for n, c, a, b in events if c == "cpu_op" and n.startswith("aten::")]
    assert ops
    assert all(lo <= a and b <= hi for _, a, b in ops), [n for n, a, b in ops
                                                       if not (lo <= a and b <= hi)]


@pytest.mark.parametrize("case", list(CASES))
def test_no_record_function_without_a_profiler(case, monkeypatch):
    call = CASES[case][0]()
    want = call()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert torch.equal(call(), want)


def test_the_profilers_flag_flips():
    """The spans test this private flag of torch's: it must exist, read
    False with no profiler and True while one records."""
    import torch.autograd.profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("form", ["decorator", "context"])
def test_span_forms_keep_results_and_errors(form, tmp_path):
    def body(x, fail=False):
        if fail:
            raise KeyError("inside")
        return torch.ones(2) * x

    if form == "decorator":
        fn = profiling.span("engine.test.body")(body)
        assert fn.__name__ == "body" and fn.__wrapped__ is body
    else:
        def fn(x, fail=False):
            with profiling.span("engine.test.body"):
                return body(x, fail)
    assert torch.equal(fn(3.0), torch.full((2,), 3.0))
    with pytest.raises(KeyError):
        fn(1.0, fail=True)
    events = _traced(lambda: fn(2.0), tmp_path)
    (name, lo, hi), = _spans(events)
    assert name == "engine.test.body"
    ops = [(a, b) for n, c, a, b in events if n == "aten::mul"]
    assert ops and all(lo <= a and b <= hi for a, b in ops)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError):
            fn(1.0, fail=True)
    assert fn(4.0)[0] == 4.0  # the failed call's span closed
