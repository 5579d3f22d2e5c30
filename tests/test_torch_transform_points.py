"""The transform wrappers' ``<wrapper>.points`` counters: each launch adds
its frames x N (K9 adds its forward's and its inverse's, 2 x frames x N)
beside ``<wrapper>.launches``, counted here by hand.

No kernel runs on the CPU, so the wrappers take meta tensors (which take
the card's branch) with the kernel library replaced by one whose every
launch returns 0: the wrappers route, check and count as on the card, and
nothing is computed. The CPU's plain versions count nothing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft as hf  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_kernels as hk  # noqa: E402
from hisstools_library_tpu_torch.models.mono import LatencyMode  # noqa: E402
from hisstools_library_tpu_torch.models.multichannel import Convolver  # noqa: E402

META = "meta"


class _Launches:
    """A kernel library whose every entry point returns 0 (no error)."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def launches(monkeypatch):
    """Fake launches, every wrapper's counters at 0; yields a function that
    reads the counters that moved, {wrapper: (launches, points)}."""
    monkeypatch.setattr(_build, "load", lambda: _Launches())
    monkeypatch.setattr(_build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    wrappers = {name: getattr(mod, name) for mod in (hf, hk) for name in dir(mod)
                if callable(getattr(mod, name)) and hasattr(getattr(mod, name), "launches")}
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", 0)
        if hasattr(fn, "points"):
            monkeypatch.setattr(fn, "points", 0)

    def moved():
        return {name: (fn.launches, getattr(fn, "points", None))
                for name, fn in wrappers.items() if fn.launches}
    yield moved


def _m(*shape):
    return torch.empty(*shape, device=META)


# (call, the wrapper that launches, its points by hand)
CASES = {
    "K1": (lambda: hf.rfft_packed(_m(5, 4096)), "rfft_packed", 5 * 4096),
    "K1-batched": (lambda: hf.rfft_packed(_m(2, 3, 8192)), "rfft_packed", 6 * 8192),
    "K10": (lambda: hf.rfft_packed(_m(3, 7, 256)), "rfft_small", 21 * 256),
    "K13": (lambda: hf.rfft_packed(_m(2, 1 << 18)), "rfft_packed_split", 2 << 18),
    "tiny-rfft": (lambda: hf.rfft_packed(_m(4, 8)), "rfft_tiny", 4 * 8),
    "K6": (lambda: hf.rifft_packed(_m(5, 2048), _m(5, 2048)), "rifft_packed", 5 * 4096),
    "K11": (lambda: hf.rifft_packed(_m(3, 128), _m(3, 128)), "rifft_small", 3 * 256),
    "K14": (lambda: hf.rifft_packed(_m(2, 1 << 17), _m(2, 1 << 17)), "rifft_packed_split",
            2 << 18),
    "tiny-rifft": (lambda: hf.rifft_packed(_m(4, 4), _m(4, 4)), "rifft_tiny", 4 * 8),
    "K10w": (lambda: hf.rfft_small_windowed(_m(2, 5, 512), _m(512)), "rfft_small_windowed",
             10 * 512),
    "tiny-K10w": (lambda: hf.rfft_small_windowed(_m(2, 5, 8), _m(8)), "rfft_tiny_windowed",
                  10 * 8),
    "K11w": (lambda: hf.rifft_small_windowed(_m(2, 5, 256), _m(2, 5, 256), _m(512), 0.5),
             "rifft_small_windowed", 10 * 512),
    "tiny-K11w": (lambda: hf.rifft_small_windowed(_m(2, 5, 4), _m(2, 5, 4), _m(8), 0.5),
                  "rifft_tiny_windowed", 10 * 8),
    "K12": (lambda: hf.fft_split(_m(3, 64), _m(3, 64)), "fft_split", 3 * 64),
    "K12-inverse": (lambda: hf.fft_split(_m(3, 1 << 17), _m(3, 1 << 17), inverse=True),
                    "fft_split", 3 << 17),
    "tiny-fft": (lambda: hf.fft_split(_m(3, 8), _m(3, 8)), "fft_tiny", 3 * 8),
    "K2": (lambda: hf.rfft_packed_stream(_m(2, 5, 2048)), "rfft_packed_stream", 10 * 4096),
    "K4": (lambda: hf.rifft_packed_tail(_m(2, 5, 2048), _m(2, 5, 2048), 0.5),
           "rifft_packed_tail", 10 * 4096),
    "K9": (lambda: hk.hop_fire(_m(3, 256), _m(3, 2, 128), _m(3, 2, 128), _m(2, 128),
                               _m(2, 128)), "hop_fire", 2 * 3 * 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_launch_counts_frames_times_n(launches, case):
    call, name, points = CASES[case]
    call()
    call()
    assert launches() == {name: (2, 2 * points)}


def test_the_cpu_counts_nothing(launches):
    hf.rfft_packed(torch.zeros(5, 4096))
    hk.hop_fire(torch.zeros(3, 256), *(torch.zeros(3, 2, 128),) * 2,
                *(torch.zeros(2, 128),) * 2)
    assert launches() == {}


def test_n2m_collapsed_call_counts_every_pair(launches):
    """``Convolver.process`` of 3 inputs into 4 outputs on the Zero preset,
    IRs of 80 000 taps (9 partitions of the 16384 section, so the collapsed
    engine runs K1 -> K7 -> K4), a block of two 8192-sample hops: each of
    the 12 pairs transforms its 2 frames of 16384 forward (K1) and back (K4),
    and the refreshed sections' 3 frames of 256 and 1024 (K10) and of 4096
    (K1); the inputs are transformed once a pair, not once."""
    pairs = 12
    conv = Convolver(3, 4, latency=LatencyMode.Zero, max_length=80000, device=META)
    conv.set_all(np.zeros((4, 3, 80000)))
    conv.prepare(backend="pallas")
    state = conv.init_state()
    assert state.sections[-1].ring.re.shape == (4, 3, 9, 8192)
    for fn in (hf.rfft_packed, hf.rfft_small):  # the IR's spectra, prepared above
        fn.launches = fn.points = 0
    _, y = conv.process(state, _m(3, 16384), backend="pallas")
    assert y.shape == (4, 16384)
    assert launches() == {
        "rfft_packed": (2, pairs * (2 * 16384 + 3 * 4096)),
        "rfft_small": (2, pairs * 3 * (256 + 1024)),
        "lag_mac_ring": (1, None),
        "rifft_packed_tail": (1, pairs * 2 * 16384),
    }


def test_process_any_counts_each_firing(launches):
    """``process_any`` of 2 channels, a 2100-sample callback from phase 0:
    the 256 section fires 16 times and the 1024 section 4 times on K9 (a
    forward and an inverse each), the 4096 section once on K1 and K6."""
    conv = Convolver(2, latency=LatencyMode.Zero, max_length=20000, device=META)
    conv.set_all(np.zeros((2, 20000)))
    conv.prepare(backend="pallas")
    state = conv.init_stream_state()
    for fn in (hf.rfft_packed, hf.rfft_small):
        fn.launches = fn.points = 0
    _, y = conv.process_any(state, _m(2, 2100), backend="pallas")
    assert y.shape == (2, 2100)
    assert launches() == {
        "hop_fire": (20, 2 * 2 * (16 * 256 + 4 * 1024)),
        "rfft_packed": (1, 2 * 4096),
        "rifft_packed": (1, 2 * 4096),
    }
