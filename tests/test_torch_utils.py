"""Port parity: the hot-swap cell (utils/memory_swap.py), its native runtime
(utils/native_rt.py, built from native/rt_runtime.cpp into the port's own
build directory) and profiling (utils/profiling.py).

The twins of ``tests/test_utils.py``'s MemorySwap cases and of
``tests/test_native_rt.py``: lock discipline, swap-cell consistency under
two-thread hammering, SPSC ring integrity and a duplex audio-callback host
loop with underrun accounting. Besides: ``Roofline`` / ``convolve_roofline``
equal the JAX package's numbers, ``trace`` writes a Chrome trace on the CPU,
``sync`` is a no-op for CPU tensors, the port's ``utils`` and ``io`` export
every public name of their JAX twins, and no file of the port imports
``jax`` or ``hisstools_library_tpu`` (an AST check).
"""

import ast
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hisstools_library_tpu.io as jio  # noqa: E402
import hisstools_library_tpu.utils as jutils  # noqa: E402
from hisstools_library_tpu.utils import profiling as jprof  # noqa: E402
import hisstools_library_tpu_torch as port  # noqa: E402
import hisstools_library_tpu_torch.io as tio  # noqa: E402
import hisstools_library_tpu_torch.utils as tutils  # noqa: E402
from hisstools_library_tpu_torch import _native  # noqa: E402
from hisstools_library_tpu_torch.utils import MemorySwap, native_rt, profiling  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "hisstools_library_tpu"
PORT_PKG = REPO / "hisstools_library_tpu_torch"


@pytest.fixture
def rt():
    if not native_rt.available():
        pytest.skip("native runtime unavailable (no g++)")
    return native_rt


# -- MemorySwap ------------------------------------------------------------------

def test_attempt_nonblocking_while_held():
    ms = MemorySwap(value=np.zeros(4), size=4)
    h = ms.access()
    assert h.valid()
    h2 = ms.attempt()
    assert not h2.valid()  # audio thread never blocks
    h.release()
    h3 = ms.attempt()
    assert h3.valid() and h3.get_size() == 4
    h3.release()


def test_swap_and_grow():
    freed = []
    ms = MemorySwap(value="old", size=2, free=freed.append)
    with ms.swap("new", 5) as h:
        assert h.get() == "new" and h.get_size() == 5
    assert freed == ["old"]
    with ms.grow(lambda n: f"alloc{n}", 3) as h:
        assert h.get() == "new"  # 5 >= 3: no realloc
    with ms.grow(lambda n: f"alloc{n}", 9) as h:
        assert h.get() == "alloc9" and h.get_size() == 9
    assert freed == ["old", "new"]


def test_loader_vs_audio_thread():
    ms = MemorySwap(value=np.zeros(16), size=16)
    stop = threading.Event()
    hits = [0]

    def audio():
        while not stop.is_set():
            h = ms.attempt()
            if h.valid():
                _ = h.get().sum()
                hits[0] += 1
                h.release()

    at = threading.Thread(target=audio)
    at.start()
    for i in range(50):
        with ms.swap(np.full(16, float(i)), 16):
            time.sleep(0.0002)
    stop.set()
    at.join(timeout=10)
    assert not at.is_alive()
    assert hits[0] > 0  # audio thread made progress
    with ms.access() as h:
        assert h.get()[0] == 49.0


def test_equal_exact_size_semantics():
    """equal() reallocates on ANY size mismatch including shrinks
    (std::not_equal_to, MemorySwap.h:209-212); grow() only grows
    (std::greater, :204-207)."""
    freed = []
    ms = MemorySwap(value="v8", size=8, free=freed.append)
    with ms.equal(lambda n: f"alloc{n}", 8) as h:
        assert h.get() == "v8" and h.get_size() == 8  # exact: no realloc
    with ms.equal(lambda n: f"alloc{n}", 4) as h:  # shrink: must realloc
        assert h.get() == "alloc4" and h.get_size() == 4
    assert freed == ["v8"]
    with ms.grow(lambda n: f"alloc{n}", 2) as h:  # grow never shrinks
        assert h.get() == "alloc4" and h.get_size() == 4
    with ms.grow(lambda n: f"alloc{n}", 16) as h:
        assert h.get() == "alloc16" and h.get_size() == 16
    h = ms.access()  # Handle variants under a held lock behave identically
    h.equal(lambda n: f"h{n}", 6)
    assert h.get() == "h6" and h.get_size() == 6
    h.grow(lambda n: f"h{n}", 3)
    assert h.get_size() == 6
    h.release()


# -- native runtime ----------------------------------------------------------------

def test_native_builds_into_port_build_dir(rt):
    path = _native.library_path("rt_runtime.cpp", ("-pthread",))
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert rt.load().ht_rt_version() >= 1


def test_spinlock_attempt_and_release(rt):
    lk = rt.NativeSpinLock()
    assert lk.attempt()
    assert not lk.attempt()          # held
    lk.release()
    assert lk.attempt()              # reacquirable
    lk.release()


def test_spinlock_blocking_acquire_across_threads(rt):
    lk = rt.NativeSpinLock()
    lk.acquire()
    acquired = threading.Event()

    def waiter():
        lk.acquire()                 # must block until the release below
        acquired.set()
        lk.release()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    assert not acquired.is_set()     # still blocked
    lk.release()
    t.join(timeout=5)
    assert acquired.is_set()


@pytest.mark.parametrize("cls", ["python", "native"])
def test_swap_interface_parity(cls, request):
    """The native cell honours the exact MemorySwap interface semantics."""
    sw = MemorySwap() if cls == "python" else request.getfixturevalue("rt").NativeMemorySwap()
    with sw.attempt() as h:
        assert h.get() is None and h.get_size() == 0
    sw.swap("first", 5).release()
    with sw.attempt() as h:
        assert h.get() == "first" and h.get_size() == 5
    h = sw.equal(lambda n: f"alloc{n}", 5)
    assert h.get() == "first"
    h.release()
    h = sw.equal(lambda n: f"alloc{n}", 3)
    assert h.get() == "alloc3" and h.get_size() == 3
    h.release()
    h = sw.equal(lambda n: f"alloc{n}", 9)
    assert h.get() == "alloc9" and h.get_size() == 9
    h.release()
    h = sw.grow(lambda n: f"grown{n}", 4)
    assert h.get() == "alloc9" and h.get_size() == 9
    h.release()
    h = sw.grow(lambda n: f"grown{n}", 12)
    assert h.get() == "grown12" and h.get_size() == 12
    h.release()
    sw.clear()
    with sw.attempt() as h:
        assert h.get() is None


def test_swap_attempt_fails_while_loader_holds(rt):
    sw = rt.NativeMemorySwap("ir", 1)
    h = sw.access()                  # loader side holds the cell
    audio = sw.attempt()
    assert not audio.valid() and audio.get() is None   # silence path
    h.release()
    with sw.attempt() as h2:
        assert h2.get() == "ir"


def test_swap_two_thread_hammer(rt):
    """Audio thread attempt()s while the loader swaps stamped pairs; every
    observed payload must be internally consistent (value == size stamp)."""
    sw = rt.NativeMemorySwap()
    stop = threading.Event()
    bad = []

    def audio():
        while not stop.is_set():
            with sw.attempt() as h:
                v = h.get()
                if v is not None and (v[0] != v[1] or h.get_size() != v[0]):
                    bad.append((v, h.get_size()))

    t = threading.Thread(target=audio)
    t.start()
    for i in range(1, 3001):
        sw.swap((i, i), i).release()
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not bad


def test_ring_sequence_integrity_across_threads(rt):
    """SPSC ring: a produced counter sequence arrives intact through random
    partial writes/reads from two threads."""
    ring = rt.Ring(1 << 12)
    n = 200_000
    seq = np.arange(n, dtype=np.float32)
    rng = np.random.RandomState(7)

    def producer():
        pos = 0
        while pos < n:
            k = int(rng.randint(1, 4096))
            pos += ring.write(seq[pos:pos + k])

    out = np.empty(n, np.float32)
    t = threading.Thread(target=producer)
    t.start()
    got = 0
    deadline = time.time() + 30
    rng2 = np.random.RandomState(8)
    while got < n and time.time() < deadline:
        chunk = ring.read(int(rng2.randint(1, 4096)))
        out[got:got + chunk.size] = chunk
        got += chunk.size
    t.join(timeout=10)
    assert got == n
    np.testing.assert_array_equal(out, seq)


def test_ring_capacity_and_backpressure(rt):
    ring = rt.Ring(100)              # rounds up to 128
    assert ring.capacity() == 128
    data = np.ones(200, np.float32)
    assert ring.write(data) == 128   # partial write at capacity
    assert ring.writable() == 0
    assert ring.discard(28) == 28
    assert ring.write(data) == 28


def test_audio_host_duplex_loop(rt):
    """Native host produces capture blocks and drains playback blocks at
    48 kHz cadence; a Python worker applies a gain. The played audio must be
    the gained source, with no overruns and scheduler-jitter underruns only."""
    fpb, ch, nblocks, warmup = 512, 2, 48, 3
    bf = fpb * ch
    in_ring, out_ring = rt.Ring(1 << 16), rt.Ring(1 << 16)
    src = np.random.RandomState(0).randn(bf * 8).astype(np.float32)
    host = rt.AudioHost(in_ring, out_ring, src, fpb, ch, 48000.0,
                        nblocks, warmup_blocks=warmup)
    done = 0
    t0 = time.time()
    while done < nblocks and time.time() - t0 < 20:
        blk = in_ring.read(bf)
        if blk.size < bf:
            time.sleep(0.0002)
            continue
        out_ring.write(blk * 0.5)
        done += 1
    stats = host.join()
    assert stats["blocks"] == nblocks
    assert stats["overruns"] == 0
    assert stats["underruns"] <= 3   # scheduler-jitter tolerance
    if stats["underruns"]:
        return  # a mid-stream zero-fill shifts alignment; content check n/a
    played = host.played.ravel()
    exp = np.concatenate([src] * ((nblocks * bf) // src.size + 2))
    for delay in range(4):
        cand = 0.5 * exp[:nblocks * bf]
        seg_p = played[(warmup + delay) * bf:(warmup + delay + 4) * bf]
        seg_e = cand[warmup * bf:(warmup + 4) * bf]
        if seg_p.size == seg_e.size and np.allclose(seg_p, seg_e, atol=1e-6):
            break
    else:
        raise AssertionError("played stream never aligned with gained source")


def test_audio_host_counts_underruns_when_worker_stalls(rt):
    """No worker at all: every post-warmup playback block underruns."""
    fpb, ch, nblocks, warmup = 128, 1, 10, 2
    in_ring, out_ring = rt.Ring(1 << 14), rt.Ring(1 << 14)
    src = np.zeros(fpb * 4, np.float32)
    host = rt.AudioHost(in_ring, out_ring, src, fpb, ch, 48000.0,
                        nblocks, warmup_blocks=warmup, capture=False)
    deadline = time.time() + 20
    while not host.done() and time.time() < deadline:
        time.sleep(0.005)
    stats = host.join()
    assert stats["blocks"] == nblocks
    assert stats["underruns"] == nblocks - warmup


# -- profiling -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 65536, 4096, 8), (128, 483328, 65536, 15),
                                   (3, 1000, 256, 1)])
def test_roofline_matches_jax(shape):
    a, b = profiling.convolve_roofline(*shape), jprof.convolve_roofline(*shape)
    assert a.flops == b.flops and a.bytes == b.bytes
    for peaks in ((profiling.H100_SXM_PEAK_FLOPS_F32, profiling.H100_SXM_PEAK_BW),
                  (1e12, 1e9)):
        assert a.time_bound(*peaks) == b.time_bound(*peaks)
        assert a.fraction_of_peak(1e-3, *peaks) == b.fraction_of_peak(1e-3, *peaks)
    assert profiling.Roofline(3.0, 5.0) == profiling.Roofline(3.0, 5.0)


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.fft.rfft(torch.randn(4, 1024)).abs().sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    assert prof.key_averages()


def test_sync_timer_and_build_dir():
    x = torch.ones(3)
    profiling.sync({"b": [x], "a": None})  # CPU tensors: nothing to wait for
    profiling.sync(3)                       # no tensor leaf at all
    t = profiling.Timer()
    t.start()
    assert t.stop(x) >= 0.0 and t.best == t.mean
    from hisstools_library_tpu_torch import _build
    assert profiling.enable_compile_cache() == str(_build.BUILD_DIR)


# -- the public surface and the port's imports ------------------------------------------

def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")} - {"annotations"}


def _defs(path: Path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


@pytest.mark.parametrize("pkg", ["utils", "io"])
def test_packages_export_jax_names(pkg):
    jax_mod, port_mod = (jutils, tutils) if pkg == "utils" else (jio, tio)
    jax_names = {n for n in _public(jax_mod) if not (JAX_PKG / pkg / f"{n}.py").exists()}
    assert jax_names <= _public(port_mod)
    for f in sorted((JAX_PKG / pkg).glob("*.py")):
        twin = PORT_PKG / pkg / f.name
        assert twin.exists(), twin
        assert _defs(f) <= _defs(twin), f.name


def test_port_imports_no_jax():
    bad = []
    for f in sorted(PORT_PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "hisstools_library_tpu")]
    assert not bad
    assert os.path.basename(port.__file__) == "__init__.py"
