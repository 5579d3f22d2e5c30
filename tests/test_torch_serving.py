"""Port parity: the serving loop (utils/serving.py StreamingServer) and its
swap cell, against the JAX package's server and float64 oracles.

Reference semantics under test (MonoConvolve.cpp:179-201, 118-140;
MemorySwap.h:174-212): the audio thread never blocks — it emits silence for
exactly the blocks during which the loader holds the IR lock; a completed
swap resets the engine state; capacity grows by doubling. The twins of
``tests/test_serving.py``'s seven cases, each with the JAX server fed the
same IRs and the same ragged callbacks where it has an output to compare.

Tolerances: >= 110 dB SNR against the JAX server in float32 (transforms and
sums in another order), > 90 dB against a float64 convolution (the JAX
test's bar), bit-equal to ``mono.process_any`` driven directly on the
capacity-padded IR (the server adds no arithmetic).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.models.mono import PartitionScheme as JScheme  # noqa: E402
from hisstools_library_tpu.utils.serving import StreamingServer as JServer  # noqa: E402
from hisstools_library_tpu_torch.models import mono  # noqa: E402
from hisstools_library_tpu_torch.models.mono import PartitionScheme  # noqa: E402
from hisstools_library_tpu_torch.utils import native_rt  # noqa: E402
from hisstools_library_tpu_torch.utils.serving import StreamingServer  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_JAX_DB = 110.0
SNR_F64_DB = 90.0
SIZES = (32, 64)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def make_server(channels=2, native=None):
    return StreamingServer(channels, capacity=256,
                           scheme=PartitionScheme(SIZES, True),
                           dtype=torch.float32, native=native, device=CPU)


def make_jax_server(channels=2):
    return JServer(channels, capacity=256, scheme=JScheme(SIZES, True),
                   dtype=jnp.float32)


def _stream(srv, x, cuts):
    outs = []
    i = 0
    for b in cuts:
        y, live = srv.process(x[:, i:i + b])
        assert live
        outs.append(np.asarray(y))
        i += b
    return np.concatenate(outs, axis=-1)


def test_serving_basic_parity(rng):
    srv, jsrv = make_server(), make_jax_server()
    irs = rng.standard_normal((2, 200)).astype(np.float32)
    srv.set_ir(irs)
    jsrv.set_ir(irs)
    x = rng.standard_normal((2, 600)).astype(np.float32)
    cuts = [64, 480, 33, 23]
    y = _stream(srv, x, cuts)
    yj = _stream(jsrv, x, cuts)
    for c in range(2):
        ref = np.convolve(x[c].astype(np.float64), irs[c].astype(np.float64))[:600]
        assert snr_db(ref, y[c]) > SNR_F64_DB
        assert snr_db(yj[c], y[c]) >= SNR_JAX_DB


def test_serving_swap_resets_and_uses_new_ir(rng):
    srv, jsrv = make_server(), make_jax_server()
    ir1 = rng.standard_normal((2, 150)).astype(np.float32)
    ir2 = rng.standard_normal((2, 220)).astype(np.float32)
    x1 = rng.standard_normal((2, 256)).astype(np.float32)
    x2 = rng.standard_normal((2, 256)).astype(np.float32)
    outs = {}
    for name, s in (("port", srv), ("jax", jsrv)):
        s.set_ir(ir1)
        y1, live = s.process(x1)
        assert live
        # Swap mid-stream; state resets, so post-swap output is the
        # convolution of ONLY the post-swap samples with the new IR.
        s.set_ir(ir2)
        y2, live = s.process(x2)
        assert live
        outs[name] = (np.asarray(y1), np.asarray(y2))
    for c in range(2):
        ref1 = np.convolve(x1[c].astype(np.float64), ir1[c].astype(np.float64))[:256]
        ref2 = np.convolve(x2[c].astype(np.float64), ir2[c].astype(np.float64))[:256]
        assert snr_db(ref1, outs["port"][0][c]) > SNR_F64_DB
        assert snr_db(ref2, outs["port"][1][c]) > SNR_F64_DB
        for k in range(2):
            assert snr_db(outs["jax"][k][c], outs["port"][k][c]) >= SNR_JAX_DB


@pytest.mark.parametrize("native", [False, True])
def test_serving_silence_while_locked(rng, native):
    if native and not native_rt.available():
        pytest.skip("native runtime unavailable (no g++)")
    srv = make_server(native=native)
    irs = rng.standard_normal((2, 100)).astype(np.float32)
    srv.set_ir(irs)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    y, live = srv.process(x)
    assert live and torch.isfinite(y).all()

    # Loader holds the lock: the audio thread must get silence, not block.
    handle = srv._swap.access()
    t0 = time.monotonic()
    y, live = srv.process(x)
    dt = time.monotonic() - t0
    handle.release()
    assert not live
    assert np.array_equal(np.asarray(y), np.zeros_like(x))
    assert dt < 0.1  # non-blocking

    # Stream resumes after release (same IR version -> state kept).
    y, live = srv.process(x)
    assert live


def test_serving_threaded_swap_smoke(rng):
    """Loader thread swaps IRs while the audio thread streams: no deadlock,
    every live block is finite, every silent block is zeros, every swap
    lands."""
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 100)).astype(np.float32))
    banks = [rng.standard_normal((2, 120)).astype(np.float32) for _ in range(3)]
    stop = threading.Event()
    versions = []

    def loader():
        for bank in banks:
            versions.append(srv.set_ir(bank))
            time.sleep(0.01)
        stop.set()

    th = threading.Thread(target=loader)
    th.start()
    x = rng.standard_normal((2, 64)).astype(np.float32)
    lives = []
    while not stop.is_set():
        y, live = srv.process(x)
        lives.append(live)
        assert torch.isfinite(y).all()
        if not live:
            assert not y.any()
    th.join(timeout=30)
    assert not th.is_alive()
    assert versions == [2, 3, 4]
    assert any(lives)


def test_serving_capacity_zero_does_not_hang(rng):
    """capacity=0 must not loop forever (0 * 2 == 0) in the grow loop."""
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 100)).astype(np.float32), capacity=0)
    assert srv.capacity >= 100


def test_serving_capacity_growth(rng):
    srv, jsrv = make_server(), make_jax_server()
    for s in (srv, jsrv):
        s.set_ir(rng.standard_normal((2, 100)).astype(np.float32))
        assert s.capacity == 256
    big = rng.standard_normal((2, 700)).astype(np.float32)
    srv.set_ir(big)
    jsrv.set_ir(big)
    assert srv.capacity == jsrv.capacity == 1024  # doubled past the length
    x = rng.standard_normal((2, 128)).astype(np.float32)
    y, live = srv.process(x)
    yj, _ = jsrv.process(x)
    assert live and torch.isfinite(y).all()
    assert snr_db(np.asarray(yj), y) >= SNR_JAX_DB


def test_locked_block_silence_keeps_server_dtype(rng):
    """Blocks emitted while the loader holds the lock are silence in the
    SERVER's dtype — a float64 numpy callback block must not flip the output
    stream's dtype on swap boundaries."""
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 64)).astype(np.float32))
    blk64 = np.zeros((2, 64), np.float64)
    y_live, live = srv.process(blk64)
    assert live and y_live.dtype == torch.float32
    h = srv._swap.access()  # loader holds the cell -> audio path sees locked
    try:
        y_locked, live = srv.process(blk64)
    finally:
        h.release()
    assert not live
    assert y_locked.dtype == torch.float32
    assert not y_locked.any()


def test_serving_equals_process_any_on_padded_ir(rng):
    """The server adds no arithmetic: its output is bit-equal to
    ``mono.process_any`` on the capacity-padded IR, from a fresh state,
    with the same ragged callbacks (numpy blocks of the callback's
    (frames, channels) layout, transposed, as an audio-file reader gives
    them)."""
    srv = make_server()
    irs = rng.standard_normal((2, 300)).astype(np.float32)
    srv.set_ir(irs)
    padded = np.zeros((2, srv.capacity), np.float32)
    padded[:, :300] = irs
    scheme = PartitionScheme(SIZES, True)
    mir = mono.prepare_ir(scheme, padded, offline_tail=False, device=CPU)
    state = mono.init_stream_state(scheme, mir, (2,))
    x = rng.standard_normal((700, 2)).astype(np.float32)
    i = 0
    for b in (17, 256, 1, 300, 126):
        y, live = srv.process(x[i:i + b].T)
        state, y_ref = mono.process_any(mir, state, torch.from_numpy(x[i:i + b].T.copy()))
        assert live
        assert torch.equal(y, y_ref)
        i += b
