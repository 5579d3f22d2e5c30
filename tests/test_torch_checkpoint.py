"""Port parity: durable checkpoint/resume (utils/checkpoint.py), the twin of
``tests/test_checkpoint.py``, plus the crossings with the JAX package.

A stream stops, checkpoints to disk (``save``: ``torch.save`` written to a
temporary name and moved into place; ``save_npz``: the JAX twin's format),
restores into freshly built exemplars and continues bit-exactly. The port's
states are dataclasses, flattened in the JAX twin's ``tree_flatten`` order,
so an ``.npz`` crosses between the packages in both directions:

- a JAX ``save_npz`` restored by the port's ``restore_npz`` equals
  ``from_numpy`` of the same state, bit for bit, and the reverse;
- a JAX stream continued in the port from such a file matches the JAX
  continuation at >= 110 dB SNR in float32 (transforms and sums in another
  order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.utils import checkpoint as jckpt  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.models import mono  # noqa: E402
from hisstools_library_tpu_torch.models import partial_tracker as pt  # noqa: E402
from hisstools_library_tpu_torch.models import partitioned as part  # noqa: E402
from hisstools_library_tpu_torch.models.mono import PartitionScheme  # noqa: E402
from hisstools_library_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_JAX_DB = 110.0
SCHEME = PartitionScheme((32, 128), zero_latency=True)
JSCHEME = jmono.PartitionScheme((32, 128), zero_latency=True)
FORMATS = ["torch", "npz"]


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _save(fmt, path, state):
    if fmt == "torch":
        ckpt.save(path, state)
    else:
        ckpt.save_npz(path, state)


def _restore(fmt, path, like):
    return ckpt.restore(path, like) if fmt == "torch" else ckpt.restore_npz(path, like)


def _path(tmp_path, fmt):
    return str(tmp_path / ("ck.pt" if fmt == "torch" else "ck.npz"))


def _assert_same(a, b):
    """Two port trees with the same structure and bit-equal leaves."""
    la, lb = ckpt.leaves(a), ckpt.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _run(mir, state, x, hop, start, stop):
    outs = []
    for j in range(start, stop):
        state, y = mono.process(mir, state, torch.from_numpy(x[:, j * hop:(j + 1) * hop]))
        outs.append(y.numpy())
    return state, outs


@pytest.mark.parametrize("fmt", FORMATS)
def test_stream_checkpoint_resume_bitexact(tmp_path, rng, fmt):
    hop = 64
    C, T = 2, 10
    ir = rng.standard_normal((C, 700)).astype(np.float32)
    x = rng.standard_normal((C, T * hop)).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, offline_tail=False, device=CPU)

    # Uninterrupted reference stream.
    _, ref_outs = _run(mir, mono.init_state(SCHEME, mir, (C,)), x, hop, 0, T)

    # Stream 4 hops, checkpoint BOTH the state and the prepared IR, restore
    # into freshly built exemplars, continue.
    st, outs = _run(mir, mono.init_state(SCHEME, mir, (C,)), x, hop, 0, 4)
    path = _path(tmp_path, fmt)
    _save(fmt, path, {"state": st, "ir": mir})
    fresh = mono.prepare_ir(SCHEME, np.zeros_like(ir), offline_tail=False, device=CPU)
    exemplar = {"state": mono.init_state(SCHEME, fresh, (C,)), "ir": fresh}
    restored = _restore(fmt, path, exemplar)
    _, outs2 = _run(restored["ir"], restored["state"], x, hop, 4, T)

    np.testing.assert_array_equal(np.concatenate(outs + outs2, axis=-1),
                                  np.concatenate(ref_outs, axis=-1))


@pytest.mark.parametrize("fmt", FORMATS)
def test_leaf_count_mismatch_raises(tmp_path, rng, fmt):
    st = mono.init_state(
        SCHEME, mono.prepare_ir(SCHEME, rng.standard_normal(300), offline_tail=False,
                                device=CPU), ())
    path = _path(tmp_path, fmt)
    _save(fmt, path, st)
    with pytest.raises(ValueError):
        _restore(fmt, path, {"not": "the same tree"})


@pytest.mark.parametrize("fmt", FORMATS)
def test_python_scalar_leaves(tmp_path, fmt):
    """Python-scalar leaves (config values in a state dict) come back as the
    exemplar's Python type; a numpy leaf as numpy, a tensor leaf as a
    tensor in the exemplar's dtype."""
    state = {"gain": 0.5, "count": 3, "arr": np.arange(4), "t": torch.arange(3.0)}
    path = _path(tmp_path, fmt)
    _save(fmt, path, state)
    r = _restore(fmt, path, {"gain": 0.0, "count": 0, "arr": np.zeros(4, np.int64),
                             "t": torch.zeros(3, dtype=torch.float64)})
    assert r["gain"] == 0.5 and isinstance(r["gain"], float)
    assert r["count"] == 3 and isinstance(r["count"], int)
    assert isinstance(r["arr"], np.ndarray)
    np.testing.assert_array_equal(r["arr"], np.arange(4))
    assert r["t"].dtype == torch.float64 and torch.equal(r["t"], torch.arange(3.0).double())


def _states(rng):
    """One of every state type the port checkpoints, each advanced so its
    leaves are not zeros: (name, state, fresh exemplar)."""
    ir = (rng.standard_normal((2, 2000)) * 0.3).astype(np.float32)
    zero = PartitionScheme((32, 64, 128, 256), zero_latency=True)
    mir = mono.prepare_ir(zero, ir, offline_tail=True, device=CPU)
    fresh = mono.prepare_ir(zero, np.zeros_like(ir), offline_tail=True, device=CPU)
    x = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    st, _ = mono.process(mir, mono.init_state(zero, mir, (2,)), x[:, :256])
    ss, _ = mono.process_any(mir, mono.init_stream_state(zero, mir, (2,)), x[:, :77])
    bs, _ = mono.process(mir, mono.init_block_state(zero, mir, (2,)),
                         x[:, :mir.far.shape[-1]])
    eng = part.PartitionedConvolve(64)
    eng.set(ir[0], device=CPU)
    ps, _ = eng.process(eng.spectra, eng.init_state(), x[0, :96])
    sts, _ = eng.step_any(eng.spectra, eng.init_stream_state(), x[0, :45])
    tr = pt.TrackerState(torch.rand(4), torch.rand(4), torch.arange(4, dtype=torch.int32))
    return [
        ("MonoState", st, mono.init_state(zero, fresh, (2,))),
        ("MonoStreamState", ss, mono.init_stream_state(zero, fresh, (2,))),
        ("MonoBlockState", bs, mono.init_block_state(zero, fresh, (2,))),
        ("PartitionedState", ps, eng.init_state()),
        ("StreamState", sts, eng.init_stream_state()),
        ("MonoIR", mir, fresh),
        ("Split", mir.spectra[1], Split.zeros(mir.spectra[1].shape, device=CPU)),
        ("TrackerState", tr, pt.TrackerState.init(4, device=CPU)),
    ]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", ["MonoState", "MonoStreamState", "MonoBlockState",
                                  "PartitionedState", "StreamState", "MonoIR", "Split",
                                  "TrackerState"])
def test_round_trip_every_state_type(tmp_path, rng, fmt, kind):
    name, state, like = next(s for s in _states(rng) if s[0] == kind)
    path = _path(tmp_path, fmt)
    _save(fmt, path, state)
    _assert_same(_restore(fmt, path, like), state)


def _jax_stream(rng, offline_tail=False):
    """A JAX stream advanced by ragged callbacks, with its prepared IR, and
    the port's fresh exemplars of both."""
    ir = (rng.standard_normal((2, 700)) * 0.3).astype(np.float32)
    jmir = jmono.prepare_ir(JSCHEME, ir, dtype=jnp.float32, offline_tail=offline_tail)
    js = jmono.init_stream_state(JSCHEME, jmir, (2,), jnp.float32)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    for a, b in ((0, 45), (45, 301), (301, 400)):
        js, _ = jmono.process_any(jmir, js, jnp.asarray(x[:, a:b]))
    fresh = mono.prepare_ir(SCHEME, np.zeros_like(ir), offline_tail=offline_tail, device=CPU)
    like = {"ir": fresh, "state": mono.init_stream_state(SCHEME, fresh, (2,))}
    return {"ir": jmir, "state": js}, like, x


@pytest.mark.parametrize("offline_tail", [False, True])
def test_jax_npz_restores_in_port_bitexact(tmp_path, rng, offline_tail):
    jtree, like, _ = _jax_stream(rng, offline_tail)
    path = str(tmp_path / "j.npz")
    jckpt.save_npz(path, jtree)
    got = ckpt.restore_npz(path, like)
    expect = {"ir": mono.MonoIR.from_numpy(jtree["ir"], CPU),
              "state": mono.MonoStreamState.from_numpy(jtree["state"], CPU)}
    _assert_same(got, expect)
    assert got["ir"].tail_shift == expect["ir"].tail_shift  # from the exemplar


@pytest.mark.parametrize("offline_tail", [False, True])
def test_port_npz_restores_in_jax_bitexact(tmp_path, rng, offline_tail):
    jtree, like, x = _jax_stream(rng, offline_tail)
    port = {"ir": mono.MonoIR.from_numpy(jtree["ir"], CPU),
            "state": mono.MonoStreamState.from_numpy(jtree["state"], CPU)}
    port["state"], _ = mono.process_any(port["ir"], port["state"],
                                        torch.from_numpy(x[:, 400:517]))
    path = str(tmp_path / "p.npz")
    ckpt.save_npz(path, port)
    jlike = jtu.tree_map(jnp.zeros_like, jtree)
    got = jtu.tree_leaves(jckpt.restore_npz(path, jlike))
    want = ckpt.leaves(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if w.dtype.kind == "f":  # host-int counters take the exemplar's int32
            assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_jax_stream_continues_in_port(tmp_path, rng):
    jtree, like, x = _jax_stream(rng)
    path = str(tmp_path / "j.npz")
    jckpt.save_npz(path, jtree)
    restored = ckpt.restore_npz(path, like)
    js, tstate = jtree["state"], restored["state"]
    yj, yt = [], []
    for a, b in ((400, 431), (431, 700), (700, 1000)):
        js, y = jmono.process_any(jtree["ir"], js, jnp.asarray(x[:, a:b]))
        yj.append(np.asarray(y))
        tstate, y = mono.process_any(restored["ir"], tstate, torch.from_numpy(x[:, a:b]))
        yt.append(y.numpy())
    assert snr_db(np.concatenate(yj, -1), np.concatenate(yt, -1)) >= SNR_JAX_DB
