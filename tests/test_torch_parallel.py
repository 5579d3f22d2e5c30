"""Port parity: ``parallel`` (meshes, halos, the sharded scheme, N-to-mono,
channel-parallel streaming) on CPU ranks over gloo.

The twin, case for case, of ``tests/test_parallel.py``: the same inputs (the
tests' seed, drawn in the same order), meshes and bars. One spawn of 8 ranks
(``parallel.launch.run``) runs every case (``torch_parallel_cases``, which
imports no jax) in a module fixture; each test then reads its case. Each is
also held against the JAX package on the same numpy inputs: the sharded
offline and halo cases against the JAX sharded functions (jitted, at the
JAX tests' meshes), the streaming cases against the JAX single-device
``mono.process`` / ``process_any`` (the JAX test shows its sharded engine
equals those).

Tolerances: the JAX tests' own bars against their oracles (> 180 dB
against ``np.convolve`` and > 250 dB against the single-rank engine in
float64, > 90 dB for the fused section, > 100 dB for mesh invariance, >
110 dB for streaming, bit-identical for sample-granular streaming against
the port's single-rank run); against the JAX package >= 250 dB in float64
and >= 110 dB in float32 (sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402
from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models.mono import PartitionScheme as JScheme  # noqa: E402
from hisstools_library_tpu.parallel import (  # noqa: E402
    BLOCK_AXIS as JBLOCK, left_halo as jleft_halo, make_mesh as jmake_mesh,
    n_to_one_offline as jn_to_one, scheme_offline_sharded as jscheme_offline,
    shift_from_left as jshift)
from hisstools_library_tpu_torch import parallel  # noqa: E402
from hisstools_library_tpu_torch.parallel import launch  # noqa: E402

SEED = 0x1557
WORLD = 8
SNR_F64_JAX_DB = 250.0
SNR_F32_JAX_DB = 110.0
JSCHEME = JScheme((32, 128), zero_latency=True)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _inputs() -> dict:
    """Each case's inputs, drawn from a fresh generator as the JAX test's
    ``rng`` fixture gives them."""
    inp = {}
    f32 = np.float32
    rng = np.random.default_rng(SEED)
    inp["scheme_single"] = dict(x=rng.standard_normal((8, 512)),
                                irs=rng.standard_normal((8, 300)))
    rng = np.random.default_rng(SEED)
    inp["scheme_engine"] = dict(x=rng.standard_normal((4, 512)),
                                irs=rng.standard_normal((4, 256)))
    rng = np.random.default_rng(SEED)
    inp["n_to_one"] = dict(x=rng.standard_normal((4, 384)), irs=rng.standard_normal((4, 200)))
    rng = np.random.default_rng(SEED)
    inp["long_ir"] = dict(x=rng.standard_normal(256), irs=rng.standard_normal(480))
    rng = np.random.default_rng(SEED)
    inp["fused"] = dict(x=rng.standard_normal((4, 2048 * 8)).astype(f32),
                        irs=(rng.standard_normal((4, 3 * 2048 + 100)) * 0.2).astype(f32))
    rng = np.random.default_rng(SEED)
    inp["sharded_twice"] = dict(irs=(rng.standard_normal((4, 5000)) * 0.2).astype(f32),
                                x=rng.standard_normal((4, 2048 * 8)).astype(f32))
    rng = np.random.default_rng(SEED)
    inp["invariance"] = dict(x=rng.standard_normal((8, 2048)).astype(f32),
                             irs=(rng.standard_normal((8, 1000)) * 0.2).astype(f32))
    rng = np.random.default_rng(SEED)
    irs = (rng.standard_normal((8, 600)) * 0.3).astype(f32)
    inp["stream"] = dict(irs=irs, x1=rng.standard_normal((8, 256)).astype(f32),
                         x2=rng.standard_normal((8, 256)).astype(f32))
    rng = np.random.default_rng(SEED)
    irs = (rng.standard_normal((8, 600)) * 0.3).astype(f32)
    inp["any"] = dict(irs=irs, xs=[rng.standard_normal((8, b)).astype(f32)
                                   for b in (37, 100, 1, 64, 333)])
    return inp


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    return inp, launch.run(WORLD, cases.parallel_cases, inp)[0]


def _jax_offline(mesh_shape, scheme, c, dtype=jnp.float64, backend=None, fn=jscheme_offline,
                 offline_tail=True):
    mesh = jmake_mesh(channel=mesh_shape[0], block=mesh_shape[1])
    ir = jmono.prepare_ir(scheme, c["irs"], dtype=dtype, offline_tail=offline_tail)
    x = jnp.asarray(c["x"] if c["x"].ndim == 2 else c["x"][None, :])
    return np.asarray(jax.jit(lambda i, xx: fn(mesh, scheme, i, xx, backend=backend))(ir, x))


def test_exports_the_jax_names():
    import inspect

    import hisstools_library_tpu.parallel as jpar
    names = {n for n, v in vars(jpar).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert len(names) == 18 and names <= set(vars(parallel))


def test_mesh_shapes(ranks):
    _, out = ranks
    assert out["mesh_4x2"] == {"channel": 4, "block": 2}
    assert out["mesh_default"]["channel"] == WORLD


def test_shift_from_left(ranks):
    _, out = ranks
    assert np.allclose(out["shift"].ravel(), [0, 0, 1, 2, 3, 4, 5, 6])
    mesh = jmake_mesh(channel=1, block=8)
    y = jax.shard_map(lambda xl: jshift(xl, JBLOCK), mesh=mesh, in_specs=P(JBLOCK, None),
                      out_specs=P(JBLOCK, None))(jnp.arange(8.0).reshape(8, 1))
    np.testing.assert_array_equal(out["shift"], np.asarray(y))


@pytest.mark.parametrize("halo", [3, 16, 40])
def test_left_halo_reconstructs(ranks, halo):
    _, out = ranks
    y = out[f"halo_{halo}"]
    loc = 64 // 4
    for d in range(4):
        start = d * loc
        ref = np.concatenate([np.zeros(max(0, halo - start)),
                              np.arange(float(max(0, start - halo)), start),
                              np.arange(float(start), start + loc)])[-(halo + loc):]
        assert np.allclose(y[d], ref), d
    mesh = jmake_mesh(channel=1, block=4)
    yj = jax.shard_map(lambda xl: jleft_halo(xl, halo, axis=0, axis_name=JBLOCK), mesh=mesh,
                       in_specs=P(JBLOCK), out_specs=P(JBLOCK))(jnp.arange(64.0))
    np.testing.assert_array_equal(y, np.asarray(yj).reshape(4, -1))


def test_sharded_scheme_matches_single_device(ranks):
    inp, out = ranks
    c = inp["scheme_single"]
    y = out["scheme_single"]
    assert out["scheme_single_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    for ch in range(8):
        ref = np.convolve(c["x"][ch], c["irs"][ch])[:512]
        assert snr_db(ref, y[ch]) > 180, ch
    assert snr_db(_jax_offline((4, 2), JSCHEME, c), y) >= SNR_F64_JAX_DB


def test_sharded_matches_offline_engine(ranks):
    inp, out = ranks
    assert snr_db(out["scheme_engine_single"], out["scheme_engine"]) > 250
    jax_y = _jax_offline((2, 4), JSCHEME, inp["scheme_engine"])
    assert snr_db(jax_y, out["scheme_engine"]) >= SNR_F64_JAX_DB


def test_n_to_one_psum(ranks):
    inp, out = ranks
    c = inp["n_to_one"]
    ref = sum(np.convolve(c["x"][i], c["irs"][i])[:384] for i in range(4))
    assert out["n_to_one"].shape == (384,)
    assert out["n_to_one_placements"] == ["Replicate()", "Shard(dim=0)"]
    assert snr_db(ref, out["n_to_one"]) > 180
    assert snr_db(_jax_offline((4, 2), JSCHEME, c, fn=jn_to_one),
                  out["n_to_one"]) >= SNR_F64_JAX_DB


def test_long_ir_halo_beyond_one_device(ranks):
    inp, out = ranks
    c = inp["long_ir"]
    ref = np.convolve(c["x"], c["irs"])[:256]
    assert snr_db(ref, out["long_ir"][0]) > 180
    jax_y = _jax_offline((1, 8), JScheme((32,), zero_latency=True), c)
    assert snr_db(jax_y, out["long_ir"]) >= SNR_F64_JAX_DB


def test_sharded_pallas_fused_matches_single_device(ranks):
    """backend="pallas": the fused K2 -> K15 (lead_skip 1) -> K4 section per
    shard (their plain versions on the CPU) == the single-rank engine."""
    inp, out = ranks
    assert snr_db(out["fused_single"], out["fused"]) > 90.0
    jax_y = _jax_offline((2, 4), JScheme((4096,), zero_latency=False), inp["fused"],
                         dtype=jnp.float32, backend="pallas")
    assert snr_db(jax_y, out["fused"]) >= SNR_F32_JAX_DB


def test_sharded_bitwise_reproducible(ranks):
    """The twin of tests/test_determinism.py's sharded case: the fused
    section on a 2 x 4 mesh, called twice, gives the same bits (a uint32
    view), and matches the JAX sharded function on the same inputs."""
    inp, out = ranks
    y1, y2 = out["sharded_twice"]
    assert y1.dtype == np.float32
    assert np.array_equal(y1.view(np.uint32), y2.view(np.uint32))
    jax_y = _jax_offline((2, 4), JScheme((4096,), zero_latency=False), inp["sharded_twice"],
                         dtype=jnp.float32, backend="pallas", offline_tail=False)
    assert snr_db(jax_y, y1) >= SNR_F32_JAX_DB


def test_mesh_shape_invariance(ranks):
    inp, out = ranks
    y_ref = out["invariance_single"]
    scheme = JScheme((512,), zero_latency=False)
    for ch, blk in ((8, 1), (4, 2), (2, 4), (1, 8)):
        y = out[f"invariance_{ch}x{blk}"]
        assert snr_db(y_ref, y) > 100.0, (ch, blk)
        jax_y = _jax_offline((ch, blk), scheme, inp["invariance"], dtype=jnp.float32,
                             offline_tail=False)
        assert snr_db(jax_y, y) >= SNR_F32_JAX_DB, (ch, blk)


def test_sharded_streaming_channel_parallel(ranks):
    """Two channel-parallel calls with the state carried (as DTensors) ==
    the single-rank engine, bit for bit, and the JAX engine at > 110 dB."""
    inp, out = ranks
    c = inp["stream"]
    assert out["stream_state_is_dtensor"]
    for got, want in zip(out["stream"], out["stream_single"]):
        np.testing.assert_array_equal(got, want)
    scheme = JScheme((64, 256), zero_latency=True)
    ir = jmono.prepare_ir(scheme, c["irs"], offline_tail=False)
    s_ref = jmono.init_state(scheme, ir, batch_shape=(8,))
    s_ref, ya_ref = jmono.process(ir, s_ref, jnp.asarray(c["x1"]))
    _, yb_ref = jmono.process(ir, s_ref, jnp.asarray(c["x2"]))
    assert snr_db(np.asarray(ya_ref, np.float64), out["stream"][0]) > 110.0
    assert snr_db(np.asarray(yb_ref, np.float64), out["stream"][1]) > 110.0


def test_make_mesh_rejects_non_dividing_inference(ranks):
    """Inferring the other axis from a non-dividing factor would silently
    idle ranks (block=3 on 8 ranks -> 2x3, 2 idle)."""
    _, out = ranks
    assert out["reject_block3"].startswith("ValueError: block=3 does not divide 8")
    assert out["reject_channel5"].startswith("ValueError: channel=5 does not divide 8")
    assert out["mesh_block2_ranks"] == WORLD


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(device_type="cpu")


def test_sharded_streaming_sample_granular(ranks):
    """Sample-granular streaming under the channel mesh is bit-identical to
    the port's single-rank ``process_any`` over a ragged callback sequence,
    and holds > 110 dB against the JAX engine's."""
    inp, out = ranks
    c = inp["any"]
    for got, want in zip(out["any"], out["any_single"]):
        np.testing.assert_array_equal(got, want)
    scheme = JScheme((64, 256), zero_latency=True)
    ir = jmono.prepare_ir(scheme, c["irs"], offline_tail=False)
    s_ref = jmono.init_stream_state(scheme, ir, batch_shape=(8,))
    for x, got in zip(c["xs"], out["any"]):
        s_ref, y = jmono.process_any(ir, s_ref, jnp.asarray(x))
        assert snr_db(np.asarray(y, np.float64), got) > 110.0


def test_dryrun_multichip(ranks):
    """The dry run's body on 8 ranks: a 2 x 4 mesh, every part within 1e-3
    of the single-rank engine, two-tier streaming exact."""
    _, out = ranks
    d = out["dryrun"]
    assert d["mesh"] == (2, 4)
    for key in ("offline", "n_to_one", "fused", "two_tier", "rfft_roundtrip"):
        assert d[key] < 1e-3, key
