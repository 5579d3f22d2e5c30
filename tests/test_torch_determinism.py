"""Determinism of the port: same inputs -> bitwise-identical outputs.

The twin of ``tests/test_determinism.py``, guarantee for guarantee, on the
CPU (the kernels' plain versions; ``chip_smoke.py``'s determinism phase
holds the kernels themselves on the card, each launched twice with a
NaN-filled block handed back by the allocator in between):

- the fused offline chain (``FastFIR`` with ``backend="pallas"``) twice;
- the streaming scan twice from one fresh state (the port's states are
  values: a call never changes the state it was given);
- the sharded path twice: a case of ``tests/torch_parallel_cases.py``
  (``parallel_cases``' "sharded_twice"), read by
  ``tests/test_torch_parallel.py::test_sharded_bitwise_reproducible``, so
  its gloo ranks are spawned once per file;
- checkpoint resume bit-exact: ``tests/test_torch_checkpoint.py``
  (``test_stream_checkpoint_resume_bitexact`` and the npz crossings with the
  JAX package), not repeated here;
- accuracy does not drift over a long stream: 400 hops, the same bars as
  the JAX test (> 120 dB at both ends, within 15 dB of each other).

Bits are compared through a ``uint32`` view. Each output is also held
against the JAX package's on the same numpy inputs (the tests' seed, drawn
in the JAX tests' order) at >= 110 dB (float32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.models import mono as jmono  # noqa: E402
from hisstools_library_tpu.models.offline import FastFIR as JFastFIR  # noqa: E402
from hisstools_library_tpu_torch.models import mono  # noqa: E402
from hisstools_library_tpu_torch.models.mono import PartitionScheme  # noqa: E402
from hisstools_library_tpu_torch.models.offline import FastFIR  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU
SNR_JAX_DB = 110.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _bitwise_equal(a, b):
    a, b = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (a, b))
    return a.dtype == b.dtype == np.float32 and np.array_equal(a.view(np.uint32),
                                                               b.view(np.uint32))


def test_fused_offline_chain_bitwise_reproducible(rng):
    ir = (rng.standard_normal(9000) * 0.2).astype(np.float32)
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    eng = FastFIR(ir[None], fft_size=4096, backend="pallas", device=CPU)
    xt = torch.from_numpy(x)
    y1 = FastFIR.apply(eng.spectra, xt, backend="pallas")
    y2 = FastFIR.apply(eng.spectra, xt, backend="pallas")
    assert _bitwise_equal(y1, y2)
    jeng = JFastFIR(ir[None], fft_size=4096, backend="pallas")
    yj = jax.jit(lambda s, xx: JFastFIR.apply(s, xx, backend="pallas"))(
        jeng.spectra, jnp.asarray(x))
    assert snr_db(yj, y1) >= SNR_JAX_DB


def test_streaming_scan_bitwise_reproducible(rng):
    scheme = PartitionScheme((64, 256), zero_latency=True)
    blk = 128
    ir_np = (rng.standard_normal((2, 500)) * 0.3).astype(np.float32)
    ir = mono.prepare_ir(scheme, ir_np, offline_tail=False, device=CPU)
    x_np = rng.standard_normal((2, blk * 6)).astype(np.float32)
    x = torch.from_numpy(x_np)
    s0 = mono.init_state(scheme, ir, batch_shape=(2,))
    _, y1 = mono.process(ir, s0, x)
    _, y2 = mono.process(ir, s0, x)
    assert _bitwise_equal(y1, y2)
    jscheme = jmono.PartitionScheme((64, 256), zero_latency=True)
    jir = jmono.prepare_ir(jscheme, ir_np, offline_tail=False)
    _, yj = jax.jit(jmono.process)(jir, jmono.init_state(jscheme, jir, batch_shape=(2,)),
                                   jnp.asarray(x_np))
    assert snr_db(yj, y1) >= SNR_JAX_DB


def test_long_stream_no_snr_drift(rng):
    """Late-stream SNR equals early-stream SNR after 400 hops: the state has
    no error feedback, so accuracy is stationary."""
    scheme = PartitionScheme((32, 128, 512), zero_latency=True)
    ir = (rng.standard_normal(2000) *
          np.exp(-np.arange(2000) / 600)).astype(np.float32)
    mir = mono.prepare_ir(scheme, ir, dtype=torch.float32, offline_tail=False, device=CPU)
    st = mono.init_state(scheme, mir, (), torch.float32)
    hop, T = 256, 400
    x = rng.standard_normal(T * hop).astype(np.float32)
    xt = torch.from_numpy(x)
    first = last = None
    for j in range(T):
        st, y = mono.process(mir, st, xt[j * hop:(j + 1) * hop])
        if j == 4:
            first = (j, y.numpy())
        if j == T - 1:
            last = (j, y.numpy())
    ref = np.convolve(x.astype(np.float64), ir.astype(np.float64))

    def snr(j, y):
        return snr_db(ref[j * hop:(j + 1) * hop], y)

    s_first, s_last = snr(*first), snr(*last)
    assert s_first > 120.0 and s_last > 120.0
    assert abs(s_first - s_last) < 15.0  # stationary accuracy, no drift
