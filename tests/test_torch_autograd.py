"""Port parity: gradients through the port's engines, and no silent
gradient through a hand kernel.

The autograd twin of ``tests/test_differentiability.py``: its six cases at
their shapes and inputs (the tests' seed, drawn in the same order). On the
CPU each wrapper runs its kernel's plain torch version, so gradients flow
through every engine. Each gradient is held against the JAX package's
``jax.grad`` on the same numpy inputs at >= 110 dB (float32 sums in another
order) and against a central finite difference as ``_fd_check`` takes it
(eps 1e-2, rtol 0.05). The IR-learning case runs ``torch.optim.Adam(lr=0.05)``
for optax's ``adam(0.05)``, 120 steps, to ``l1 < 0.05 l0``; the JAX case's
vmap is a batch here.

On a CUDA tensor the hand kernels have no backward (as the Pallas kernels
have no VJP): ``_build.check_tensors`` raises when grad is enabled and an
operand requires it, before any other check, so that is tested here on the
CPU; ``tests/test_torch_cuda.py`` tests it on the kernels themselves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hisstools_library_tpu.core.types import Split as JSplit  # noqa: E402
from hisstools_library_tpu.models import mono as jmono, time_domain as jtd  # noqa: E402
from hisstools_library_tpu.ops import spectral_processor as jsp  # noqa: E402
from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.models import mono, time_domain as td  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral_processor as sp  # noqa: E402

SNR_JAX_DB = 110.0
CPU = "cpu"
SCHEME = mono.PartitionScheme((32, 128), zero_latency=True)
JSCHEME = jmono.PartitionScheme((32, 128), zero_latency=True)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _grad(loss, x: np.ndarray) -> np.ndarray:
    t = torch.tensor(x, requires_grad=True)
    loss(t).backward()
    return t.grad.numpy()


def _fd_check(loss, x: np.ndarray, i, g: np.ndarray, eps=1e-2, rtol=0.05) -> None:
    """``_fd_check`` of the JAX test: g finite, and g[i] within rtol of the
    central difference of ``loss`` at ``x[i]``."""
    assert np.isfinite(g).all()
    xp, xm = x.copy(), x.copy()
    xp[i] += eps
    xm[i] -= eps
    with torch.no_grad():
        fd = (float(loss(torch.tensor(xp))) - float(loss(torch.tensor(xm)))) / (2 * eps)
    assert abs(float(g[i]) - fd) <= rtol * (abs(fd) + 1e-6)


def _check(loss, jloss, x: np.ndarray, i) -> np.ndarray:
    """The port's gradient of ``loss`` at x against JAX's of ``jloss`` and
    the finite difference at index i."""
    g = _grad(loss, x)
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    assert g.shape == gj.shape
    assert snr_db(gj, g) >= SNR_JAX_DB
    _fd_check(loss, x, i, g)
    return g


def test_grad_through_scheme_engine_wrt_input(rng):
    ir = rng.standard_normal(500).astype(np.float32)
    x = rng.standard_normal(512).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, dtype=torch.float32, offline_tail=False, device=CPU)
    st = mono.init_state(SCHEME, mir, (), torch.float32)
    jmir = jmono.prepare_ir(JSCHEME, ir, dtype=jnp.float32, offline_tail=False)
    jst = jmono.init_state(JSCHEME, jmir, (), jnp.float32)

    def loss(x):
        _, y = mono.process(mir, st, x)
        return torch.sum(y * y)

    def jloss(x):
        _, y = jmono.process(jmir, jst, x)
        return jnp.sum(y * y)

    _check(loss, jloss, x, 13)


def test_grad_wrt_ir_spectra_learns_target(rng):
    """Gradient descent on the partition spectra drives the engine's output
    toward a target response (the learnable-FIR case); the first step's
    gradient is the JAX package's."""
    ir = (rng.standard_normal(200) * 0.1).astype(np.float32)
    target_ir = (rng.standard_normal(200) * 0.1).astype(np.float32)
    # The head ([0, head_taps)) is not learned: share it, so that the
    # spectra can explain the whole residual.
    target_ir[:SCHEME.head_taps] = ir[:SCHEME.head_taps]
    x = rng.standard_normal(512).astype(np.float32)

    mir = mono.prepare_ir(SCHEME, ir, dtype=torch.float32, offline_tail=False, device=CPU)
    mir_t = mono.prepare_ir(SCHEME, target_ir, dtype=torch.float32, offline_tail=False,
                            device=CPU)
    st = mono.init_state(SCHEME, mir, (), torch.float32)
    xt = torch.from_numpy(x)
    _, y_target = mono.process(mir_t, st, xt)
    params = [p.clone().requires_grad_(True) for s in mir.spectra for p in (s.re, s.im)]

    def loss(ps):
        spectra = tuple(Split(ps[2 * k], ps[2 * k + 1]) for k in range(len(ps) // 2))
        _, y = mono.process(mono.MonoIR(mir.head_taps, spectra, None, 0), st, xt)
        return torch.mean((y - y_target) ** 2)

    jmir = jmono.prepare_ir(JSCHEME, ir, dtype=jnp.float32, offline_tail=False)
    jmir_t = jmono.prepare_ir(JSCHEME, target_ir, dtype=jnp.float32, offline_tail=False)
    jst = jmono.init_state(JSCHEME, jmir, (), jnp.float32)
    _, jy_target = jmono.process(jmir_t, jst, jnp.asarray(x))

    def jloss(spectra):
        _, y = jmono.process(jmono.MonoIR(jmir.head_taps, spectra, None, 0), jst,
                             jnp.asarray(x))
        return jnp.mean((y - jy_target) ** 2)

    jg = jax.grad(jloss)(tuple(JSplit(jnp.asarray(p.re), jnp.asarray(p.im))
                               for p in jmir.spectra))
    l0_t = loss(params)
    l0_t.backward()
    got = np.concatenate([p.grad.numpy().ravel() for p in params])
    want = np.concatenate([np.asarray(a).ravel() for s in jg for a in (s.re, s.im)])
    assert np.isfinite(got).all()
    assert snr_db(want, got) >= SNR_JAX_DB

    l0 = float(l0_t.detach())
    opt = torch.optim.Adam(params, lr=0.05)
    for _ in range(120):
        opt.zero_grad()
        loss(params).backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss(params))
    assert l1 < 0.05 * l0  # the optimisation converges toward the 0 floor


def test_grad_through_time_domain_taps(rng):
    x = rng.standard_normal(300).astype(np.float32)
    taps = rng.standard_normal(16).astype(np.float32)
    xt = torch.from_numpy(x)

    def loss(taps):
        return torch.sum(td.fir_offline(xt, taps) ** 2)

    def jloss(taps):
        return jnp.sum(jtd.fir_offline(jnp.asarray(x), taps) ** 2)

    _check(loss, jloss, taps, 3)


def test_grad_through_spectral_processor(rng):
    x = rng.standard_normal(256).astype(np.float32)
    h = rng.standard_normal(64).astype(np.float32)
    ht = torch.from_numpy(h)

    def loss(x):
        return torch.sum(sp.convolve(x, ht, sp.EdgeMode.Linear) ** 2)

    def jloss(x):
        return jnp.sum(jsp.convolve(x, jnp.asarray(h), jsp.EdgeMode.Linear) ** 2)

    _check(loss, jloss, x, 100)


def test_grad_through_change_phase(rng):
    """Minimum-phase reshaping (the cepstral chain) is differentiable end to
    end: finite, the JAX gradient, and the finite difference."""
    x = (rng.standard_normal(256) * np.exp(-np.arange(256) / 40.0)).astype(np.float32)

    def loss(x):
        return torch.sum(sp.change_phase(x, 0.0) ** 2)

    def jloss(x):
        return jnp.sum(jsp.change_phase(x, 0.0) ** 2)

    _check(loss, jloss, x, 10)


def test_grad_batched(rng):
    """The JAX case's grad of a vmapped engine: per-channel input gradients
    of a (4, 512) batch in one call."""
    ir = rng.standard_normal(300).astype(np.float32)
    xs = rng.standard_normal((4, 512)).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, dtype=torch.float32, offline_tail=False, device=CPU)
    st = mono.init_state(SCHEME, mir, (4,), torch.float32)
    jmir = jmono.prepare_ir(JSCHEME, ir, dtype=jnp.float32, offline_tail=False)
    jst = jmono.init_state(JSCHEME, jmir, (4,), jnp.float32)

    def loss(xs):
        _, ys = mono.process(mir, st, xs)
        return torch.sum(ys * ys)

    def jloss(xs):
        _, ys = jmono.process(jmir, jst, xs)
        return jnp.sum(ys * ys)

    g = _check(loss, jloss, xs, (2, 77))
    assert g.shape == (4, 512)


def test_check_tensors_refuses_an_operand_that_requires_grad():
    """Grad enabled and an operand that requires it: the error names the
    kernel, before the device check (so it shows on a CPU tensor too)."""
    t = torch.zeros(2, 4, 16, requires_grad=True)
    with pytest.raises(_build.NoBackwardError, match="K7 lag_mac_ring: .*no backward"):
        _build.check_tensors("K7 lag_mac_ring", torch.zeros(2, 4, 16), t)
    assert issubclass(_build.NoBackwardError, RuntimeError)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), pytest.raises(ValueError, match="one CUDA device"):
            _build.check_tensors("K7 lag_mac_ring", t)
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.check_tensors("K7 lag_mac_ring", t.detach())
