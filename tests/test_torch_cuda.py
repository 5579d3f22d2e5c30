"""The port's Hopper kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs on a GPU machine that has none; ``tests/conftest.py``
imports jax, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: >= 120 dB SNR for each kernel against its plain version (float32
sums taken in another order give ~130 dB), >= 110 dB for the FastFIR chain
against the CPU path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import offline  # noqa: E402

pytestmark = pytest.mark.cuda

SNR_KERNEL_DB = 120.0
SNR_CHAIN_DB = 110.0
KERNELS = {
    "rfft_packed": hopper_fft,
    "rfft_packed_stream": hopper_fft,
    "lag_mac_causal": hopper_kernels,
    "rifft_packed_tail": hopper_fft,
}


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    return torch.device("cuda")


def _inputs(name, n, dev):
    """Kernel arguments at real size ``n``: 2 channels, 5 hops, 7 lags
    (more lags than hops, so K3's clipped lag range is exercised)."""
    g = torch.Generator(device=dev).manual_seed(0)
    k = n // 2

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    if name == "rfft_packed":
        return (randn(6, n),)
    if name == "rfft_packed_stream":
        return (randn(2, 5, k),)
    if name == "lag_mac_causal":
        return (randn(2, 5, k), randn(2, 5, k), randn(2, 7, k), randn(2, 7, k))
    return (randn(2, 5, k), randn(2, 5, k), 1.0 / (4.0 * n))


@pytest.mark.parametrize("n", [4096, 1 << 14, 1 << 17])
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_matches_plain(cuda, name, n):
    mod = KERNELS[name]
    fn = getattr(mod, name)
    args = _inputs(name, n, cuda)
    before = fn.launches
    got = fn(*args)
    want = getattr(mod, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert snr_db(w.cpu().numpy(), g.cpu().numpy()) >= SNR_KERNEL_DB


def test_fastfir_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(0x70C4)
    x = rng.standard_normal((2, 40000)).astype(np.float32)
    ir = rng.standard_normal((2, 30000)).astype(np.float32)
    y_cpu = offline.FastFIR(ir, fft_size=16384)(torch.from_numpy(x))
    counted = (hopper_fft.rfft_packed, hopper_fft.rfft_packed_stream,
               hopper_kernels.lag_mac_causal, hopper_fft.rifft_packed_tail)
    before = [fn.launches for fn in counted]
    eng = offline.FastFIR(ir, fft_size=16384, device=cuda)
    y = eng(torch.from_numpy(x).to(cuda))
    assert y.device.type == "cuda" and y.shape == (2, 40000)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1, 1]
    assert snr_db(y_cpu, y.cpu()) >= SNR_CHAIN_DB


@pytest.mark.parametrize("call,exc,match", [
    (lambda d: hopper_fft.rfft_packed(torch.zeros(2, 4096, dtype=torch.float64,
                                                  device=d)),
     NotImplementedError, "float64"),
    (lambda d: hopper_fft.rfft_packed(torch.zeros(2, 2048, device=d)),
     NotImplementedError, "K10"),
    (lambda d: hopper_fft.rfft_packed(torch.zeros(4096, 2, device=d).t()),
     ValueError, "contiguous"),
    (lambda d: hopper_kernels.lag_mac_causal(
        *(torch.zeros(2, 3, 256, device=d) for _ in range(2)),
        *(torch.zeros(2, 4, 128, device=d) for _ in range(2))),
     ValueError, "H planes"),
])
def test_kernel_wrappers_refuse_on_cuda(cuda, call, exc, match):
    with pytest.raises(exc, match=match):
        call(cuda)
