"""The port's Hopper kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs on a GPU machine that has none; ``tests/conftest.py``
imports jax, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: >= 120 dB SNR for each kernel against its plain version (float32
sums taken in another order give ~130 dB; >= 110 dB for K12, K13 and K14
above 2^16 points, whose sums run over 2^17..2^28 points), >= 110 dB for the
FastFIR chain and the streaming engines against the CPU path, >= 100 dB for
the streaming engines and the spectral ops and >= 120 dB for
the time-domain FIR against float64 (a TF32 convolution would give ~60 dB).
The serving loop and a checkpointed stream are held bit-equal to
``mono.process_any`` run directly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.core.types import Split  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402
from hisstools_library_tpu_torch.models import mono, offline, pipeline, time_domain  # noqa: E402
from hisstools_library_tpu_torch.ops import spectral_processor as sp  # noqa: E402

pytestmark = pytest.mark.cuda

SNR_KERNEL_DB = 120.0
CPU = "cpu"  # the port builds on the card unless a call names the CPU
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


# K1 on its one-pass route (csrc/rfft_packed.cu): every real N = 4096..2^17
# (one block to M = 2^13, clusters of 2 / 4 / 8 above) at batches of 1 and 3
# and a 3-D leading shape, and the FastFIR IR preparation's 1920 frames of
# 2^16.
K1_CASES = ([(b, n) for n in (1 << e for e in range(12, 18)) for b in (1, 3)]
            + [(2, 3, n) for n in (4096, 1 << 16, 1 << 17)] + [(1920, 1 << 16)])


@pytest.mark.parametrize("shape", K1_CASES)
def test_k1_one_pass_matches_plain(cuda, shape):
    x = torch.randn(*shape, generator=torch.Generator(device=cuda).manual_seed(len(shape)),
                    device=cuda)
    before = hopper_fft.rfft_packed.launches
    got = hopper_fft.rfft_packed(x)
    want = hopper_fft.rfft_packed_plain(x)
    torch.cuda.synchronize()
    assert hopper_fft.rfft_packed.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (*shape[:-1], shape[-1] // 2)
        assert snr_db(w.cpu().numpy(), g.cpu().numpy()) >= SNR_KERNEL_DB


def test_k1_allocates_only_its_outputs(cuda):
    """One K1 call at (1920, 2^16) raises the peak allocation by its two
    output planes alone: no scratch frame."""
    b, n = 1920, 1 << 16
    x = torch.randn(b, n, device=cuda)
    hopper_fft.rfft_packed(x[:1])  # the twiddle table, cached for the size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = hopper_fft.rfft_packed(x)
    torch.cuda.synchronize()
    out_bytes = 2 * b * (n // 2) * 4
    assert sum(t.numel() * 4 for t in out) == out_bytes
    assert torch.cuda.max_memory_allocated() - base <= out_bytes


def test_k1_frames_resident(cuda):
    """At least one frame of every K1 size fits the card at once."""
    for e in range(12, 18):
        assert hopper_fft.rfft_packed_resident(1 << e) >= 1


# K2 on K1's one-pass route (csrc/rfft_packed_stream.cu): every real N =
# 4096..2^17 with T = 1 (the lower half of every frame zero) and with C = 3,
# T = 5 (frames that cross channel boundaries at frame % T == 0), and the
# offline path's (128, 236, 2048).
K2_CASES = ([(c, t, 1 << (e - 1)) for e in range(12, 18) for c, t in ((2, 1), (3, 5))]
            + [(128, 236, 1 << 11)])


@pytest.mark.parametrize("shape", K2_CASES)
def test_k2_one_pass_matches_plain(cuda, shape):
    x = torch.randn(*shape, generator=torch.Generator(device=cuda).manual_seed(shape[1]),
                    device=cuda)
    before = hopper_fft.rfft_packed_stream.launches
    got = hopper_fft.rfft_packed_stream(x)
    want = hopper_fft.rfft_packed_stream_plain(x)
    torch.cuda.synchronize()
    assert hopper_fft.rfft_packed_stream.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == shape and g.device.type == "cuda"
        assert bool(torch.isfinite(g).all())
        assert snr_db(w.cpu().numpy(), g.cpu().numpy()) >= SNR_KERNEL_DB


def test_k2_allocates_only_its_outputs(cuda):
    """One K2 call at the offline path's (128, 236, 2048) raises the peak
    allocation by its two output planes and at most 1 MB more: no scratch
    frame."""
    x = torch.randn(128, 236, 1 << 11, device=cuda)
    hopper_fft.rfft_packed_stream(x[:1, :1])  # the twiddle table, cached for the size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = hopper_fft.rfft_packed_stream(x)
    torch.cuda.synchronize()
    out_bytes = 2 * x.numel() * 4
    assert sum(t.numel() * 4 for t in out) == out_bytes
    assert torch.cuda.max_memory_allocated() - base <= out_bytes + (1 << 20)


def test_k2_frames_resident(cuda):
    """At least one frame of every K2 size fits the card at once."""
    for e in range(12, 18):
        assert hopper_fft.rfft_packed_stream_resident(1 << e) >= 1


# K4 and K6 on the one-pass route with the paired unpack (csrc/rifft_packed_tail.cu,
# csrc/rifft_packed.cu): every real N = 4096..2^17 at 1, 3 and 128 frames,
# and K4 at its paths' shapes (the far tier's (128, 4, 32768), the collapsed
# and matched sections' (128, 16, 8192), the offline 4096 section's
# (128, 236, 2048)) and the main path's (128, 16, 32768).
K4_PATH_SHAPES = [(128, 4, 1 << 15), (128, 16, 1 << 13), (128, 236, 1 << 11),
                  (128, 16, 1 << 15)]
INVERSE_CASES = ([(name, (b, 1 << (e - 1))) for name in ("rifft_packed_tail", "rifft_packed")
                  for e in range(12, 18) for b in (1, 3, 128)]
                 + [("rifft_packed_tail", shape) for shape in K4_PATH_SHAPES])


def _inverse_call(name, shape, dev):
    """The wrapper's call on packed planes of ``shape`` (..., N/2), from a
    seed: K4 with its overlap-save scale 1/(4N), K6 unscaled."""
    g = torch.Generator(device=dev).manual_seed(shape[-1] + len(shape))
    re, im = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
    fn = getattr(hopper_fft, name)
    args = (re, im, 1.0 / (8.0 * shape[-1])) if name == "rifft_packed_tail" else (re, im)
    return fn, args


@pytest.mark.parametrize("name,shape", INVERSE_CASES)
def test_one_pass_inverse_matches_plain(cuda, name, shape):
    fn, args = _inverse_call(name, shape, cuda)
    before = fn.launches
    got = fn(*args)
    want = getattr(hopper_fft, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    k = shape[-1]
    assert got.shape == want.shape == (*shape[:-1], k if name == "rifft_packed_tail" else 2 * k)
    assert bool(torch.isfinite(got).all())
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("name,shape", [("rifft_packed_tail", (128, 16, 1 << 15)),
                                        ("rifft_packed", (128, 1 << 13)),
                                        ("rifft_packed", (128, 1 << 11))])
def test_one_pass_inverse_allocates_only_its_output(cuda, name, shape):
    """One K4 / K6 call raises the peak allocation above its inputs by its
    output alone: no scratch frame."""
    fn, args = _inverse_call(name, shape, cuda)
    fn(*(a[:1] if torch.is_tensor(a) else a for a in args))  # the twiddle table
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out.numel() * 4


def test_fastfir_on_cuda_matches_cpu(cuda):
    """FastFIR at N = 16384: K1 prepares the IR, one K5 call runs the pass,
    and none of K2, K3, K4 launches."""
    rng = np.random.default_rng(0x70C4)
    x = rng.standard_normal((2, 40000)).astype(np.float32)
    ir = rng.standard_normal((2, 30000)).astype(np.float32)
    y_cpu = offline.FastFIR(ir, fft_size=16384, device=CPU)(torch.from_numpy(x))
    counted = (hopper_fft.rfft_packed, hopper_fft.fastfir_chain,
               hopper_fft.rfft_packed_stream, hopper_kernels.lag_mac_causal,
               hopper_fft.rifft_packed_tail)
    before = [fn.launches for fn in counted]
    eng = offline.FastFIR(ir, fft_size=16384, device=cuda)
    y = eng(torch.from_numpy(x).to(cuda))
    assert y.device.type == "cuda" and y.shape == (2, 40000)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 0, 0, 0]
    assert snr_db(y_cpu, y.cpu()) >= SNR_CHAIN_DB


def _chain_inputs(c, t, p, n, dev, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = n // 2

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev)

    # H as a row slice of a wider spectra tensor, read in place.
    h = [randn(c, p + 1, k)[:, 1:] * 1e-3 for _ in range(2)]
    return randn(c, t, k) + 0.5, h


# (C, T, P, N): P > T, one lag (T = 2, P = 1: the smallest output that
# depends on the MAC), the main path's P = 15, and P beyond shared memory
# (47 lags fit at 2^15..2^16, 22 at 2^17; hopper_fft._chain_plan).
CHAIN_CASES = [(2, 5, 7, 1 << 14), (2, 3, 2, 1 << 17), (2, 2, 1, 1 << 16),
               (3, 16, 15, 1 << 16), (2, 9, 4, 1 << 15), (2, 3, 60, 1 << 16),
               (1, 9, 25, 1 << 17),
               # several chunks a block, the last one partial (16 hops a chunk
               # up to 2^16, 8 at 2^17; hopper_fft._chain_plan), in one
               # tile, or double-buffered in two where a block has its SM to
               # itself (the 2^17 shapes and (40, 25, 2^16))
               (2, 40, 15, 1 << 16), (2, 37, 5, 1 << 14), (1, 19, 9, 1 << 17),
               (2, 40, 25, 1 << 16), (2, 17, 4, 1 << 15), (1, 9, 9, 1 << 17)]


@pytest.mark.parametrize("c,t,p,n", CHAIN_CASES)
def test_fastfir_chain_matches_plain(cuda, c, t, p, n):
    """K5 (csrc/fastfir_chain.cu) against its plain version."""
    x2d, (hr, hi) = _chain_inputs(c, t, p, n, cuda)
    scale = 1.0 / (4.0 * n)
    before = hopper_fft.fastfir_chain.launches
    got = hopper_fft.fastfir_chain(x2d, hr, hi, scale)
    want = hopper_fft.fastfir_chain_plain(x2d, hr, hi, scale)
    torch.cuda.synchronize()
    assert hopper_fft.fastfir_chain.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= SNR_KERNEL_DB


def test_fastfir_chain_single_hop_is_zero(cuda):
    """K5 at T = 1: x[-1] = 0 and no lag-0 term, so the output is exactly
    zero, as the plain version's is."""
    x2d, (hr, hi) = _chain_inputs(2, 1, 3, 1 << 16, cuda)
    got = hopper_fft.fastfir_chain(x2d, hr, hi, 1.0 / (4.0 * (1 << 16)))
    want = hopper_fft.fastfir_chain_plain(x2d, hr, hi, 1.0 / (4.0 * (1 << 16)))
    assert got.shape == x2d.shape
    assert float(got.abs().max()) == 0.0 and float(want.abs().max()) == 0.0


# (C, T, P, N, lag0): the single 2^17 section and the far tier's 2^16 at
# P = 8, T > P (the ring's spectra leave within the call) at 2^15..2^16, P
# beyond shared memory, and T = 1.
WIDE_STREAM_CASES = [(2, 2, 8, 1 << 17, False), (2, 4, 8, 1 << 16, True),
                     (2, 11, 3, 1 << 16, True), (1, 2, 30, 1 << 17, False),
                     (2, 1, 5, 1 << 16, False), (2, 11, 8, 1 << 15, True),
                     (2, 35, 3, 1 << 15, True)]


@pytest.mark.parametrize("c,t,p,n,lag0", WIDE_STREAM_CASES)
def test_wide_stream_chain_matches_plain(cuda, c, t, p, n, lag0):
    """K8 at N = 2^15..2^17 (the chain family's stream instantiation, which
    serves 2^14 too: STREAM_CASES) against its plain version: output and new
    ring."""
    x2d, (hr, hi) = _chain_inputs(c, t, p, n, cuda, seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    k = n // 2
    prev, rr, ri = (torch.randn(*sh, generator=g, device=cuda)
                    for sh in ((c, k), (c, p, k), (c, p, k)))
    kw = {}
    if lag0:
        kw = dict(l0_re=torch.randn(c, k, generator=g, device=cuda) * 1e-3,
                  l0_im=torch.randn(c, k, generator=g, device=cuda) * 1e-3)
    args = (x2d, prev, rr, ri, hr, hi, 1.0 / (4.0 * n))
    before = hopper_fft.fastfir_chain_stream.launches
    got = hopper_fft.fastfir_chain_stream(*args, **kw)
    want = hopper_fft.fastfir_chain_stream_plain(*args, **kw)
    torch.cuda.synchronize()
    assert hopper_fft.fastfir_chain_stream.launches == before + 1
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and bool(torch.isfinite(gt).all())
        assert snr_db(w.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


# K8's state kernel alone (csrc/fastfir_stream.cu stream_state), (C, T, P, K,
# lag0, H layout): T < P, T = P, T > P, P = 1, T = 1, a chunk of 16 hops and
# chunks past it (17, 40 hops), K at its smallest (256 bins, one block a
# channel); H as a row slice, a channel-broadcast view or contiguous, and
# the lag-0 planes as a channel-broadcast view.
STATE_CASES = [(2, 2, 8, 1 << 16, False, "slice"), (3, 8, 8, 4096, True, "slice"),
               (2, 16, 3, 8192, True, "broadcast"), (2, 5, 1, 1024, True, "contiguous"),
               (2, 1, 5, 768, False, "broadcast"), (2, 17, 3, 512, True, "slice"),
               (1, 40, 6, 256, True, "broadcast"), (2, 3, 20, 2048, False, "contiguous"),
               (3, 24, 5, 128, True, "broadcast"), (20, 17, 2, 16, False, "slice")]


@pytest.mark.parametrize("c,t,p,k,lag0,layout", STATE_CASES)
def test_stream_state_matches_plain(cuda, c, t, p, k, lag0, layout):
    """K8's state kernel against its plain version (the ring MAC's plain
    version and the lag-0 product): Y and the new ring, bin 0's two real
    products included, with H and lag0 read in place from views."""
    g = torch.Generator(device=cuda).manual_seed(c * 1000 + t * 10 + p)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=cuda)

    xr, xi, rr, ri = randn(c, t, k), randn(c, t, k), randn(c, p, k), randn(c, p, k)
    if layout == "slice":
        h = [randn(c, p + 2, k)[:, 1:p + 1] for _ in range(2)]
    elif layout == "broadcast":
        h = [randn(1, p, k).expand(c, p, k) for _ in range(2)]
    else:
        h = [randn(c, p, k) for _ in range(2)]
    l0 = [randn(1, k).expand(c, k) for _ in range(2)] if lag0 else [None, None]
    before = hopper_fft.stream_state.launches
    got = hopper_fft.stream_state(xr, xi, rr, ri, *h, *l0)
    want = hopper_fft.stream_state_plain(xr, xi, rr, ri, *h, *l0)
    torch.cuda.synchronize()
    assert hopper_fft.stream_state.launches == before + 1
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and bool(torch.isfinite(gt).all())
        assert snr_db(w.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB
        # bin 0: two real products a lag, not a complex one
        assert snr_db(w[..., 0].cpu().numpy(), gt[..., 0].cpu().numpy()) >= SNR_KERNEL_DB
    # the new ring is copied, not computed: [ring | X] from row T on
    assert torch.equal(got[2], torch.cat([rr, xr], 1)[:, t:])
    assert torch.equal(got[3], torch.cat([ri, xi], 1)[:, t:])


# K8 at its plan's edges (hopper_fft._stream_plan), (C, T, P, N, lag0): each
# one-pass route (one block at 2^14, clusters of 2 / 4 / 8 above), a chunk
# of 16 hops and one hop past it, T = 1, P = 1, T = P, with H and lag0 as
# channel-broadcast views read in place.
STREAM_PLAN_CASES = [(2, 16, 3, 1 << 14, True), (2, 17, 3, 1 << 14, True),
                     (2, 1, 1, 1 << 15, True), (2, 8, 8, 1 << 16, False),
                     (1, 3, 8, 1 << 17, True), (2, 33, 2, 1 << 15, False)]


@pytest.mark.parametrize("c,t,p,n,lag0", STREAM_PLAN_CASES)
def test_stream_chain_plan_edges_match_plain(cuda, c, t, p, n, lag0):
    """K8 against its plain version with H and lag0 broadcast over the
    channels (the Convolver's N2M layout): output and new ring."""
    g = torch.Generator(device=cuda).manual_seed(t * 100 + p)
    k = n // 2

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=cuda)

    kw = {}
    if lag0:
        kw = dict(l0_re=(randn(1, k) * 1e-3).expand(c, k),
                  l0_im=(randn(1, k) * 1e-3).expand(c, k))
    args = (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
            (randn(1, p, k) * 1e-3).expand(c, p, k), (randn(1, p, k) * 1e-3).expand(c, p, k),
            1.0 / (4.0 * n))
    before = hopper_fft.fastfir_chain_stream.launches
    got = hopper_fft.fastfir_chain_stream(*args, **kw)
    want = hopper_fft.fastfir_chain_stream_plain(*args, **kw)
    torch.cuda.synchronize()
    assert hopper_fft.fastfir_chain_stream.launches == before + 1
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and bool(torch.isfinite(gt).all())
        assert snr_db(w.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("path", ["single-section", "two-tier"])
def test_convolver_stream_paths_launch_k8_on_cuda(cuda, path):
    """The Convolver's hop-aligned paths at the chain family's sizes: parallel
    2 channels on one N = 2^17 section (P = 4), and N2M 2 x 2 on the Zero
    preset's two-tier state with a 290 000-tap IR (far tier N = 2^16,
    P2 = 8). Each call launches K8 (twice on the two-tier path, near and far
    tier) and no K7; two calls match the CPU path."""
    from hisstools_library_tpu_torch.models.multichannel import Convolver
    rng = np.random.default_rng(0xC0)
    if path == "single-section":
        scheme = mono.PartitionScheme.for_latency_budget(65536)
        bank = rng.standard_normal((2, 200000)).astype(np.float32) * 0.1
        args, init, per_call = (2,), "init_state", 1
    else:
        scheme = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
        bank = (rng.standard_normal((2, 2, 290000)) * np.exp(-np.arange(290000) / 48000)
                ).astype(np.float32)
        args, init, per_call = (2, 2), "init_block_state", 2
    outs = []
    for dev in (cuda, CPU):
        conv = Convolver(*args, scheme=scheme, device=dev)
        conv.set_all(bank)
        conv.prepare(offline_tail=False)
        st = getattr(conv, init)()
        before = (hopper_fft.fastfir_chain_stream.launches, hopper_kernels.lag_mac_ring.launches)
        ys = []
        for i in range(2):
            x = np.random.default_rng(i).standard_normal((2, 131072)).astype(np.float32)
            st, y = conv.process(st, torch.from_numpy(x).to(dev))
            ys.append(y.cpu().numpy())
        if dev == cuda:
            assert hopper_fft.fastfir_chain_stream.launches - before[0] == 2 * per_call
            assert hopper_kernels.lag_mac_ring.launches == before[1]
        outs.append(np.concatenate(ys, axis=-1))
    assert snr_db(outs[1], outs[0]) >= SNR_CHAIN_DB


@pytest.mark.parametrize("call,exc,match", [
    (lambda d: hopper_fft.rfft_packed(torch.zeros(2, 4096, dtype=torch.float64,
                                                  device=d)),
     NotImplementedError, "float64"),
    (lambda d: hopper_fft.rfft_packed(torch.zeros(1, 1, device=d).expand(2, 1 << 29)),
     NotImplementedError, "above 2\\^28"),
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


def _stream_inputs(name, shape, dev):
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev)

    if name == "rfft_small":
        b, n = shape
        return (randn(b, n),), {}
    if name == "lag_mac_ring":
        c, t, p, k, *layout = shape
        # H as a row slice of a wider spectra tensor, or one plane broadcast
        # over the channels (stride 0), read in place.
        if layout == ["broadcast"]:
            h = [randn(1, p, k).expand(c, p, k) for _ in range(2)]
        else:
            h = [randn(c, p + 2, k)[:, 1:p + 1] for _ in range(2)]
        return (randn(c, p, k), randn(c, p, k), randn(c, t, k), randn(c, t, k),
                *h), {}
    c, t, p, n, lag0 = shape
    k = n // 2
    kw = {}
    if lag0:
        kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3)
    return (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
            randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n)), kw


STREAM_CASES = [
    ("rfft_small", (384, 32)), ("rfft_small", (385, 128)), ("rfft_small", (384, 256)),
    ("rfft_small", (7, 1024)), ("rfft_small", (384, 2048)),
    # the other sizes, 2F + 3 rows (F frames a block, hopper_fft._small_plan)
    ("rfft_small", (259, 64)), ("rfft_small", (35, 512)),
    ("lag_mac_ring", (2, 1, 3, 128)), ("lag_mac_ring", (2, 3, 3, 1024)),
    ("lag_mac_ring", (3, 4, 14, 4096)),
    # the ring MAC's narrow tiles (K = 16 / 32 / 64 bins: a block of one
    # warp and idle lanes, of two warps); H broadcast over the channels; more
    # hops than one chunk of 16
    ("lag_mac_ring", (5, 2, 3, 16)), ("lag_mac_ring", (17, 4, 9, 32)),
    ("lag_mac_ring", (6, 3, 5, 64, "broadcast")), ("lag_mac_ring", (3, 4, 14, 4096, "broadcast")),
    ("lag_mac_ring", (3, 20, 24, 128)),
    ("fastfir_chain_stream", (2, 3, 2, 1 << 14, True)),
    ("fastfir_chain_stream", (2, 2, 3, 1 << 14, False)),
    ("fastfir_chain_stream", (1, 5, 8, 1 << 15, True)),
    ("fastfir_chain_stream", (2, 1, 1, 1 << 14, False)),
]


@pytest.mark.parametrize("name,shape", STREAM_CASES)
def test_stream_kernel_matches_plain(cuda, name, shape):
    mod = hopper_kernels if name == "lag_mac_ring" else hopper_fft
    fn = getattr(mod, name)
    args, kw = _stream_inputs(name, shape, cuda)
    before = fn.launches
    got = fn(*args, **kw)
    want = getattr(mod, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert bool(torch.isfinite(g).all())
        assert snr_db(w.cpu().numpy(), g.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("call,match", [
    (lambda d: hopper_fft.fastfir_chain_stream(
        torch.zeros(1, 2, 1 << 17, device=d), torch.zeros(1, 1 << 17, device=d),
        *(torch.zeros(1, 2, 1 << 17, device=d) for _ in range(4)), 1.0), "K8"),
    # N = 2..2048 are served (2..16 by the tiny form); 24 is no power of two.
    (lambda d: hopper_fft.rfft_small(torch.zeros(2, 24, device=d)), "K10"),
    # the ring MAC serves K = 16, 32, 64, 128 and multiples of 256
    (lambda d: hopper_kernels.lag_mac_ring(*(torch.zeros(2, 3, 8, device=d) for _ in range(4)),
                                           *(torch.zeros(2, 3, 8, device=d) for _ in range(2))),
     "K7"),
    (lambda d: hopper_kernels.lag_mac_ring(*(torch.zeros(2, 3, 48, device=d) for _ in range(6))),
     "K7"),
])
def test_stream_wrappers_refuse_on_cuda(cuda, call, match):
    with pytest.raises(NotImplementedError, match=match):
        call(cuda)


def test_two_tier_stream_on_cuda(cuda):
    """The Zero preset's two-tier path on the card (near tier K8, far tier
    K1 -> K7 -> K4, IR preparation K10 and K1) matches the CPU path and a
    float64 convolution over three carried blocks. 160 000 taps give a far
    tier of G = 2 and P2 = 9 partitions, above K8's P <= 8."""
    rng = np.random.default_rng(0x57E4)
    ir = (rng.standard_normal((2, 160000)) * np.exp(-np.arange(160000) / 24000)
          ).astype(np.float32)
    scheme = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    counted = (hopper_fft.rfft_packed, hopper_fft.rfft_small, hopper_kernels.lag_mac_ring,
               hopper_fft.fastfir_chain_stream, hopper_fft.rifft_packed_tail)
    before = [fn.launches for fn in counted]
    mir = mono.prepare_ir(scheme, ir, offline_tail=False, device=cuda)
    mir_cpu = mono.prepare_ir(scheme, ir, offline_tail=False, device=CPU)
    st = mono.init_block_state(scheme, mir, batch_shape=(2,))
    st_cpu = mono.init_block_state(scheme, mir_cpu, batch_shape=(2,))
    h2 = mir.far.shape[-1]
    xs, ys, ys_cpu = [], [], []
    for _ in range(3):
        x = rng.standard_normal((2, 2 * h2)).astype(np.float32)
        st, y = mono.process(mir, st, torch.from_numpy(x).to(cuda))
        st_cpu, y_cpu = mono.process(mir_cpu, st_cpu, torch.from_numpy(x))
        xs.append(x)
        ys.append(y.cpu().numpy())
        ys_cpu.append(y_cpu.numpy())
    grew = [fn.launches - b for fn, b in zip(counted, before)]
    assert all(n >= 1 for n in grew), grew
    assert grew[3] == 3  # one K8 launch per near-tier call
    y, y_cpu, x = (np.concatenate(a, axis=-1) for a in (ys, ys_cpu, xs))
    assert snr_db(y_cpu, y) >= SNR_CHAIN_DB
    for c in range(2):
        size = 1 << (x.shape[-1] + ir.shape[-1]).bit_length()
        ref = np.fft.irfft(np.fft.rfft(x[c].astype(np.float64), size)
                           * np.fft.rfft(ir[c].astype(np.float64), size), size)
        assert snr_db(ref[:x.shape[-1]], y[c]) >= 100.0


def test_time_domain_fir_full_fp32_on_cuda(cuda):
    """The head's grouped conv1d runs in full FP32 on the card (cuDNN's TF32
    default would cost ~60 dB)."""
    rng = np.random.default_rng(0x7D)
    x = rng.standard_normal((4, 20000)).astype(np.float32)
    h = rng.standard_normal((4, 128)).astype(np.float32)
    y = time_domain.fir_offline(torch.from_numpy(x).to(cuda), torch.from_numpy(h).to(cuda))
    for c in range(4):
        ref = np.convolve(x[c].astype(np.float64), h[c].astype(np.float64))[:20000]
        assert snr_db(ref, y[c].cpu().numpy()) >= 120.0


def _slice_inputs(name, shape, dev):
    """Arguments of the sample-granular slice's kernels (K6, K9, K11, K15)."""
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev)

    if name in ("rifft_packed", "rifft_small"):
        b, n = shape
        return (randn(b, n // 2), randn(b, n // 2)), {}
    if name == "hop_fire":
        c, n, p, shared, *layout = shape
        k = n // 2
        lead = () if shared else (c,)
        frame = randn(c, n)
        if layout == ["slice"]:    # rows of a wider staging buffer, float2-aligned
            frame = randn(c, n + 38)[:, 6:6 + n]
        elif layout == ["odd"]:    # an odd channel stride and base: scalar loads
            frame = randn(c, n + 37)[:, 5:5 + n]
        return (frame, randn(c, p, k), randn(c, p, k), randn(*lead, p, k),
                randn(*lead, p, k)), {}
    c, skip, t, p, k, *layout = shape  # lag_mac; H as a row slice of a wider tensor
    if layout == ["broadcast"]:        # or one plane broadcast over the channels
        h = [randn(1, p, k).expand(c, p, k) for _ in range(2)]
    else:
        h = [randn(c, p + 1, k)[:, 1:] for _ in range(2)]
    return (randn(c, skip + t + p, k), randn(c, skip + t + p, k), *h, t), \
        dict(lead_skip=skip)


SLICE_CASES = [
    ("rifft_packed", (3, 4096)), ("rifft_packed", (128, 16384)), ("rifft_packed", (2, 1 << 17)),
    ("rifft_small", (384, 32)), ("rifft_small", (385, 256)), ("rifft_small", (7, 1024)),
    ("rifft_small", (128, 2048)),
    ("hop_fire", (128, 256, 3, False)), ("hop_fire", (5, 1024, 3, True)),
    ("hop_fire", (3, 32, 1, False)), ("hop_fire", (9, 64, 20, False)),
] + [
    # K9: every N at P 1 and 3; P 20 / 64 / 256 at N = 64 and 1024; C no
    # multiple of the frames a block; frames read in place from a wider
    # buffer (float2-aligned or not); H broadcast over the channels
    ("hop_fire", (7, 1 << e, p, False)) for e in range(5, 11) for p in (1, 3)
] + [
    ("hop_fire", (6, n, p, False)) for n in (64, 1024) for p in (20, 64, 256)
] + [
    # the plans that ask the most shared memory (4 helpers x 4 stages, P = 14..17)
    ("hop_fire", (6, 1 << e, 17, False)) for e in range(5, 11)
] + [
    ("hop_fire", (6, 1024, 14, False)), ("hop_fire", (128, 128, 15, False)),
    ("hop_fire", (5, 256, 16, True)),
    ("hop_fire", (1, 256, 3, False)), ("hop_fire", (127, 256, 3, False)),
    ("hop_fire", (129, 1024, 3, False)), ("hop_fire", (127, 32, 3, False)),
    ("hop_fire", (129, 256, 64, True)), ("hop_fire", (128, 1024, 256, True)),
    ("hop_fire", (33, 256, 3, False, "slice")), ("hop_fire", (9, 1024, 20, False, "slice")),
    ("hop_fire", (33, 128, 3, True, "odd")), ("hop_fire", (5, 1024, 1, False, "odd")),
    # many blocks of F frames, the last block ragged
    ("hop_fire", (4099, 32, 3, False)), ("hop_fire", (1001, 256, 3, True)),
    ("hop_fire", (515, 128, 20, False, "slice")),
] + [
    ("lag_mac", (2, 0, 5, 7, 256)), ("lag_mac", (3, 1, 48, 47, 1024)),
    ("lag_mac", (2, 1, 1, 4, 128)), ("lag_mac", (3, 1, 48, 47, 1024, "broadcast")),
    ("lag_mac", (9, 1, 20, 5, 16)), ("lag_mac", (4, 0, 33, 40, 64, "broadcast")),
]


@pytest.mark.parametrize("name,shape", SLICE_CASES)
def test_slice_kernel_matches_plain(cuda, name, shape):
    mod = hopper_fft if name.startswith("rifft") else hopper_kernels
    fn = getattr(mod, name)
    args, kw = _slice_inputs(name, shape, cuda)
    before = fn.launches
    got = fn(*args, **kw)
    want = getattr(mod, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert bool(torch.isfinite(g).all())
        assert snr_db(w.cpu().numpy(), g.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("call,match", [
    (lambda d: hopper_kernels.hop_fire(torch.zeros(2, 2048, device=d),
                                       *(torch.zeros(2, 3, 1024, device=d) for _ in range(4))),
     "K9"),
    (lambda d: hopper_fft.rifft_small(*(torch.zeros(2, 12, device=d) for _ in range(2))), "K11"),
    (lambda d: hopper_kernels.lag_mac(*(torch.zeros(2, 9, 24, device=d) for _ in range(2)),
                                      *(torch.zeros(2, 4, 24, device=d) for _ in range(2)), 5),
     "K15"),
    (lambda d: hopper_fft.rifft_packed(*(torch.zeros(1, 1, device=d).expand(2, 1 << 28)
                                         for _ in range(2))),
     "above 2\\^28"),
])
def test_slice_wrappers_refuse_on_cuda(cuda, call, match):
    with pytest.raises(NotImplementedError, match=match):
        call(cuda)


@pytest.mark.parametrize("path", ["process", "process_any", "process_offline"])
def test_convolver_n2m_matrix_on_cuda(cuda, path):
    """The N-in / M-out route at 5 x 5 with 90 000-tap IRs on the Zero
    preset (10 partitions of the 16384 section): ``process`` on
    ``init_state`` runs the collapsed engine over the 25 pairs (K1 -> K7 ->
    K4, a launch each a block, every pair's frames counted in ``.points``),
    ``process_any`` the sample-granular path, ``process_offline`` the lazy
    tail; each matches the CPU path."""
    from hisstools_library_tpu_torch.models.multichannel import Convolver
    rng = np.random.default_rng(0x27)
    ins = outs = 5
    taps, block = 90000, 16384
    bank = (rng.standard_normal((outs, ins, taps)) / np.sqrt(taps)).astype(np.float32)
    xs = [rng.standard_normal((ins, block)).astype(np.float32) for _ in range(3)]
    res = []
    for dev in (cuda, CPU):
        conv = Convolver(ins, outs, latency=mono.LatencyMode.Zero, max_length=taps, device=dev)
        conv.set_all(bank)
        conv.prepare()
        if path == "process_offline":
            res.append(conv.process_offline(torch.from_numpy(np.concatenate(xs, -1)).to(dev))
                       .cpu().numpy())
            continue
        st = conv.init_state() if path == "process" else conv.init_stream_state()
        step = conv.process if path == "process" else conv.process_any
        counted = (hopper_fft.rfft_packed, hopper_kernels.lag_mac_ring,
                   hopper_fft.rifft_packed_tail)
        before = [(fn.launches, fn.points if hasattr(fn, "points") else 0) for fn in counted]
        ys = []
        for x in xs:
            st, y = step(st, torch.from_numpy(x).to(dev))
            ys.append(y.cpu().numpy())
        if dev == cuda and path == "process":
            grew = [(fn.launches - b[0], (fn.points if hasattr(fn, "points") else 0) - b[1])
                    for fn, b in zip(counted, before)]
            pairs = outs * ins
            assert grew == [(6, 3 * pairs * (2 * 16384 + 3 * 4096)), (3, 0),
                            (3, 3 * pairs * 2 * 16384)], grew
        res.append(np.concatenate(ys, axis=-1))
    assert res[0].shape == (outs, 3 * block)
    assert snr_db(res[1], res[0]) >= SNR_CHAIN_DB


def test_process_any_on_cuda(cuda):
    """The Zero preset's sample-granular path on the card: 48 callbacks of
    256 samples fire every section (K9 at N = 256, 1024; K1 -> MAC -> K6 at
    4096, 16384) and match the CPU path and a float64 convolution."""
    rng = np.random.default_rng(0x5A)
    ir = (rng.standard_normal((2, 20000)) * np.exp(-np.arange(20000) / 6000)
          ).astype(np.float32)
    scheme = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    mir = mono.prepare_ir(scheme, ir, offline_tail=False, device=cuda)
    mir_cpu = mono.prepare_ir(scheme, ir, offline_tail=False, device=CPU)
    st = mono.init_stream_state(scheme, mir, batch_shape=(2,))
    st_cpu = mono.init_stream_state(scheme, mir_cpu, batch_shape=(2,))
    counted = (hopper_kernels.hop_fire, hopper_fft.rifft_packed, hopper_fft.rfft_packed)
    before = [fn.launches for fn in counted]
    xs, ys, ys_cpu = [], [], []
    for _ in range(48):
        x = rng.standard_normal((2, 256)).astype(np.float32)
        st, y = mono.process_any(mir, st, torch.from_numpy(x).to(cuda))
        st_cpu, y_cpu = mono.process_any(mir_cpu, st_cpu, torch.from_numpy(x))
        xs.append(x)
        ys.append(y.cpu().numpy())
        ys_cpu.append(y_cpu.numpy())
    grew = [fn.launches - b for fn, b in zip(counted, before)]
    # K9: 2 firings per call at N = 256, one per 2 calls at 1024.
    assert grew[0] == 48 * 2 + 48 // 2, grew
    assert grew[1] >= 1 and grew[2] >= 1, grew
    y, y_cpu, x = (np.concatenate(a, axis=-1) for a in (ys, ys_cpu, xs))
    assert snr_db(y_cpu, y) >= SNR_CHAIN_DB
    for c in range(2):
        size = 1 << (x.shape[-1] + ir.shape[-1]).bit_length()
        ref = np.fft.irfft(np.fft.rfft(x[c].astype(np.float64), size)
                           * np.fft.rfft(ir[c].astype(np.float64), size), size)
        assert snr_db(ref[:x.shape[-1]], y[c]) >= 100.0


def test_staged_offline_on_cuda(cuda):
    """FastFIR at N = 2048 (outside the fused chain) runs K10 -> K15 -> K11
    once each; mono.process_offline without the tail launches K11 (the direct
    sections' taps) and the fused chain; both match the CPU path."""
    rng = np.random.default_rng(0x2B)
    ir = rng.standard_normal((2, 20000)).astype(np.float32)
    x = rng.standard_normal((2, 30000)).astype(np.float32)
    counted = (hopper_fft.rfft_small, hopper_kernels.lag_mac, hopper_fft.rifft_small)
    eng = offline.FastFIR(ir, fft_size=2048, device=cuda)
    before = [fn.launches for fn in counted]
    y = eng(torch.from_numpy(x).to(cuda))
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1]
    y_cpu = offline.FastFIR(ir, fft_size=2048, device=CPU)(torch.from_numpy(x))
    assert snr_db(y_cpu, y.cpu()) >= SNR_CHAIN_DB
    scheme = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    before = hopper_fft.rifft_small.launches
    y = mono.process_offline(mono.prepare_ir(scheme, ir, offline_tail=False, device=cuda),
                             torch.from_numpy(x).to(cuda))
    assert hopper_fft.rifft_small.launches - before == 2
    y_cpu = mono.process_offline(mono.prepare_ir(scheme, ir, offline_tail=False, device=CPU),
                                 torch.from_numpy(x))
    assert snr_db(y_cpu, y.cpu()) >= SNR_CHAIN_DB


def test_mac_routes_above_512_partitions_on_cuda(cuda):
    """Above 512 partitions (the TPU package's VMEM bound, which the card does
    not share) "auto" still launches the kernels: K15 in the staged FastFIR
    and K7 in process_block (P = 625 at N = 64), each matching the CPU path."""
    from hisstools_library_tpu_torch.models import partitioned
    rng = np.random.default_rng(0x2C)
    ir = rng.standard_normal((2, 20000)).astype(np.float32)
    x = rng.standard_normal((2, 30000)).astype(np.float32)
    before = hopper_kernels.lag_mac.launches
    y = offline.FastFIR(ir, fft_size=64, device=cuda)(torch.from_numpy(x).to(cuda))
    assert hopper_kernels.lag_mac.launches - before == 1
    y_cpu = offline.FastFIR(ir, fft_size=64, device=CPU)(torch.from_numpy(x))
    assert snr_db(y_cpu, y.cpu()) >= SNR_CHAIN_DB
    outs = []
    for dev in (cuda, CPU):
        eng = partitioned.PartitionedConvolve(64)
        eng.set(ir, device=dev)
        assert eng.num_partitions == 625
        before = hopper_kernels.lag_mac_ring.launches
        _, y = partitioned.PartitionedConvolve.process_block(
            eng.spectra, eng.init_state((2,)), torch.from_numpy(x[:, :128]).to(dev))
        if dev == cuda:
            assert hopper_kernels.lag_mac_ring.launches - before == 1
        outs.append(y.cpu())
    assert snr_db(outs[1], outs[0]) >= SNR_CHAIN_DB


SPECTRAL_CASES = [
    ("fft_split", (3, 32), False), ("fft_split", (5, 1024), True),
    ("fft_split", (3, 2048), False), ("fft_split", (2, 1 << 14), True),
    ("fft_split", (2, 1 << 16), False), ("fft_split", (2, 1 << 17), True),
    ("fft_split", (1, 1 << 18), False), ("fft_split", (3, 1 << 19), True),
    ("rfft_packed_split", (3, 1 << 18), None), ("rfft_packed_split", (1, 1 << 19), None),
    ("rfft_packed_split", (2, 1 << 20), None),
    ("rifft_packed_split", (3, 1 << 18), None), ("rifft_packed_split", (1, 1 << 19), None),
    ("rifft_packed_split", (2, 1 << 20), None),
]
# The edges of the large routes (csrc/fft_large.cuh): K12 on the cluster at
# complex 2^17 (one frame, a few, 129: more clusters than fit at once) and
# in two long passes at 2^18 and 2^19, both directions; K13 and K14 on the
# cluster at real 2^18 and in two long passes at 2^19 and 2^20.
SPECTRAL_CASES += [("fft_split", shape, inverse)
                   for shape in [(1, 1 << 17), (3, 1 << 17), (129, 1 << 17), (2, 1 << 18),
                                 (3, 1 << 19)]
                   for inverse in (False, True)
                   if ("fft_split", shape, inverse) not in SPECTRAL_CASES]
SPECTRAL_CASES += [(name, shape, None)
                   for name in ("rfft_packed_split", "rifft_packed_split")
                   for shape in [(1, 1 << 18), (5, 1 << 18), (3, 1 << 19), (3, 1 << 20)]
                   if (name, shape, None) not in SPECTRAL_CASES]


@pytest.mark.parametrize("name,shape,inverse", SPECTRAL_CASES)
def test_spectral_kernel_matches_plain(cuda, name, shape, inverse):
    """K12 in shared memory, two passes, on the cluster and in two long
    passes, forward and inverse; K13 and K14 at every size of their envelope
    (the cluster at 2^18, two long passes above)."""
    fn = getattr(hopper_fft, name)
    g = torch.Generator(device=cuda).manual_seed(3)
    b, n = shape
    k = n // 2 if name == "rifft_packed_split" else n
    args = (torch.randn(b, k, generator=g, device=cuda),)
    if name != "rfft_packed_split":
        args += (torch.randn(b, k, generator=g, device=cuda),)
    kw = {} if inverse is None else dict(inverse=inverse)
    before = fn.launches
    got = fn(*args, **kw)
    want = getattr(hopper_fft, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    floor = SNR_CHAIN_DB if n > (1 << 16) else SNR_KERNEL_DB
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and gt.device.type == "cuda"
        assert bool(torch.isfinite(gt).all())
        assert snr_db(w.cpu().numpy(), gt.cpu().numpy()) >= floor


# The sizes above real 2^20 / complex 2^19 (csrc/fft_large.cuh: two long
# passes of 1024 x 1024 at complex 2^20, three passes above), every one, at
# small batches; odd batches (3, 5) are no multiple of a tile's 16 columns.
LARGE_CASES = ([("fft_split", (3 if lm == 20 else 1, 1 << lm), inverse)
                for lm in range(20, 29) for inverse in (False, True)]
               + [(name, (5 if lm == 21 else 3 if lm == 22 else 1, 1 << lm), None)
                  for name in ("rfft_packed_split", "rifft_packed_split")
                  for lm in range(21, 29)])


def _snr_card(ref, test):
    """SNR of ``test`` against ``ref`` in float64 on the card (frames of up
    to 2^28 points)."""
    ref = ref.double()
    err = test.double() - ref
    return float(10 * torch.log10((ref * ref).sum() / (err * err).sum()))


@pytest.mark.parametrize("name,shape,inverse", LARGE_CASES)
def test_large_kernel_matches_plain(cuda, name, shape, inverse):
    """K12 at complex 2^20..2^28 (both directions), K13 and K14 at real
    2^21..2^28, each against its plain version: >= 110 dB and finite."""
    fn = getattr(hopper_fft, name)
    g = torch.Generator(device=cuda).manual_seed(5)
    b, n = shape
    k = n // 2 if name == "rifft_packed_split" else n
    args = (torch.randn(b, k, generator=g, device=cuda),)
    if name != "rfft_packed_split":
        args += (torch.randn(b, k, generator=g, device=cuda),)
    kw = {} if inverse is None else dict(inverse=inverse)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = getattr(hopper_fft, name + "_plain")(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and gt.device.type == "cuda"
        assert bool(torch.isfinite(gt).all())
        assert _snr_card(w, gt) >= SNR_CHAIN_DB


@pytest.mark.parametrize("n", [1 << 18, 1 << 20, 1 << 21, 1 << 24])
def test_packed_split_round_trip(cuda, n):
    """K14(K13(x)) = 2N x to >= 110 dB, on the cluster (2^18), in two long
    passes (2^20, 2^21) and in three (2^24)."""
    x = torch.randn(2, n, generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    y = hopper_fft.rifft_packed_split(*hopper_fft.rfft_packed_split(x))
    torch.cuda.synchronize()
    assert snr_db((2 * n * x).cpu().numpy(), y.cpu().numpy()) >= SNR_CHAIN_DB


@pytest.mark.parametrize("n,scratch_frames", [(1 << 18, 0), (1 << 20, 1), (1 << 22, 1)])
def test_packed_split_memory(cuda, n, scratch_frames):
    """K13 at (8, n) raises the peak allocation by its output and, with two
    passes (2^20) or three (2^22: the middle one in place), one scratch
    frame (N/2 float2) per transform; on the cluster (2^18) by its output
    alone."""
    b = 8
    x = torch.randn(b, n, device=cuda)
    hopper_fft.rfft_packed_split(x)  # the twiddle table, cached for the size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = hopper_fft.rfft_packed_split(x)
    torch.cuda.synchronize()
    out_bytes = 2 * b * (n // 2) * 4
    assert sum(t.numel() * 4 for t in out) == out_bytes
    assert torch.cuda.max_memory_allocated() - base <= out_bytes + scratch_frames * b * 4 * n


SPECTRAL_PATHS = {
    # name: (call on (x1, x2), {wrapper: launches})
    "convolve-2^20": (lambda a, b: sp.convolve(a, b),
                      {"rfft_packed_split": 2, "rifft_packed_split": 1}),
    "convolve_complex-2^17": (lambda a, b: sp.convolve_complex(Split(a, b), Split(b.flip(-1), a)),
                              {"fft_split": 3}),
    "change_phase-2^19": (lambda a, b: sp.change_phase(a, 0.0),
                          {"rfft_packed_split": 2, "rifft_packed_split": 2}),
}
SPECTRAL_LENGTHS = {"convolve-2^20": 480000, "convolve_complex-2^17": 65536,
                    "change_phase-2^19": 480000}


@pytest.mark.parametrize("path", list(SPECTRAL_PATHS))
def test_spectral_path_launches_on_cuda(cuda, path):
    """The spectral ops at the sizes of 10 s signals at 48 kHz launch K12,
    K13 and K14 as many times as the path needs, and match the CPU path in
    float64. change_phase runs at phase 0 (minimum phase): its float32 path
    holds ~116 dB against float64 at N = 2^19, while an interpolated phase
    rounds a phase argument of up to ~4e5 radians to float32 (~39 dB)."""
    call, need = SPECTRAL_PATHS[path]
    rng = np.random.default_rng(0x5B)
    n = SPECTRAL_LENGTHS[path]
    x = (rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 24000)).astype(np.float32)
    h = (rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 24000)).astype(np.float32)
    before = {k: getattr(hopper_fft, k).launches for k in need}
    got = call(torch.from_numpy(x).to(cuda), torch.from_numpy(h).to(cuda))
    torch.cuda.synchronize()
    assert {k: getattr(hopper_fft, k).launches - v for k, v in before.items()} == need
    want = call(torch.from_numpy(x).double(), torch.from_numpy(h).double())
    got = (got.re, got.im) if isinstance(got, Split) else (got,)
    want = (want.re, want.im) if isinstance(want, Split) else (want,)
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and bool(torch.isfinite(gt).all())
        assert snr_db(w.numpy(), gt.cpu().numpy()) >= 100.0


def test_ir_deconvolve_on_cuda(cuda):
    """ir_deconvolve of a 2^20-point capture (K13 twice, K14 once) matches
    the CPU path in float64 (torch's float32 CPU FFT of a batch of two 2^20
    frames holds only ~107 dB itself)."""
    rng = np.random.default_rng(0x5C)
    exc = rng.standard_normal(300000).astype(np.float32)
    measured = rng.standard_normal((2, 600000)).astype(np.float32)
    before = (hopper_fft.rfft_packed_split.launches, hopper_fft.rifft_packed_split.launches)
    h = pipeline.ir_deconvolve(torch.from_numpy(measured).to(cuda),
                               torch.from_numpy(exc).to(cuda))
    torch.cuda.synchronize()
    assert (hopper_fft.rfft_packed_split.launches - before[0],
            hopper_fft.rifft_packed_split.launches - before[1]) == (2, 1)
    want = pipeline.ir_deconvolve(torch.from_numpy(measured).double(),
                                  torch.from_numpy(exc).double())
    assert h.shape == (2, 1 << 20)
    assert snr_db(want.numpy(), h.cpu().numpy()) >= 100.0


# K16 (csrc/bin_product.cu): the per-bin products of packed spectra. Path
# shapes: the 10 s and 20 s convolutions' (128, 2^19..2^20 bins) and the sweep
# deconvolution's (128, 2^21) against one broadcast excitation row. Small
# shapes: one float a lane (K not a multiple of 4, or a plane not 16-byte
# aligned), K = 1 (lane 0 alone), a broadcast first operand and a floor a row.
K16_PATH_CASES = [("bin_mul", (128,), (128,), 1 << 20), ("bin_mul", (128,), (128,), 1 << 21),
                  ("bin_mul_conj", (128,), (128,), 1 << 20),
                  ("bin_mul_conj", (128,), (128,), 1 << 21),
                  ("bin_deconvolve", (128,), (), 1 << 21)]
K16_SMALL_CASES = [("bin_mul", (3,), (3,), 6), ("bin_mul_conj", (2, 3), (1,), 1),
                   ("bin_mul", (1,), (5,), 4100), ("bin_mul_conj", (4,), (), 1 << 12),
                   ("bin_deconvolve", (5,), (5,), 4096), ("bin_deconvolve", (), (7,), 1000),
                   ("bin_deconvolve", (2, 3), (), 1 << 14), ("bin_deconvolve", (3,), (), 1)]


def _k16_args(op, a_lead, b_lead, k, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    planes = [torch.randn(*lead, k, generator=g, device=dev)
              for lead in (a_lead, a_lead, b_lead, b_lead)]
    planes[0][..., 0] += 4.0   # DC and Nyquist of unlike size and sign
    planes[3][..., 0] -= 6.0
    return planes + ([1e-4, 0.5 / (2 * k)] if op == "bin_deconvolve" else [0.25 / (2 * k)])


def _rel_err(want, got):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.parametrize("op,a_lead,b_lead,k", K16_PATH_CASES + K16_SMALL_CASES)
def test_k16_matches_plain(cuda, op, a_lead, b_lead, k):
    """K16 against its plain version: relative error <= 1e-6 a plane, DC and
    Nyquist exact for the products, one launch a call (and one of the floor
    a deconvolution)."""
    args = _k16_args(op, a_lead, b_lead, k, cuda)
    fn = getattr(hopper_kernels, op)
    before = (fn.launches, hopper_kernels.bin_floor.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    floors = 1 if op == "bin_deconvolve" else 0
    assert (fn.launches - before[0], hopper_kernels.bin_floor.launches - before[1]) == (1, floors)
    want = getattr(hopper_kernels, op + "_plain")(*args)
    lead = torch.broadcast_shapes(a_lead, b_lead)
    for g, w in zip(got, want):
        assert g.shape == w.shape == lead + (k,) and g.is_contiguous()
        assert bool(torch.isfinite(g).all())
        assert _rel_err(w, g) <= 1e-6
        if op != "bin_deconvolve":
            assert torch.equal(g[..., 0], w[..., 0])
    del args, got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("op", ["bin_mul", "bin_mul_conj", "bin_deconvolve"])
def test_k16_unaligned_planes(cuda, op):
    """Contiguous planes that start one float past a 16-byte boundary take
    K16's one-float-a-lane form and match the plain version."""
    k = 4096
    args = _k16_args(op, (3,), (3,), k, cuda, seed=1)
    for i in range(4):
        shifted = torch.empty(3 * k + 1, device=cuda)[1:].view(3, k)
        shifted.copy_(args[i])
        args[i] = shifted
    assert args[0].data_ptr() % 16 and args[0].is_contiguous()
    got = getattr(hopper_kernels, op)(*args)
    want = getattr(hopper_kernels, op + "_plain")(*args)
    for g, w in zip(got, want):
        assert _rel_err(w, g) <= 1e-6


@pytest.mark.parametrize("rows,k", [(1, 1 << 21), (3, 5), (300, 4096), (2, 1), (70000, 8)])
def test_k16_floor_matches_plain(cuda, rows, k):
    """K16's floor reduction: one launch, every row's floor equal to the
    plain version's, twice in a row (its work words left zero), and a NaN
    in a row gives that row a NaN floor as ``amax`` does."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x_re, x_im = (torch.randn(rows, k, generator=g, device=cuda) for _ in range(2))
    x_im[..., 0] *= 9.0  # a Nyquist that dominates its row
    want = hopper_kernels.bin_floor_plain(x_re, x_im, 1e-4)
    for _ in range(2):
        before = hopper_kernels.bin_floor.launches
        got = hopper_kernels.bin_floor(x_re, x_im, 1e-4)
        torch.cuda.synchronize()
        assert hopper_kernels.bin_floor.launches == before + 1
        assert got.shape == (rows, 1) and torch.equal(got, want)
    x_re[0, k // 2] = float("nan")
    got = hopper_kernels.bin_floor(x_re, x_im, 1e-4)
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isfinite(got[1:]).all())


def test_k16_refuses_layouts(cuda):
    """A float32 CUDA call with a layout K16 does not take raises, and
    launches nothing: a strided plane, operands that broadcast only in
    part, unequal K, float64."""
    a = torch.randn(2, 3, 64, device=cuda)
    cases = [
        ((a[..., ::2], a[..., ::2], a[0, :, :32], a[0, :, :32]), ValueError, "contiguous"),
        ((a[:, :1].contiguous(), a[:, :1].contiguous(), a[:1].contiguous(),
          a[:1].contiguous()), ValueError, "neither one row"),
        ((a, a, a[..., :32].contiguous(), a[..., :32].contiguous()), ValueError, "one K"),
        ((a.double(), a.double(), a.double(), a.double()), NotImplementedError, "float64"),
    ]
    before = {n: getattr(hopper_kernels, n).launches
              for n in ("bin_mul", "bin_mul_conj", "bin_deconvolve", "bin_floor")}
    for planes, exc, match in cases:
        for op, extra in (("bin_mul", ()), ("bin_mul_conj", ()), ("bin_deconvolve", (1e-4,))):
            with pytest.raises(exc, match=match):
                getattr(hopper_kernels, op)(*planes, *extra)
    assert {n: getattr(hopper_kernels, n).launches for n in before} == before


@pytest.mark.parametrize("a_lead,b_lead,k", [((0,), (0,), 64), ((0,), (), 4096),
                                             ((2, 0), (1,), 8), ((3,), (3,), 0)])
def test_k16_empty_output_launches_nothing(cuda, a_lead, b_lead, k):
    """An empty output (no rows, or K = 0) launches and counts nothing, the
    floor's reduction included, and comes back as empty planes of the
    broadcast shape."""
    names = ("bin_mul", "bin_mul_conj", "bin_deconvolve", "bin_floor")
    before = {n: getattr(hopper_kernels, n).launches for n in names}
    planes = [torch.randn(*lead, k, device=cuda) for lead in (a_lead, a_lead, b_lead, b_lead)]
    for op, extra in (("bin_mul", (0.5,)), ("bin_mul_conj", (0.5,)),
                      ("bin_deconvolve", (1e-4, 0.5))):
        re, im = getattr(hopper_kernels, op)(*planes, *extra)
        assert re.shape == im.shape == np.broadcast_shapes(a_lead, b_lead) + (k,)
        assert re.device.type == "cuda"
    torch.cuda.synchronize()
    assert {n: getattr(hopper_kernels, n).launches for n in names} == before


@pytest.mark.parametrize("op", ["convolve", "correlate"])
@pytest.mark.parametrize("mode", list(sp.EdgeMode), ids=lambda m: m.name)
def test_spectral_edge_modes_on_cuda(cuda, mode, op):
    """convolve and correlate in every EdgeMode on the card (K13 twice, K16
    once, K14 once at N = 2^19..2^20) against the float64 CPU path."""
    rng = np.random.default_rng(0x16)
    x = (rng.standard_normal((3, 300000)) * np.exp(-np.arange(300000) / 90000)).astype(np.float32)
    h = (rng.standard_normal((3, 70000)) * np.exp(-np.arange(70000) / 20000)).astype(np.float32)
    k16 = hopper_kernels.bin_mul_conj if op == "correlate" else hopper_kernels.bin_mul
    before = (k16.launches, hopper_fft.rfft_packed_split.launches,
              hopper_fft.rifft_packed_split.launches)
    got = getattr(sp, op)(torch.from_numpy(x).to(cuda), torch.from_numpy(h).to(cuda), mode)
    torch.cuda.synchronize()
    assert (k16.launches - before[0], hopper_fft.rfft_packed_split.launches - before[1],
            hopper_fft.rifft_packed_split.launches - before[2]) == (1, 2, 1)
    want = getattr(sp, op)(torch.from_numpy(x).double(), torch.from_numpy(h).double(), mode)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert snr_db(want.numpy(), got.cpu().numpy()) >= 100.0


@pytest.mark.parametrize("excitation", ["broadcast", "batched"])
def test_ir_deconvolve_k16_on_cuda(cuda, excitation):
    """ir_deconvolve on the card at N = 2^18 (K13 / K14) and 2^17 (K1 / K6):
    one floor and one division of K16 a call, one excitation row broadcast
    over the captures or one a capture, against the float64 CPU path."""
    rng = np.random.default_rng(0x5D)
    for length in (200000, 100000):
        exc = rng.standard_normal((3, length) if excitation == "batched" else length)
        measured = rng.standard_normal((3, length + 3000)).astype(np.float32)
        exc = exc.astype(np.float32)
        before = (hopper_kernels.bin_deconvolve.launches, hopper_kernels.bin_floor.launches)
        h = pipeline.ir_deconvolve(torch.from_numpy(measured).to(cuda),
                                   torch.from_numpy(exc).to(cuda))
        torch.cuda.synchronize()
        assert (hopper_kernels.bin_deconvolve.launches - before[0],
                hopper_kernels.bin_floor.launches - before[1]) == (1, 1)
        want = pipeline.ir_deconvolve(torch.from_numpy(measured).double(),
                                      torch.from_numpy(exc).double())
        assert h.shape == want.shape == (3, 1 << (length + 3000 - 1).bit_length())
        assert snr_db(want.numpy(), h.cpu().numpy()) >= 100.0


# (frames as (C, T, N) strided views of (C, (T-1) hop + N) signals, or a
# contiguous (B, N) batch when hop is None)
WINDOWED_CASES = [(3, 256, None, 1), (2, 1024, 341, 9), (128, 1024, 512, 938),
                  (5, 32, 7, 11), (3, 2048, 1024, 6), (4, 128, 64, 1),
                  # hop >= N; one frame of a view; frame counts that are not a
                  # multiple of the frames a block holds (hopper_fft._small_plan)
                  (2, 256, 300, 5), (3, 64, 64, 3), (1, 2048, 1024, 1), (3, 512, 256, 7),
                  (1, 1024, 1500, 4)]


def _window(n, dev):
    return torch.from_numpy(np.hanning(n + 1)[:n].astype(np.float32)).to(dev)


@pytest.mark.parametrize("c,n,hop,t", WINDOWED_CASES)
def test_windowed_kernels_match_plain(cuda, c, n, hop, t):
    """K10w reads frames in place from an unfold view (any hop, odd ones
    included) or a contiguous batch; K11w windows and scales in its store."""
    g = torch.Generator(device=cuda).manual_seed(4)
    if hop is None:
        frames = torch.randn(c, n, generator=g, device=cuda)
    else:
        frames = torch.randn(c, (t - 1) * hop + n, generator=g, device=cuda).unfold(-1, n, hop)
    w = _window(n, cuda)
    before = (hopper_fft.rfft_small_windowed.launches, hopper_fft.rifft_small_windowed.launches)
    got = hopper_fft.rfft_small_windowed(frames, w)
    want = hopper_fft.rfft_small_windowed_plain(frames, w)
    spec = [torch.randn(frames.shape[:-1] + (n // 2,), generator=g, device=cuda)
            for _ in range(2)]
    back = hopper_fft.rifft_small_windowed(*spec, w, 0.5 / n)
    back_want = hopper_fft.rifft_small_windowed_plain(*spec, w, 0.5 / n)
    torch.cuda.synchronize()
    assert (hopper_fft.rfft_small_windowed.launches - before[0],
            hopper_fft.rifft_small_windowed.launches - before[1]) == (1, 1)
    for gt, wt in list(zip(got, want)) + [(back, back_want)]:
        assert gt.shape == wt.shape and gt.device.type == "cuda"
        assert bool(torch.isfinite(gt).all())
        assert snr_db(wt.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


# (N, hop, frames a channel, extra floats a channel): the view's base at an
# odd float offset, with an even and an odd channel stride.
ODD_BASE_CASES = [(32, 16, 5, 0), (256, 128, 3, 1), (1024, 512, 9, 0), (1024, 341, 4, 1),
                  (2048, 1024, 3, 0)]


@pytest.mark.parametrize("n,hop,t,extra", ODD_BASE_CASES)
def test_windowed_kernel_reads_odd_base(cuda, n, hop, t, extra):
    """K10w on frames that start one float into their signal (the scalar
    loader: no float2 pair is 8-byte aligned)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    sig = torch.randn(3, 1 + (t - 1) * hop + n + extra, generator=g, device=cuda)
    frames = sig[:, 1:1 + (t - 1) * hop + n].unfold(-1, n, hop)
    assert frames.storage_offset() % 2 == 1
    w = _window(n, cuda)
    before = hopper_fft.rfft_small_windowed.launches
    got = hopper_fft.rfft_small_windowed(frames, w)
    want = hopper_fft.rfft_small_windowed_plain(frames, w)
    torch.cuda.synchronize()
    assert hopper_fft.rfft_small_windowed.launches == before + 1
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and bool(torch.isfinite(gt).all())
        assert snr_db(wt.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("n", [1 << k for k in range(5, 12)])
def test_small_inverses_match_plain(cuda, n):
    """K11 and K11w at every size N = 32..2048 on 385 rows, which leave a
    ragged last round of F frames (hopper_fft._small_plan) at each size."""
    g = torch.Generator(device=cuda).manual_seed(n)
    re, im = (torch.randn(385, n // 2, generator=g, device=cuda) for _ in range(2))
    w = _window(n, cuda)
    before = (hopper_fft.rifft_small.launches, hopper_fft.rifft_small_windowed.launches)
    got = [hopper_fft.rifft_small(re, im), hopper_fft.rifft_small_windowed(re, im, w, 0.5 / n)]
    want = [hopper_fft.rifft_small_plain(re, im),
            hopper_fft.rifft_small_windowed_plain(re, im, w, 0.5 / n)]
    torch.cuda.synchronize()
    assert (hopper_fft.rifft_small.launches - before[0],
            hopper_fft.rifft_small_windowed.launches - before[1]) == (1, 1)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape == (385, n) and gt.device.type == "cuda"
        assert bool(torch.isfinite(gt).all())
        assert snr_db(wt.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("call,exc,match", [
    (lambda d: hopper_fft.rfft_small_windowed(torch.zeros(2, 4096, device=d),
                                              torch.zeros(4096, device=d)),
     NotImplementedError, "K10w"),
    (lambda d: hopper_fft.rifft_small_windowed(*(torch.zeros(2, 12, device=d) for _ in range(2)),
                                               torch.zeros(24, device=d), 1.0),
     NotImplementedError, "K11w"),
    (lambda d: hopper_fft.rfft_small_windowed(torch.zeros(2, 256, dtype=torch.float64, device=d),
                                              torch.zeros(256, dtype=torch.float64, device=d)),
     NotImplementedError, "float64"),
    (lambda d: hopper_fft.rfft_small_windowed(torch.zeros(2, 256, device=d),
                                              torch.zeros(128, device=d)),
     ValueError, "window"),
])
def test_windowed_wrappers_refuse_on_cuda(cuda, call, exc, match):
    with pytest.raises(exc, match=match):
        call(cuda)


@pytest.mark.parametrize("n,hop,need", [
    (1024, 512, ("rfft_small_windowed", "rifft_small_windowed")),
    (1024, 341, ("rfft_small_windowed", "rifft_small_windowed")),
    (4096, 1024, ("rfft_packed", "rifft_packed")),
    (16, 8, ("rfft_tiny_windowed", "rifft_tiny_windowed")),
])
def test_stft_on_cuda_launches_and_matches_cpu(cuda, n, hop, need):
    """stft / istft on the card: K10w / K11w once each up to N = 2048, the
    window multiply and K1 / K6 above; spectra and resynthesis match the
    CPU path and the round trip holds the input."""
    from hisstools_library_tpu_torch.ops import stft as stft_mod, windows
    rng = np.random.default_rng(0x57F7)
    x = rng.standard_normal((2, 3, 20000)).astype(np.float32)
    w = windows.hann(n - 1, dtype=torch.float64, device=cuda)   # a window on the card
    before = {k: getattr(hopper_fft, k).launches for k in need}
    S = stft_mod.stft(torch.from_numpy(x).to(cuda), w, n, hop, boundary=True)
    y = stft_mod.istft(S, w, hop, length=20000, boundary=True)
    torch.cuda.synchronize()
    assert {k: getattr(hopper_fft, k).launches - v for k, v in before.items()} == dict.fromkeys(need, 1)
    S_cpu = stft_mod.stft(torch.from_numpy(x), w.cpu(), n, hop, boundary=True)
    y_cpu = stft_mod.istft(S_cpu, w.cpu(), hop, length=20000, boundary=True)
    assert snr_db(S_cpu.re.numpy(), S.re.cpu().numpy()) >= SNR_CHAIN_DB
    assert snr_db(S_cpu.im.numpy(), S.im.cpu().numpy()) >= SNR_CHAIN_DB
    assert snr_db(y_cpu.numpy(), y.cpu().numpy()) >= SNR_CHAIN_DB
    assert snr_db(x, y.cpu().numpy()) >= SNR_CHAIN_DB


# The sizes below the other kernels' ranges (csrc/fft_tiny.cu, one thread a
# frame): real N = 2..16 through the wrappers of K10 / K11 and K10w / K11w,
# complex N = 1..16 through K12's; 257 rows leave a ragged last block.
TINY_REAL = [2, 4, 8, 16]
TINY_COMPLEX = [1, 2, 4, 8, 16]


@pytest.mark.parametrize("n", TINY_REAL)
def test_tiny_real_kernels_match_plain(cuda, n):
    """rfft_packed / rifft_packed at N = 2..16 launch the tiny forms once
    each, match their plain versions and keep rifft(rfft(x)) == 2N x."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(257, n, generator=g, device=cuda)
    spec = [torch.randn(3, 86, n // 2, generator=g, device=cuda) for _ in range(2)]
    before = (hopper_fft.rfft_tiny.launches, hopper_fft.rifft_tiny.launches)
    got = hopper_fft.rfft_packed(x)
    back = hopper_fft.rifft_packed(*spec)
    trip = hopper_fft.rifft_packed(*got)
    torch.cuda.synchronize()
    assert (hopper_fft.rfft_tiny.launches - before[0],
            hopper_fft.rifft_tiny.launches - before[1]) == (1, 2)
    pairs = list(zip(hopper_fft.rfft_tiny_plain(x), got))
    pairs += [(hopper_fft.rifft_tiny_plain(*spec), back), (2 * n * x, trip)]
    for want, gt in pairs:
        assert gt.shape == want.shape and gt.device.type == "cuda"
        assert bool(torch.isfinite(gt).all())
        assert snr_db(want.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("n", TINY_REAL)
def test_tiny_windowed_kernels_match_plain(cuda, n):
    """K10w's and K11w's tiny forms: frames read in place from an unfold
    view one float into its signal (hop N/2, or 1 at N = 2), the window
    and scale in the store."""
    g = torch.Generator(device=cuda).manual_seed(7)
    hop, t = max(1, n // 2), 9
    sig = torch.randn(3, 1 + (t - 1) * hop + n, generator=g, device=cuda)
    frames = sig[:, 1:].unfold(-1, n, hop)
    w = _window(n, cuda)
    spec = [torch.randn(3, t, n // 2, generator=g, device=cuda) for _ in range(2)]
    before = (hopper_fft.rfft_tiny_windowed.launches, hopper_fft.rifft_tiny_windowed.launches)
    got = hopper_fft.rfft_small_windowed(frames, w)
    back = hopper_fft.rifft_small_windowed(*spec, w, 0.5 / n)
    torch.cuda.synchronize()
    assert (hopper_fft.rfft_tiny_windowed.launches - before[0],
            hopper_fft.rifft_tiny_windowed.launches - before[1]) == (1, 1)
    pairs = list(zip(hopper_fft.rfft_tiny_windowed_plain(frames, w), got))
    pairs += [(hopper_fft.rifft_tiny_windowed_plain(*spec, w, 0.5 / n), back)]
    for want, gt in pairs:
        assert gt.shape == want.shape and bool(torch.isfinite(gt).all())
        assert snr_db(want.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", TINY_COMPLEX)
def test_tiny_complex_kernel_matches_plain(cuda, n, inverse):
    """fft / ifft at complex N = 1..16 launch K12's tiny form (N = 1 a copy)."""
    from hisstools_library_tpu_torch.fft import api
    g = torch.Generator(device=cuda).manual_seed(8)
    re, im = (torch.randn(2, 129, n, generator=g, device=cuda) for _ in range(2))
    before = hopper_fft.fft_tiny.launches
    got = (api.ifft if inverse else api.fft)(re, im, backend="pallas")
    torch.cuda.synchronize()
    assert hopper_fft.fft_tiny.launches == before + 1
    for want, gt in zip(hopper_fft.fft_tiny_plain(re, im, inverse), got):
        assert gt.shape == want.shape and bool(torch.isfinite(gt).all())
        assert snr_db(want.cpu().numpy(), gt.cpu().numpy()) >= SNR_KERNEL_DB


@pytest.mark.parametrize("length", range(1, 17))
def test_small_convolve_on_cuda(cuda, length):
    """spectral_processor.convolve of two signals of 1..16 samples on the
    card (FFT sizes 4..32: the tiny forms to 16, K10 / K11 at 32; one sample
    each is a product) against float64."""
    rng = np.random.default_rng(0x5C + length)
    x = rng.standard_normal((2, length)).astype(np.float32)
    h = rng.standard_normal((2, length)).astype(np.float32)
    size = sp.required_fft_size(length, length)
    names = (() if length == 1 else ("rfft_tiny", "rifft_tiny") if size <= 16
             else ("rfft_small", "rifft_small"))
    before = {k: getattr(hopper_fft, k).launches for k in names}
    got = sp.convolve(torch.from_numpy(x).to(cuda), torch.from_numpy(h).to(cuda))
    torch.cuda.synchronize()
    assert [getattr(hopper_fft, k).launches - v for k, v in before.items()] == [2, 1][:len(names)]
    want = np.stack([np.convolve(x[i].astype(np.float64), h[i].astype(np.float64))
                     for i in range(2)])
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert snr_db(want, got.cpu().numpy()) >= SNR_CHAIN_DB


def test_tracker_graph_on_cuda_matches_cpu(cuda):
    """The frame chain's tracker loop on the card (one frame's step captured
    as a CUDA graph, replayed per frame) gives the CPU loop's states."""
    from hisstools_library_tpu_torch.models import partial_tracker as pt
    rng = np.random.default_rng(0x7A)
    frames, pk = 40, 16
    base = 440.0 * 2.0 ** (rng.choice(48, pk, replace=False) / 12.0)
    f = base[None, :] * 2.0 ** (rng.uniform(-0.04, 0.04, (frames, pk)) / 12.0)
    a = rng.uniform(0.05, 1.0, (frames, pk))
    f[rng.random((frames, pk)) < 0.2] = 0.0
    a[f == 0.0] = 0.0
    cfg = pt.TrackerConfig(max_peaks=pk, max_tracks=pk)
    outs = []
    for dev in (cuda, CPU):
        ft = torch.from_numpy(f.astype(np.float32)).to(dev)
        at = torch.from_numpy(a.astype(np.float32)).to(dev)
        order = torch.argsort(-at, dim=-1, stable=True)
        ft, at = torch.gather(ft, -1, order), torch.gather(at, -1, order)
        outs.append([o.cpu() for o in pipeline._track_frames(cfg, ft, at, (at > 0).sum(-1), 0.0)])
    for g_, c_ in zip(*outs):
        assert torch.equal(g_, c_)


def test_frames_pipeline_on_cuda(cuda):
    """run_ir_pipeline_frames on the card: ir_deconvolve at N = 2^18 (K13
    twice, K14 once) and the STFT on K10w; the IR and smoothed spectra match
    the CPU path, and so do the track states of the 7 frames inside the
    4096-tap IR (beyond it the deconvolved IR is rounding noise, whose peaks
    no two runs order alike)."""
    fs = 48000.0
    t = np.arange(1 << 17) / fs
    # The benchmark's sweep, whose chirp folds over the whole band (a sweep
    # that stops at 20 kHz is the next test's).
    sweep = np.sin(2 * np.pi * (20.0 * (1000.0 ** (t / t[-1]))) * t)
    rng = np.random.default_rng(0)
    ir = rng.standard_normal(4096) * np.exp(-np.arange(4096) / 4800.0)
    measured = np.convolve(sweep, ir).astype(np.float32)
    exc = sweep.astype(np.float32)
    need = {"rfft_packed_split": 2, "rifft_packed_split": 1, "rfft_small_windowed": 1}
    before = {k: getattr(hopper_fft, k).launches for k in need}
    got = pipeline.run_ir_pipeline_frames(torch.from_numpy(measured).to(cuda),
                                          torch.from_numpy(exc).to(cuda), regularization=1e-9)
    assert {k: getattr(hopper_fft, k).launches - v for k, v in before.items()} == need
    want = pipeline.run_ir_pipeline_frames(torch.from_numpy(measured), torch.from_numpy(exc),
                                           regularization=1e-9)
    assert got.track_states.shape == want.track_states.shape == (511, 16)
    assert snr_db(want.impulse, got.impulse) >= SNR_CHAIN_DB
    assert snr_db(want.smoothed_amp, got.smoothed_amp) >= SNR_CHAIN_DB
    assert np.array_equal(want.track_states[:7], got.track_states[:7])
    assert np.any(got.track_states[1:7] != 0)


def test_frames_pipeline_log_sweep_on_cuda(cuda):
    """run_ir_pipeline_frames on the card with a 20 Hz - 20 kHz exponential
    sweep: the bins above 20 kHz hold almost no excitation, so the
    regularised division amplifies float32 rounding there, on the CPU as on
    the card. The card's IR and smoothed spectra are held against float64 to
    the CPU float32 path's own SNR less 3 dB; the track states of the frames
    inside the IR equal the float64 run's."""
    fs, n, f1, f2 = 48000.0, 1 << 17, 20.0, 20000.0
    t = np.arange(n) / fs
    k = np.log(f2 / f1)
    sweep = np.sin(2 * np.pi * f1 * (n / fs) / k * (np.exp(t * k / (n / fs)) - 1.0))
    rng = np.random.default_rng(0)
    ir = rng.standard_normal(4096) * np.exp(-np.arange(4096) / 4800.0)
    measured = np.convolve(sweep, ir).astype(np.float32)
    exc = sweep.astype(np.float32)
    need = {"rfft_packed_split": 2, "rifft_packed_split": 1, "rfft_small_windowed": 1}
    before = {k_: getattr(hopper_fft, k_).launches for k_ in need}
    got = pipeline.run_ir_pipeline_frames(torch.from_numpy(measured).to(cuda),
                                          torch.from_numpy(exc).to(cuda), regularization=1e-9)
    assert {k_: getattr(hopper_fft, k_).launches - v for k_, v in before.items()} == need
    cpu32 = pipeline.run_ir_pipeline_frames(torch.from_numpy(measured), torch.from_numpy(exc),
                                            regularization=1e-9)
    cpu64 = pipeline.run_ir_pipeline_frames(torch.from_numpy(measured).double(),
                                            torch.from_numpy(exc).double(), regularization=1e-9)
    for field in ("impulse", "smoothed_amp"):
        want = getattr(cpu64, field)
        bar = snr_db(want, getattr(cpu32, field)) - 3.0
        assert np.all(np.isfinite(getattr(got, field)))
        assert snr_db(want, getattr(got, field)) >= bar
    assert np.array_equal(cpu64.track_states[:7], got.track_states[:7])
    assert np.any(got.track_states[1:7] != 0)


# -- the serving loop and checkpoints on the card ---------------------------------

SERVE_SCHEME = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
SERVE_CUTS = (17, 256, 1, 300, 2048, 126, 4096, 5000)


def test_server_equals_process_any_on_cuda(cuda):
    """The StreamingServer on the card adds no arithmetic: its output over
    ragged numpy callbacks equals process_any on the capacity-padded IR bit
    for bit, holds >= 100 dB against float64, and runs K9, K1 and K6."""
    from hisstools_library_tpu_torch.utils.serving import StreamingServer

    rng = np.random.default_rng(20)
    c, taps = 4, 20000
    irs = (rng.standard_normal((c, taps)) * np.exp(-np.arange(taps) / 4000.0)).astype(np.float32)
    x = rng.standard_normal((c, sum(SERVE_CUTS))).astype(np.float32)
    srv = StreamingServer(c, capacity=1 << 14, device=cuda)
    srv.set_ir(irs)
    assert srv.capacity == 1 << 15
    padded = np.zeros((c, srv.capacity), np.float32)
    padded[:, :taps] = irs
    ir = mono.prepare_ir(SERVE_SCHEME, padded, offline_tail=False, device=cuda)
    state = mono.init_stream_state(SERVE_SCHEME, ir, (c,))
    names = ("hop_fire", "rfft_packed", "rifft_packed")
    mods = {"hop_fire": hopper_kernels, "rfft_packed": hopper_fft, "rifft_packed": hopper_fft}
    for k in names:
        getattr(mods[k], k).launches = 0
    outs, i = [], 0
    for b in SERVE_CUTS:
        y, live = srv.process(x[:, i:i + b])
        state, y_ref = mono.process_any(ir, state, torch.from_numpy(x[:, i:i + b]).to(cuda))
        assert live and y.device.type == "cuda"
        assert torch.equal(y, y_ref)
        outs.append(y.cpu().numpy())
        i += b
    for k in names:
        assert getattr(mods[k], k).launches > 0, k
    y = np.concatenate(outs, axis=-1)
    for ch in range(c):
        ref = np.convolve(x[ch].astype(np.float64), irs[ch].astype(np.float64))[:i]
        assert snr_db(ref, y[ch]) >= 100.0


@pytest.mark.parametrize("fmt", ["torch", "npz"])
def test_checkpoint_resume_bitexact_on_cuda(cuda, tmp_path, fmt):
    """A process_any stream on the card checkpointed mid-stream (state and
    MonoIR), restored into fresh exemplars on the card, continues bit-exactly."""
    from hisstools_library_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(21)
    c = 4
    irs = (rng.standard_normal((c, 20000)) * 0.1).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((c, 32 * 256)).astype(np.float32)).to(cuda)
    ir = mono.prepare_ir(SERVE_SCHEME, irs, offline_tail=False, device=cuda)

    def run(ir, state, start, stop):
        ys = []
        for j in range(start, stop):
            state, y = mono.process_any(ir, state, x[:, j * 256:(j + 1) * 256])
            ys.append(y)
        return state, ys

    _, ref = run(ir, mono.init_stream_state(SERVE_SCHEME, ir, (c,)), 0, 32)
    state, ys = run(ir, mono.init_stream_state(SERVE_SCHEME, ir, (c,)), 0, 16)
    payload = {"state": state, "ir": ir}
    path = str(tmp_path / f"ck.{fmt}")
    (checkpoint.save if fmt == "torch" else checkpoint.save_npz)(path, payload)
    like = checkpoint.rebuild(payload, [torch.empty_like(t) if isinstance(t, torch.Tensor)
                                        else t for t in checkpoint.leaves(payload)])
    restored = (checkpoint.restore if fmt == "torch" else checkpoint.restore_npz)(path, like)
    assert restored["ir"].spectra[-1].re.device.type == "cuda"
    _, ys2 = run(restored["ir"], restored["state"], 16, 32)
    assert torch.equal(torch.cat(ys + ys2, -1), torch.cat(ref, -1))


def _grad_operands(name, dev):
    """Each kernel's operands at a small shape: (fn, args), the first
    argument the one that will require grad."""
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    if name == "rfft_packed":
        return hopper_fft.rfft_packed, (randn(4, 4096),)
    if name == "rfft_packed_stream":
        return hopper_fft.rfft_packed_stream, (randn(2, 5, 2048),)
    if name == "lag_mac_ring":
        return hopper_kernels.lag_mac_ring, (randn(2, 3, 256), randn(2, 3, 256),
                                             randn(2, 2, 256), randn(2, 2, 256),
                                             randn(2, 3, 256), randn(2, 3, 256))
    return hopper_kernels.lag_mac, (randn(2, 1 + 4 + 3, 256), randn(2, 8, 256),
                                    randn(2, 3, 256), randn(2, 3, 256), 4, 1)


@pytest.mark.parametrize("name,i", [("rfft_packed", 0), ("lag_mac_ring", 0),
                                    ("lag_mac_ring", 2), ("lag_mac_ring", 4),
                                    ("lag_mac", 0), ("lag_mac", 2),
                                    ("rfft_packed_stream", 0)])
def test_kernels_refuse_operands_that_require_grad(cuda, name, i):
    """K1 / K7 / K15 / K2: an operand that requires grad (argument ``i``:
    the signal, spectra, ring or H), with grad enabled, raises the
    no-backward error (a launch would return an output with no grad_fn);
    under no_grad the same call returns what it returns on the detached
    operands."""
    fn, args = _grad_operands(name, cuda)
    want = fn(*args)
    args = list(args)
    args[i] = args[i].clone().requires_grad_(True)
    before = fn.launches
    with pytest.raises(_build.NoBackwardError, match="no backward"):
        fn(*args)
    assert fn.launches == before
    with torch.no_grad():
        got = fn(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert not a.requires_grad
        assert torch.equal(a, b)


def test_gradient_paths_on_cuda(cuda):
    """The autograd twin's engines on the card: fir_offline (conv1d, no hand
    kernel) gives the CPU gradient; mono.process, whose sections run hand
    kernels, raises instead of returning a gradient without them."""
    rng = np.random.default_rng(0x1557)
    x = rng.standard_normal(300).astype(np.float32)
    taps = rng.standard_normal(16).astype(np.float32)
    grads = []
    for dev in (CPU, cuda):
        t = torch.tensor(taps, device=dev, requires_grad=True)
        torch.sum(time_domain.fir_offline(torch.from_numpy(x).to(dev), t) ** 2).backward()
        grads.append(t.grad.cpu().numpy())
    assert snr_db(grads[0], grads[1]) >= SNR_CHAIN_DB
    scheme = mono.PartitionScheme((32, 128), zero_latency=True)
    ir = mono.prepare_ir(scheme, rng.standard_normal(500).astype(np.float32),
                         offline_tail=False, device=cuda)
    st = mono.init_state(scheme, ir, ())
    xg = torch.randn(512, device=cuda, requires_grad=True)
    with pytest.raises(_build.NoBackwardError, match="K10 rfft_small"):
        mono.process(ir, st, xg)


def test_parallel_world_one_on_cuda(cuda):
    """``parallel`` on one card over NCCL (world size 1): the sharded
    offline scheme runs its fused section as K2 -> K15 (lead_skip 1) -> K4
    and matches process_offline; N-to-mono sums it; the FFT pair round-trips."""
    import torch.distributed as dist

    from hisstools_library_tpu_torch import parallel

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        rng = np.random.default_rng(5)
        scheme = mono.PartitionScheme((4096,), zero_latency=False)
        ir = mono.prepare_ir(scheme, (rng.standard_normal((4, 3 * 2048 + 100)) * 0.2)
                             .astype(np.float32), offline_tail=False, device=cuda)
        x = torch.from_numpy(rng.standard_normal((4, 2048 * 8)).astype(np.float32)).to(cuda)
        for name in ("rfft_packed_stream", "rifft_packed_tail"):
            getattr(hopper_fft, name).launches = 0
        hopper_kernels.lag_mac.launches = 0
        y = parallel.scheme_offline_sharded(mesh, scheme, ir, x).full_tensor()
        assert hopper_fft.rfft_packed_stream.launches == 1
        assert hopper_kernels.lag_mac.launches == 1
        assert hopper_fft.rifft_packed_tail.launches == 1
        ref = mono.process_offline(ir, x)
        assert snr_db(ref.cpu().numpy(), y.cpu().numpy()) >= SNR_CHAIN_DB
        y1 = parallel.n_to_one_offline(mesh, scheme, ir, x).full_tensor()
        assert snr_db(ref.sum(0).cpu().numpy(), y1.cpu().numpy()) >= SNR_CHAIN_DB
        xr = x[0, :1 << 14].contiguous()
        pr, pi = parallel.rfft_sharded(mesh, xr)
        back = parallel.rifft_sharded(mesh, pr, pi).full_tensor() / (2 << 14)
        assert snr_db(xr.cpu().numpy(), back.cpu().numpy()) >= SNR_CHAIN_DB
    finally:
        dist.destroy_process_group()


# -- double-float FFT and determinism on the card ------------------------------

def test_df64_selfcheck_on_cuda(cuda):
    """The compensated arithmetic survives the card's element-wise kernels
    (a contracted FMA or a reassociated sum would give ~1e-7)."""
    from hisstools_library_tpu_torch.fft import df64
    assert df64.selfcheck(device=cuda) < 1e-10


def test_df64_round_trip_on_cuda(cuda):
    """rifft_df64(rfft_df64(x)) == 2N x at (4, 4096) on the card, >= 250 dB
    against float64, and the same planes as the CPU's (one rounding an op
    on both)."""
    from hisstools_library_tpu_torch.fft import df64
    x = np.random.default_rng(0xDF64).standard_normal((4, 4096)).astype(np.float32)
    planes = df64.rfft_df64(torch.from_numpy(x).to(cuda))
    y_h, y_l = df64.rifft_df64(*planes)
    assert y_h.device.type == "cuda"
    y = df64.dd_to_f64(y_h, y_l)
    assert snr_db(2.0 * 4096 * x.astype(np.float64), y) >= 250.0
    for card, cpu in zip(planes, df64.rfft_df64(x, device=CPU)):
        assert snr_db(cpu.numpy(), card.cpu().numpy()) >= 250.0


def _twice_case(name, dev):
    """(wrapper, args, kwargs) of each kernel at a small shape."""
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev)

    mod = (hopper_kernels if name in ("lag_mac_causal", "lag_mac_ring", "hop_fire", "lag_mac")
           else hopper_fft)
    fn = getattr(mod, name)
    if name in ("rfft_packed_stream", "lag_mac_causal", "rifft_packed_tail"):
        return fn, _inputs(name, 4096, dev), {}
    if name == "rfft_packed":
        return fn, (randn(3, 4096),), {}
    if name in ("rifft_packed", "rifft_small", "hop_fire", "lag_mac"):
        shape = {"rifft_packed": (3, 4096), "rifft_small": (385, 256),
                 "hop_fire": (128, 256, 3, False), "lag_mac": (3, 1, 48, 47, 1024)}[name]
        return (fn, *_slice_inputs(name, shape, dev))
    if name in ("lag_mac_ring", "rfft_small", "fastfir_chain_stream"):
        shape = {"lag_mac_ring": (3, 4, 14, 4096), "rfft_small": (385, 128),
                 "fastfir_chain_stream": (2, 3, 2, 1 << 14, True)}[name]
        return (fn, *_stream_inputs(name, shape, dev))
    if name == "fastfir_chain":
        x2d, (hr, hi) = _chain_inputs(2, 5, 7, 1 << 14, dev)
        return fn, (x2d, hr, hi, 1.0 / (4.0 * (1 << 14))), {}
    if name in ("fft_split", "fft_tiny"):
        n = 2048 if name == "fft_split" else 16
        return fn, (randn(3, n), randn(3, n)), dict(inverse=True)
    if name == "rfft_packed_split":
        return fn, (randn(1, 1 << 18),), {}
    if name == "rifft_packed_split":
        return fn, (randn(1, 1 << 17), randn(1, 1 << 17)), {}
    if name == "rfft_tiny":
        return fn, (randn(257, 16),), {}
    if name == "rifft_tiny":
        return fn, (randn(3, 86, 8), randn(3, 86, 8)), {}
    n = 1024 if "small" in name else 16
    w = _window(n, dev)
    if name.startswith("rfft"):  # frames in place from an unfold view
        return fn, (randn(2, 8 * (n // 2) + n).unfold(-1, n, n // 2), w), {}
    return fn, (randn(2, 9, n // 2), randn(2, 9, n // 2), w, 0.5 / n), {}


TWICE_KERNELS = ["rfft_packed", "rfft_packed_stream", "lag_mac_causal", "rifft_packed_tail",
                 "rifft_packed", "lag_mac_ring", "fastfir_chain", "fastfir_chain_stream",
                 "hop_fire", "rfft_small", "rifft_small", "lag_mac", "fft_split",
                 "rfft_packed_split", "rifft_packed_split", "rfft_small_windowed",
                 "rifft_small_windowed", "rfft_tiny", "rifft_tiny", "rfft_tiny_windowed",
                 "rifft_tiny_windowed", "fft_tiny"]


@pytest.mark.parametrize("name", TWICE_KERNELS)
def test_kernel_twice_bit_equal(cuda, name):
    """Two launches on the same inputs give the same bits and leave the
    inputs as they were, the second into blocks the caching allocator hands
    back full of NaN (so an output element the kernel never writes shows)."""
    fn, args, kw = _twice_case(name, cuda)
    tensors = [a for a in list(args) + list(kw.values()) if torch.is_tensor(a)]
    before = [t.clone() for t in tensors]
    first = fn(*args, **kw)
    first = first if isinstance(first, tuple) else (first,)
    torch.cuda.synchronize()
    assert all(torch.equal(t, b) for t, b in zip(tensors, before))
    torch.cuda.empty_cache()
    dirty = [torch.full((1 << 26,), float("nan"), device=cuda)]
    dirty += [torch.full((1 << 18,), float("nan"), device=cuda) for _ in range(16)]
    torch.cuda.synchronize()
    del dirty
    launches = fn.launches
    second = fn(*args, **kw)
    second = second if isinstance(second, tuple) else (second,)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for a, b in zip(first, second):
        assert a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
