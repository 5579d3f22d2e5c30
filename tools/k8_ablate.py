"""K8 fastfir_chain_stream in its fused four-step form, in measurement variants.

    python3 tools/k8_ablate.py CHECKOUT

CHECKOUT is a checkout whose ``csrc/fastfir_chain.cu`` still serves K8 as
the stream instantiation of the chain family (K8's earlier, fused form:
the forward column pass, the middle phase ``chain_mid`` that also moves
the carried ring and H through a 4-block cluster and writes the new ring
back, the inverse column pass). For each entry of ``VARIANTS`` (text
replacements in that file), copies CHECKOUT's ``csrc`` under
``build/k8_ablate/NAME/``, applies them and builds ``fastfir_chain.cu``
alone into a shared library (one ``nvcc`` each, all started together,
``-fno-gnu-unique``). Then, on one card in one process, at chip_smoke's four
128-channel K8 shapes (the two-tier near tier (T 16, P 3, 2^14) with and
without lag0, the single 2^17 section (T 2, P 8), the far tier (T 4, P 8,
2^16)) it prints the device ms of the three launches (A the forward column
pass ``fft_cols``, B ``chain_mid``, C ``fft_cols_tail``; ``torch.profiler``,
mean of 10) and the SNR against ``fastfir_chain_stream_plain``.

``shipped`` is the checkout's kernel. ``no-cluster`` computes the same
function with each block loading its own bins by strided reads (no
distributed shared memory). ``no-state`` is there to time the state
hand-off: the ring and H are neither loaded (zeros, no cluster) nor the new
ring written; its SNR is not the kernel's. B(shipped) - B(no-state) is the
share of the middle phase that moves the carried state.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

SRC = "fastfir_chain.cu"
NO_CLUSTER = [("  const bool cluster_h = in_smem;", "  const bool cluster_h = false;"),
              ("__cluster_dims__(kCluster, 1, 1) ", "")]
VARIANTS = {
    "shipped": [],
    "no-cluster": NO_CLUSTER,
    "no-state": NO_CLUSTER + [
        ("        hs[lag * NB + b] = make_float2(__ldg(&hr[o]), __ldg(&hi[o]));\n"
         "        if (rr != nullptr) ring[lag * NB + b] = make_float2(__ldg(&rr[o]), "
         "__ldg(&ri[o]));",
         "        hs[lag * NB + b] = make_float2(0.f, 0.f);\n"
         "        if (rr != nullptr) ring[lag * NB + b] = make_float2(0.f, 0.f);"),
        ("  if (a.rout_re != nullptr) {", "  if (false) {")],
}
SHAPES = ((16, 3, 1 << 14, True), (16, 3, 1 << 14, False), (2, 8, 1 << 17, False),
          (4, 8, 1 << 16, False))
PHASES = (("A", "fft_cols"), ("B", "chain_mid"), ("C", "fft_cols_tail"))
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The fused form's entry: x, prev, rin_re, rin_im, h_re, h_im, h_cstride,
# l0_re, l0_im, l0_cstride, y, rout_re, rout_im, scratch, gring, tw,
# channels, t, p, n, scale, stream.
FUSED_SIGNATURE = [_P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                   _I, _F, _P]


def _build_all(src_dir: Path):
    out = ROOT / "build" / "k8_ablate"
    jobs = {}
    for name, reps in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        text = (d / SRC).read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"k8_ablate: {name}: {old!r} is not once in {SRC}")
            text = text.replace(old, new)
        (d / SRC).write_text(text)
        lib = d / "libk8.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-shared",
             str(d / SRC), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k8_ablate: {name}: nvcc failed\n{log}")
        so = ctypes.CDLL(str(lib))
        so.hst_fastfir_chain.argtypes = FUSED_SIGNATURE
        so.hst_fastfir_chain_ring_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        so.hst_fastfir_chain_ring_scratch.restype = ctypes.c_longlong
        libs[name] = so
    return libs


def _phase_ms(fn, runs: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = {e.key: e.device_time_total / runs / 1e3 for e in prof.key_averages()
             if e.device_type.name == "CUDA" and e.device_time_total > 0}
    out = {label: sum(v for k, v in times.items() if re.search(rf"\b{stem}<", k))
           for label, stem in PHASES}
    out["total"] = sum(times.values())
    return out


def _snr(want, got) -> float:
    err = float(((got.double() - want.double()) ** 2).sum())
    ref = float((want.double() ** 2).sum())
    return float("inf") if err == 0 else 10 * torch.log10(torch.tensor(ref / err)).item()


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("k8_ablate: no CUDA device")
    src_dir = Path(sys.argv[1]).resolve() / "hisstools_library_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    libs = _build_all(src_dir)
    dev = torch.device("cuda", 0)
    stream = _build.stream(dev)
    c = 128
    for t, p, n, lag0 in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(12)
        k = n // 2

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        x2d, prev, rr, ri = randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k)
        hr, hi = randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3
        l0 = (randn(c, k) * 1e-3, randn(c, k) * 1e-3) if lag0 else (None, None)
        scale = 1.0 / (4.0 * n)
        want = hopper_fft.fastfir_chain_stream_plain(x2d, prev, rr, ri, hr, hi, scale, *l0)
        y, nr, ni = torch.empty_like(x2d), torch.empty_like(rr), torch.empty_like(ri)
        scratch = torch.empty(c * t, n, device=dev)
        tw = hopper_fft._twiddles(n, dev)
        shape = f"(128, T {t}, P {p}, {n}{', lag0' if lag0 else ''})"
        for name, so in libs.items():
            floats2 = so.hst_fastfir_chain_ring_scratch(n, p)
            gring = torch.empty(c, floats2, 2, device=dev) if floats2 else None

            def call():
                rc = so.hst_fastfir_chain(
                    x2d.data_ptr(), prev.data_ptr(), rr.data_ptr(), ri.data_ptr(),
                    hr.data_ptr(), hi.data_ptr(), p * k,
                    None if l0[0] is None else l0[0].data_ptr(),
                    None if l0[1] is None else l0[1].data_ptr(), k, y.data_ptr(),
                    nr.data_ptr(), ni.data_ptr(), scratch.data_ptr(),
                    None if gring is None else gring.data_ptr(), tw.data_ptr(), c, t, p, n,
                    scale, stream)
                if rc:
                    raise SystemExit(f"k8_ablate: {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            snr = min(_snr(w, g) for w, g in zip(want, (y, nr, ni)))
            ph = _phase_ms(call)
            print(f"K8 {shape} {name}: device A {ph['A']:.4f} B {ph['B']:.4f} C {ph['C']:.4f} "
                  f"total {ph['total']:.4f} ms, SNR vs plain {snr:.2f} dB [{smi}]", flush=True)
        del x2d, prev, rr, ri, hr, hi, l0, want, y, nr, ni, scratch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
