"""K8's split chain (``csrc/fastfir_stream.cu``) with other one-pass plans
for its two transforms, side by side.

    python3 tools/k8_layouts.py [--only NAME,...] [--shape C,T,P,N]

For each entry of ``LAYOUTS`` (``OnePass`` parameters at complex M = 2^LM:
log2 of the columns, blocks a frame, threads a block, blocks an SM for
``__launch_bounds__``), copies ``hisstools_library_tpu_torch/csrc`` under
``build/k8_layouts/NAME/``, puts those plans in place of ``K8Pass`` (K1's
plan, which ``shipped`` keeps) at those sizes, and builds
``fastfir_stream.cu`` with the ring MAC (``ring_mac.cu``, its state kernel)
(``tools/layouts.py``). Then, on one card in one process,
at the two-tier near tier (C 128, T 16, P 3, N 2^14) unless ``--shape``
names another, with and without lag0, it prints ptxas's registers of each
transform's instantiation at the shape's size, the device ms of K8's three
launches (the forward ``fft_onepass`` with the stream loader, the state
kernel, the inverse ``fft_onepass`` with the tail store; ``torch.profiler``,
mean of 10), their sum, and the SNR against ``fastfir_chain_stream_plain``.
Every entry computes the same function.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import sys
from pathlib import Path

import torch

from layouts import build, card, kernel_ms, ptxas, snr

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

SRC = "fastfir_stream.cu"
ALIAS = "template <int LM>\nusing K8Pass = K1Pass<LM>;\n"
# name: {LM: (LCols, C, NT, MinBlocks)} in place of K8Pass<LM> ({}: K1's plan).
LAYOUTS = {
    "shipped": {},
    "13-cluster2-256t": {13: (7, 2, 256, 4)},   # 47 KB a block, 4 an SM
    "13-256t": {13: (7, 1, 256, 2)},            # one block a frame, 256 threads
    "13-cluster4-128t": {13: (7, 4, 128, 8)},   # 28 KB a block, 8 an SM
    "13-cols64-cluster2": {13: (6, 2, 256, 4)},  # 64 columns of 128 points
}


def _source(text: str, layout: dict) -> str:
    if text.count(ALIAS) != 1:
        raise SystemExit(f"k8_layouts: the K8Pass alias is not once in {SRC}")
    plans = "".join(f"template <>\nstruct K8Plan<{lm}> {{\n  using T = OnePass<{lm}, "
                    f"{', '.join(map(str, p))}>;\n}};\n" for lm, p in layout.items())
    return text.replace(ALIAS, "template <int LM>\nstruct K8Plan {\n  using T = K1Pass<LM>;\n};\n"
                        + plans + "template <int LM>\nusing K8Pass = typename K8Plan<LM>::T;\n")


def _registers(log: str, lm: int) -> list:
    """ptxas's register lines of the fft_onepass instantiations at M = 2^lm."""
    return [f"{'forward' if e.endswith('ELi4ELi0EEEvPKfS4_PfS5_PK6float2iif') else 'inverse'} "
            f"{line}" for e, lines in ptxas(log, f"OnePassILi{lm}E", ("registers",)).items()
            for line in lines]


def _launch_ms(fn, runs: int = 10) -> dict:
    """Device ms of K8's three launches: the forward, the state kernel, the
    inverse."""
    out = {"forward": 0.0, "state": 0.0, "inverse": 0.0}
    for key, ms in kernel_ms(fn, runs).items():
        out["state" if "ring_mac" in key else
            "forward" if re.search(r", 4, 0>", key) else "inverse"] += ms
    return out


def _change(name: str, d: Path) -> None:
    (d / SRC).write_text(_source((d / SRC).read_text(), LAYOUTS[name]))


def main() -> None:
    args = sys.argv[1:]
    names = list(LAYOUTS)
    c, t, p, n = 128, 16, 3, 1 << 14
    while args:
        if args[0] == "--only" and len(args) > 1:
            names = args[1].split(",")
        elif args[0] == "--shape" and len(args) > 1:
            c, t, p, n = (int(v) for v in args[1].split(","))
        else:
            raise SystemExit(__doc__)
        args = args[2:]
    smi = card("k8_layouts")
    libs = build("k8_layouts", names, [SRC, "ring_mac.cu"], _change, ["hst_fastfir_stream"])
    dev = torch.device("cuda", 0)
    stream = _build.stream(dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    k = n // 2

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x2d, prev, rr, ri = randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k)
    hr, hi = randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3
    lag0 = (randn(c, k) * 1e-3, randn(c, k) * 1e-3)
    scale = 1.0 / (4.0 * n)
    y, nr, ni = torch.empty_like(x2d), torch.empty_like(rr), torch.empty_like(ri)
    spectra = torch.empty(4, c * t, k, device=dev)
    tw = hopper_fft._twiddles(n, dev)
    lm = n.bit_length() - 2
    for name, v in libs.items():
        so = v.so
        print(f"{name} M = 2^{lm}: {'; '.join(_registers(v.log, lm))}", flush=True)
        for l0 in ((None, None), lag0):
            def call():
                rc = so.hst_fastfir_stream(
                    x2d.data_ptr(), prev.data_ptr(), rr.data_ptr(), ri.data_ptr(),
                    hr.data_ptr(), hi.data_ptr(), p * k,
                    None if l0[0] is None else l0[0].data_ptr(),
                    None if l0[1] is None else l0[1].data_ptr(), k, y.data_ptr(),
                    nr.data_ptr(), ni.data_ptr(), spectra.data_ptr(), tw.data_ptr(), c, t, p,
                    n, scale, stream)
                if rc:
                    raise SystemExit(f"k8_layouts: {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            want = hopper_fft.fastfir_chain_stream_plain(x2d, prev, rr, ri, hr, hi, scale, *l0)
            db = min(snr(w, g) for w, g in zip(want, (y, nr, ni)))
            ms = _launch_ms(call)
            print(f"K8 ({c}, T {t}, P {p}, {n}{', lag0' if l0[0] is not None else ''}) {name}: "
                  f"device forward {ms['forward']:.4f} state {ms['state']:.4f} inverse "
                  f"{ms['inverse']:.4f} total {sum(ms.values()):.4f} ms, SNR vs plain "
                  f"{db:.2f} dB [{smi}]", flush=True)


if __name__ == "__main__":
    main()
