"""K4 and K6 (the real inverse on the one-pass route, ``csrc/rifft_packed_tail.cu``
and ``csrc/rifft_packed.cu``) with other one-pass plans, side by side.

    python3 tools/k4_layouts.py [--only NAME,...]

For each entry of ``LAYOUTS`` (``OnePass`` parameters at complex M = 2^LM:
log2 of the columns, blocks a frame, threads a block, blocks an SM for
``__launch_bounds__``), it puts those plans in place of ``K1Pass`` (K1's
plan, which ``shipped`` keeps) in the two files at those sizes, in a copy of
``csrc/`` under ``build/k4_layouts/NAME/``, and builds them alone
(``tools/layouts.py``). Then, on one card in one process, it prints ptxas's
registers, stack frame and spills of each inverse instantiation, the local
loads and stores (``LDL`` / ``STL``) in its SASS where ``cuobjdump`` is
there, and at K4's path shapes ((128, 16, 2^15), (128, 4, 2^15),
(128, 16, 2^13), (128, 236, 2^11)) and K6's ((128, 2^13), (128, 2^11)) the
device ms of a launch (20 launches in a CUDA graph, replayed between CUDA
events, median of 5) and the SNR against the plain version. Every entry computes the same function.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from layouts import build, card, graph_ms, ptxas, snr, variant_names

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

SRCS = ("rifft_packed_tail.cu", "rifft_packed.cu")
ANCHOR = "using namespace hst;\n"
# name: {LM: (LCols, C, NT, MinBlocks)} in place of K1Pass<LM> ({}: K1's plan).
LAYOUTS = {
    "shipped": {},
    "13-256t": {13: (7, 1, 256, 2)},             # one block a frame, 256 threads
    "13-cluster2-256t": {13: (7, 2, 256, 4)},    # 47 KB a block, 4 an SM
    "13-cluster2-256t-2": {13: (7, 2, 256, 2)},  # the same, up to 128 registers
    "13-cluster4-128t": {13: (7, 4, 128, 8)},    # 28 KB a block, 8 an SM
    "13-cols64-256t": {13: (6, 1, 256, 2)},      # 64 columns of 128 points
    "11-128t": {11: (6, 1, 128, 4)},             # 2048 points a block of 128 threads
    "11-256t-4": {11: (6, 1, 256, 4)},           # 4 blocks an SM for the registers
    "11-cols32": {11: (5, 1, 256, 2)},           # 32 columns of 64 points
    "11-cols32-128t": {11: (5, 1, 128, 4)},      # the same on 128 threads
}
# (kernel, shape of a packed plane): K4's path shapes, K6's.
CASES = [("K4", (128, 16, 1 << 15)), ("K4", (128, 4, 1 << 15)), ("K4", (128, 16, 1 << 13)),
         ("K4", (128, 236, 1 << 11)), ("K6", (128, 1 << 13)), ("K6", (128, 1 << 11))]


def _source(text: str, layout: dict) -> str:
    if text.count(ANCHOR) != 1 or "K1Pass<LM>" not in text:
        raise SystemExit("k4_layouts: the sources do not launch K1Pass<LM> as expected")
    plans = "".join(f"template <>\nstruct K4Plan<{lm}> {{\n  using T = OnePass<{lm}, "
                    f"{', '.join(map(str, p))}>;\n}};\n" for lm, p in layout.items())
    alias = ("template <int LM>\nstruct K4Plan {\n  using T = K1Pass<LM>;\n};\n" + plans
             + "template <int LM>\nusing K4Pass = typename K4Plan<LM>::T;\n")
    return text.replace(ANCHOR, ANCHOR + alias).replace("K1Pass<LM>", "K4Pass<LM>").replace(
        "using T = K4Pass<LM>;", "using T = K1Pass<LM>;")


def _local_ops(lib: Path) -> dict:
    """LDL / STL instructions in each fft_onepass function's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m.group(1) if "fft_onepass" in m.group(1) else None
        elif entry and re.search(r"\b(LDL|STL)\b", line):
            out[entry] = out.get(entry, 0) + 1
    return out


def _change(name: str, d: Path) -> None:
    for src in SRCS:
        (d / src).write_text(_source((d / src).read_text(), LAYOUTS[name]))


def main() -> None:
    names = variant_names(sys.argv[1:], LAYOUTS, __doc__)
    smi = card("k4_layouts")
    libs = build("k4_layouts", names, SRCS, _change,
                 ["hst_rifft_packed_tail", "hst_rifft_packed"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = {}
    for kernel, shape in CASES:
        n = 2 * shape[-1]
        re_, im_ = (torch.randn(*shape, generator=gen, device=dev) for _ in range(2))
        scale = 1.0 / (4.0 * n)
        want = (hopper_fft.rifft_packed_tail_plain(re_, im_, scale) if kernel == "K4"
                else hopper_fft.rifft_packed_plain(re_, im_))
        inputs[(kernel, shape)] = (re_, im_, scale, want, torch.empty_like(want),
                                   hopper_fft._twiddles(n, dev))
    for name, v in libs.items():
        so, local = v.so, _local_ops(v.lib)
        for entry, lines in ptxas(v.log, "fft_onepass").items():
            lm = re.search(r"OnePassILi(\d+)E", entry).group(1)
            store = "tail" if entry.endswith("ELi2ELi1EEEvPKfS4_PfS5_PK6float2iif") else "full"
            print(f"{name} M = 2^{lm} {store}: {'; '.join(lines)}; LDL/STL "
                  f"{local.get(entry, 'not read')}", flush=True)
        for kernel, shape in CASES:
            re_, im_, scale, want, out, tw = inputs[(kernel, shape)]
            frames, n = re_.numel() // shape[-1], 2 * shape[-1]

            def call():
                stream = _build.stream(dev)  # the capturing stream inside a graph
                if kernel == "K4":
                    rc = so.hst_rifft_packed_tail(re_.data_ptr(), im_.data_ptr(), out.data_ptr(),
                                                  tw.data_ptr(), frames, n, scale, stream)
                else:
                    rc = so.hst_rifft_packed(re_.data_ptr(), im_.data_ptr(), out.data_ptr(),
                                             tw.data_ptr(), frames, n, stream)
                if rc:
                    raise SystemExit(f"k4_layouts: {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            print(f"{kernel} {shape} {name}: device {graph_ms(call):.4f} ms, SNR vs plain "
                  f"{snr(want, out):.2f} dB [{smi}]", flush=True)


if __name__ == "__main__":
    main()
