"""K1 rfft_packed's one-pass route at other plans and variants, side by side.

    python3 tools/k1_layouts.py [--only NAME,...] [--sass]

For each entry of ``LAYOUTS`` (the ``OnePass`` parameters of some complex
sizes M = 2^LM: log2 of the columns, blocks a frame, threads a block, blocks
an SM for ``__launch_bounds__``; and text replacements in ``fft_large.cuh``
that make a variant of the kernel), copies ``hisstools_library_tpu_torch/csrc``
under ``build/k1_layouts/NAME/``, puts the plans in ``fft_large.cuh`` in
place of ``K1Plan`` at those sizes, applies the replacements, and builds
``rfft_packed.cu`` alone (``tools/layouts.py``). It then prints, for each
entry, ptxas's
registers and stack of the instantiations at M = 2^13..2^16, and, on the
same card in one process, the device time of ``hst_rfft_packed`` at (1920,
2^16) (the FastFIR IR preparation) and at (128, N), N = 2^14..2^17 (CUDA
events, median of 20 after a warm-up, and the kernel's own time by
``torch.profiler``, mean of 10), with the SNR against the plain
packed transform and the frames resident at once, beside
``torch.fft.rfft`` on the same inputs and a device-to-device copy of the
same bytes. The plan that ``fft_large.cuh`` ships is the entry
``shipped``. An entry whose replacements change what the kernel computes
(``no-pack``: the rows' bins stored as split planes, no split step;
``no-load``: synthetic input in place of the frame's loads;
``local-rows``: the exchange kept inside each block, block barriers) is
there to time a part of it; its SNR is not the kernel's.
``table-dft`` (the sub-DFTs' twiddles read from the W_512 table in shared
memory) and ``joined-barrier`` (the first barrier after the columns'
step-2 DFTs, not around them) compute the same function.
``--sass`` also prints, for each entry, the instructions of the M = 2^15
kernel by opcode (``cuobjdump -sass``; a static count of the straight-line
code).

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import subprocess
import sys
from pathlib import Path

import torch

from layouts import build, card, device_ms, events_ms, ptxas, replace_once, snr
from layouts import variant_names

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

# The sub-DFTs on the W_512 table in shared memory, as before dft_c.
TABLE_DFT = [("dft_c<CB>(v[u]);", "reg_dft<CB, true>(v[u], twd.tl, kTlLog);"),
             ("dft_c<CA>(v[u]);", "reg_dft<CA, true>(v[u], twd.tl, kTlLog);"),
             ("dft_c<B>(v[u]);", "reg_dft<B, true>(v[u], twd.tl, kTlLog);"),
             ("dft_c<A>(w);", "reg_dft<A, true>(w, twd.tl, kTlLog);")]
# The rows' bins stored as they are (split planes), no split step.
NO_PACK = [("    for (int k1 = 0; k1 < A; ++k1) g[k1] = w[k1];",
            "    for (int k1 = 0; k1 < A; ++k1)\n"
            "      store_bin<kStoreSplit>(out, out_im, frame * (long long)m, rank * G::kOwnRows +\n"
            "                             t % G::kOwnRows + G::kRows * (t / G::kOwnRows + B * k1),\n"
            "                             w[k1]);"),
           ("    pack_rows_tile<L, G::kLdR", "    if (false) pack_rows_tile<L, G::kLdR")]

# No frame read from HBM: synthetic column data (frame and thread numbers).
NO_LOAD = [("        v[u][j2] = load_elem<kPair ? kLoadSplit : kLoad>(a, lo, tw, frame,\n"
            + " " * 57 + "col + G::kCols * (j1 + CA * j2), m,\n" + " " * 57 + "first);",
            "        v[u][j2] = make_float2((float)(frame + j2), (float)(t + j1));")]

# Each block's column outputs stored into its own row tiles, behind block
# barriers: no distributed shared memory, no cluster barrier.
LOCAL_ROWS = [("        frame_smem<C>(lsm, owner)[slot * G::kLdR + col] = v[u][k1];",
               "        lsm[slot * G::kLdR + col] = v[u][k1];"),
              ("    frame_arrive<C>();  // this block has read its columns", ""),
              ("    frame_wait<C>();  // every block has read its columns",
               "    __syncthreads();  // every block has read its columns"),
              ("  frame_arrive<C>();\n  frame_wait<C>();  // every row is in place",
               "  __syncthreads();  // every row is in place")]
# The first barrier whole, after the columns' step-2 DFTs.
JOINED_BARRIER = [("    frame_arrive<C>();  // this block has read its columns", ""),
                  ("    frame_wait<C>();  // every block has read its columns",
                   "    frame_arrive<C>();\n    frame_wait<C>();  // every block has read its columns")]

# name: ({LM: (LCols, C, NT, MinBlocks)} in place of K1Plan<LM>, or {} for
# the shipped plan; replacements in fft_large.cuh).
LAYOUTS = {
    "shipped": ({}, []),
    "256t": ({13: (7, 1, 256, 2), 14: (7, 2, 256, 2), 16: (7, 8, 256, 2)}, []),
    "512t": ({15: (7, 4, 512, 2)}, []),
    "32KB-256t": ({15: (7, 8, 256, 4), 14: (7, 4, 256, 4), 13: (7, 2, 256, 4)}, []),
    "rows256": ({15: (8, 4, 256, 2)}, []),                       # 256 x 128
    "128KB-512t": ({15: (7, 2, 512, 1), 16: (8, 4, 512, 1)}, []),  # Cl17's shape
    "table-dft": ({}, TABLE_DFT),
    "joined-barrier": ({}, JOINED_BARRIER),
    "no-pack": ({}, NO_PACK),
    "no-load": ({}, NO_LOAD),
    "no-load-no-pack": ({}, NO_LOAD + NO_PACK),
    "no-load-local-rows": ({}, NO_LOAD + LOCAL_ROWS),
}
SHAPES = ((1920, 1 << 16), (128, 1 << 17), (128, 1 << 16), (128, 1 << 15), (128, 1 << 14))


def _source(text: str, layout) -> str:
    for lm, p in layout.items():
        text, n = re.subn(rf"(struct K1Plan<{lm}> {{\n  using T = )OnePass<[^>]*>",
                          rf"\g<1>OnePass<{lm}, {', '.join(map(str, p))}>", text)
        if n != 1:
            raise SystemExit(f"k1_layouts: no K1Plan<{lm}> in fft_large.cuh")
    return text


def _change(name: str, d: Path) -> None:
    layout, patches = LAYOUTS[name]
    large = d / "fft_large.cuh"
    large.write_text(replace_once(_source(large.read_text(), layout), patches,
                                  f"{name}: fft_large.cuh"))


def _sass_counts(lib: Path, lm: int = 15) -> dict:
    """Opcode -> count in the SASS of the fft_onepass instantiation at M = 2^lm."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = f"OnePassILi{lm}E" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                op = m.group(1)
                counts[op] = counts.get(op, 0) + 1
    return counts


def main() -> None:
    args = sys.argv[1:]
    sass = "--sass" in args
    names = variant_names([a for a in args if a != "--sass"], LAYOUTS, __doc__)
    smi = card("k1_layouts")
    libs = build("k1_layouts", names, ["rfft_packed.cu"], _change,
                 ["hst_rfft_packed", "hst_rfft_packed_resident"])
    for name, v in libs.items():
        for entry, lines in ptxas(v.log, "OnePassILi1").items():
            lm = re.search(r"OnePassILi(\d+)E", entry).group(1)
            if lm in ("13", "14", "15", "16"):
                for line in lines:
                    print(f"{name} M = 2^{lm}: {line}", flush=True)
    if sass:
        for name, v in libs.items():
            counts = _sass_counts(v.lib)
            top = sorted(counts.items(), key=lambda kv: -kv[1])
            print(f"{name} M = 2^15 SASS: {sum(counts.values())} instructions; "
                  f"{', '.join(f'{k} {v}' for k, v in top[:28])}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    stream = _build.stream(dev)
    for b, n in SHAPES:
        x = torch.randn(b, n, generator=gen, device=dev)
        re_, im_ = torch.empty(b, n // 2, device=dev), torch.empty(b, n // 2, device=dev)
        tw = hopper_fft._twiddles(n, dev)
        want = hopper_fft.rfft_packed_plain(x)
        y = torch.empty_like(x)
        def rfft():
            return torch.fft.rfft(x, dim=-1)

        copy_ms = events_ms(lambda: y.copy_(x))
        print(f"({b}, {n}): torch.fft.rfft {events_ms(rfft):.4f} ms (device "
              f"{device_ms(rfft):.4f}), copy of the same bytes {copy_ms:.4f} ms [{smi}]",
              flush=True)
        del y
        for name, v in libs.items():
            def call(so=v.so):
                rc = so.hst_rfft_packed(x.data_ptr(), re_.data_ptr(), im_.data_ptr(),
                                        tw.data_ptr(), b, n, stream)
                if rc:
                    raise SystemExit(f"{name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            print(f"({b}, {n}) {name}: {events_ms(call):.4f} ms (device {device_ms(call):.4f}), "
                  f"SNR vs plain {snr(want, (re_, im_)):.2f} dB, "
                  f"{v.so.hst_rfft_packed_resident(n)} frames resident [{smi}]", flush=True)
        del x, re_, im_, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
