"""K2 rfft_packed_stream's one-pass route at other plans and variants, side by side.

    python3 tools/k2_layouts.py [--only NAME,...]

For each entry of ``LAYOUTS`` (the ``OnePass`` parameters of some complex
sizes M = 2^LM in place of K1's plan: log2 of the columns, blocks a frame,
threads a block, blocks an SM for ``__launch_bounds__``; and text
replacements in ``fft_large.cuh`` that make a variant of the kernel), copies
``hisstools_library_tpu_torch/csrc`` under ``build/k2_layouts/NAME/``, gives
``rfft_packed_stream.cu`` those plans, applies the replacements, and builds
``rfft_packed_stream.cu`` alone (``tools/layouts.py``). It then prints, for
each entry, ptxas's registers, stack and spills of the instantiations at M =
2^11 and 2^15, and, on the same card in one process, the time of
``hst_rfft_packed_stream`` at ``SHAPES`` (C, T, H): offline-no-tail's 4096
section (128, 236, 2^11) and (128, 16, 2^15): CUDA events (median of 20
after a warm-up), a launch in a CUDA graph (20 launches replayed, median of
5) and the kernel's own time by ``torch.profiler`` (mean of 10), with the
TB/s of the function's bytes (x once and the packed spectra: 12 H a hop),
the SNR against the plain version and the frames resident at once, beside
``torch.stft`` on the same input and a device-to-device copy of the
function's bytes (6 H a hop read, 6 H written).
The entry ``shipped`` is the plan ``rfft_packed_stream.cu`` ships.

Variants that compute the same function: the plans, and ``2frames`` (a
block runs two frames one after the other, the twiddle tables staged once;
half the grid). Variants that time a part of the kernel (their SNR is not
the kernel's): ``no-load`` (synthetic input in place of the frame's loads),
``no-pack`` (the rows' bins stored as split planes, no split step),
``zero-lower`` (every frame's lower half zero: x read once, no second read
of a block).

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import sys

import torch

from k1_layouts import NO_LOAD, NO_PACK
from layouts import build, card, device_ms, events_ms, graph_ms, ptxas, replace_once, snr
from layouts import variant_names

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

# Two frames a block, one after the other: the loop over the frames around
# the kernel's body, the twiddle tables fetched and staged on the first.
TWO_FRAMES = [
    ("  const long long frame = blockIdx.x / C;\n  const int tid = threadIdx.x;",
     "  const int tid = threadIdx.x;\n  for (int fi = 0; fi < 2; ++fi) {\n"
     "  const long long frame = 2 * (blockIdx.x / C) + fi;"),
    ("  tl.fetch(tw, [&](int i) { return i << (log_n - kTlLog); });",
     "  if (fi == 0) {\n  tl.fetch(tw, [&](int i) { return i << (log_n - kTlLog); });"),
    ("(rank, i, G::kRows); });\n  }\n", "(rank, i, G::kRows); });\n  }\n  }\n"),
    ("    tl.put(twd.tl);", "    if (fi == 0) {\n    tl.put(twd.tl);"),
    ("      wrows.put(wrow);\n    }\n", "      wrows.put(wrow);\n    }\n    }\n"),
    ("rank, G::kRows, scale);\n  }\n}\n", "rank, G::kRows, scale);\n  }\n  }\n}\n"),
    ("  cfg.gridDim = dim3((unsigned)(frames * G::kBlocks));",
     "  cfg.gridDim = dim3((unsigned)((frames + 1) / 2 * G::kBlocks));"),
]
# Every frame's lower half zero, as at a channel's first hop.
ZERO_LOWER = [("&& frame % hops == 0;", "&& (frame % hops == 0 || kLoad == kLoadStream);")]

# name: ({LM: (LCols, C, NT, MinBlocks)} in place of K1's plan, or {} for
# K1's plan; replacements in fft_large.cuh).
LAYOUTS = {
    "shipped": ({}, []),
    "256t-3b": ({11: (6, 1, 256, 3)}, []),
    "256t-4b": ({11: (6, 1, 256, 4)}, []),
    "128t-4b": ({11: (6, 1, 128, 4)}, []),
    "128t-6b": ({11: (6, 1, 128, 6)}, []),
    "128t-8b": ({11: (6, 1, 128, 8)}, []),
    "cols32": ({11: (5, 1, 256, 2)}, []),
    "cols32-4b": ({11: (5, 1, 256, 4)}, []),
    "2frames": ({}, TWO_FRAMES),
    "2frames-4b": ({11: (6, 1, 256, 4)}, TWO_FRAMES),
    "no-load": ({}, NO_LOAD),
    "no-pack": ({}, NO_PACK),
    "zero-lower": ({}, ZERO_LOWER),
}
SHAPES = ((128, 236, 1 << 11), (128, 16, 1 << 15))
PARTS = ("no-load", "no-pack", "zero-lower")  # their SNR is not the kernel's


def _change(name: str, d) -> None:
    layout, patches = LAYOUTS[name]
    if layout:
        plans = "".join(f"template <>\nstruct K2Plan<{lm}> {{\n  using T = OnePass<{lm}, "
                        f"{', '.join(map(str, p))}>;\n}};\n" for lm, p in layout.items())
        src = d / "rfft_packed_stream.cu"
        src.write_text(replace_once(
            src.read_text(),
            [("template <int LM>\nusing K2Pass = K1Pass<LM>;\n",
              "template <int LM>\nstruct K2Plan {\n  using T = K1Pass<LM>;\n};\n" + plans
              + "template <int LM>\nusing K2Pass = typename K2Plan<LM>::T;\n")],
            f"{name}: rfft_packed_stream.cu"))
    large = d / "fft_large.cuh"
    large.write_text(replace_once(large.read_text(), patches, f"{name}: fft_large.cuh"))


def main() -> None:
    names = variant_names(sys.argv[1:], LAYOUTS, __doc__)
    smi = card("k2_layouts")
    libs = build("k2_layouts", names, ["rfft_packed_stream.cu"], _change,
                 ["hst_rfft_packed_stream", "hst_rfft_packed_stream_resident"])
    for name, v in libs.items():
        for entry, lines in ptxas(v.log, "OnePassILi1",
                                  ("registers", "stack frame", "spill")).items():
            lm = re.search(r"OnePassILi(\d+)E", entry).group(1)
            if lm in ("11", "15"):
                for line in lines:
                    print(f"{name} M = 2^{lm}: {line}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    for c, t, h in SHAPES:
        n = 2 * h
        x = torch.randn(c, t, h, generator=gen, device=dev)
        re_, im_ = torch.empty_like(x), torch.empty_like(x)
        tw = hopper_fft._twiddles(n, dev)
        want = hopper_fft.rfft_packed_stream_plain(x)
        nbytes = 12 * x.numel()
        sig = torch.nn.functional.pad(x.reshape(c, -1), (h, 0))
        win = torch.ones(n, device=dev)

        def stft():
            return torch.stft(sig, n, hop_length=h, window=win, center=False,
                              return_complex=True)

        src = torch.empty(3 * x.numel() // 2, device=dev)
        dst = torch.empty_like(src)
        copy_ms = events_ms(lambda: dst.copy_(src))
        print(f"({c}, {t}, {h}): bound {nbytes / 3.35e9:.4f} ms ({nbytes / 1e9:.3f} GB); "
              f"torch.stft {events_ms(stft):.4f} ms (device {device_ms(stft):.4f}); copy of "
              f"the same bytes {copy_ms:.4f} ms [{smi}]", flush=True)
        del src, dst, sig
        for name, v in libs.items():
            def call(so=v.so):  # on the current stream: a graph captures on its own
                rc = so.hst_rfft_packed_stream(x.data_ptr(), re_.data_ptr(), im_.data_ptr(),
                                               tw.data_ptr(), c, t, n, _build.stream(dev))
                if rc:
                    raise SystemExit(f"{name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            dms = device_ms(call)
            tag = " (a part: not the kernel's SNR)" if name in PARTS else ""
            print(f"({c}, {t}, {h}) {name}: {events_ms(call):.4f} ms, graph "
                  f"{graph_ms(call):.4f} ms (device {dms:.4f}, {nbytes / dms / 1e9:.3f} TB/s), "
                  f"SNR vs plain {snr(want, (re_, im_)):.2f} dB{tag}, "
                  f"{v.so.hst_rfft_packed_stream_resident(n)} frames resident [{smi}]",
                  flush=True)
        del x, re_, im_, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
