"""K16 (``csrc/bin_product.cu``) in layout variants, side by side.

    python3 tools/bin_layouts.py [--only NAME,...]

For each entry of ``VARIANTS`` (text replacements in ``bin_product.cu``) it
builds that file alone in a copy of ``csrc/`` under
``build/bin_layouts/NAME/`` (``tools/layouts.py``). Then, on one card in one
process, it prints ptxas's registers and spills of each kernel
instantiation, and at K16's path shapes (the 20 s convolution's (128, 2^20)
and the 30 s deconvolution's (128, 2^21) against one excitation row, with
the floor's launch) and at (128, 2^21) batched, the device ms of a launch
(20 launches in a CUDA graph, replayed between CUDA events, median of 5),
the TB/s its bytes reach (every input bin read once, every output bin
written once) and whether its planes equal the plain version's. Beside them
``Tensor.copy_`` of a 2 GiB plane (one read, one write) times the rate the
card reaches on a plain stream. Every variant computes the same function:

* ``shipped``: the source as it is (256 threads, four 16-byte vectors of
  each plane a thread a tile, at most 4096 blocks walking the tiles, plain
  cached loads and stores);
* ``unroll2`` / ``unroll1``: two / one vector a thread a tile;
* ``threads512``: 512 threads a block;
* ``grid-all``: a block a tile, the grid-stride loop taken once;
* ``grid-all-512``: both;
* ``grid-1056``: 1056 blocks (8 on each of 132 SMs);
* ``streaming``: streaming loads and stores (``__ldcs``, ``__stcs``);
* ``min4``: ``__launch_bounds__(256, 4)``, at most 64 registers a thread.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import sys
from pathlib import Path

import torch

from layouts import build, card, edit, graph_ms, ptxas, variant_names

from hisstools_library_tpu_torch.fft import hopper_kernels  # noqa: E402

SRC = "bin_product.cu"
_UNROLL = "constexpr int kUnroll = 4;"
_THREADS = "constexpr int kThreads = 256;"
_GRID = "constexpr int kMaxGrid = 4096;"
VARIANTS = {
    "shipped": (),
    "unroll2": ((_UNROLL, "constexpr int kUnroll = 2;"),),
    "unroll1": ((_UNROLL, "constexpr int kUnroll = 1;"),),
    "threads512": ((_THREADS, "constexpr int kThreads = 512;"),),
    "grid-all": ((_GRID, "constexpr int kMaxGrid = 1 << 30;"),),
    "grid-1056": ((_GRID, "constexpr int kMaxGrid = 1056;"),),
    "grid-all-512": ((_GRID, "constexpr int kMaxGrid = 1 << 30;"),
                     (_THREADS, "constexpr int kThreads = 512;")),
    "streaming": (("const float4 t = reinterpret_cast<const float4*>(p)[i];",
                   "const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + i);"),
                  ("out.v[0] = p[i];", "out.v[0] = __ldcs(p + i);"),
                  ("reinterpret_cast<float4*>(p)[i] = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);",
                   "__stcs(reinterpret_cast<float4*>(p) + i, "
                   "make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));"),
                  ("    p[i] = x.v[0];", "    __stcs(p + i, x.v[0]);")),
    "min4": (("template <int E, int V>\n__global__ void __launch_bounds__(kThreads)\n",
              "template <int E, int V>\n__global__ void __launch_bounds__(kThreads, 4)\n"),),
}
# (epilogue, rows, K, excitation rows): conv's path shape, deconv's, conv batched at 2^21.
CASES = [("conv", 128, 1 << 20, 128), ("deconv", 128, 1 << 21, 1), ("conv", 128, 1 << 21, 128)]
_EPILOGUE = {"conv": 0, "corr": 1, "deconv": 2}


def _change(name: str, d: Path) -> None:
    edit(d, SRC, VARIANTS[name])


def main() -> None:
    names = variant_names(sys.argv[1:], VARIANTS, __doc__)
    smi = card("bin_layouts")
    libs = build("bin_layouts", names, [SRC], _change, ["hst_bin_product", "hst_bin_floor"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    plane = torch.empty(1 << 29, device=dev)
    copy = torch.empty_like(plane)
    ms = graph_ms(lambda: copy.copy_(plane))
    print(f"copy_ of a 2 GiB plane: device {ms:.4f} ms, {2 * 4 * plane.numel() / ms / 1e9:.3f} "
          f"TB/s [{smi}]", flush=True)
    del plane, copy
    for name, v in libs.items():
        for entry, lines in ptxas(v.log, "bin_").items():
            tag = re.search(r"(bin_\w+?kernel)(?:ILi(\d)ELi(\d)E|ILi(\d)E)?", entry)
            print(f"{name} {tag.group(0) if tag else entry[:60]}: {'; '.join(lines)}",
                  flush=True)
    for epi, rows, k, xrows in CASES:
        a_re, a_im = (torch.randn(rows, k, generator=gen, device=dev) for _ in range(2))
        b_re, b_im = (torch.randn(xrows, k, generator=gen, device=dev) for _ in range(2))
        if epi == "deconv":
            want = hopper_kernels.bin_deconvolve_plain(a_re, a_im, b_re, b_im, 1e-4, 0.5 / k)
        else:
            want = hopper_kernels.bin_mul_plain(a_re, a_im, b_re, b_im, 0.25 / k)
        floor = hopper_kernels.bin_floor_plain(b_re, b_im, 1e-4)
        work = torch.zeros(2 * xrows, dtype=torch.int32, device=dev)
        y_re, y_im = torch.empty_like(want[0]), torch.empty_like(want[1])
        nbytes = 8 * k * (rows + xrows + rows)
        b_rs = k if xrows > 1 else 0
        scale = 0.5 / k if epi == "deconv" else 0.25 / k
        for name, v in libs.items():
            so = v.so

            def product():
                rc = so.hst_bin_product(a_re.data_ptr(), a_im.data_ptr(), k, b_re.data_ptr(),
                                        b_im.data_ptr(), b_rs, floor.data_ptr(),
                                        1 if b_rs else 0, y_re.data_ptr(), y_im.data_ptr(),
                                        rows, k, _EPILOGUE[epi], scale,
                                        torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise SystemExit(f"bin_layouts: {name}: CUDA error {rc}")

            def reduce():
                rc = so.hst_bin_floor(b_re.data_ptr(), b_im.data_ptr(), xrows, k, 1e-4,
                                      work.data_ptr(), floor.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise SystemExit(f"bin_layouts: {name}: CUDA error {rc}")

            product()
            torch.cuda.synchronize()
            same = torch.equal(y_re, want[0]) and torch.equal(y_im, want[1])
            ms = graph_ms(product)
            extra = ""
            if epi == "deconv":
                extra = f", floor {graph_ms(reduce):.4f} ms"
            print(f"{epi} ({rows}, {k}) x {xrows} rows {name}: device {ms:.4f} ms, "
                  f"{nbytes / ms / 1e9:.3f} TB/s, {100 * nbytes / 3.35e12 / (ms * 1e-3):.1f}% of "
                  f"the bytes' bound{extra}; equal to plain {same} [{smi}]", flush=True)
        del a_re, a_im, b_re, b_im, want, y_re, y_im
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
