"""K5 fastfir_chain's middle phase (``chain_mid``) in measurement variants.

    python3 tools/k5_layouts.py [--only NAME,...] [--shape C,T,P,N]

For each entry of ``VARIANTS`` (text replacements in
``csrc/fastfir_chain.cu``) it applies the replacements in a copy of
``csrc/`` under ``build/k5_layouts/NAME/``, appends a C entry that reports
the middle phase's blocks resident on the card, and builds
``fastfir_chain.cu`` alone (``tools/layouts.py``). Then, on one card in one
process, at the main path's
(C 128, T 16, P 15, N 2^16) unless ``--shape`` names another:

* ptxas's registers, stack and spills of each ``chain_mid`` instantiation,
  and ``cuobjdump --dump-resource-usage`` of the one at the shape's L;
* the middle phase's blocks resident on the card at once (whole clusters, by
  ``cudaOccupancyMaxActiveClusters``);
* the device ms of each of K5's three launches (the forward column pass
  ``fft_cols``, the middle phase ``chain_mid``, the inverse column pass
  ``fft_cols_tail``) by ``torch.profiler`` (mean of 10) and of the call by
  CUDA events (median of 20 after a warm-up), with the SNR against
  ``fastfir_chain_plain``; beside them the staged K2 -> K3 -> K4 of the
  checkout's own library on the same inputs.

A variant that changes what the kernel computes (``no-hload``: H zero, not
loaded; ``no-mac``: Y_t = X_t; ``no-dft``: the rows copied through, no row
DFTs) is there to time a part of the middle phase; its SNR is not the
kernel's. ``no-cluster`` (each block loads its own bins with strided reads,
no distributed shared memory), ``rows16`` (chunks of 16 rows, 8 hops, in
place of 32), ``h-batch8`` (8 values of H in flight a thread, not 16),
``cluster8`` / ``cluster2`` (clusters of 8 or 2 blocks, not 4),
``one-tile`` (never double-buffered), ``two-tiles`` (double-buffered
wherever a launch has more than one chunk, also where two blocks share an
SM or the second tile costs one) and ``one-tile-big`` (one tile in two
tiles' shared memory) compute the same function.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from layouts import build, card, events_ms, kernel_ms, ptxas, replace_once, snr

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

SRC = "fastfir_chain.cu"
# mid_tiles' rule: two tiles where a block has its SM to itself
TILES = "  return more && blocks_per_sm(mid_smem(l, p, ring_in_smem, 1)) == 1 ? 2 : 1;"
NO_CLUSTER_H = [("  const bool cluster_h = in_smem;", "  const bool cluster_h = false;")]
# name: text replacements in fastfir_chain.cu.
VARIANTS = {
    "shipped": [],
    "no-hload": NO_CLUSTER_H + [
        ("        hs[lag * NB + b] = make_float2(__ldg(&hr[o]), __ldg(&hi[o]));",
         "        hs[lag * NB + b] = make_float2(0.f, 0.f);")],
    "no-mac": [("        for (int lag = 0; lag < lag_end; ++lag) {",
                "        for (int i = 0; i < kMacHops; ++i) acc[i] = x[i];\n"
                "        for (int lag = 0; lag < 0; ++lag) {")],
    "no-dft": [("      hst_reg::Stages<Sub<L>::kLog>::run(v, row_in, tf, sw);",
                "      for (int u = 0; u < hst_reg::kR; ++u) row_in[pad(tf + T * u)] = v[u];"),
               ("      hst_reg::Stages<Sub<L>::kLog>::run(v, row, tf, sw);", "")],
    "no-cluster": NO_CLUSTER_H + [("__cluster_dims__(kCluster, 1, 1) ", "")],
    "rows16": [("  return kThreads / (l / 16) < 32 ? kThreads / (l / 16) : 32;",
                "  return 16;")],
    "h-batch8": [("constexpr int kBatch = 16;", "constexpr int kBatch = 8;")],
    "cluster8": [("constexpr int kCluster = 4;", "constexpr int kCluster = 8;")],
    "cluster2": [("constexpr int kCluster = 4;", "constexpr int kCluster = 2;")],
    "one-tile": [(TILES, "  return 1;")],
    "two-tiles": [(TILES, "  return more ? 2 : 1;")],
    # one tile in two tiles' shared memory: the footprint alone
    "one-tile-big": [(TILES, "  return 1;"),
                     ("  const int smem = mid_smem(L, a.p, a.gring == nullptr, a.tiles);",
                      "  const int smem = mid_smem(L, a.p, a.gring == nullptr, 2);")],
}
# Blocks of chain_mid<L> resident on the card at once for the launch at size
# n over t hops with p lags, or minus a CUDA error: whole clusters, or blocks
# an SM times the SMs without them.
RESIDENT = """
template <int L>
int mid_resident(int p, int t, bool ring_in_smem) {
  const int smem = mid_smem(L, p, ring_in_smem, mid_tiles(L, p, t, ring_in_smem));
  cudaError_t err =
      cudaFuncSetAttribute(chain_mid<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
#if CLUSTERED
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(chain_mid<L>),
                                       &cfg);
  return err != cudaSuccess ? -(int)err : kCluster * clusters;
#else
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_mid<L>, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err != cudaSuccess ? -(int)err : per_sm * sms;
#endif
}

extern "C" int hst_fastfir_chain_resident(int n, int t, int p) {
  const Plan pl = make_plan(n);
  const bool in_smem = hst_fastfir_chain_ring_scratch(n, p) == 0;
  return pl.l_last == 64    ? mid_resident<64>(p, t, in_smem)
         : pl.l_last == 128 ? mid_resident<128>(p, t, in_smem)
                            : mid_resident<256>(p, t, in_smem);
}
"""
PHASES = (("A", "fft_cols"), ("B", "chain_mid"), ("C", "fft_cols_tail"))


def _change(name: str, d: Path) -> None:
    text = replace_once((d / SRC).read_text(), VARIANTS[name], f"{name}: {SRC}")
    clustered = "__cluster_dims__" in text
    (d / SRC).write_text(text + RESIDENT.replace("#if CLUSTERED", f"#if {int(clustered)}"))


def _resource_usage(lib: Path, l_last: int) -> str:
    """cuobjdump's resource line of chain_mid<l_last>."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True).stdout
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if f"chain_midILi{l_last}E" in line and i + 1 < len(lines):
            return lines[i + 1].strip()
    return "not found"


def _by_phase(times: dict) -> dict:
    out = {}
    for label, stem in PHASES:
        out[label] = sum(v for k, v in times.items() if re.search(rf"\b{stem}<", k))
    out["total"] = sum(times.values())
    return out


def main() -> None:
    args = sys.argv[1:]
    names = list(VARIANTS)
    c, t, p, n = 128, 16, 15, 1 << 16
    while args:
        if args[0] == "--only" and len(args) > 1:
            names = args[1].split(",")
        elif args[0] == "--shape" and len(args) > 1:
            c, t, p, n = (int(v) for v in args[1].split(","))
        else:
            raise SystemExit(__doc__)
        args = args[2:]
    smi = card("k5_layouts")
    libs = build("k5_layouts", names, [SRC], _change, {
        "hst_fastfir_chain": (_build._SIGNATURES["hst_fastfir_chain"], None),
        "hst_fastfir_chain_ring_scratch": (_build._SIGNATURES["hst_fastfir_chain_ring_scratch"],
                                           ctypes.c_longlong),
        "hst_fastfir_chain_resident": ([ctypes.c_int] * 3, None)})
    for name, v in libs.items():
        for entry, lines in ptxas(v.log, "chain_mid", ("registers", "spill")).items():
            m = re.search(r"chain_midILi(\d+)E", entry)
            for line in lines:
                print(f"{name} chain_mid<{m.group(1) if m else '?'}>: {line}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    k = n // 2
    x2d = torch.randn(c, t, k, generator=gen, device=dev)
    hr = torch.randn(c, p, k, generator=gen, device=dev) * 1e-3
    hi = torch.randn(c, p, k, generator=gen, device=dev) * 1e-3
    scale = 1.0 / (4.0 * n)
    want = hopper_fft.fastfir_chain_plain(x2d, hr, hi, scale)
    y = torch.empty_like(x2d)
    scratch = torch.empty(c * t, n, device=dev)
    tw = hopper_fft._twiddles(n, dev)
    stream = _build.stream(dev)
    l_last = hopper_fft._plan(n).lengths[1]
    staged = _by_phase(kernel_ms(lambda: hopper_fft.fastfir_chain_staged(x2d, hr, hi, scale)))
    print(f"({c}, T {t}, P {p}, {n}): staged K2 -> K3 -> K4 device {staged['total']:.4f} ms, "
          f"events {events_ms(lambda: hopper_fft.fastfir_chain_staged(x2d, hr, hi, scale)):.4f}"
          f" ms [{smi}]", flush=True)
    for name, v in libs.items():
        so = v.so
        floats2 = so.hst_fastfir_chain_ring_scratch(n, p)
        gring = (torch.empty(c, floats2, 2, device=dev) if floats2 else None)

        def call():
            rc = so.hst_fastfir_chain(
                x2d.data_ptr(), hr.data_ptr(), hi.data_ptr(), p * k, y.data_ptr(),
                scratch.data_ptr(), None if gring is None else gring.data_ptr(), tw.data_ptr(),
                c, t, p, n, scale, stream)
            if rc:
                raise SystemExit(f"{name}: CUDA error {rc}")
        call()
        torch.cuda.synchronize()
        ph = _by_phase(kernel_ms(call))
        print(f"({c}, T {t}, P {p}, {n}) {name}: device A {ph['A']:.4f} B {ph['B']:.4f} "
              f"C {ph['C']:.4f} total {ph['total']:.4f} ms, events {events_ms(call):.4f} ms, "
              f"SNR vs plain {snr(want, y):.2f} dB, {so.hst_fastfir_chain_resident(n, t, p)} "
              f"middle-phase blocks resident; "
              f"{_resource_usage(v.lib, l_last)} "
              f"[{smi}]", flush=True)


if __name__ == "__main__":
    main()
