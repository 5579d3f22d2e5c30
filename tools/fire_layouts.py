"""K9 hop_fire (``csrc/hop_fire.cu``) in layout variants, side by side.

    python3 tools/fire_layouts.py [--only NAME,...]

For each entry of ``VARIANTS`` (text replacements in ``hop_fire.cu``),
copies ``hisstools_library_tpu_torch/csrc`` under
``build/fire_layouts/NAME/``, applies the replacements and builds that file
alone into a shared library (one ``nvcc`` each, all started together,
``-fno-gnu-unique``). Then, on one card in one process, it prints ptxas's
registers and spills of each kernel instantiation, the device ms of an empty
kernel launch (the floor any launch pays), and at K9's path shapes ((128,
256, P 3), (128, 1024, P 3)), its large-P shapes ((128, 256, P 64), (128,
1024, P 256)), small ones ((3, 32, P 1), (9, 64, P 20), P 1 and 2 at
N = 256, P 1 and 20 at N = 1024), (1000, 256, P 3) and (128, 128, P 15)
(four helpers of four stages, the most shared memory) the device
ms of a launch (50 launches in a CUDA graph, replayed between CUDA events,
median of 9; the variants in turns at each shape), the mean device ms of 20
launches by ``torch.profiler`` and the SNR against ``hop_fire_plain``. The layout variants
compute the same function:

* ``shipped``: the source as it is (warp 0 runs the transforms, a helper
  warp a 4 of the old ring's lags sums them while the forward runs, its
  rows staged by ``cp.async`` from kernel entry);
* ``helpers-1``, ``helpers-3``: at most that many helper warps;
* ``lags-1``, ``lags-2``, ``lags-8``: a helper a 1, 2 or 8 lags;
* ``budget-24``: 24 stages a block where the shipped kernel keeps 16 (3
  stages a helper at 7 helpers);
* ``unstaged``: no row staging, each lane loads its chunks of the ring
  and H rows from global memory as it sums them (``__ldg`` of float4);
* ``e-row-warp0``: warp 0 stores ring' row P-1 itself, 32 scalar stores a
  lane in its bin order, where the shipped kernel has helper 0 store it
  from shared memory as float4 after the barrier;
* ``full-groups``: F = 32 / T frames a block at every C and P (32 blocks
  at (128, 256)), where the shipped plan halves the frames a block while
  there are fewer than 128 blocks where P - 1 > 4 (more than one helper);
  ``split-always``: it halves them at every P.

Measurement variants, which leave a part out (their output is wrong, and
the SNR says so): ``no-lag-sum`` (the helpers sum no lag), ``no-lag-copies``
(no lag row is copied; the sums read whatever the stages hold),
``no-lag-stores`` (ring' rows 0..P-2 are not stored), ``no-e-row`` (ring'
row P-1 is not stored); and of warp 0's chain: ``only-forward`` (warp 0 stops
at the barrier), ``no-inverse`` (no inverse stages), ``no-frame-loads``
(the frames are zeros, no load), ``no-shuffles`` (the unpack takes no
partner from another lane).

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import sys
from pathlib import Path

import torch

from layouts import build, card, device_ms, edit, graph_ms, ptxas, snr, variant_names

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402
from chip_phases import empty_launch  # noqa: E402

SRC = "hop_fire.cu"
_NO_COPIES = (("      if (s < lags) issue(s, stage + i * kPlanes * kGroupFloats);",
               "      (void)s;"),
              ("      if (s + helpers * stages < lags) issue(s + helpers * stages, st);", ""))
_UNSTAGED = _NO_COPIES + (("""        const float4 vr = ld4(st + ce[j]), vi = ld4(st + kGroupFloats + ce[j]);
        const float4 hr = ld4(st + 2 * kGroupFloats + ce[j]);
        const float4 hi = ld4(st + 3 * kGroupFloats + ce[j]);
""", """        const long long c_ = clive[j] ? cch[j] : 0;
        const long long r_ = (c_ * p + s + 1) * M + cb[j];
        const long long h_ = c_ * h_cs + (long long)(p - 1 - s) * M + cb[j];
        const float4 vr = __ldg(reinterpret_cast<const float4*>(rin_re + r_));
        const float4 vi = __ldg(reinterpret_cast<const float4*>(rin_im + r_));
        const float4 hr = __ldg(reinterpret_cast<const float4*>(h_re + h_));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(h_im + h_));
"""),)
_NO_SUM = (("    for (int i = 0, s = hw; s < lags; ++i, s += helpers) {",
            "    for (int i = 0, s = hw; s < 0; ++i, s += helpers) {"),)
_NO_STORES = (("""        if (clive[j]) {  // ring' row s
          const long long r = (cch[j] * p + s) * M + cb[j];
          st4(rout_re + r, vr);
          st4(rout_im + r, vi);
        }
""", ""),)
_NO_E_ROW = (("""        st4(rout_re + r, ld4(erow + co[j]));
        st4(rout_im + r, ld4(erow + kFin + co[j]));
""", ""),)
# ring' row P-1 stored by warp 0 (32 scalar stores a lane, its bin order)
_E_ROW_WARP0 = (("""        st4(rout_re + r, ld4(erow + co[j]));
        st4(rout_im + r, ld4(erow + kFin + co[j]));
""", ""), ("""    erow[fr + k] = e[m].x;
    erow[kFin + fr + k] = e[m].y;
""", """    erow[fr + k] = e[m].x;
    erow[kFin + fr + k] = e[m].y;
    if (live) {
      rout_re[(ch * p + p - 1) * M + k] = e[m].x;
      rout_im[(ch * p + p - 1) * M + k] = e[m].y;
    }
"""))


def _const(name: str, old: int, new: int):
    return ((f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"),)


VARIANTS = {
    "shipped": (),
    "helpers-1": _const("kMaxHelpers", 7, 1),
    "helpers-3": _const("kMaxHelpers", 7, 3),
    "lags-1": _const("kLagsPerHelper", 4, 1),
    "lags-2": _const("kLagsPerHelper", 4, 2),
    "lags-8": _const("kLagsPerHelper", 4, 8),
    "budget-24": _const("kStageBudget", 16, 24),
    "unstaged": _UNSTAGED,
    "e-row-warp0": _E_ROW_WARP0,
    # measurement variants (they leave a part out: their output is wrong)
    "no-lag-sum": _NO_SUM,
    "no-lag-copies": _NO_COPIES,
    "no-lag-stores": _NO_STORES,
    "no-e-row": _NO_E_ROW,
    "only-forward": (("  __syncthreads();\n\n  // Y = E * H[0]",
                      "  __syncthreads();\n  return;\n\n  // Y = E * H[0]"),),
    "no-inverse": (("  hst_reg::Stages<LOG_M>::run(v, fbf, tf, stw);\n  if (!live) return;",
                    "  if (!live) return;"),),
    "no-frame-loads": (("      if (live) {\n        if constexpr (kPairs) {",
                        "      if (false) {\n        if constexpr (kPairs) {"),),
    "no-shuffles": (("    if constexpr (T > 1) {\n      qm = make_float2(",
                     "    if constexpr (T > 999) {\n      qm = make_float2("),),
}
# (C, N, P): the paths' shapes, the large-P shapes, small ones, many channels.
CASES = [(128, 256, 3), (128, 1024, 3), (128, 256, 64), (128, 1024, 256), (3, 32, 1),
         (9, 64, 20), (128, 256, 1), (128, 256, 2), (128, 1024, 1), (128, 1024, 20),
         (1000, 256, 3), (128, 128, 15)]


def _change(name: str, d: Path) -> None:
    edit(d, SRC, VARIANTS[name])


def main() -> None:
    names = variant_names(sys.argv[1:], VARIANTS, __doc__)
    smi = card("fire_layouts")
    libs = build("fire_layouts", names, [SRC], _change, ["hst_hop_fire"])
    dev = torch.device("cuda", 0)
    print(f"empty kernel launch: graph {graph_ms(empty_launch(dev), 50, 9):.4f} ms [{smi}]",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = {}
    for c, n, p in CASES:
        k = n // 2
        frame = torch.randn(c, n, generator=gen, device=dev)
        ring = [torch.randn(c, p, k, generator=gen, device=dev) for _ in range(2)]
        h = [torch.randn(c, p, k, generator=gen, device=dev) * 1e-3 for _ in range(2)]
        want = hopper_kernels.hop_fire_plain(frame, *ring, *h)
        out = [torch.empty_like(w) for w in want]
        inputs[(c, n, p)] = (frame, ring, h, want, out, hopper_fft._twiddles(n, dev))
    for name, v in libs.items():
        for entry, lines in ptxas(v.log, "hop_fire_kernel").items():
            print(f"{name} {entry}: {'; '.join(lines)}", flush=True)
    for c, n, p in CASES:  # the variants in turns, case by case
        frame, ring, h, want, out, tw = inputs[(c, n, p)]
        for name, v in libs.items():
            def call(so=v.so, name=name):
                rc = so.hst_hop_fire(frame.data_ptr(), n, ring[0].data_ptr(),
                                     ring[1].data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
                                     p * (n // 2), out[0].data_ptr(), out[1].data_ptr(),
                                     out[2].data_ptr(), tw.data_ptr(), c, p, n, 1.0 / (4.0 * n),
                                     _build.stream(dev))
                if rc:
                    raise SystemExit(f"fire_layouts: {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            db = min(snr(w, g) for w, g in zip(want, out))
            print(f"K9 ({c}, {n}, P {p}) {name}: device {graph_ms(call, 50, 9):.4f} ms, "
                  f"profiler {device_ms(call, 20):.4f} ms, SNR vs plain {db:.2f} dB [{smi}]",
                  flush=True)


if __name__ == "__main__":
    main()
