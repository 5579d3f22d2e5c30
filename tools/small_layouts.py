"""K11 / K11w (``csrc/rifft_small.cu``) in layout variants, side by side.

    python3 tools/small_layouts.py [--only NAME,...]

For each entry of ``VARIANTS`` (text replacements in ``rifft_small.cu``) it
builds that file alone in a copy of ``csrc/`` under
``build/small_layouts/NAME/`` (``tools/layouts.py``). Then, on one card in
one process, it prints ptxas's
registers, stack frame and spills of each kernel instantiation, and at K11's
path shapes ((128, 256), (128, 1024), the staged FastFIR's (6144, 2048)) and
K11w's (the STFT's 128 x 938 frames of 1024, the pipeline's 511) the device
ms of a launch (20 launches in a CUDA graph, replayed between CUDA events,
median of 5) and the SNR against the plain version. Every variant computes
the same function:

* ``shipped``: the source as it is (one block a resident slot, the rounds
  of F frames split evenly; float2 stores);
* ``round-blocks``: one block a round of F frames;
* ``store4``: each thread stores two neighbouring output pairs as one
  float4 (points 2(tf + T*m) and 2(tf + T*m) + 1, m < 8);
* ``window-regs``: K11w holds the window values of the thread's 32 output
  points in registers, loaded once a block (as K10w does), where the
  shipped kernel reads them in the store (from L1);
* ``unpaired``: the loader takes all 16 partners (into 16 more registers)
  before it unpacks, where the shipped one takes slots m and 15 - m
  together and unpacks them at once.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import sys
from pathlib import Path

import torch

from layouts import build, card, edit, graph_ms, ptxas, snr, variant_names

from hisstools_library_tpu_torch import _build  # noqa: E402
from hisstools_library_tpu_torch.fft import hopper_fft  # noqa: E402

SRC = "rifft_small.cu"
_GRID = ("const unsigned blocks = hst_reg::round_grid(per_sm, (batch + F - 1) / F);",
         "const unsigned blocks = (unsigned)((batch + F - 1) / F);")
_STORE = ("""    float2* out = y2 + row * M;
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int n = tf + m * T;
      const float2 z = fb[pad(n)];
      if constexpr (kWindowed) {
        out[n] = make_float2(z.x * (scale * __ldg(&w[2 * n])),
                             -z.y * (scale * __ldg(&w[2 * n + 1])));
      } else {
        out[n] = make_float2(z.x, -z.y);
      }
    }
""", """    float4* out = reinterpret_cast<float4*>(y2 + row * M);
#pragma unroll
    for (int m = 0; m < kR / 2; ++m) {
      const int n = 2 * (tf + m * T);
      const float2 a = fb[pad(n)], b = fb[pad(n + 1)];
      if constexpr (kWindowed) {
        out[n / 2] = make_float4(a.x * (scale * __ldg(&w[2 * n])),
                                 -a.y * (scale * __ldg(&w[2 * n + 1])),
                                 b.x * (scale * __ldg(&w[2 * n + 2])),
                                 -b.y * (scale * __ldg(&w[2 * n + 3])));
      } else {
        out[n / 2] = make_float4(a.x, -a.y, b.x, -b.y);
      }
    }
""")
_WINDOW_REGS = (("  __syncthreads();\n  float2* y2",
                 """  float2 wr[kWindowed ? kR : 1];
  if constexpr (kWindowed) {
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int i = 2 * (tf + m * T);
      wr[m] = make_float2(scale * __ldg(&w[i]), scale * __ldg(&w[i + 1]));
    }
  }
  __syncthreads();
  float2* y2"""),
                ("""        out[n] = make_float2(z.x * (scale * __ldg(&w[2 * n])),
                             -z.y * (scale * __ldg(&w[2 * n + 1])));
""", "        out[n] = make_float2(z.x * wr[m].x, -z.y * wr[m].y);\n"))
_UNPAIRED = (("""#pragma unroll
      for (int m = 0; m < kR / 2; ++m) {
        const int o = kR - 1 - m;
        float2 qm = p[o], qo = p[m];
        if constexpr (T > 1) {
          qm = make_float2(__shfl_sync(0xffffffffu, p[o].x, src, T),
                           __shfl_sync(0xffffffffu, p[o].y, src, T));
          qo = make_float2(__shfl_sync(0xffffffffu, p[m].x, src, T),
                           __shfl_sync(0xffffffffu, p[m].y, src, T));
        }
        if (tf == 0) {
          qm = p[(kR - m) % kR];
          qo = p[m + 1];
        }
        v[m] = unpack(m, qm);
        v[o] = unpack(o, qo);
      }
""", """      float2 q[kR];
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        q[m] = p[kR - 1 - m];
        if constexpr (T > 1) {
          q[m] = make_float2(__shfl_sync(0xffffffffu, p[kR - 1 - m].x, src, T),
                             __shfl_sync(0xffffffffu, p[kR - 1 - m].y, src, T));
        }
        if (tf == 0) q[m] = p[(kR - m) % kR];
      }
#pragma unroll
      for (int m = 0; m < kR; ++m) v[m] = unpack(m, q[m]);
"""),)
VARIANTS = {
    "shipped": (),
    "round-blocks": (_GRID,),
    "store4": (_STORE,),
    "window-regs": _WINDOW_REGS,
    "unpaired": _UNPAIRED,
}
# (kernel, frames, N): K11's path shapes, K11w's.
CASES = [("K11", 128, 256), ("K11", 128, 1024), ("K11", 6144, 2048),
         ("K11w", 128 * 938, 1024), ("K11w", 511, 1024)]


def _change(name: str, d: Path) -> None:
    edit(d, SRC, VARIANTS[name])


def main() -> None:
    names = variant_names(sys.argv[1:], VARIANTS, __doc__)
    smi = card("small_layouts")
    libs = build("small_layouts", names, [SRC], _change,
                 ["hst_rifft_small", "hst_rifft_small_windowed"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = {}
    for kernel, frames, n in CASES:
        re_, im_ = (torch.randn(frames, n // 2, generator=gen, device=dev) for _ in range(2))
        w = torch.hann_window(n, dtype=torch.float64, device=dev).float()
        scale = 0.5 / n
        want = (hopper_fft.rifft_small_plain(re_, im_) if kernel == "K11"
                else hopper_fft.rifft_small_windowed_plain(re_, im_, w, scale))
        inputs[(kernel, frames, n)] = (re_, im_, w, scale, want, torch.empty_like(want),
                                       hopper_fft._twiddles(n, dev))
    for name, v in libs.items():
        so = v.so
        for entry, lines in ptxas(v.log, "rifft_small_kernel").items():
            lm, win = re.search(r"rifft_small_kernelILi(\d+)ELb(\d)E", entry).groups()
            print(f"{name} M = 2^{lm}{' windowed' if win == '1' else ''}: "
                  f"{'; '.join(lines)}", flush=True)
        for kernel, frames, n in CASES:
            re_, im_, w, scale, want, out, tw = inputs[(kernel, frames, n)]

            def call():
                stream = _build.stream(dev)  # the capturing stream inside a graph
                if kernel == "K11":
                    rc = so.hst_rifft_small(re_.data_ptr(), im_.data_ptr(), out.data_ptr(),
                                            tw.data_ptr(), frames, n, stream)
                else:
                    rc = so.hst_rifft_small_windowed(
                        re_.data_ptr(), im_.data_ptr(), w.data_ptr(), scale, out.data_ptr(),
                        tw.data_ptr(), frames, n, stream)
                if rc:
                    raise SystemExit(f"small_layouts: {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            print(f"{kernel} ({frames}, {n}) {name}: device {graph_ms(call):.4f} ms, SNR vs "
                  f"plain {snr(want, out):.2f} dB [{smi}]", flush=True)


if __name__ == "__main__":
    main()
