// K4: overlap-save inverse. Per hop spectrum, scale * rifft(Y_t)[H:], the
// kept second half of the unscaled packed inverse (rifft(rfft(x)) = 2N x).
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rifft_packed_tail
// (_rifft_tail_kernel). Pass 1's loader unpacks the packed planes (pairing
// bins k and M-k) and conjugates, so the forward passes compute the inverse;
// pass 2 stores only outputs k >= M/2, conjugated and scaled, which are the
// samples [H, N). The discarded half is still transformed in pass 1 (every
// output of a four-step depends on every input) but never stored.
//
// Bound on the H100: HBM bytes. Per hop 8H in (two planes), 2 x 8H of pass-1
// scratch written and read, 4H out: 28H bytes (H = N/2), ~1.9 GB at the main
// path's (128, 16, 32768).
#include "fft_common.cuh"

using namespace hst;

extern "C" int hst_rifft_packed_tail(const float* re, const float* im,
                                     float* out, void* scratch_y,
                                     const void* tw, long long frames, int n,
                                     float scale, void* stream) {
  const Plan p = make_plan(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* y = static_cast<float2*>(scratch_y);
  const float2* w = static_cast<const float2*>(tw);
  run_fft<kLoadUnpack, kStoreTail>(p, frames, re, im, y, out, nullptr, w, 1, scale, st);
  return (int)cudaGetLastError();
}
