// K6: unscaled inverse of the packed real spectrum, N = 4096..2^17:
// rifft(rfft(x)) = 2N x, (frames, N/2) packed planes -> (frames, N) samples.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rifft_packed
// (_rifft_kernel). It is K4 (rifft_packed_tail.cu) without the tail: pass 1's
// loader unpacks the packed planes (pairing bins k and M-k) and conjugates, so
// the forward passes of fft_common.cuh compute the inverse, and pass 2 stores
// every output, conjugated and unscaled. N = 32..2048 go to K11
// (rifft_small.cu) instead, as the TPU package sends them to _rifft_small.
//
// Bound on the H100: HBM bytes. Per frame 4N in (two planes of N/2), 2 x 4N
// of pass-1 scratch written and read, 4N out: 16N bytes, ~0.13 GB at the
// streaming _emit's (128, N = 2^14) and 34 MB at (128, 4096).
#include "fft_common.cuh"

using namespace hst;

extern "C" int hst_rifft_packed(const float* re, const float* im, float* out,
                                void* scratch_y, const void* tw,
                                long long frames, int n, void* stream) {
  const Plan p = make_plan(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* y = static_cast<float2*>(scratch_y);
  const float2* w = static_cast<const float2*>(tw);
  run_fft<kLoadUnpack, kStoreFull>(p, frames, re, im, y, out, nullptr, w, 1, 1.f, st);
  return (int)cudaGetLastError();
}
