// K2: overlap-save forward transform. Spectrum t of each channel is
// rfft([x[t-1] | x[t]]) of its (T, H) hop blocks, with x[-1] = 0.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rfft_packed_stream
// (_rfft_stream_kernel). As there, no frames buffer exists: pass 1's loader
// reads frame t as the float2 view of the signal starting one block before
// block t (the blocks of a channel are contiguous), and zeroes the lower half
// for each channel's first hop.
//
// Bound on the H100: HBM bytes. Per hop the signal is read twice (each block
// is the upper half of one frame and the lower half of the next, 8H bytes),
// the pass-1 scratch frame written and read (2 x 8H) and the spectra written
// once (8H): 32H bytes, ~2.1 GB at the main path's (128, 16, 32768).
#include "fft_common.cuh"

using namespace hst;

extern "C" int hst_rfft_packed_stream(const float* x, float* re, float* im,
                                      void* scratch_y, const void* tw,
                                      long long channels,
                                      int hops, int n, void* stream) {
  const Plan p = make_plan(n);
  const long long frames = channels * hops;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* y = static_cast<float2*>(scratch_y);
  const float2* w = static_cast<const float2*>(tw);
  run_fft<kLoadStream, kStorePack>(p, frames, x, nullptr, y, re, im, w, hops, st);
  return (int)cudaGetLastError();
}
