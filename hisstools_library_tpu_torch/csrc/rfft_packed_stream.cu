// K2: overlap-save forward transform. Spectrum t of each channel is
// rfft([x[t-1] | x[t]]) of its (T, H) hop blocks, with x[-1] = 0,
// N = 2H = 4096..2^17.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rfft_packed_stream
// (_rfft_stream_kernel). As there, no frames buffer exists. Here the
// transform is fft_large.cuh's one-pass route (fft_onepass, K1's kernel):
// the complex frame of M = N/2 points sits in the shared memory of one
// block (M <= 2^13) or of a 2-, 4- or 8-block cluster, and its loader
// (kLoadStream) reads frame t as the float2 view of the signal starting one
// block before block t (the blocks of a channel are contiguous), with zeros
// for the lower half at each channel's first hop. The packed spectra are
// stored once from the rows' tiles (kStorePack); no scratch frame goes to
// HBM. K8's forward (fastfir_stream.cu) is the same launch with the
// carried block in place of the zeros.
//
// Bound on the H100: HBM bytes. The function reads x once (4H bytes a hop)
// and writes the packed spectra (8H): 12H a hop, 0.74 GB at the offline
// path's (128, 236, 2048), 0.22 ms at 3.35 TB/s. The design reads each
// block twice, as the upper half of its frame and the lower half of the
// next: 16H a hop if the second read misses L2, 0.99 GB there. The
// butterflies (~2.5 N log2 N FP32 operations a hop) are not the limit.
#include "fft_large.cuh"

using namespace hst;

namespace {

// K2's plan is K1's at every size, as K8's forward's.
template <int LM>
using K2Pass = K1Pass<LM>;

template <int LM>
int k2_launch(const float* x, float* re, float* im, const float2* tw, long long frames,
              int hops, cudaStream_t st) {
  return launch_onepass<K2Pass<LM>, kLoadStream>(frames, x, nullptr, re, im, tw, LM + 1, st,
                                                 hops);
}

template <int LM>
int k2_resident() {
  int resident = 0;
  const int rc = onepass_resident<K2Pass<LM>>(fft_onepass<K2Pass<LM>, kLoadStream, kStorePack>,
                                                  resident);
  return rc != 0 ? -rc : resident;
}

}  // namespace

// x: (channels, hops, n/2) floats; re, im: (channels * hops, n/2) packed
// planes; tw: the n-entry table.
extern "C" int hst_rfft_packed_stream(const float* x, float* re, float* im, const void* tw,
                                      long long channels, int hops, int n, void* stream) {
  const float2* w = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long frames = channels * hops;
  switch (ilog2(n) - 1) {
    case 11: return k2_launch<11>(x, re, im, w, frames, hops, st);
    case 12: return k2_launch<12>(x, re, im, w, frames, hops, st);
    case 13: return k2_launch<13>(x, re, im, w, frames, hops, st);
    case 14: return k2_launch<14>(x, re, im, w, frames, hops, st);
    case 15: return k2_launch<15>(x, re, im, w, frames, hops, st);
    case 16: return k2_launch<16>(x, re, im, w, frames, hops, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Frames of real size n that K2 holds on the card at once (clusters, or
// blocks where one block holds a frame), or minus a CUDA error.
extern "C" int hst_rfft_packed_stream_resident(int n) {
  switch (ilog2(n) - 1) {
    case 11: return k2_resident<11>();
    case 12: return k2_resident<12>();
    case 13: return k2_resident<13>();
    case 14: return k2_resident<14>();
    case 15: return k2_resident<15>();
    case 16: return k2_resident<16>();
    default: return -(int)cudaErrorInvalidValue;
  }
}
