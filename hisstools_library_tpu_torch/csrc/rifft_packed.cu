// K6: unscaled inverse of the packed real spectrum, N = 4096..2^17:
// rifft(rfft(x)) = 2N x, (frames, N/2) packed planes -> (frames, N) samples.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rifft_packed
// (_rifft_kernel). It is K4 (rifft_packed_tail.cu) without the tail: the
// one-pass route on K1's plan with the paired unpack in its column stage
// (kLoadUnpack), and a row stage that stores every output, conjugated and
// unscaled (kStoreFull). N = 32..2048 go to K11 (rifft_small.cu) instead, as
// the TPU package sends them to _rifft_small, and N = 2^18..2^28 to K14.
//
// Bound on the H100: HBM bytes. Per frame 4N in (two planes of N/2) and 4N
// out: 8N bytes, 16.8 MB at the streaming _emit's (128, N = 2^14), 5.0 us
// at 3.35 TB/s, and 4.2 MB at (128, 4096). The design moves those bytes
// once and no scratch frame.
#include "fft_large.cuh"

using namespace hst;

namespace {

template <int LM>
int k6_launch(const float* re, const float* im, float* out, const float2* tw, long long frames,
              cudaStream_t st) {
  return launch_onepass<K1Pass<LM>, kLoadUnpack, kStoreFull>(frames, re, im, out, nullptr, tw,
                                                             LM + 1, st);
}

}  // namespace

// re, im: (frames, N/2) packed planes; out: (frames, N) floats; tw: the
// twiddle table of N entries.
extern "C" int hst_rifft_packed(const float* re, const float* im, float* out, const void* tw,
                                long long frames, int n, void* stream) {
  const float2* w = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ilog2(n) - 1) {
    case 11: return k6_launch<11>(re, im, out, w, frames, st);
    case 12: return k6_launch<12>(re, im, out, w, frames, st);
    case 13: return k6_launch<13>(re, im, out, w, frames, st);
    case 14: return k6_launch<14>(re, im, out, w, frames, st);
    case 15: return k6_launch<15>(re, im, out, w, frames, st);
    case 16: return k6_launch<16>(re, im, out, w, frames, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
