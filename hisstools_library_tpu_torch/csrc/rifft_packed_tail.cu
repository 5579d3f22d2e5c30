// K4: overlap-save inverse. Per hop spectrum, scale * rifft(Y_t)[H:], the
// kept second half of the unscaled packed inverse (rifft(rfft(x)) = 2N x),
// N = 4096..2^17.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rifft_packed_tail
// (_rifft_tail_kernel). The transform is fft_large.cuh's one-pass route on
// K1's plan (K1Pass): the frame of M = N/2 points in the shared memory of one
// block (M <= 2^13) or of a 2-, 4- or 8-block cluster. Its column stage
// unpacks the packed planes in pairs (kLoadUnpack: a block's column slots
// hold the columns n1 and M1 - n1, so bins k and M-k meet in shared memory
// and each is read from HBM once) and conjugates, so the forward stages
// compute the inverse; its row stage stores only the outputs k >= M/2,
// conjugated and scaled, which are the samples [H, N) (kStoreTail). The
// discarded half is still transformed (every output of a four-step depends
// on every input) but never stored. K8's inverse (fastfir_stream.cu) is the
// same kernel.
//
// Bound on the H100: HBM bytes. Per hop 8H in (two planes of H = N/2
// floats) and 4H out: 12H bytes, 0.81 GB at the main path's (128, 16,
// 32768), 0.24 ms at 3.35 TB/s. The design moves those bytes once and no
// scratch frame.
#include "fft_large.cuh"

using namespace hst;

namespace {

template <int LM>
int k4_launch(const float* re, const float* im, float* out, const float2* tw, long long frames,
              float scale, cudaStream_t st) {
  return launch_onepass<K1Pass<LM>, kLoadUnpack, kStoreTail>(frames, re, im, out, nullptr, tw,
                                                             LM + 1, st, 1, scale);
}

}  // namespace

// re, im: (frames, N/2) packed planes; out: (frames, N/2) floats; tw: the
// twiddle table of N entries.
extern "C" int hst_rifft_packed_tail(const float* re, const float* im, float* out,
                                     const void* tw, long long frames, int n, float scale,
                                     void* stream) {
  const float2* w = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ilog2(n) - 1) {
    case 11: return k4_launch<11>(re, im, out, w, frames, scale, st);
    case 12: return k4_launch<12>(re, im, out, w, frames, scale, st);
    case 13: return k4_launch<13>(re, im, out, w, frames, scale, st);
    case 14: return k4_launch<14>(re, im, out, w, frames, scale, st);
    case 15: return k4_launch<15>(re, im, out, w, frames, scale, st);
    case 16: return k4_launch<16>(re, im, out, w, frames, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
