// K1: batched real FFT to the packed layout, N = 4096..2^17.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rfft_packed
// (_rfft_kernel), the TPU four-step whose DFT stages run as MXU matmuls in
// VMEM with a (b, n2h, n1) output tiling. Here the output is in natural bin
// order, and the transform is fft_large.cuh's one-pass route with the split
// step in the row stage's store.
//
// Bound on the H100: HBM bytes, 4N in and 4N out per transform: 8N bytes,
// 1.007 GB at the FastFIR main path's IR preparation (1920 frames of
// N = 2^16, 0.30 ms at 3.35 TB/s); the butterflies (~2.5 N log2 N FP32
// operations) are not the limit. The design moves no more than that: the
// complex frame of M = N/2 points (16 KB - 512 KB) sits in the shared memory
// of one block (M <= 2^13) or of a 2-, 4- or 8-block cluster (64 KB of the
// frame a block), each block loads runs of consecutive columns of the float2
// view z[n] = x[2n] + i x[2n+1], and the rows' blocks hold the row pairs
// (j, R-j), so bins k and M-k meet in shared memory and neither Z nor a
// scratch frame goes to HBM.
#include "fft_large.cuh"

using namespace hst;

namespace {

// K1's plan (hopper_fft._onepass_plan mirrors it): complex M = 2^LM as M1
// columns of M2 points on C blocks, two blocks an SM (<= 128 registers a
// thread at 256 threads, <= 64 at 512). A block holds 2048..8192 points;
// its columns give it runs of 32..128 points of every row. The threads
// follow tools/k1_layouts.py's measurements on an H100: 256 at the FastFIR
// main path's M = 2^15, 512 at 2^13, 2^14 and 2^16.
template <int LM>
struct K1Plan;
template <>
struct K1Plan<11> {
  using T = OnePass<11, 6, 1, 256, 2>;  // 64 x 32, one block (16 KB)
};
template <>
struct K1Plan<12> {
  using T = OnePass<12, 6, 1, 256, 2>;  // 64 x 64, one block (32 KB)
};
template <>
struct K1Plan<13> {
  using T = OnePass<13, 7, 1, 512, 2>;  // 128 x 64, one block (64 KB)
};
template <>
struct K1Plan<14> {
  using T = OnePass<14, 7, 2, 512, 2>;  // 128 x 128 on a 2-block cluster
};
template <>
struct K1Plan<15> {
  using T = OnePass<15, 7, 4, 256, 2>;  // 128 x 256 on 4 blocks
};
template <>
struct K1Plan<16> {
  using T = OnePass<16, 8, 8, 512, 2>;  // 256 x 256 on 8 blocks
};
template <int LM>
using K1Pass = typename K1Plan<LM>::T;

template <int LM>
int k1_launch(const float* x, float* re, float* im, const float2* tw, long long batch,
              cudaStream_t st) {
  return launch_onepass<K1Pass<LM>, kLoadReal>(batch, x, nullptr, re, im, tw, LM + 1, st);
}

template <int LM>
int k1_resident() {
  int resident = 0;
  const int rc = onepass_resident<K1Pass<LM>>(fft_onepass<K1Pass<LM>, kLoadReal>, resident);
  return rc != 0 ? -rc : resident;
}

}  // namespace

extern "C" int hst_rfft_packed(const float* x, float* re, float* im, const void* tw,
                               long long batch, int n, void* stream) {
  const float2* w = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ilog2(n) - 1) {
    case 11: return k1_launch<11>(x, re, im, w, batch, st);
    case 12: return k1_launch<12>(x, re, im, w, batch, st);
    case 13: return k1_launch<13>(x, re, im, w, batch, st);
    case 14: return k1_launch<14>(x, re, im, w, batch, st);
    case 15: return k1_launch<15>(x, re, im, w, batch, st);
    case 16: return k1_launch<16>(x, re, im, w, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Frames of real size n that K1 holds on the card at once (clusters, or
// blocks where one block holds a frame), or minus a CUDA error.
extern "C" int hst_rfft_packed_resident(int n) {
  switch (ilog2(n) - 1) {
    case 11: return k1_resident<11>();
    case 12: return k1_resident<12>();
    case 13: return k1_resident<13>();
    case 14: return k1_resident<14>();
    case 15: return k1_resident<15>();
    case 16: return k1_resident<16>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
