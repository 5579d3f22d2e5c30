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

// K1's plan is fft_large.cuh's K1Plan (hopper_fft._onepass_plan mirrors it).

template <int LM>
int k1_launch(const float* x, float* re, float* im, const float2* tw, long long batch,
              cudaStream_t st) {
  return launch_onepass<K1Pass<LM>, kLoadReal>(batch, x, nullptr, re, im, tw, LM + 1, st);
}

template <int LM>
int k1_resident() {
  int resident = 0;
  const int rc = onepass_resident<K1Pass<LM>>(fft_onepass<K1Pass<LM>, kLoadReal, kStorePack>,
                                                  resident);
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
