// K1: batched real FFT to the packed layout, N = 4096..2^17.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: rfft_packed
// (_rfft_kernel), the TPU four-step whose DFT stages run as MXU matmuls in
// VMEM with a (b, n2h, n1) output tiling. Here the output is in natural bin
// order, and the transform is fft_common.cuh's two shared-memory passes plus
// the pack pass.
//
// Bound on the H100: HBM bytes, 4N in, 4N out and 8N of pass-1 scratch
// written and read per transform: 16N bytes, ~2.0 GB at the FastFIR main
// path's IR preparation (1920 frames of N = 2^16). The design keeps global
// accesses in coalesced runs, does all butterflies in shared memory, and packs
// in pass 2's store, so the complex spectrum Z never goes to HBM.
#include "fft_common.cuh"

using namespace hst;

extern "C" int hst_rfft_packed(const float* x, float* re, float* im,
                               void* scratch_y, const void* tw,
                               long long batch, int n,
                               void* stream) {
  const Plan p = make_plan(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* y = static_cast<float2*>(scratch_y);
  const float2* w = static_cast<const float2*>(tw);
  run_fft<kLoadReal, kStorePack>(p, batch, x, nullptr, y, re, im, w, 1, 1.f, st);
  return (int)cudaGetLastError();
}

extern "C" const char* hst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
