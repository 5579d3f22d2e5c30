// K13: batched real FFT to the packed layout, N = 2^18..2^20.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _rfft_packed_split
// (_rfft_stage1_kernel, _rfft_stage2_kernel), the TPU's two-kernel four-step
// for sizes whose DFT tables do not fit VMEM at once: stage 1 a k1-chunked
// DFT with twiddle into HBM, stage 2 a DFT emitting the packed layout. There
// the "highest" mode falls back to the XLA-staged matmul_fft at 2^20; here
// both precision modes run this kernel at every size of the envelope.
//
// The complex M = N/2 = 2^17..2^19 point FFT is fft_common.cuh's three-pass
// form (M = M1 * M2 * M3, each <= 256); the split step (bins k and M-k) stays
// in the last pass's store, because the middle pass writes its rows in the
// order that keeps rows j and R-j of the last pass in one block.
//
// Bound on the H100: HBM bytes, 4N in and 4N out (1.07 GB at (128, 2^20));
// the two scratch frames add 4N written and 4N read each, 24N bytes a
// transform in all.
#include "fft_common.cuh"

using namespace hst;

// scratch holds 2 * batch * N/2 float2 (two scratch frames per transform).
extern "C" int hst_rfft_packed_split(const float* x, float* re, float* im,
                                     void* scratch, const void* tw,
                                     long long batch, int n, void* stream) {
  run_fft<kLoadReal, kStorePack>(make_plan(n), batch, x, nullptr,
                                 static_cast<float2*>(scratch), re, im,
                                 static_cast<const float2*>(tw), 1, 1.f,
                                 static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
