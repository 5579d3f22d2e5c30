// K13: batched real FFT to the packed layout, N = 2^18..2^28.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _rfft_packed_split
// (:664; _rfft_stage1_kernel :689, _rfft_stage2_kernel :714), the TPU's
// two-kernel four-step for sizes whose DFT tables do not fit VMEM at once:
// stage 1 a k1-chunked DFT with twiddle into HBM, stage 2 a DFT emitting the
// packed layout. There the "highest" mode falls back to the XLA-staged
// matmul_fft at 2^20, and every size above 2^20 does (with the out-of-core
// four-step of fft/oversize.py on a TPU from 2^21); here both precision
// modes run this kernel at every size up to 2^28.
//
// Bound on the H100: HBM bytes, 4N in and 4N out (1.07 GB at (128, 2^20),
// 0.32 ms at 3.35 TB/s); the butterflies (~2.5 N log2 N FP32 operations,
// ~0.1 ms there) are not the limit. The design goes to HBM as few times as
// the frame allows (fft_large.cuh): at N = 2^18 the complex 2^17 frame (1 MB)
// sits in the shared memory of one 8-block cluster, one pass and no scratch
// (8N bytes); at 2^19..2^21 two passes of 512- and 512..1024-point sub-FFTs
// over one scratch frame (16N bytes); at 2^22..2^28 three passes (24N). The
// split step (bins k and M-k) is the last pass's store, whose blocks hold
// the row pairs (j, R-j), so it costs no pass of its own.
#include "fft_large.cuh"

using namespace hst;

// scratch holds batch * N/2 float2 at N = 2^19..2^28 and is not read at
// 2^18; tw is the table of make_plan(n)'s route (run_fft_large).
extern "C" int hst_rfft_packed_split(const float* x, float* re, float* im,
                                     void* scratch, const void* tw,
                                     long long batch, int n, void* stream) {
  return run_fft_large<kLoadReal, kStorePack>(make_plan(n), batch, x, nullptr,
                                              static_cast<float2*>(scratch), re, im,
                                              static_cast<const float2*>(tw),
                                              static_cast<cudaStream_t>(stream));
}
