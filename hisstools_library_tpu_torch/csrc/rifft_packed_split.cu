// K14: unscaled inverse of the packed real spectrum, N = 2^18..2^28:
// rifft(rfft(x)) = 2N x, (frames, N/2) packed planes -> (frames, N) samples.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _rifft_packed_split
// (:775; _rifft_stageA_kernel :801, _rifft_stageC_kernel :830 and the XLA
// combine after them), the TPU's chunked matmul inverse for sizes whose
// tables do not fit VMEM. Both precision modes run it at every size up to
// 2^28 (the TPU's "highest" falls back to matmul_fft at 2^20, and every size
// above 2^20 does).
//
// Bound on the H100: HBM bytes, 4N in (two planes of N/2) and 4N out (1.07 GB
// at (128, 2^20), 0.32 ms at 3.35 TB/s). It runs on fft_large.cuh's routes
// (one pass on an 8-block cluster at N = 2^18, two passes over one scratch
// frame at 2^19..2^21, three at 2^22..2^28). The unpack of the packed planes
// is the first pass's loader, conjugating so that the forward passes compute
// the inverse, and the last pass stores every output, conjugated and
// unscaled. The unpack pairs bin idx with M-idx: a block's column slots
// hold the column pairs (c, ncol-c), so each packed bin is read from HBM
// once, into shared memory, where its partner's thread reads it too, and
// W_N^idx is the product of two shared-memory factors (unpack_pairs).
#include "fft_large.cuh"

using namespace hst;

// scratch holds frames * N/2 float2 at N = 2^19..2^28 and is not read at
// 2^18; tw is the table of make_plan(n)'s route (run_fft_large).
extern "C" int hst_rifft_packed_split(const float* re, const float* im, float* out,
                                      void* scratch, const void* tw,
                                      long long frames, int n, void* stream) {
  return run_fft_large<kLoadUnpack, kStoreFull>(make_plan(n), frames, re, im,
                                                static_cast<float2*>(scratch), out, nullptr,
                                                static_cast<const float2*>(tw),
                                                static_cast<cudaStream_t>(stream));
}
