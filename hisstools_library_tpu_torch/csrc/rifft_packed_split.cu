// K14: unscaled inverse of the packed real spectrum, N = 2^18..2^20:
// rifft(rfft(x)) = 2N x, (frames, N/2) packed planes -> (frames, N) samples.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _rifft_packed_split
// (_rifft_stageA_kernel, _rifft_stageC_kernel and the XLA combine after them),
// the TPU's chunked matmul inverse for sizes whose tables do not fit VMEM.
// Here it is K6 (rifft_packed.cu) on fft_common.cuh's three passes: the first
// pass's loader unpacks the packed planes (pairing bins k and M-k) and
// conjugates, so the forward passes compute the inverse, and the last pass
// stores every output, conjugated and unscaled. Both precision modes run it
// at every size of the envelope (the TPU's "highest" falls back to matmul_fft
// at 2^20).
//
// Bound on the H100: HBM bytes, 4N in (two planes of N/2) and 4N out (1.07 GB
// at (128, 2^20)); the two scratch frames add 4N written and 4N read each.
#include "fft_common.cuh"

using namespace hst;

// scratch holds 2 * frames * N/2 float2 (two scratch frames per transform).
extern "C" int hst_rifft_packed_split(const float* re, const float* im, float* out,
                                      void* scratch, const void* tw,
                                      long long frames, int n, void* stream) {
  run_fft<kLoadUnpack, kStoreFull>(make_plan(n), frames, re, im,
                                   static_cast<float2*>(scratch), out, nullptr,
                                   static_cast<const float2*>(tw), 1, 1.f,
                                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
