// K12: batched unscaled complex DFT along the last axis, split re/im planes
// in and natural-order split planes out, N = 32..2^19 complex points.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: fft_split (_cfft_kernel),
// the TPU four-step whose two DFT stages run as MXU matmuls against N1 x N1
// and N2 x N2 tables in VMEM for N = 2048..2^17 (other sizes go to the
// XLA-staged matmul_fft there). On Hopper there are no DFT tables:
//   N = 32..1024:    a block holds 2048 / N frames in shared memory and runs
//                    smem_fft.cuh's radix-2 DIF passes, reading the result
//                    back in bit-reversed order (as K10 does);
//   N = 2048..2^16:  fft_common.cuh's two passes;
//   N = 2^17..2^19:  its three passes.
// The planes are the first pass's loader and the last pass's store, so no
// interleaved copy exists. The inverse (N x IDFT, hisstools_ifft) is this
// forward with the planes swapped on the way in and out, which the wrapper
// does by swapping pointers.
//
// Bound on the H100: HBM bytes. 8N in and 8N out per frame, plus 16N of
// scratch per pass boundary (one with two passes, two with three): 2 x 0.13 GB
// in and out at (128, 2^17), against ~5 N log2 N FP32 operations.
#include "fft_common.cuh"
#include "smem_fft.cuh"

namespace {

constexpr int kSmallPoints = 2048;  // complex points per block (all rows)
constexpr int kSmallThreads = 256;

__global__ void __launch_bounds__(kSmallThreads)
cfft_small_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  const float2* __restrict__ tw, long long batch, int log_m) {
  using namespace hst_smem;
  __shared__ float2 a[kSmallPoints];
  const int m = 1 << log_m;
  const int rows = kSmallPoints >> log_m;
  const long long row0 = (long long)blockIdx.x * rows;
  for (int i = threadIdx.x; i < kSmallPoints; i += blockDim.x) {
    const long long row = row0 + (i >> log_m);
    const long long g = row0 * m + i;
    a[i] = row < batch ? make_float2(re[g], im[g]) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  dif(a, log_m, rows, tw, log_m + 1);
  for (int i = threadIdx.x; i < kSmallPoints; i += blockDim.x) {
    const int r = i >> log_m;
    const int k = i & (m - 1);
    if (row0 + r >= batch) continue;
    const float2 z = a[(r << log_m) + brev(k, log_m)];
    out_re[row0 * m + i] = z.x;
    out_im[row0 * m + i] = z.y;
  }
}

}  // namespace

// Twiddle table tw of 2N entries (the real-size table of fft_common.cuh);
// scratch holds batch * N float2 (N = 2048..2^16) or twice that (2^17..2^19),
// and is not read for N <= 1024.
extern "C" int hst_fft_split(const float* re, const float* im, float* out_re,
                             float* out_im, void* scratch, const void* tw,
                             long long batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = static_cast<const float2*>(tw);
  if (n <= 1024) {
    const int rows = kSmallPoints / n;
    const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
    cfft_small_kernel<<<blocks, kSmallThreads, 0, st>>>(re, im, out_re, out_im, w, batch,
                                                         hst::ilog2(n));
  } else {
    hst::run_fft<hst::kLoadSplit, hst::kStoreSplit>(
        hst::make_plan(2 * n), batch, re, im, static_cast<float2*>(scratch), out_re,
        out_im, w, 1, 1.f, st);
  }
  return (int)cudaGetLastError();
}
