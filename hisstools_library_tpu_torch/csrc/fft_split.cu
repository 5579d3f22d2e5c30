// K12: batched unscaled complex DFT along the last axis, split re/im planes
// in and natural-order split planes out, N = 32..2^28 complex points.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: fft_split (:856,
// _cfft_kernel), the TPU four-step whose two DFT stages run as MXU matmuls
// against N1 x N1 and N2 x N2 tables in VMEM for N = 2048..2^17 (other sizes
// go to the XLA-staged matmul_fft there, and on a TPU from 2^21 to the
// out-of-core four-step of fft/oversize.py). On Hopper there are no DFT
// tables:
//   N = 32..1024:    a block holds 2048 / N frames in shared memory and runs
//                    smem_fft.cuh's radix-2 DIF passes, reading the result
//                    back in bit-reversed order (as K10 does);
//   N = 2048..2^16:  fft_common.cuh's two passes;
//   N = 2^17:        fft_large.cuh's one pass on an 8-block cluster, the
//                    1 MB frame in the cluster's shared memory;
//   N = 2^18..2^20:  fft_large.cuh's two passes of 512..1024-point sub-FFTs;
//   N = 2^21..2^28:  fft_large.cuh's three passes of 128..1024-point sub-FFTs.
// The planes are the first stage's loader and the last stage's store, so no
// interleaved copy exists. The inverse (N x IDFT, hisstools_ifft) is this
// forward with the planes swapped on the way in and out, which the wrapper
// does by swapping pointers.
//
// Bound on the H100: HBM bytes, 8N in and 8N out per frame (0.27 GB at the
// path shape (128, 2^17), 0.08 ms at 3.35 TB/s), against ~5 N log2 N FP32
// operations. The design's own traffic adds 16N of scratch for two passes
// (N = 2048..2^16 and 2^18..2^20), 32N for three (2^21..2^28) and none at
// 2^17.
#include "fft_common.cuh"
#include "fft_large.cuh"
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

// Twiddle table tw: 2N entries (the real-size table of fft_common.cuh) for
// N <= 2^17, the W_2048 table of fft_large.cuh's long routes above; scratch
// holds batch * N float2 (N = 2048..2^16 and 2^18..2^28), and is not read
// for N <= 1024 and N = 2^17.
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
  } else if (n <= (1 << 16)) {
    hst::run_fft(hst::make_plan(2 * n), batch, re, im, static_cast<float2*>(scratch), out_re,
                 out_im, w, st);
  } else {
    return hst::run_fft_large<hst::kLoadSplit, hst::kStoreSplit>(
        hst::make_plan(2 * n), batch, re, im, static_cast<float2*>(scratch), out_re,
        out_im, w, st);
  }
  return (int)cudaGetLastError();
}
