// K10: batched small real FFT to the packed layout, N = 32..2048.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _small_fwd_call
// (_small_fwd_kernel, reached through _rfft_small and, at N = 2048, the
// folded _rfft_small_folded). The TPU kernel is a dense DFT: two matmuls
// against N x N/2 tables on the MXU, with the packing baked into the tables,
// and a fold to serve N = 2048 inside VMEM. On Hopper a dense DFT would do
// N/log2(N) times the work of an FFT on the FP32 units, and a frame of at
// most 1024 complex points (8 KB) fits shared memory whole, so no table and
// no fold: each block holds kRows = 2048 / M frames (M = N/2 complex points,
// 16 KB), runs the radix-2 passes of smem_fft.cuh over all of them, and packs
// (x2 scale, DC in re[0], Nyquist in im[0]) in the store.
//
// Bound on the H100: the launch and the shared-memory passes; HBM traffic is
// 8 bytes in and 8 out per complex point (12 MB at the IR preparation's
// 384 rows of N = 256, 1024).
#include "smem_fft.cuh"

namespace {

constexpr int kPoints = 2048;  // complex points per block (all rows)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rfft_small_kernel(const float* __restrict__ x, float* __restrict__ re,
                  float* __restrict__ im, const float2* __restrict__ tw,
                  long long batch, int log_n) {
  using namespace hst_smem;
  __shared__ float2 a[kPoints];
  const int log_m = log_n - 1;
  const int m = 1 << log_m;
  const int rows = kPoints >> log_m;
  const long long row0 = (long long)blockIdx.x * rows;
  const float2* x2 = reinterpret_cast<const float2*>(x);
  for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
    const long long row = row0 + (i >> log_m);
    a[i] = row < batch ? x2[row0 * m + i] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  dif(a, log_m, rows, tw, log_n);
  for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
    const int r = i >> log_m;
    const int k = i & (m - 1);
    const long long row = row0 + r;
    if (row >= batch) continue;
    const float2* ar = a + (r << log_m);
    const float2 zk = ar[brev(k, log_m)];
    const float2 p = k == 0 ? pack_bin0(zk)
                            : pack_bin(zk, ar[brev(m - k, log_m)], __ldg(&tw[k]));
    re[row * m + k] = p.x;
    im[row * m + k] = p.y;
  }
}

}  // namespace

extern "C" int hst_rfft_small(const float* x, float* re, float* im,
                              const void* tw, long long batch, int n,
                              void* stream) {
  int log_n = 0;
  while ((1 << (log_n + 1)) <= n) ++log_n;
  const int rows = kPoints / (n / 2);
  const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
  rfft_small_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, re, im, static_cast<const float2*>(tw), batch, log_n);
  return (int)cudaGetLastError();
}
