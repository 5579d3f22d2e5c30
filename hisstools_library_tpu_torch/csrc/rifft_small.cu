// K11: batched small unscaled inverse of the packed real spectrum,
// N = 32..2048: rifft(rfft(x)) = 2N x, (batch, N/2) planes -> (batch, N);
// and its windowed form K11w: scale * rifft(spec) * w.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _small_inv_call
// (_small_inv_kernel, reached through _rifft_small and, at N = 2048, the
// folded _rifft_small_folded; and through rifft_small_windowed, with the
// synthesis window and the scale folded into the tables,
// _small_inv_tables_windowed, N = 2048 left out). The TPU kernel is a dense
// inverse DFT: two matmuls against N/2 x N tables on the MXU, folded at
// N = 2048 to fit VMEM. On Hopper it mirrors K10 (rfft_small.cu): a frame of
// at most 1024 complex points fits shared memory whole, so each block holds
// kRows = 2048 / M frames (M = N/2, 16 KB in all). The loader unpacks bins k
// and M-k into the bit-reversed slot of k (unpack_bin, conjugated), the
// radix-2 dit() passes of smem_fft.cuh run over all rows, and the store
// writes the conjugated (even, odd) sample pairs in natural order. No table
// and no fold, so both forms serve N = 32..2048. K11w differs only in the
// store, which multiplies each output pair by scale * w[2j] and
// scale * w[2j+1] (float32 products of the float32 window copy, as the plain
// version forms them).
//
// Bound on the H100: HBM bytes, 8 bytes in and 8 out per complex point
// (0.4 MB at the hand-off's (128, 256), 1.6 MB at (128, 1024); K11w 0.98 GB
// at the STFT's 128 x 938 frames of 1024, 0.29 ms at 3.35 TB/s).
#include "smem_fft.cuh"

namespace {

constexpr int kPoints = 2048;  // complex points per block (all rows)
constexpr int kThreads = 256;

template <bool kWindowed>
__global__ void __launch_bounds__(kThreads)
rifft_small_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ w, float scale, float* __restrict__ y,
                   const float2* __restrict__ tw, long long batch, int log_n) {
  using namespace hst_smem;
  __shared__ float2 a[kPoints];
  const int log_m = log_n - 1;
  const int m = 1 << log_m;
  const int rows = kPoints >> log_m;
  const long long row0 = (long long)blockIdx.x * rows;
  for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
    const int r = i >> log_m;
    const int k = i & (m - 1);
    const long long row = row0 + r;
    float2 v = make_float2(0.f, 0.f);
    if (row < batch) {
      const long long base = row * m;
      const float2 pk = make_float2(re[base + k], im[base + k]);
      v = k == 0 ? unpack_bin0(pk)
                 : unpack_bin(pk, make_float2(re[base + m - k], im[base + m - k]),
                              __ldg(&tw[k]));
    }
    a[(r << log_m) + brev(k, log_m)] = v;
  }
  __syncthreads();
  dit(a, log_m, rows, tw, log_n);
  float2* y2 = reinterpret_cast<float2*>(y);
  for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
    if (row0 + (i >> log_m) >= batch) continue;
    const float2 v = a[i];
    if constexpr (kWindowed) {
      const int j = i & (m - 1);
      const float w0 = scale * __ldg(&w[2 * j]);
      const float w1 = scale * __ldg(&w[2 * j + 1]);
      y2[row0 * m + i] = make_float2(v.x * w0, -v.y * w1);
    } else {
      y2[row0 * m + i] = make_float2(v.x, -v.y);
    }
  }
}

template <bool kWindowed>
int launch(const float* re, const float* im, const float* w, float scale, float* y,
           const void* tw, long long batch, int n, void* stream) {
  int log_n = 0;
  while ((1 << (log_n + 1)) <= n) ++log_n;
  const int rows = kPoints / (n / 2);
  const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
  rifft_small_kernel<kWindowed><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, w, scale, y, static_cast<const float2*>(tw), batch, log_n);
  return (int)cudaGetLastError();
}

}  // namespace

// re, im: (batch, N/2) contiguous; y: (batch, N) contiguous.
extern "C" int hst_rifft_small(const float* re, const float* im, float* y,
                               const void* tw, long long batch, int n,
                               void* stream) {
  return launch<false>(re, im, nullptr, 1.f, y, tw, batch, n, stream);
}

// re, im: (batch, N/2) contiguous; w: N floats; y: (batch, N) contiguous.
extern "C" int hst_rifft_small_windowed(const float* re, const float* im, const float* w,
                                        float scale, float* y, const void* tw,
                                        long long batch, int n, void* stream) {
  return launch<true>(re, im, w, scale, y, tw, batch, n, stream);
}
