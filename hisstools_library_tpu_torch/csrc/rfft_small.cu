// K10: batched small real FFT to the packed layout, N = 32..2048, and its
// windowed form K10w: rfft(frame * w) for every frame of a strided view.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: _small_fwd_call
// (_small_fwd_kernel, reached through _rfft_small and, at N = 2048, the
// folded _rfft_small_folded; and through rfft_small_windowed, with the
// analysis window folded into the tables, _small_fwd_tables_windowed). The
// TPU kernel is a dense DFT: two matmuls against N x N/2 tables on the MXU,
// with the packing (and the window, a diagonal factor) baked into the tables,
// and a fold to serve N = 2048 inside VMEM; the windowed form leaves N = 2048
// out because the fold does not commute with a window. On Hopper a dense DFT
// would do N/log2(N) times the work of an FFT on the FP32 units, and a frame
// of at most 1024 complex points (8 KB) fits shared memory whole, so no table
// and no fold: each block holds kRows = 2048 / M frames (M = N/2 complex
// points, 16 KB), runs the radix-2 passes of smem_fft.cuh over all of them,
// and packs (x2 scale, DC in re[0], Nyquist in im[0]) in the store. Both
// forms serve N = 32..2048; they differ only in the loader.
//
// K10 loads contiguous (batch, N) rows as float2 pairs. K10w multiplies each
// sample by w[t] (a float32 copy of the float64 host window) in the loader
// and reads its frames in place: frame (b, t) starts at x + b * outer_stride
// + t * row_stride, so the STFT passes the padded signal's `unfold` view (row
// stride = hop) and no frame buffer exists. K10w's loader reads scalars, not
// float2 pairs, so any hop (odd ones included, e.g. 341) and any base
// alignment serve; the two 4-byte loads of a thread hit the same 32-byte
// sectors as a float2 load would.
//
// Bound on the H100: HBM bytes. K10: 8 bytes in and 8 out per complex point
// (12 MB at the IR preparation's 384 rows of N = 256, 1024). K10w: the
// signal the frames cover, read once however many frames hold a sample, and
// the packed spectra written once: 246 MB + 492 MB at the STFT's 128 x 938
// frames of 1024 (hop 512), 0.22 ms at 3.35 TB/s.
#include "smem_fft.cuh"

namespace {

constexpr int kPoints = 2048;          // complex points per block (all rows)
constexpr int kThreads = 256;
constexpr int kMaxRows = kPoints / 16;  // N = 32: 128 frames a block

template <bool kWindowed>
__global__ void __launch_bounds__(kThreads)
rfft_small_kernel(const float* __restrict__ x, long long outer_stride,
                  long long row_stride, long long t, const float* __restrict__ w,
                  float* __restrict__ re, float* __restrict__ im,
                  const float2* __restrict__ tw, long long batch, int log_n) {
  using namespace hst_smem;
  __shared__ float2 a[kPoints];
  __shared__ long long base[kWindowed ? kMaxRows : 1];
  const int log_m = log_n - 1;
  const int m = 1 << log_m;
  const int rows = kPoints >> log_m;
  const long long row0 = (long long)blockIdx.x * rows;
  if constexpr (kWindowed) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long row = row0 + r;
      base[r] = row < batch ? (row / t) * outer_stride + (row % t) * row_stride : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
      const int r = i >> log_m;
      const int k = i & (m - 1);
      float2 v = make_float2(0.f, 0.f);
      if (base[r] >= 0) {
        const float* f = x + base[r] + 2 * k;
        v = make_float2(__ldg(f) * __ldg(&w[2 * k]), __ldg(f + 1) * __ldg(&w[2 * k + 1]));
      }
      a[i] = v;
    }
  } else {
    const float2* x2 = reinterpret_cast<const float2*>(x);
    for (int i = threadIdx.x; i < kPoints; i += blockDim.x) {
      const long long row = row0 + (i >> log_m);
      a[i] = row < batch ? x2[row0 * m + i] : make_float2(0.f, 0.f);
    }
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

template <bool kWindowed>
int launch(const float* x, long long outer_stride, long long row_stride, long long t,
           const float* w, float* re, float* im, const void* tw, long long batch, int n,
           void* stream) {
  int log_n = 0;
  while ((1 << (log_n + 1)) <= n) ++log_n;
  const int rows = kPoints / (n / 2);
  const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
  rfft_small_kernel<kWindowed><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, outer_stride, row_stride, t, w, re, im, static_cast<const float2*>(tw), batch,
      log_n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, N) contiguous; re, im: (batch, N/2) contiguous.
extern "C" int hst_rfft_small(const float* x, float* re, float* im,
                              const void* tw, long long batch, int n,
                              void* stream) {
  return launch<false>(x, 0, 0, 1, nullptr, re, im, tw, batch, n, stream);
}

// x: frame (b, t) at x + b * outer_stride + t * row_stride (floats), b < batch / t;
// w: N floats; re, im: (batch, N/2) contiguous.
extern "C" int hst_rfft_small_windowed(const float* x, long long outer_stride,
                                       long long row_stride, long long t, const float* w,
                                       float* re, float* im, const void* tw,
                                       long long batch, int n, void* stream) {
  return launch<true>(x, outer_stride, row_stride, t, w, re, im, tw, batch, n, stream);
}
