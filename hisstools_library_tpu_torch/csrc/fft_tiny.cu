// The FFT sizes below the other kernels' ranges: real N = 2..16 (the packed
// forward of K10 and K10w, the unscaled inverse of K11 and K11w) and complex
// N = 1..16 (K12), one thread a frame.
//
// The TPU package serves these sizes outside Pallas: below its kernels'
// sizes rfft_packed / rifft_packed / fft_split fall back to the XLA-staged
// matmul_fft (hisstools_library_tpu/fft/pallas_fft.py:470-471, :866-868),
// a dense DFT against an N x N table. On Hopper a frame of at most 16 points
// fits one thread's registers, so each thread loads its frame, runs
// reg_fft.cuh's in-register DFT (radix-2 passes on compile-time W_16
// constants, W_N^e = W_16^(e * 16/N)), and stores it. The real transforms
// keep the packed conventions of the larger kernels: z[n] = x[2n] + i x[2n+1]
// through the M = N/2-point DFT, then the split step (pack_bin; DC in re[0],
// Nyquist in im[0], forward x2), and for the inverse the unpack (unpack_bin,
// conjugated), the DFT and the conjugated (even, odd) store, so that
// rifft(rfft(x)) = 2N x. Complex N = 1 is a copy. The windowed forms multiply
// by the window in the loader (forward) and by scale * w in the store
// (inverse), as K10w / K11w do; the forward reads frame (b, t) of a strided
// view at x + b * outer_stride + t * row_stride.
//
// Bound on the H100: HBM bytes, 4N in and 4N out a real frame (8N each way a
// complex one); ~5 N log2 N operations a frame, in registers.
#include "reg_fft.cuh"

namespace {

constexpr int kThreads = 256;

// W_N^e for N = 2^LOG_N <= 16 and a compile-time e once the loops unroll.
template <int LOG_N>
__device__ __forceinline__ float2 w_n(int e) {
  return hst_reg::mul_w16(make_float2(1.f, 0.f), e << (4 - LOG_N));
}

template <int LOG_N, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
rfft_tiny_kernel(const float* __restrict__ x, long long outer_stride, long long row_stride,
                 long long t, const float* __restrict__ w, float* __restrict__ re,
                 float* __restrict__ im, long long batch) {
  constexpr int N = 1 << LOG_N, M = N / 2;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const float* xf = x + (row / t) * outer_stride + (row % t) * row_stride;
  float2 z[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float a = __ldg(&xf[2 * i]), b = __ldg(&xf[2 * i + 1]);
    if constexpr (kWindowed) {
      a *= __ldg(&w[2 * i]);
      b *= __ldg(&w[2 * i + 1]);
    }
    z[i] = make_float2(a, b);
  }
  hst_reg::dft<M>(z);
  float* rr = re + row * M;
  float* ir = im + row * M;
  const float2 p0 = hst_smem::pack_bin0(z[0]);
  rr[0] = p0.x;
  ir[0] = p0.y;
#pragma unroll
  for (int k = 1; k < M; ++k) {
    const float2 pk = hst_smem::pack_bin(z[k], z[M - k], w_n<LOG_N>(k));
    rr[k] = pk.x;
    ir[k] = pk.y;
  }
}

template <int LOG_N, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
rifft_tiny_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ w, float scale, float* __restrict__ y,
                  long long batch) {
  constexpr int N = 1 << LOG_N, M = N / 2;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const float* rr = re + row * M;
  const float* ir = im + row * M;
  float2 p[M];
#pragma unroll
  for (int k = 0; k < M; ++k) p[k] = make_float2(__ldg(&rr[k]), __ldg(&ir[k]));
  float2 c[M];
  c[0] = hst_smem::unpack_bin0(p[0]);
#pragma unroll
  for (int k = 1; k < M; ++k) c[k] = hst_smem::unpack_bin(p[k], p[M - k], w_n<LOG_N>(k));
  hst_reg::dft<M>(c);
  float* yf = y + row * N;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if constexpr (kWindowed) {
      yf[2 * i] = c[i].x * (scale * __ldg(&w[2 * i]));
      yf[2 * i + 1] = -c[i].y * (scale * __ldg(&w[2 * i + 1]));
    } else {
      yf[2 * i] = c[i].x;
      yf[2 * i + 1] = -c[i].y;
    }
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
cfft_tiny_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ out_re, float* __restrict__ out_im, long long batch) {
  constexpr int N = 1 << LOG_N;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;
  const long long o = row * N;
  float2 z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) z[i] = make_float2(__ldg(&re[o + i]), __ldg(&im[o + i]));
  hst_reg::dft<N>(z);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out_re[o + i] = z[i].x;
    out_im[o + i] = z[i].y;
  }
}

inline unsigned blocks_of(long long batch) {
  return (unsigned)((batch + kThreads - 1) / kThreads);
}

template <bool kWindowed>
int launch_rfft(const float* x, long long outer_stride, long long row_stride, long long t,
                const float* w, float* re, float* im, long long batch, int n,
                cudaStream_t st) {
#define HST_TINY_CASE(LN)                                                               \
  case LN:                                                                              \
    rfft_tiny_kernel<LN, kWindowed><<<blocks_of(batch), kThreads, 0, st>>>(             \
        x, outer_stride, row_stride, t, w, re, im, batch);                              \
    break;
  switch (hst_reg::log2_c(n)) {
    HST_TINY_CASE(1)
    HST_TINY_CASE(2)
    HST_TINY_CASE(3)
    HST_TINY_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef HST_TINY_CASE
  return (int)cudaGetLastError();
}

template <bool kWindowed>
int launch_rifft(const float* re, const float* im, const float* w, float scale, float* y,
                 long long batch, int n, cudaStream_t st) {
#define HST_TINY_CASE(LN)                                                                \
  case LN:                                                                               \
    rifft_tiny_kernel<LN, kWindowed><<<blocks_of(batch), kThreads, 0, st>>>(re, im, w,   \
                                                                            scale, y, batch); \
    break;
  switch (hst_reg::log2_c(n)) {
    HST_TINY_CASE(1)
    HST_TINY_CASE(2)
    HST_TINY_CASE(3)
    HST_TINY_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef HST_TINY_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Real N = 2..16 (a power of two). Frame (b, t) of x at x + b * outer_stride
// + t * row_stride floats, b < batch / t; w: null, or N floats (the window);
// re, im: (batch, N/2) contiguous.
extern "C" int hst_rfft_tiny(const float* x, long long outer_stride, long long row_stride,
                             long long t, const float* w, float* re, float* im,
                             long long batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w == nullptr
             ? launch_rfft<false>(x, outer_stride, row_stride, t, w, re, im, batch, n, st)
             : launch_rfft<true>(x, outer_stride, row_stride, t, w, re, im, batch, n, st);
}

// Real N = 2..16: re, im (batch, N/2) contiguous -> y (batch, N) contiguous,
// times scale * w where w is not null.
extern "C" int hst_rifft_tiny(const float* re, const float* im, const float* w, float scale,
                              float* y, long long batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w == nullptr ? launch_rifft<false>(re, im, w, scale, y, batch, n, st)
                      : launch_rifft<true>(re, im, w, scale, y, batch, n, st);
}

// Complex N = 1..16: split planes (batch, N) contiguous in and out.
extern "C" int hst_fft_tiny(const float* re, const float* im, float* out_re, float* out_im,
                            long long batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_of(batch);
  switch (hst_reg::log2_c(n)) {
    case 0: cfft_tiny_kernel<0><<<blocks, kThreads, 0, st>>>(re, im, out_re, out_im, batch); break;
    case 1: cfft_tiny_kernel<1><<<blocks, kThreads, 0, st>>>(re, im, out_re, out_im, batch); break;
    case 2: cfft_tiny_kernel<2><<<blocks, kThreads, 0, st>>>(re, im, out_re, out_im, batch); break;
    case 3: cfft_tiny_kernel<3><<<blocks, kThreads, 0, st>>>(re, im, out_re, out_im, batch); break;
    case 4: cfft_tiny_kernel<4><<<blocks, kThreads, 0, st>>>(re, im, out_re, out_im, batch); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
