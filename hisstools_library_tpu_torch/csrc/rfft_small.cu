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
// would do N/log2(N) times the work of an FFT on the FP32 units, so no table
// and no fold: the M = N/2-point complex FFT of z[n] = x[2n] + i x[2n+1] runs
// on the register-DFT core of reg_fft.cuh (16 points a thread, radix-16
// stages, one shared-memory exchange between stages), and the split step
// pairs bins k and M-k from the natural-order spectrum in shared memory and
// stores both (x2 scale, DC in re[0], Nyquist in im[0]). Both forms serve
// N = 32..2048; they differ only in the loader.
//
// Frame (b, t) starts at x + b * outer_stride + t * row_stride: K10w passes
// the padded signal's `unfold` view (row stride = hop), so no frame buffer
// exists; K10 passes contiguous rows. Thread tf of a frame always loads the
// points tf + T*m (m < 16), so K10w keeps its 32 window values in registers
// for every frame it takes. The loader reads float2 pairs when the base
// pointer is 8-byte aligned and both strides are even, and scalars otherwise
// (a second instantiation chosen per launch), so any hop (odd ones included,
// e.g. 341) and any base offset serve. Each block takes a run of consecutive
// rounds of F frames (one block a resident slot, the rounds split evenly), so
// the 50% overlap of the STFT's hop 512 is read again from L1 / L2, not HBM.
//
// Bound on the H100: HBM bytes. K10: 8 bytes in and 8 out per complex point
// (12 MB at the IR preparation's 384 rows of N = 256, 1024). K10w: the
// signal the frames cover, read once however many frames hold a sample, and
// the packed spectra written once: 246 MB + 492 MB at the STFT's 128 x 938
// frames of 1024 (hop 512), 0.22 ms at 3.35 TB/s.
#include <cstdint>

#include "reg_fft.cuh"

namespace {

using hst_reg::kR;
using hst_reg::kThreads;

template <int LOG_M, bool kWindowed, bool kPairs>
__global__ void __launch_bounds__(kThreads, 2)
rfft_small_kernel(const float* __restrict__ x, long long outer_stride,
                  long long row_stride, long long t, const float* __restrict__ w,
                  float* __restrict__ re, float* __restrict__ im,
                  const float2* __restrict__ tw, long long batch) {
  using P = hst_reg::Plan<LOG_M>;
  constexpr int M = P::kM, T = P::kT, F = P::kFrames;
  __shared__ float2 buf[F * P::kLd];
  __shared__ float2 stw[M];
  const int f = threadIdx.x / T;
  const int tf = threadIdx.x % T;
  float2* fb = buf + f * P::kLd;
  for (int i = threadIdx.x; i < M; i += kThreads) stw[i] = __ldg(&tw[i]);
  float2 wr[kWindowed ? kR : 1];
  if constexpr (kWindowed) {
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int i = 2 * (tf + m * T);
      wr[m] = make_float2(__ldg(&w[i]), __ldg(&w[i + 1]));
    }
  }
  __syncthreads();
  const long long rounds = (batch + F - 1) / F;
  const long long r0 = (long long)blockIdx.x * rounds / gridDim.x;
  const long long r1 = (long long)(blockIdx.x + 1) * rounds / gridDim.x;
  for (long long rd = r0; rd < r1; ++rd) {
    const long long row = rd * F + f;
    const bool live = row < batch;
    const long long base = live ? (row / t) * outer_stride + (row % t) * row_stride : 0;
    float2 v[kR];
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int i = tf + m * T;
      float2 p = make_float2(0.f, 0.f);
      if (live) {
        if constexpr (kPairs) {
          p = __ldg(reinterpret_cast<const float2*>(x + base) + i);
        } else {
          p = make_float2(__ldg(x + base + 2 * i), __ldg(x + base + 2 * i + 1));
        }
      }
      if constexpr (kWindowed) p = make_float2(p.x * wr[m].x, p.y * wr[m].y);
      v[m] = p;
    }
    hst_reg::Stages<LOG_M>::run(v, fb, tf, stw);
    if (!live) continue;
    float* re_row = re + row * M;
    float* im_row = im + row * M;
    for (int k = tf; k <= M / 2; k += T) {
      const float2 zk = fb[hst_reg::pad(k)];
      if (k == 0) {
        const float2 p0 = hst_smem::pack_bin0(zk);
        re_row[0] = p0.x;
        im_row[0] = p0.y;
        continue;
      }
      const float2 zm = fb[hst_reg::pad(M - k)];
      const float2 pk = hst_smem::pack_bin(zk, zm, stw[k]);
      re_row[k] = pk.x;
      im_row[k] = pk.y;
      if (k != M - k) {
        const float2 pm = hst_smem::pack_bin(zm, zk, stw[M - k]);
        re_row[M - k] = pm.x;
        im_row[M - k] = pm.y;
      }
    }
  }
}

// One block a resident slot of the card, capped at the rounds of F frames.
template <int LOG_M, bool kWindowed, bool kPairs>
int launch_m(const float* x, long long outer_stride, long long row_stride, long long t,
             const float* w, float* re, float* im, const float2* tw, long long batch,
             cudaStream_t stream) {
  constexpr int F = hst_reg::Plan<LOG_M>::kFrames;
  auto kernel = rfft_small_kernel<LOG_M, kWindowed, kPairs>;
  static const int per_sm = hst_reg::blocks_per_sm(reinterpret_cast<const void*>(kernel));
  const unsigned blocks = hst_reg::round_grid(per_sm, (batch + F - 1) / F);
  kernel<<<blocks, kThreads, 0, stream>>>(x, outer_stride, row_stride, t, w, re, im, tw,
                                          batch);
  return (int)cudaGetLastError();
}

template <bool kWindowed, bool kPairs>
int launch_pairs(const float* x, long long outer_stride, long long row_stride, long long t,
                 const float* w, float* re, float* im, const float2* tw, long long batch,
                 int n, cudaStream_t stream) {
  return hst_reg::with_log_m(n, [&](auto lm) {
    return launch_m<decltype(lm)::value, kWindowed, kPairs>(x, outer_stride, row_stride, t,
                                                             w, re, im, tw, batch, stream);
  });
}

template <bool kWindowed>
int launch(const float* x, long long outer_stride, long long row_stride, long long t,
           const float* w, float* re, float* im, const void* tw, long long batch, int n,
           void* stream) {
  const bool pairs = (reinterpret_cast<uintptr_t>(x) & 7) == 0 && outer_stride % 2 == 0 &&
                     row_stride % 2 == 0;
  const float2* tw2 = static_cast<const float2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pairs ? launch_pairs<kWindowed, true>(x, outer_stride, row_stride, t, w, re, im,
                                               tw2, batch, n, s)
               : launch_pairs<kWindowed, false>(x, outer_stride, row_stride, t, w, re, im,
                                                tw2, batch, n, s);
}

}  // namespace

// x: (batch, N) contiguous; re, im: (batch, N/2) contiguous.
extern "C" int hst_rfft_small(const float* x, float* re, float* im,
                              const void* tw, long long batch, int n,
                              void* stream) {
  return launch<false>(x, n, 0, 1, nullptr, re, im, tw, batch, n, stream);
}

// x: frame (b, t) at x + b * outer_stride + t * row_stride (floats), b < batch / t;
// w: N floats; re, im: (batch, N/2) contiguous.
extern "C" int hst_rfft_small_windowed(const float* x, long long outer_stride,
                                       long long row_stride, long long t, const float* w,
                                       float* re, float* im, const void* tw,
                                       long long batch, int n, void* stream) {
  return launch<true>(x, outer_stride, row_stride, t, w, re, im, tw, batch, n, stream);
}
