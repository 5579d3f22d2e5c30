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
// N = 2048 to fit VMEM. On Hopper it is K10's kernel (rfft_small.cu) run
// backwards on the same register-DFT core (reg_fft.cuh: 16 points a thread,
// radix-16 Stockham stages, one padded shared-memory exchange between
// stages), by the conjugate route: the forward M-point DFT (M = N/2) of the
// conjugated unpacked input is the conjugate of the inverse's (even, odd)
// sample pairs. No table and no fold, so both forms serve N = 32..2048.
//
// Loader: thread tf of a frame (T = M/16 threads) loads the packed bins
// k = tf + T*m, m < 16, from the re / im planes, each bin once, lanes on
// neighbouring addresses. Unpacking bin k needs bin M-k, which thread
// T - tf holds in slot 15 - m (tf >= 1), or thread 0 in slot 16 - m (tf = 0,
// m >= 1); (0, 0) is the DC / Nyquist lane. Up to M = 512 a frame lies in one
// warp and the partner comes by __shfl_sync among the frame's T lanes; at
// M = 1024 (two warps) through the frame's padded shared slots. W_N^k comes
// from the block's staged half table. The stages then run unchanged, and
// leave the spectrum in natural order in the frame's slots; the store reads
// points tf + T*m and writes the conjugated pairs as coalesced float2, K11w
// multiplying them by scale * w[2n] and scale * w[2n+1] (float32 products
// of the float32 window, as the plain version forms them), read in the store
// from L1 (the window is N floats): kept in 32 registers a thread, as K10w
// keeps its analysis window, they spilled at M = 1024 and ran 3% slower at
// the STFT's frames (tools/small_layouts.py). The grid is K10's: one block a
// resident slot, the rounds of F frames split evenly (a block a round ran
// 4-12% slower at 6144 x 2048 and the STFT's frames).
//
// Bound on the H100: HBM bytes, 8 bytes in and 8 out per complex point
// (0.4 MB at the hand-off's (128, 256), 1.6 MB at (128, 1024), 101 MB at the
// staged FastFIR's 6144 frames of 2048; K11w 0.98 GB at the STFT's 128 x 938
// frames of 1024, 0.29 ms at 3.35 TB/s).
#include "reg_fft.cuh"

namespace {

using hst_reg::kR;
using hst_reg::kThreads;
using hst_reg::pad;

template <int LOG_M, bool kWindowed>
__global__ void __launch_bounds__(kThreads, 2)
rifft_small_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ w, float scale, float* __restrict__ y,
                   const float2* __restrict__ tw, long long batch) {
  using P = hst_reg::Plan<LOG_M>;
  constexpr int M = P::kM, T = P::kT, F = P::kFrames;
  __shared__ float2 buf[F * P::kLd];
  __shared__ float2 stw[M];
  const int f = threadIdx.x / T;
  const int tf = threadIdx.x % T;
  float2* fb = buf + f * P::kLd;
  for (int i = threadIdx.x; i < M; i += kThreads) stw[i] = __ldg(&tw[i]);
  __syncthreads();
  float2* y2 = reinterpret_cast<float2*>(y);
  const long long rounds = (batch + F - 1) / F;
  const long long r0 = (long long)blockIdx.x * rounds / gridDim.x;
  const long long r1 = (long long)(blockIdx.x + 1) * rounds / gridDim.x;
  for (long long rd = r0; rd < r1; ++rd) {
    const long long row = rd * F + f;
    const bool live = row < batch;
    float2 p[kR];
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const long long i = row * M + tf + m * T;
      p[m] = live ? make_float2(__ldg(re + i), __ldg(im + i)) : make_float2(0.f, 0.f);
    }
    // The conjugated input point k = tf + T*m from bins k and M - k (q).
    auto unpack = [&](int m, float2 q) {
      const int k = tf + m * T;
      return k == 0 ? hst_smem::unpack_bin0(p[m]) : hst_smem::unpack_bin(p[m], q, stw[k]);
    };
    float2 v[kR];
    if constexpr (T <= 32) {
      // Bin M - k of slot m is slot 15 - m of lane (T - tf) mod T of the
      // frame (tf = 0: its own slot 16 - m), so slots m and 15 - m take
      // their partners in one step, each shuffle offering the other's slot.
      const int src = (T - tf) & (T - 1);
#pragma unroll
      for (int m = 0; m < kR / 2; ++m) {
        const int o = kR - 1 - m;
        float2 qm = p[o], qo = p[m];
        if constexpr (T > 1) {
          qm = make_float2(__shfl_sync(0xffffffffu, p[o].x, src, T),
                           __shfl_sync(0xffffffffu, p[o].y, src, T));
          qo = make_float2(__shfl_sync(0xffffffffu, p[m].x, src, T),
                           __shfl_sync(0xffffffffu, p[m].y, src, T));
        }
        if (tf == 0) {
          qm = p[(kR - m) % kR];
          qo = p[m + 1];
        }
        v[m] = unpack(m, qm);
        v[o] = unpack(o, qo);
      }
    } else {
      hst_reg::frame_sync<LOG_M>();  // the previous round's store has read fb
#pragma unroll
      for (int m = 0; m < kR; ++m) fb[pad(tf + m * T)] = p[m];
      hst_reg::frame_sync<LOG_M>();
#pragma unroll
      for (int m = 0; m < kR; ++m) v[m] = unpack(m, fb[pad((M - tf - m * T) & (M - 1))]);
    }
    hst_reg::Stages<LOG_M>::run(v, fb, tf, stw);
    if (!live) continue;
    float2* out = y2 + row * M;
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int n = tf + m * T;
      const float2 z = fb[pad(n)];
      if constexpr (kWindowed) {
        out[n] = make_float2(z.x * (scale * __ldg(&w[2 * n])),
                             -z.y * (scale * __ldg(&w[2 * n + 1])));
      } else {
        out[n] = make_float2(z.x, -z.y);
      }
    }
  }
}

template <bool kWindowed>
int launch(const float* re, const float* im, const float* w, float scale, float* y,
           const void* tw, long long batch, int n, void* stream) {
  return hst_reg::with_log_m(n, [&](auto lm) {
    constexpr int LOG_M = decltype(lm)::value;
    constexpr int F = hst_reg::Plan<LOG_M>::kFrames;
    auto kernel = rifft_small_kernel<LOG_M, kWindowed>;
    static const int per_sm = hst_reg::blocks_per_sm(reinterpret_cast<const void*>(kernel));
    const unsigned blocks = hst_reg::round_grid(per_sm, (batch + F - 1) / F);
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        re, im, w, scale, y, static_cast<const float2*>(tw), batch);
    return (int)cudaGetLastError();
  });
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
