// Register-DFT core for one frame of M = 16..1024 complex points (K10 and
// K10w, rfft_small.cu; K11 and K11w, rifft_small.cu; both transforms of K9,
// hop_fire.cu, M = 16..512; K5's row DFTs, fastfir_chain.cu).
//
// Each thread of a frame holds kR = 16 points in registers; a frame has
// T = M / 16 threads, and a block of kThreads = 256 threads holds
// F = 256 / T frames (4096 points in all). The M-point DFT runs as a
// Stockham autosort FFT (decimation in time, natural order in and out) of
// stages of radix 16, with the remainder 2, 4 or 8 as the last stage:
//
//   M     16  32    64    128   256    512       1024
//   radix 16  16x2  16x4  16x8  16x16  16x16x2   16x16x4
//
// In every stage thread tf of a frame holds the points tf + T*m, m < 16, of
// the stage's input; a stage of radix r takes them as 16/r DFTs of r points,
// DFT q on the points j + (M/r)*k, k < r, of j = tf + q*T. Each point k > 0
// is multiplied by the inter-stage twiddle W_{Ns*r}^((j mod Ns) * k) (Ns =
// 16^stage, the product of the earlier radices), the r-point DFT runs in
// registers (radix-2 passes whose twiddles W_16^e are compile-time constants),
// and output k goes to (j / Ns) * Ns * r + (j mod Ns) + k * Ns. So the first
// stage reads the same 16 point indices of every frame a thread takes, and
// between two stages the frame goes once through shared memory: at M = 512
// two exchanges, where the radix-2 core (smem_fft.cuh) makes nine passes with
// a barrier each. The last stage writes the spectrum in natural order to
// shared memory, where the split step pairs bins k and M-k (K10) or the
// store reads the conjugated sample pairs (K11, whose loader unpacks).
//
// A frame up to M = 512 lives in one warp (T <= 32; below 512 a warp holds
// 32 / T frames), so its exchanges need only __syncwarp(). At M = 1024 a
// frame takes two warps (T = 64) and the exchanges are block barriers; 32
// points a thread in one warp would need twice the registers, and was not
// tried. Shared memory holds each frame padded by one slot every 16 points,
// so the stride-16 stores of the first stage fall in distinct banks.
//
// Twiddles: the block stages tw[e] = W_N^e, e < M, N = 2M (the first half of
// the table the host builds in float64 and stores as float32) once in
// shared memory; the inter-stage twiddle W_{Ns*r}^x is W_N^(x * N/(Ns*r))
// and W_N^(e + M) = -W_N^e. The split step (and the inverse's unpack) reads
// W_N^k from the same table. No sincosf, no fast-math intrinsics.
//
// hopper_fft._small_plan mirrors this plan (stage radices, threads and warps
// a frame, frames a block, shared bytes).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "smem_fft.cuh"

namespace hst_reg {

using hst_smem::cmul;

constexpr int kR = 16;         // points a thread holds
constexpr int kThreads = 256;  // threads a block

// (fft_common.cuh includes this file and takes log2_c and brev_permute from
// it; the reverse would compile the two-pass core's kernels into every file
// that includes this one.)
__host__ __device__ constexpr int log2_c(int v) { return v <= 1 ? 0 : 1 + log2_c(v / 2); }

__host__ __device__ constexpr int brev_c(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((v >> i) & 1);
  return r;
}

// The plan of a complex size M = 2^LOG_M.
template <int LOG_M>
struct Plan {
  static constexpr int kM = 1 << LOG_M;
  static constexpr int kT = kM / kR;             // threads a frame
  static constexpr int kFrames = kThreads / kT;  // frames a block
  static constexpr int kLd = kM + kM / 16;       // padded frame in shared memory
  static constexpr int kFull = LOG_M / 4;        // stages of radix 16
  static constexpr int kStages = kFull + (LOG_M % 4 ? 1 : 0);
  __host__ __device__ static constexpr int radix(int s) {
    return s < kFull ? 16 : 1 << (LOG_M % 4);
  }
  // Ns of stage s: the product of the earlier radices
  __host__ __device__ static constexpr int span(int s) { return 1 << (4 * s); }
};

// Index of point i of a frame in its padded shared-memory slot range.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// a * W_16^e, e a compile-time constant once the callers' loops unroll; the
// values are the float64 cos / sin rounded to float32.
__device__ __forceinline__ float2 mul_w16(float2 a, int e) {
  constexpr float c1 = 0.92387953251128674f, c2 = 0.70710678118654752f,
                  c3 = 0.38268343236508977f;
  switch (e & 15) {
    case 0: return a;
    case 1: return cmul(a, make_float2(c1, -c3));
    case 2: return cmul(a, make_float2(c2, -c2));
    case 3: return cmul(a, make_float2(c3, -c1));
    case 4: return make_float2(a.y, -a.x);
    case 5: return cmul(a, make_float2(-c3, -c1));
    case 6: return cmul(a, make_float2(-c2, -c2));
    case 7: return cmul(a, make_float2(-c1, -c3));
    case 8: return make_float2(-a.x, -a.y);
    case 9: return cmul(a, make_float2(-c1, c3));
    case 10: return cmul(a, make_float2(-c2, c2));
    case 11: return cmul(a, make_float2(-c3, c1));
    case 12: return make_float2(-a.y, a.x);
    case 13: return cmul(a, make_float2(c3, c1));
    case 14: return cmul(a, make_float2(c2, c2));
    default: return cmul(a, make_float2(c1, c3));
  }
}

// a[i] <-> a[brev(i)], the bit-reversal permutation of an R-point register
// DFT's input (this file's dft and fft_common.cuh's reg_dft), with every
// index a constant expression: brev_c evaluated at run time inside an
// unrolled loop left its bit loop rolled, indexed the array dynamically and
// put it in local memory (ptxas: stack frames of up to 336 bytes in the
// one-pass kernel).
template <int R, int I = 0>
__device__ __forceinline__ void brev_permute(float2 (&a)[R]) {
  if constexpr (I < R) {
    constexpr int j = brev_c(I, log2_c(R));
    if constexpr (j > I) {
      const float2 t = a[I];
      a[I] = a[j];
      a[j] = t;
    }
    brev_permute<R, I + 1>(a);
  }
}

// In-register R-point DFT (R = 2..16), natural order in and out: bit
// reversal by register renaming, then radix-2 decimation-in-time passes
// with W_{2h}^j = W_16^(j * 16 / (2h)).
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
  constexpr int kLog = log2_c(R);
  brev_permute(a);
#pragma unroll
  for (int s = 0; s < kLog; ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int b = 0; b < R / 2; ++b) {
      const int j = b & (h - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const float2 u = a[i0];
      const float2 t = mul_w16(a[i0 + h], j * (8 >> s));
      a[i0] = make_float2(u.x + t.x, u.y + t.y);
      a[i0 + h] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
}

// W_N^e for e < 2M from the staged half table s[e] = W_N^e, e < M.
template <int M>
__device__ __forceinline__ float2 tw_n(const float2* s, int e) {
  if (e < M) return s[e];
  const float2 w = s[e - M];
  return make_float2(-w.x, -w.y);
}

// Stage S of the frame's FFT on the thread's 16 points v (v[m] = point
// tf + T*m of the stage's input): twiddles and the 16/r DFTs of r points.
template <int LOG_M, int S>
__device__ __forceinline__ void stage(float2 (&v)[kR], int tf, const float2* stw) {
  using P = Plan<LOG_M>;
  constexpr int r = P::radix(S), ns = P::span(S), q_n = kR / r;
  constexpr int kShift = LOG_M + 1 - log2_c(ns * r);  // N / (Ns * r) = 2^kShift
#pragma unroll
  for (int q = 0; q < q_n; ++q) {
    const int jm = (tf + q * P::kT) & (ns - 1);
    float2 a[r];
#pragma unroll
    for (int k = 0; k < r; ++k) {
      a[k] = v[q + k * q_n];
      if (S > 0 && k > 0) a[k] = cmul(a[k], tw_n<P::kM>(stw, (jm * k) << kShift));
    }
    dft<r>(a);
#pragma unroll
    for (int k = 0; k < r; ++k) v[q + k * q_n] = a[k];
  }
}

// Stage S's outputs to the frame's shared slots f: output k of DFT q at
// (j / Ns) * Ns * r + (j mod Ns) + k * Ns.
template <int LOG_M, int S>
__device__ __forceinline__ void stage_store(float2* f, const float2 (&v)[kR], int tf) {
  using P = Plan<LOG_M>;
  constexpr int r = P::radix(S), ns = P::span(S), q_n = kR / r;
#pragma unroll
  for (int q = 0; q < q_n; ++q) {
    const int j = tf + q * P::kT;
    const int o = (j / ns) * ns * r + (j & (ns - 1));
#pragma unroll
    for (int k = 0; k < r; ++k) f[pad(o + k * ns)] = v[q + k * q_n];
  }
}

// The frame's exchange barrier: one warp (or part of one) holds a frame up
// to M = 512, two warps at 1024.
template <int LOG_M>
__device__ __forceinline__ void frame_sync() {
  if (Plan<LOG_M>::kT <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Stages S.. of the frame's FFT: the thread's points v are stage S's input;
// each stage's outputs go through the frame's shared slots f (the barrier
// before a store guards the reads of the previous stage, or of the previous
// frame's split step); the last stage leaves the spectrum in natural order
// in f.
template <int LOG_M, int S = 0, bool kDone = (S >= Plan<LOG_M>::kStages)>
struct Stages {
  static __device__ __forceinline__ void run(float2 (&v)[kR], float2* f, int tf,
                                             const float2* stw) {
    stage<LOG_M, S>(v, tf, stw);
    frame_sync<LOG_M>();
    stage_store<LOG_M, S>(f, v, tf);
    frame_sync<LOG_M>();
    if (S + 1 < Plan<LOG_M>::kStages) {
#pragma unroll
      for (int m = 0; m < kR; ++m) v[m] = f[pad(tf + m * Plan<LOG_M>::kT)];
    }
    Stages<LOG_M, S + 1>::run(v, f, tf, stw);
  }
};

template <int LOG_M, int S>
struct Stages<LOG_M, S, true> {
  static __device__ __forceinline__ void run(float2 (&)[kR], float2*, int,
                                             const float2*) {}
};

// The launch of the small real transforms (K10 / K10w, K11 / K11w): a block
// takes a run of consecutive rounds of F frames, [b R / G, (b + 1) R / G) of
// the R rounds over G blocks, and G is one block a resident slot of the card,
// at most R.

// Blocks of `kernel` (kThreads threads) resident on one SM at once (at least 1).
inline int blocks_per_sm(const void* kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess)
    return 1;
  return n < 1 ? 1 : n;
}

inline unsigned round_grid(int per_sm, long long rounds) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = (long long)per_sm * (sms < 1 ? 1 : sms);
  return (unsigned)(rounds < slots ? rounds : slots);
}

// fn(std::integral_constant<int, LOG_M>{}) for real size n = 2^(LOG_M + 1),
// LOG_M = 4..10; cudaErrorInvalidValue for any other size.
template <class Fn>
int with_log_m(int n, Fn&& fn) {
  switch (log2_c(n) - 1) {
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 9: return fn(std::integral_constant<int, 9>{});
    case 10: return fn(std::integral_constant<int, 10>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hst_reg
