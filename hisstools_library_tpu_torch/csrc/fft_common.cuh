// Shared multi-pass FFT core on Hopper: the complex K12 fft_split at
// 2048..2^16 points, and K5's FastFIR chain (fastfir_chain.cu: this file's
// column pass for its forward, and the row-first inverse at the end of this
// file). The plan (make_plan) also routes the large sizes, complex M =
// 2^17..2^28, which fft_large.cuh serves (K12 there, K13 rfft_packed_split
// and K14 rifft_packed_split). K1 rfft_packed, K2 rfft_packed_stream, K4
// rifft_packed_tail and K6 rifft_packed take none of make_plan's routes:
// they run fft_large.cuh's one-pass kernel on K1's own plan (K1Pass) at
// every size they serve.
//
// A real transform of length N is an M = N/2 point complex FFT of
// z[n] = x[2n] + i x[2n+1], plus the split step that pairs bins k and M-k.
// The complex K12 is the M-point FFT alone, split planes in and out. A
// complex frame of M = 2048..2^16 points is 16 KB-512 KB, beyond one block's
// shared memory at the top of the range, so here the FFT runs as two passes
// over an HBM scratch frame, each pass a set of sub-FFTs of length <= 256,
// M = M1 * M2:
//     pass 1 (columns): for each column n1 < M1, the M2-point FFT of
//             z[n1 + M1*n2] over n2, times the inter-pass twiddle W_M^(n1*k2);
//             written to a scratch frame as Y[k2*M1 + n1].
//     pass 2 (rows): for each row k2 < M2, the M1-point FFT of Y[k2*M1 + n1]
//             over n1, which is Z[k2 + M2*k1].
//
// Bin k = j + R*k1 (R = M/M1 rows) and its partner M-k = (R-j) + R*(M1-1-k1)
// (row 0: column M1-k1) sit in rows j and R-j: the pairs that K5's middle
// phase and fft_large.cuh's packs (pack_row_of) hold in one block. K12's
// split planes are the row pass's store and the column pass's loader.
//
// A block runs kTile = 16 neighbouring sub-FFTs of length L = A*B, each as a
// four-step of its own: every thread takes one B-point DFT in registers
// (radix-2, fully unrolled), the block exchanges the twiddled results through
// shared memory once, and every thread takes one A-point DFT in registers.
// Each pass reads and writes straight from registers, in runs of 16
// consecutive points.
//
// Bound on the H100: HBM bytes. Each pass reads and writes one complex frame
// (8*M bytes each way); the butterflies are ~5*M*log2(M) FP32 operations per
// frame, kept in registers. Twiddles come from one table
// tw[e] = exp(-2*pi*i*e/N), e < N = 2M, computed in float64 on the host and
// stored as float32; no fast-math intrinsics are used anywhere. Frame
// offsets are 64-bit; in-frame indices stay below M <= 2^28 (fft_large.cuh).
//
// Packed layout (HISSTools/vDSP): N/2 bins, forward scaled x2, DC in re[0],
// Nyquist in im[0]. Unscaled inverse: rifft(rfft(x)) = 2N x.
#pragma once

#include <cuda_runtime.h>

#include "reg_fft.cuh"

namespace hst {

constexpr int kTile = 16;         // sub-FFTs per block
constexpr int kMaxSub = 256;      // longest sub-FFT of the two-pass route
constexpr int kLd = kMaxSub + 1;  // odd row stride of the shared tile: no bank conflicts
constexpr int kThreads = 256;     // = kTile * 16, one thread per DFT in each step

enum LoadMode {
  kLoadReal = 0, kLoadStream = 1, kLoadUnpack = 2, kLoadSplit = 3, kLoadStreamPrev = 4
};
enum StoreMode { kStorePack = 0, kStoreTail = 1, kStoreFull = 2, kStoreSplit = 3 };

// How make_plan serves a complex size M: two passes of sub-FFTs <= 256 over a
// scratch frame (M = 2048..2^16, this file), one pass on an 8-block cluster
// (M = 2^17, fft_large.cuh), two passes of sub-FFTs of 512..1024 over a
// scratch frame (M = 2^18..2^20, fft_large.cuh) or three passes of sub-FFTs
// of 128..1024 over one scratch frame (M = 2^21..2^28, fft_large.cuh).
enum Route { kRouteTwoPass = 0, kRouteCluster = 1, kRouteLong = 2, kRouteLong3 = 3 };

struct Plan {
  int n;        // twiddle table size N = 2M (the real transforms' size)
  int log_n;
  int m;        // complex size M
  int route;    // Route
  int l_first;  // column sub-FFT length: columns of l_first points
  int l_mid;    // kRouteLong3: the middle pass's sub-FFT length (else 0)
  int l_last;   // row sub-FFT length: rows of l_last points
};

inline int ilog2(long long v) {
  int l = 0;
  while ((1LL << (l + 1)) <= v) ++l;
  return l;
}

// Plan for a real size n (complex size M = n/2), M = 2048..2^28 (first x
// [mid x] last): two passes up to M = 2^16 (2^15 = 256 x 128 at the FastFIR
// main path's N = 2^16, 2^16 = 256 x 256); 2^17 = 512 x 256 on a cluster;
// 2^18 = 512 x 512, 2^19 = 512 x 1024 and 2^20 = 1024 x 1024 in two long
// passes; above that three passes, the last two of 2^(lm/3) and
// 2^((lm - lm/3)/2) points and the first of the rest (2^21 = 128^3 ..
// 2^28 = 1024 x 512 x 512). The wrappers' hopper_fft._plan mirrors it.
inline Plan make_plan(int n) {
  Plan p;
  p.n = n;
  p.log_n = ilog2(n);
  p.m = n / 2;
  p.l_mid = 0;
  const int lm = p.log_n - 1;
  if (lm <= 16) {
    p.route = kRouteTwoPass;
    p.l_last = 1 << (lm / 2);
    p.l_first = 1 << (lm - lm / 2);
  } else if (lm <= 20) {
    p.route = lm == 17 ? kRouteCluster : kRouteLong;
    p.l_first = lm == 20 ? 1024 : 512;
    p.l_last = p.m / p.l_first;
  } else {
    p.route = kRouteLong3;
    const int ll = lm / 3, lmid = (lm - ll) / 2;
    p.l_last = 1 << ll;
    p.l_mid = 1 << lmid;
    p.l_first = 1 << (lm - ll - lmid);
  }
  return p;
}

using hst_reg::log2_c;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// A twiddle from the table `tw`: the global table through the read-only
// cache, or (kSmem) a table in shared memory.
template <bool kSmem>
__device__ __forceinline__ float2 tw_at(const float2* __restrict__ tw, int i) {
  if (kSmem) return tw[i];
  return __ldg(&tw[i]);
}

// One radix-2 stage (half-span 2^LH) of an in-register R-point DFT, then the
// next stage. Template recursion keeps every register index a compile-time
// constant, so the arrays stay in registers. W_{2h}^j = tw[j * n/(2h)] for a
// table of n = 2^log_n entries (kSmem: in shared memory).
template <int R, int LH, bool kSmem = false, bool kDone = ((1 << LH) >= R)>
struct RegStage {
  static __device__ __forceinline__ void run(float2 (&v)[R],
                                             const float2* __restrict__ tw,
                                             int log_n) {
    constexpr int H = 1 << LH;
#pragma unroll
    for (int b = 0; b < R / 2; ++b) {
      const int j = b & (H - 1);
      const int a = ((b >> LH) << (LH + 1)) + j;
      const float2 u = v[a];
      const float2 t = j == 0 ? v[a + H]
                              : cmul(tw_at<kSmem>(tw, j << (log_n - 1 - LH)), v[a + H]);
      v[a] = make_float2(u.x + t.x, u.y + t.y);
      v[a + H] = make_float2(u.x - t.x, u.y - t.y);
    }
    RegStage<R, LH + 1, kSmem>::run(v, tw, log_n);
  }
};

template <int R, int LH, bool kSmem>
struct RegStage<R, LH, kSmem, true> {
  static __device__ __forceinline__ void run(float2 (&)[R], const float2* __restrict__,
                                             int) {}
};

// In-register R-point forward DFT, natural order in and out (radix-2,
// decimation in time).
template <int R, bool kSmem = false>
__device__ __forceinline__ void reg_dft(float2 (&v)[R],
                                        const float2* __restrict__ tw,
                                        int log_n) {
  hst_reg::brev_permute(v);
  RegStage<R, 0, kSmem>::run(v, tw, log_n);
}

// Split of a sub-FFT length L = A * B into the two register DFT sizes.
template <int L>
struct Sub {
  static constexpr int kLog = log2_c(L);
  static constexpr int kA = 1 << (kLog / 2);   // step-2 DFT size
  static constexpr int kB = L / kA;            // step-1 DFT size
};

// Step-1 twiddle W_L^(j1*k2) times v, stored at s[f*LD + k2*AP + j1] (AP:
// the stride of step 2's groups, A unless padded).
template <int L, bool kSmem = false, int LD = kLd, int AP = Sub<L>::kA>
__device__ __forceinline__ void step1_store(float2* s, const float2 (&v)[Sub<L>::kB],
                                            int f, int j1,
                                            const float2* __restrict__ tw,
                                            int log_n) {
  constexpr int B = Sub<L>::kB, kLog = Sub<L>::kLog;
#pragma unroll
  for (int k2 = 0; k2 < B; ++k2) {
    s[f * LD + k2 * AP + j1] =
        k2 == 0 ? v[0] : cmul(v[k2], tw_at<kSmem>(tw, (j1 * k2) << (log_n - kLog)));
  }
}

// Element `idx` (< m) of frame `frame`'s complex input, m points a frame.
//   kLoadReal:   z[idx] of a contiguous complex frame (the float2 view of a
//                real signal, or a scratch frame of an earlier pass).
//   kLoadStream: frame = hop block b of (C, T, H) blocks; the frame is
//                [x[b-1] | x[b]] read in place, with block -1 taken as zeros
//                when b is a channel's first hop (`first`): K2's forward
//                (fft_large.cuh's one-pass kernel) and K5's column pass.
//   kLoadStreamPrev: kLoadStream, with block -1 read from `a_im`, the
//                channel's carried previous block (H floats), instead (K8's
//                forward, fft_large.cuh's one-pass kernel).
//   kLoadSplit:  (a[idx], a_im[idx]), split re/im planes (also the packed
//                planes of the paired unpack, kLoadUnpack, in fft_large.cuh).
template <int kLoad>
__device__ __forceinline__ float2 load_elem(const float* __restrict__ a,
                                            const float* __restrict__ a_im,
                                            const float2* __restrict__ tw,
                                            long long frame, int idx, int m,
                                            bool first) {
  if constexpr (kLoad == kLoadReal) {
    const float2* a2 = reinterpret_cast<const float2*>(a);
    return a2[frame * m + idx];
  } else if constexpr (kLoad == kLoadStream || kLoad == kLoadStreamPrev) {
    const int half = m >> 1;
    if (idx < half && first) {
      if (kLoad == kLoadStream) return make_float2(0.f, 0.f);
      return reinterpret_cast<const float2*>(a_im)[idx];
    }
    const float2* a2 = reinterpret_cast<const float2*>(a);
    return a2[frame * half + (idx - half)];
  } else {
    static_assert(kLoad == kLoadSplit, "the packed planes are unpacked in pairs (fft_large.cuh)");
    const long long i = frame * m + idx;
    return make_float2(a[i], a_im[i]);
  }
}

// Column pass, sub-FFT length L, over frames of M = ncol * L points (ncol
// columns, each of L points ncol apart): grid = frames * (ncol / kTile)
// blocks. Output k of column col's L-point FFT goes to row k of the frame's
// scratch frame: Y[k*ncol + col] = W_M^(col * k) * FFT_L(column col)[k].
template <int kLoad, int L>
__global__ void __launch_bounds__(kThreads)
fft_cols(const float* __restrict__ a, const float* __restrict__ a_im,
         float2* __restrict__ y, const float2* __restrict__ tw, int log_n,
         int log_m, int ncol, int hops) {
  constexpr int A = Sub<L>::kA, B = Sub<L>::kB;
  __shared__ float2 s[kTile * kLd];
  const int tiles = ncol / kTile;
  const long long frame = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x - frame * tiles) * kTile;
  const bool first = kLoad == kLoadStream && frame % hops == 0;
  const int tid = threadIdx.x;
  // Step 1: thread (f, j1), f fastest so loads run along columns.
  if (tid < kTile * A) {
    const int f = tid % kTile;
    const int j1 = tid / kTile;
    float2 v[B];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2)
      v[j2] = load_elem<kLoad>(a, a_im, tw, frame, c0 + f + ncol * (j1 + A * j2),
                               ncol * L, first);
    reg_dft<B>(v, tw, log_n);
    step1_store<L>(s, v, f, j1, tw, log_n);
  }
  __syncthreads();
  // Step 2: thread (f, k2), outputs k = k2 + B*k1 straight to Y.
  if (tid < kTile * B) {
    const int f = tid % kTile;
    const int k2 = tid / kTile;
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = s[f * kLd + k2 * A + j1];
    reg_dft<A>(v, tw, log_n);
    float2* yf = y + (frame << log_m);
    const int col = c0 + f;
    const int emask = (1 << log_m) - 1;
    const int tshift = log_n - log_m;  // W_M^e = W_N^(e * N/M)
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      const int j = k2 + B * k1;
      const int e = (col * j) & emask;
      yf[(long long)j * ncol + col] = cmul(v[k1], __ldg(&tw[e << tshift]));
    }
  }
}

// Slot f (< 2H) of pack tile `tile` over R = `rows` rows: slots 0..H-1 hold
// rows H*tile + f, slots H..2H-1 their partners R - row; tile 0 holds the
// two self-paired rows 0 (slot 0) and R/2 (slot H). fft_large.cuh's packs
// and paired unpacks place their rows or columns with it.
template <int H>
__device__ __forceinline__ int pack_row_of(int tile, int f, int rows) {
  const int lo = f & (H - 1);
  if (f < H) return H * tile + lo;
  if (tile == 0 && lo == 0) return rows >> 1;
  return rows - (H * tile + lo);
}

// Row pass, sub-FFT length L = M1, over R = M/M1 rows a frame:
// grid = frames * (R / kTile) blocks. Z[j + R*k1] = FFT_M1(Y[j*M1 + n1])[k1],
// stored into the (frames, M) split planes `out` (re) and `out_im` (im).
template <int L>
__global__ void __launch_bounds__(kThreads)
fft_rows(const float2* __restrict__ y, float* __restrict__ out,
         float* __restrict__ out_im, const float2* __restrict__ tw, int log_n,
         int rows) {
  constexpr int A = Sub<L>::kA, B = Sub<L>::kB;
  __shared__ float2 s[kTile * kLd];
  const int m = 1 << (log_n - 1);
  const int tiles = rows / kTile;
  const long long frame = blockIdx.x / tiles;
  const int r0 = (int)(blockIdx.x - frame * tiles) * kTile;
  const int tid = threadIdx.x;
  // Step 1: thread (j1, f), j1 fastest so loads run along rows.
  if (tid < kTile * A) {
    const int j1 = tid % A;
    const int f = tid / A;
    const float2* yr = y + frame * m + (long long)(r0 + f) * L;
    float2 v[B];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2) v[j2] = yr[j1 + A * j2];
    reg_dft<B>(v, tw, log_n);
    step1_store<L>(s, v, f, j1, tw, log_n);
  }
  __syncthreads();
  // Step 2: thread (f, k2) stores outputs k = k2 + B*k1 of sub-FFT f.
  if (tid < kTile * B) {
    const int f = tid % kTile;
    const int k2 = tid / kTile;
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = s[f * kLd + k2 * A + j1];
    reg_dft<A>(v, tw, log_n);
    const long long base = frame * m + r0 + f;
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      const long long i = base + (long long)rows * (k2 + B * k1);
      out[i] = v[k1].x;
      out_im[i] = v[k1].y;
    }
  }
}

// Host launchers: the sub-FFT lengths are template arguments.
template <int kLoad>
inline void launch_cols(int len, long long frames, int ncol, const float* a,
                        const float* a_im, float2* y, const float2* tw, int log_n,
                        int log_m, int hops, cudaStream_t st) {
  const unsigned grid = (unsigned)(frames * (ncol / kTile));
  switch (len) {
    case 32:
      fft_cols<kLoad, 32><<<grid, kThreads, 0, st>>>(a, a_im, y, tw, log_n, log_m, ncol, hops);
      break;
    case 64:
      fft_cols<kLoad, 64><<<grid, kThreads, 0, st>>>(a, a_im, y, tw, log_n, log_m, ncol, hops);
      break;
    case 128:
      fft_cols<kLoad, 128><<<grid, kThreads, 0, st>>>(a, a_im, y, tw, log_n, log_m, ncol, hops);
      break;
    default:
      fft_cols<kLoad, 256><<<grid, kThreads, 0, st>>>(a, a_im, y, tw, log_n, log_m, ncol, hops);
  }
}

inline void launch_rows(const Plan& p, long long frames, const float2* y,
                        float* out, float* out_im, const float2* tw,
                        cudaStream_t st) {
  const int rows = p.m / p.l_last;
  const unsigned grid = (unsigned)(frames * (rows / kTile));
  switch (p.l_last) {
    case 32:
      fft_rows<32><<<grid, kThreads, 0, st>>>(y, out, out_im, tw, p.log_n, rows);
      break;
    case 64:
      fft_rows<64><<<grid, kThreads, 0, st>>>(y, out, out_im, tw, p.log_n, rows);
      break;
    case 128:
      fft_rows<128><<<grid, kThreads, 0, st>>>(y, out, out_im, tw, p.log_n, rows);
      break;
    default:
      fft_rows<256><<<grid, kThreads, 0, st>>>(y, out, out_im, tw, p.log_n, rows);
  }
}

// The whole two-pass complex transform (M <= 2^16, K12) of `frames` frames:
// split planes in (a, a_im) and out (out, out_im). `scratch` holds
// frames * M float2.
inline void run_fft(const Plan& p, long long frames, const float* a, const float* a_im,
                    float2* scratch, float* out, float* out_im, const float2* tw,
                    cudaStream_t st) {
  launch_cols<kLoadSplit>(p.l_first, frames, p.m / p.l_first, a, a_im, scratch, tw, p.log_n,
                          p.log_n - 1, 1, st);
  launch_rows(p, frames, scratch, out, out_im, tw, st);
}

// -----------------------------------------------------------------------------
// Row-first inverse: K5's FastFIR chain (fastfir_chain.cu). The two-pass
// inverse runs the forward's passes in the transpose order. With M = M1 * R
// (rows of M1 points, R = M/M1 rows, as the forward's row pass leaves them),
// bin k = j + R*k1 sits in row j, and the DFT of conj(Z') (as in K4, the
// inverse is a forward DFT of the conjugate, conjugated on the store) is
//   C[n1 + M1*n2] = sum_j W_R^(n2*j) W_M^(n1*j) sum_k1 W_M1^(n1*k1) c[j + R*k1]:
// a row pass (the M1-point DFT over k1 of each row, times W_M^(n1*j), back
// to row j) and then a column pass (the R-point DFT over j of each column
// n1). So the inverse's first pass works on the very rows the forward's last
// pass produced, and a block that owns rows (j, R-j) can run the forward row
// pass, the pack, a per-bin product, the unpack and the inverse row pass
// without the frame leaving shared memory (fastfir_chain.cu runs those row
// DFTs on reg_fft.cuh's register core).

// The row-first inverse's column pass: for each column n1 of the frames in
// `y` (R = L rows of ncol points), the L-point DFT over the rows, no
// twiddle; output n2 is sample n = n1 + ncol*n2, and the kept half n >= M/2
// goes to `out` (frames of M/2 float2 = H floats), conjugated and scaled:
// K4's tail store. grid = frames * (ncol / kTile).
template <int L>
__global__ void __launch_bounds__(kThreads)
fft_cols_tail(const float2* __restrict__ y, float* __restrict__ out,
              const float2* __restrict__ tw, int log_n, int ncol, float scale) {
  constexpr int A = Sub<L>::kA, B = Sub<L>::kB;
  __shared__ float2 s[kTile * kLd];
  const int tiles = ncol / kTile;
  const long long frame = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x - frame * tiles) * kTile;
  const int m = ncol * L;
  const float2* yf = y + frame * m;
  const int tid = threadIdx.x;
  if (tid < kTile * A) {
    const int f = tid % kTile;
    const int j1 = tid / kTile;
    float2 v[B];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2) v[j2] = yf[c0 + f + ncol * (j1 + A * j2)];
    reg_dft<B>(v, tw, log_n);
    step1_store<L>(s, v, f, j1, tw, log_n);
  }
  __syncthreads();
  if (tid < kTile * B) {
    const int f = tid % kTile;
    const int k2 = tid / kTile;
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = s[f * kLd + k2 * A + j1];
    reg_dft<A>(v, tw, log_n);
    float2* of = reinterpret_cast<float2*>(out) + frame * (m >> 1) - (m >> 1);
#pragma unroll
    for (int k1 = A / 2; k1 < A; ++k1) {
      const int n = c0 + f + ncol * (k2 + B * k1);
      of[n] = make_float2(scale * v[k1].x, -scale * v[k1].y);
    }
  }
}

}  // namespace hst
