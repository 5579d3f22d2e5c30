// Large complex FFTs on Hopper, M = 2^17..2^28 points: K12 fft_split at
// complex 2^17..2^28, K13 rfft_packed_split and K14 rifft_packed_split at
// real N = 2^18..2^28 (M = 2^17..2^27). fft_common.cuh's make_plan routes
// these sizes here; its loaders (load_elem) and the four-step of each sub-FFT
// (reg_dft, step1_store) are shared, its two-pass kernels are not.
//
// Bound on the H100: HBM bytes. A frame moves 8*M bytes in and 8*M out; the
// butterflies are ~5*M*log2(M) FP32 operations, in registers. What this file
// does about the bytes is to go to HBM as few times as the frame allows:
//
// M = 2^17 (kRouteCluster): one HBM pass. A complex 2^17 frame is 1 MB, which
// 8 blocks of one thread-block cluster hold in 128 KB of shared memory each.
// M = M1 * M2 with M1 = 256 columns of M2 = 512 points (n = n1 + 256*n2):
//   1. block r of the cluster loads 32 columns (each row of the frame gives
//      it runs of 16 or 32 points), runs their 512-point FFTs and multiplies
//      output k2 of column n1 by W_M^(n1*k2), leaving column n1 in its own
//      shared memory in natural order;
//   2. after cluster.sync(), it gathers its 64 rows of 256 points (32 from
//      each block) through distributed shared memory (map_shared_rank)
//      straight into registers and runs step 1 of their FFTs; a second
//      cluster.sync() marks the end of every block's remote reads, so its
//      shared memory is free for the rows' own exchange;
//   3. it runs step 2 and stores Z[k2 + 512*k1] of its rows.
// The frame goes to HBM once in and once out, and there is no scratch.
//
// M = 2^18..2^20 (kRouteLong): two HBM passes over one scratch frame, the
// four-step of fft_common.cuh with long sub-FFTs: columns of 512 (1024 at
// 2^20) points, rows of 512 (2^18) or 1024 (2^19, 2^20).
// M = 2^21..2^28 (kRouteLong3): three HBM passes over one scratch frame,
// M = L1 * L2 * L3 (make_plan), each pass L-point sub-FFTs (L = 128..1024):
//   1. columns: for each of R1 = M/L1 columns c, the L1-point FFT of
//      z[c + R1*n], times W_M^(c*k1), stored at Y[k1*R1 + c];
//   2. the middle pass, in place: each of the L1 rows of R1 = L2*L3 points
//      is a frame of its own, and the column pass above runs on it (L3
//      columns of L2 points, times W_R1^(c*k2)), so row k1 leaves as
//      Y[k1*R1 + k2*L3 + c];
//   3. rows: the L3 points of memory row k1*L2 + k2 are row j = k1 + L1*k2
//      of the R = L1*L2 rows of the two-pass split (fft_rows_long's row map),
//      whose L3-point FFT gives Z[j + R*k3].
// A pass reads and writes the sets of addresses its blocks own (a block's
// 16 columns x L rows, or its rows), so the middle pass can run in place.
// A block holds kTile = 16 sub-FFTs in dynamic shared memory (16-128 KB)
// and has one thread for each step-1 DFT (B points), which also takes B/A
// of the step-2 DFTs (A points). Each thread issues all B loads of its
// step-1 DFT before the first butterfly. Every load and store moves runs of
// 16 consecutive points (of 8 where the unpack or the pack pairs columns or
// rows), 64-128 bytes.
//
// Twiddles of the long routes: no table of N entries. The sub-FFTs' W_L
// (L <= 1024) and the split step's W_2L come from one 2048-entry table
// W_2048 (tf), built in float64 on the host and stored as float32; the
// inter-pass twiddle W_m^(c*k), k = k2 + B*k1, is W_m^(c*k2) * W_m^(c*B*k1),
// both factors computed for the block's 16 columns in float64 (sincospi) and
// rounded once, as is the split step's W_N^c of each slot.
// The cluster route stages its tables from the global table of N = 2^18
// entries (Twiddles, load_pack_twiddles).
//
// The split step stays in the row stage's store: with the pack (K13) a
// block's row slots hold the row pairs (j, R-j) (pack_row_of), so bin
// k = j + R*k1 meets its partner M-k = (R-j) + R*(M1-1-k1) (row 0: column
// M1-k1) in its own shared memory. The unpack of the inverse (K14) is the
// column stage's loader and mirrors it: a block's column slots hold the
// column pairs (c, ncol-c), so packed bin idx = c + ncol*j meets its partner
// M-idx = (ncol-c) + ncol*(L-1-j) (column 0: row L-j) in its own shared
// memory, and each bin is read from HBM once (unpack_pairs).
//
// K1's one pass (fft_onepass, below) serves complex M = 2^11..2^16 on one
// block or a cluster of 2..8: K1's forward (kLoadReal, kStorePack), K2's
// overlap-save forward of frames read in place with a zero first half at
// each channel's first hop (kLoadStream), K4's overlap-save inverse and K6's
// full inverse (the paired unpack kLoadUnpack, with kStoreTail and
// kStoreFull); K8's split chain (fastfir_stream.cu) runs it twice, as the
// forward of its frames read in place with the carried block as hop 0's
// first half (kLoadStreamPrev) and as K4's inverse.
#pragma once

#include <climits>

#include <cooperative_groups.h>

#include "fft_common.cuh"
#include "reg_fft.cuh"

namespace hst {

namespace cg = cooperative_groups;

// Bin k of the frame at `base` from the row stage, z = Z[k]:
//   kStoreSplit: the planes out (re) and out_im (im);
//   kStoreFull:  output samples (2k, 2k+1) of the real inverse, conj(Z[k]).
template <int kStore>
__device__ __forceinline__ void store_bin(float* __restrict__ out,
                                          float* __restrict__ out_im, long long base,
                                          int k, float2 z) {
  if (kStore == kStoreSplit) {
    out[base + k] = z.x;
    out_im[base + k] = z.y;
  } else {
    reinterpret_cast<float2*>(out)[base + k] = make_float2(z.x, -z.y);
  }
}

// The twiddles a block reads, staged in shared memory once (2*512 + M/512
// float2): read from the 2-8 MB global table they would take ~100 KB of L1
// lines (each entry a line of its own), more than the L1 beside 128 KB of
// shared memory holds, and every twiddle would wait on L2.
//   tl:  W_512^e, e < 512: every register DFT's and step-1 twiddle
//        (W_L^e = tl[e * 512/L], L <= 512), read with log_n = 9;
//   thi: W_M^(512*h), h < M/512, and tlo: W_M^e, e < 512, the two factors
//        of the inter-pass twiddle W_M^e = thi[e >> 9] * tlo[e & 511].
constexpr int kTlLog = 9;
constexpr int kTl = 1 << kTlLog;

struct Twiddles {
  float2* tl;
  float2* thi;
  float2* tlo;
};

// Carves the tables from `at` (`hi` = M/512 entries for thi) and fills them
// from the global table tw (N = 2M).
__device__ __forceinline__ Twiddles load_twiddles(float2* at, const float2* __restrict__ tw,
                                                  int log_n, int hi) {
  Twiddles t{at, at + kTl, at + kTl + hi};
  for (int i = threadIdx.x; i < kTl; i += blockDim.x) {
    t.tl[i] = __ldg(&tw[i << (log_n - kTlLog)]);
    t.tlo[i] = __ldg(&tw[i << 1]);
  }
  for (int i = threadIdx.x; i < hi; i += blockDim.x) t.thi[i] = __ldg(&tw[i << 10]);
  return t;
}

__device__ __forceinline__ float2 tw_m(const Twiddles& t, int e) {
  return cmul(t.thi[e >> 9], t.tlo[e & 511]);
}

// The split step's twiddles W_N^k, k = row + R*k1, for the 2H row slots of
// a pack tile, as W_N^row * W_N^(R*k1): `wrow` (2H entries) and `wk1` (L
// entries, W_2L^k1) in shared memory, so the pack waits on no L2 read.
template <int L, int H>
__device__ __forceinline__ void load_pack_twiddles(float2* wrow, float2* wk1,
                                                   const float2* __restrict__ tw, int tile,
                                                   int rows) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) wk1[i] = __ldg(&tw[rows * i]);
  for (int i = threadIdx.x; i < 2 * H; i += blockDim.x)
    wrow[i] = __ldg(&tw[pack_row_of<H>(tile, i, rows)]);
}

// The split step of the 2H rows of L points held in shared memory (slot f
// at s[f*LD], natural order, rows as pack_row_of<H>(tile, f, rows)), into
// one frame's packed planes re/im, by a block of NT threads:
// P[k] = (Z[k] + conj Z[M-k]) - i W_N^k (Z[k] - conj Z[M-k]), k >= 1;
// re[0] = 2(Re Z0 + Im Z0) (DC), im[0] = 2(Re Z0 - Im Z0) (Nyquist).
// W_N^k from load_pack_twiddles' tables.
template <int L, int LD, int H, int NT>
__device__ __forceinline__ void pack_rows(const float2* s, float* __restrict__ re,
                                          float* __restrict__ im, const float2* wrow,
                                          const float2* wk1, int tile, int rows) {
  static_assert(2 * H * L % NT == 0, "whole rounds");
#pragma unroll 4
  for (int it = 0; it < 2 * H * L / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int sf = i % (2 * H);
    const int k1 = i / (2 * H);
    const int row = pack_row_of<H>(tile, sf, rows);
    const int k = row + rows * k1;
    const float2 zk = s[sf * LD + k1];
    if (k == 0) {
      re[0] = 2.f * (zk.x + zk.y);
      im[0] = 2.f * (zk.x - zk.y);
    } else {
      const int g = (row == 0 || row == (rows >> 1)) ? sf : (sf ^ H);
      const int c = row == 0 ? L - k1 : L - 1 - k1;
      const float2 zm = s[g * LD + c];
      const float2 sum = make_float2(zk.x + zm.x, zk.y - zm.y);
      const float2 dif = make_float2(zk.x - zm.x, zk.y + zm.y);
      const float2 wd = cmul(cmul(wrow[sf], wk1[k1]), dif);
      re[k] = sum.x + wd.y;
      im[k] = sum.y - wd.x;
    }
  }
}

// One bin of the unpack, conj(Z'[idx]) with Z'[idx] = (P[idx] + conj
// P[M-idx]) + i W_N^-idx (P[idx] - conj P[M-idx]), from p = P[idx], q =
// P[M-idx] and w = W_N^idx (idx >= 1); unpack_dc is idx 0, p = (dc, ny).
__device__ __forceinline__ float2 unpack_bin(float2 p, float2 q, float2 w) {
  const float2 sum = make_float2(p.x + q.x, p.y - q.y);
  const float2 dif = make_float2(p.x - q.x, p.y + q.y);
  const float2 wd = cmul(make_float2(w.x, -w.y), dif);  // W_N^-idx * dif
  return make_float2(sum.x - wd.y, -(sum.y + wd.x));
}

__device__ __forceinline__ float2 unpack_dc(float2 p) {
  return make_float2(p.x + p.y, -(p.x - p.y));
}

// The paired unpack of the inverse (K14), the column stage's loader: the
// block's 2H column slots hold columns and their partners (slot f: column
// pack_row_of<H>(tile, f, ncol), partner slot f ^ H; column 0 and ncol/2
// pair with themselves). Thread (f, j1) holds in v the packed bins
// P[idx] = (re, im), idx = col + ncol*j, of rows j = j1 + A*j2 of its slot.
// They go to the slot tiles s (natural order, stride LD), and after a
// barrier each becomes conj(Z'[idx]), Z'[idx] = (P[idx] + conj P[M-idx]) +
// i W_N^-idx (P[idx] - conj P[M-idx]), with P[M-idx] read from the tile
// (row L-1-j of the partner slot; column 0: row L-j of its own), and
// DC / Nyquist (idx 0) as (dc + ny, -(dc - ny)). W_N^idx = wc[f] * wj[j]:
// W_N^col and W_N^(ncol*j) = W_2L^j. A second barrier frees the tiles for
// step 1's exchange. Each packed bin is read from HBM once, and W_N^idx is
// formed from two factors in shared memory. The one pass (fft_onepass)
// pairs its columns alike.
template <int L, int LD, int H, int A, int B>
__device__ __forceinline__ void unpack_pairs(float2 (&v)[B], float2* s, int f, int j1,
                                             int col, int ncol, const float2* wc,
                                             const float2* wj) {
#pragma unroll
  for (int j2 = 0; j2 < B; ++j2) s[f * LD + j1 + A * j2] = v[j2];
  __syncthreads();
  const float2* ps = s + ((col == 0 || 2 * col == ncol) ? f : (f ^ H)) * LD;
  const float2 w0 = wc[f];
#pragma unroll
  for (int j2 = 0; j2 < B; ++j2) {
    const int j = j1 + A * j2;
    v[j2] = col == 0 && j == 0 ? unpack_dc(v[j2])
                               : unpack_bin(v[j2], ps[col == 0 ? L - j : L - 1 - j],
                                            cmul(w0, wj[j]));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kRouteLong / kRouteLong3: passes of kTile sub-FFTs of L = 128..1024 points
// a block.

// W_n^e = exp(-2 pi i e / n), e reduced mod n (a power of two), computed in
// float64 and rounded once to float32.
__device__ __forceinline__ float2 w_exact(long long e, long long n) {
  double s, c;
  sincospi((double)(e & (n - 1)) * (2.0 / (double)n), &s, &c);
  return make_float2((float)c, (float)-s);
}

template <int L>
struct LongTile {
  static constexpr int kA = Sub<L>::kA;          // step-2 DFT size
  static constexpr int kB = Sub<L>::kB;          // step-1 DFT size, >= kA
  static constexpr int kLog = Sub<L>::kLog;
  static constexpr int kLd = L + 1;              // odd row stride: no bank conflicts
  static constexpr int kThreads = kTile * kA;    // one step-1 DFT a thread
  // Blocks an SM for the register budget: <= 128 registers a thread.
  static constexpr int kMinBlocks = L == 1024 ? 1 : L >= 256 ? 2 : 4;
  static constexpr int kTileF2 = kTile * kLd;    // float2: the tile, then the twiddles
  // The column pass: W_L (tl), the inter-pass twiddle's two factors of each
  // slot (ts: B + 1 a slot, tt: A + 1, odd strides) and, with the unpack,
  // W_2L^j (L) and W_N^col of each slot.
  static constexpr int smem_cols(int load) {
    return (kTileF2 + L + kTile * (kB + 1) + kTile * (kA + 1) +
            (load == kLoadUnpack ? L + kTile : 0)) * (int)sizeof(float2);
  }
  // The row pass: its W_L table and, with the split step, the pack's.
  static constexpr int smem_rows(int store) {
    return (kTileF2 + L + (store == kStorePack ? L + kTile : 0)) * (int)sizeof(float2);
  }
};

// Column slot f of column tile `tile`: tile*kTile + f, or with the unpack
// (kPair) the column pairs of pack_row_of.
template <bool kPair>
__device__ __forceinline__ int slot_col(int tile, int f, int ncol) {
  return kPair ? pack_row_of<kTile / 2>(tile, f, ncol) : tile * kTile + f;
}

// Column pass over frames of m = ncol * L points (pass 1; pass 2 of
// kRouteLong3 with kLoadReal, in place, over rows of the first pass's
// output): grid = frames * (ncol / kTile). Y[k*ncol + col] = W_m^(col*k) *
// FFT_L(column col)[k]. kLoadUnpack (pass 1 of K14, m = M): the planes a,
// a_im are the packed spectrum, unpacked in pairs (unpack_pairs), and slot
// f holds column slot_col<true>. tf: the W_2048 table.
template <int kLoad, int L>
__global__ void __launch_bounds__(LongTile<L>::kThreads, LongTile<L>::kMinBlocks)
fft_cols_long(const float* __restrict__ a, const float* __restrict__ a_im,
              float2* __restrict__ y, const float2* __restrict__ tf, int ncol) {
  using G = LongTile<L>;
  constexpr int A = G::kA, B = G::kB, LD = G::kLd;
  constexpr bool kPair = kLoad == kLoadUnpack;
  extern __shared__ float2 lsm[];
  const int m = ncol * L;
  const int tiles = ncol / kTile;
  const long long frame = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - frame * tiles);
  const int tid = threadIdx.x;
  float2* tl = lsm + G::kTileF2;      // W_L^e, e < L
  float2* ts = tl + L;                // W_m^(col*k2): slot f at f*(B+1)
  float2* tt = ts + kTile * (B + 1);  // W_m^(col*B*k1): slot f at f*(A+1)
  float2* wj = tt + kTile * (A + 1);  // the unpack's W_2L^j
  float2* wc = wj + L;                // and W_N^col of each slot
  {
    // Step 1: thread (f, j1), f fastest, so each load runs along the
    // block's columns; the twiddles are staged while the loads are in flight.
    const int f = tid % kTile;
    const int j1 = tid / kTile;
    const int col = slot_col<kPair>(tile, f, ncol);
    float2 v[B];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2)
      v[j2] = load_elem<kPair ? kLoadSplit : kLoad>(a, a_im, nullptr, frame,
                                                    col + ncol * (j1 + A * j2), m, false);
    for (int i = tid; i < L; i += G::kThreads) tl[i] = __ldg(&tf[i * (2048 / L)]);
    for (int i = tid; i < kTile * (A + B); i += G::kThreads) {
      const int s = i % kTile, e = i / kTile;
      const long long c = slot_col<kPair>(tile, s, ncol);
      if (e < B) {
        ts[s * (B + 1) + e] = w_exact(c * e, m);
      } else {
        tt[s * (A + 1) + e - B] = w_exact(c * B * (e - B), m);
      }
    }
    if (kPair) {
      for (int i = tid; i < L; i += G::kThreads) wj[i] = __ldg(&tf[i * (1024 / L)]);
      if (tid < kTile) wc[tid] = w_exact(slot_col<true>(tile, tid, ncol), 2LL * m);
    }
    __syncthreads();  // the twiddle tables are in place
    if (kPair) unpack_pairs<L, LD, kTile / 2, A, B>(v, lsm, f, j1, col, ncol, wc, wj);
    reg_dft<B, true>(v, tl, G::kLog);
    step1_store<L, true, LD>(lsm, v, f, j1, tl, G::kLog);
  }
  __syncthreads();
  // Step 2: tasks (f, k2), B/A a thread; outputs k = k2 + B*k1 straight to Y.
  float2* yf = y + frame * (long long)m;
#pragma unroll
  for (int u = 0; u < B / A; ++u) {
    const int t = tid + u * G::kThreads;
    const int f = t % kTile;
    const int k2 = t / kTile;
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = lsm[f * LD + k2 * A + j1];
    reg_dft<A, true>(v, tl, G::kLog);
    const int col = slot_col<kPair>(tile, f, ncol);
    const float2 w2 = ts[f * (B + 1) + k2];
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1)
      yf[(long long)(k2 + B * k1) * ncol + col] = cmul(v[k1], cmul(w2, tt[f * (A + 1) + k1]));
  }
}

// Row pass over R = `rows` rows of L points a frame: grid = frames *
// (R / kTile). Z[j + R*k1] = FFT_L(row j)[k1], stored by kStore (kStorePack:
// the split step, kStoreSplit, kStoreFull). Row j sits at memory row
// (j % L1) * (R / L1) + j / L1, L1 = 2^lg1: the identity for kRouteLong
// (lg1 = 0), the middle pass's layout for kRouteLong3 (L1 its first pass's
// length). tf: the W_2048 table.
template <int kStore, int L>
__global__ void __launch_bounds__(LongTile<L>::kThreads, LongTile<L>::kMinBlocks)
fft_rows_long(const float2* __restrict__ y, float* __restrict__ out,
              float* __restrict__ out_im, const float2* __restrict__ tf, int rows, int lg1) {
  using G = LongTile<L>;
  constexpr int A = G::kA, B = G::kB, LD = G::kLd, kPer = B / A;
  extern __shared__ float2 lsm[];
  const int m = rows * L;
  const int tiles = rows / kTile;
  const long long frame = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - frame * tiles);
  const int r0 = tile * kTile;
  const int tid = threadIdx.x;
  // W_L^e, e < L, then the pack's twiddles W_2L^k1 and W_N^row.
  float2* tl = lsm + G::kTileF2;
  float2* wk1 = tl + L;
  float2* wrow = wk1 + L;
  {
    // Step 1: thread (j1, f), j1 fastest, so each load runs along a row.
    const int j1 = tid % A;
    const int f = tid / A;
    const int row = kStore == kStorePack ? pack_row_of<kTile / 2>(tile, f, rows) : r0 + f;
    const int mem_row = ((row & ((1 << lg1) - 1)) * (rows >> lg1)) + (row >> lg1);
    const float2* yr = y + frame * (long long)m + (long long)mem_row * L;
    float2 v[B];
#pragma unroll
    for (int j2 = 0; j2 < B; ++j2) v[j2] = yr[j1 + A * j2];
    for (int i = tid; i < L; i += G::kThreads) tl[i] = __ldg(&tf[i * (2048 / L)]);
    if (kStore == kStorePack) {
      for (int i = tid; i < L; i += G::kThreads) wk1[i] = __ldg(&tf[i * (1024 / L)]);
      if (tid < kTile)
        wrow[tid] = w_exact(pack_row_of<kTile / 2>(tile, tid, rows), 2LL * m);
    }
    __syncthreads();
    reg_dft<B, true>(v, tl, G::kLog);
    step1_store<L, true, LD>(lsm, v, f, j1, tl, G::kLog);
  }
  __syncthreads();
  // Step 2: tasks (f, k2), B/A a thread; outputs k = k2 + B*k1 of slot f.
  float2 v[kPer][A];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int t = tid + u * G::kThreads;
    const int f = t % kTile;
    const int k2 = t / kTile;
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[u][j1] = lsm[f * LD + k2 * A + j1];
    reg_dft<A, true>(v[u], tl, G::kLog);
  }
  if (kStore != kStorePack) {
    const long long base = frame * (long long)m;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * G::kThreads;
      const int f = t % kTile;
      const int k2 = t / kTile;
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1)
        store_bin<kStore>(out, out_im, base, r0 + f + rows * (k2 + B * k1), v[u][k1]);
    }
    return;
  }
  __syncthreads();  // every step-2 read of lsm is done
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int t = tid + u * G::kThreads;
    const int f = t % kTile;
    const int k2 = t / kTile;
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) lsm[f * LD + k2 + B * k1] = v[u][k1];
  }
  __syncthreads();
  pack_rows<L, LD, kTile / 2, G::kThreads>(lsm, out + frame * (long long)m,
                                           out_im + frame * (long long)m, wrow, wk1, tile,
                                           rows);
}

// The block (`owner`) and row slot that hold row k of R rows spread over C
// blocks, where pack_row_of<R/(2C)> puts it: rows j and R-j in one block,
// block 0 also row R/2 (and the same for the cluster route's column pairs
// of the unpack).
template <int R, int C>
__device__ __forceinline__ void row_home(int k, int& owner, int& slot) {
  constexpr int H = R / C / 2;
  if (k == R / 2) {
    owner = 0;
    slot = H;
  } else {
    const int j = k < R / 2 ? k : R - k;
    owner = j / H;
    slot = (k < R / 2 ? 0 : H) + j % H;
  }
}

// ---------------------------------------------------------------------------
// kRouteCluster: M = 2^17 in one pass on an 8-block cluster.

struct Cl17 {
  static constexpr int kM = 1 << 17;
  static constexpr int kBlocks = 8;                 // the cluster: one frame
  static constexpr int kCols = 256;                 // M1 columns
  static constexpr int kColLen = 512;               // of M2 points
  static constexpr int kRows = kColLen;             // R = M2 rows
  static constexpr int kRowLen = kCols;             // of M1 points
  static constexpr int kOwnCols = kCols / kBlocks;  // 32 columns a block
  static constexpr int kOwnRows = kRows / kBlocks;  // 64 rows a block
  static constexpr int kThreads = 512;
  static constexpr int kLdC = kColLen + 1;          // column f at lsm[f*kLdC]
  static constexpr int kLdR = kRowLen + 1;          // row slot f at lsm[f*kLdR]
  static constexpr int kFrame =  // float2: the columns, later the rows
      kOwnCols * kLdC > kOwnRows * kLdR ? kOwnCols * kLdC : kOwnRows * kLdR;
  // then the pack's twiddle tables (load_pack_twiddles), load_twiddles'
  // and the unpack's (W_2L^j and W_N^col of each slot)
  static constexpr int kSmem = (kFrame + kRowLen + kOwnRows + 2 * kTl + kM / 512 + kColLen +
                                kOwnCols) * (int)sizeof(float2);
};

// grid = frames * 8 blocks, cluster rank r of frame blockIdx.x / 8. Loads
// with kLoad (a, a_im), stores with kStore (out, out_im). With kLoadUnpack
// (K14) block r's column slots hold the column pairs pack_row_of<16>(r, f)
// (unpack_pairs), and the row gather finds column n1 where row_home puts it.
template <int kLoad, int kStore>
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(Cl17::kThreads, 1)
fft_cluster(const float* __restrict__ a, const float* __restrict__ a_im,
            float* __restrict__ out, float* __restrict__ out_im,
            const float2* __restrict__ tw, int log_n) {
  using C = Cl17;
  constexpr int m = C::kM;
  extern __shared__ float2 lsm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long frame = blockIdx.x / C::kBlocks;
  const int tid = threadIdx.x;
  float2* wk1 = lsm + C::kFrame;  // the pack's twiddles (kStorePack)
  float2* wrow = wk1 + C::kRowLen;
  if (kStore == kStorePack)
    load_pack_twiddles<C::kRowLen, C::kOwnRows / 2>(wrow, wk1, tw, rank, C::kRows);
  const Twiddles twd = load_twiddles(wrow + C::kOwnRows, tw, log_n, m >> 9);
  constexpr bool kPair = kLoad == kLoadUnpack;
  float2* wj = twd.tlo + kTl;  // the unpack's W_2L^j = W_N^(256 j), j < 512
  float2* wc = wj + C::kColLen;  // and W_N^col of each slot

  // 1. The block's 32 columns: 512-point FFTs, times W_M^(n1*k2), column f
  //    (n1 = 32*rank + f, or with the unpack its pair slot's column) left at
  //    lsm[f*kLdC + k2].
  {
    constexpr int L = C::kColLen, A = Sub<L>::kA, B = Sub<L>::kB;
    constexpr int kPer = C::kOwnCols * B / C::kThreads;
    static_assert(C::kOwnCols * A == C::kThreads, "one step-1 DFT a thread");
    const int c0 = rank * C::kOwnCols;
    {
      const int f = tid % C::kOwnCols;
      const int j1 = tid / C::kOwnCols;
      const int col = kPair ? pack_row_of<C::kOwnCols / 2>(rank, f, C::kCols) : c0 + f;
      float2 v[B];
#pragma unroll
      for (int j2 = 0; j2 < B; ++j2)
        v[j2] = load_elem<kPair ? kLoadSplit : kLoad>(a, a_im, tw, frame,
                                                      col + C::kCols * (j1 + A * j2), m, false);
      if (kPair) {
        for (int i = tid; i < C::kColLen; i += C::kThreads) wj[i] = __ldg(&tw[C::kCols * i]);
        if (tid < C::kOwnCols) wc[tid] = __ldg(&tw[col]);
      }
      __syncthreads();  // the twiddle tables are in place
      if (kPair)
        unpack_pairs<L, C::kLdC, C::kOwnCols / 2, A, B>(v, lsm, f, j1, col, C::kCols, wc, wj);
      reg_dft<B, true>(v, twd.tl, kTlLog);
      step1_store<L, true, C::kLdC>(lsm, v, f, j1, twd.tl, kTlLog);
    }
    __syncthreads();
    float2 v[kPer][A];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * C::kThreads;
      const int f = t % C::kOwnCols;
      const int k2 = t / C::kOwnCols;
#pragma unroll
      for (int j1 = 0; j1 < A; ++j1) v[u][j1] = lsm[f * C::kLdC + k2 * A + j1];
      reg_dft<A, true>(v[u], twd.tl, kTlLog);
    }
    __syncthreads();  // every step-2 read of lsm is done
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * C::kThreads;
      const int f = t % C::kOwnCols;
      const int k2 = t / C::kOwnCols;
      const int col = kPair ? pack_row_of<C::kOwnCols / 2>(rank, f, C::kCols) : c0 + f;
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) {
        const int k = k2 + B * k1;
        lsm[f * C::kLdC + k] = cmul(v[u][k1], tw_m(twd, (col * k) & (m - 1)));
      }
    }
  }
  cl.sync();  // every block's columns are in place

  // 2-3. The block's 64 rows of 256 points: slot f holds row
  //    pack_row_of<32>(rank, f) with the split step, else 64*rank + f.
  {
    constexpr int L = C::kRowLen, A = Sub<L>::kA, B = Sub<L>::kB;
    constexpr int kPer1 = C::kOwnRows * A / C::kThreads;
    constexpr int kPer2 = C::kOwnRows * B / C::kThreads;
    float2 v[kPer1][B];
#pragma unroll
    for (int u = 0; u < kPer1; ++u) {
      // Task (f, j1), f fastest, so a warp reads 32 consecutive rows of one
      // remote column.
      const int t = tid + u * C::kThreads;
      const int f = t % C::kOwnRows;
      const int j1 = t / C::kOwnRows;
      const int row = kStore == kStorePack ? pack_row_of<C::kOwnRows / 2>(rank, f, C::kRows)
                                           : rank * C::kOwnRows + f;
#pragma unroll
      for (int j2 = 0; j2 < B; ++j2) {
        const int n1 = j1 + A * j2;
        int owner = n1 / C::kOwnCols, slot = n1 % C::kOwnCols;
        if (kPair) row_home<C::kCols, C::kBlocks>(n1, owner, slot);
        const float2* src = cl.map_shared_rank(lsm, owner);
        v[u][j2] = src[slot * C::kLdC + row];
      }
      reg_dft<B, true>(v[u], twd.tl, kTlLog);
    }
    cl.sync();  // no block reads another's shared memory after this
#pragma unroll
    for (int u = 0; u < kPer1; ++u) {
      const int t = tid + u * C::kThreads;
      const int i = tid + u * C::kThreads;
      step1_store<L, true, C::kLdR>(lsm, v[u], i % C::kOwnRows, i / C::kOwnRows, twd.tl, kTlLog);
    }
    __syncthreads();
    float2 w[kPer2][A];
#pragma unroll
    for (int u = 0; u < kPer2; ++u) {
      const int t = tid + u * C::kThreads;
      const int f = t % C::kOwnRows;
      const int k2 = t / C::kOwnRows;
#pragma unroll
      for (int j1 = 0; j1 < A; ++j1) w[u][j1] = lsm[f * C::kLdR + k2 * A + j1];
      reg_dft<A, true>(w[u], twd.tl, kTlLog);
    }
    if (kStore != kStorePack) {
      const long long base = frame * (long long)m;
#pragma unroll
      for (int u = 0; u < kPer2; ++u) {
        const int t = tid + u * C::kThreads;
        const int f = t % C::kOwnRows;
        const int k2 = t / C::kOwnRows;
#pragma unroll
        for (int k1 = 0; k1 < A; ++k1)
          store_bin<kStore>(out, out_im, base,
                            rank * C::kOwnRows + f + C::kRows * (k2 + B * k1), w[u][k1]);
      }
      return;
    }
    __syncthreads();  // every step-2 read of lsm is done
#pragma unroll
    for (int u = 0; u < kPer2; ++u) {
      const int t = tid + u * C::kThreads;
      const int f = t % C::kOwnRows;
      const int k2 = t / C::kOwnRows;
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) lsm[f * C::kLdR + k2 + B * k1] = w[u][k1];
    }
    __syncthreads();
    pack_rows<L, C::kLdR, C::kOwnRows / 2, C::kThreads>(
        lsm, out + frame * (long long)m, out_im + frame * (long long)m, wrow, wk1, rank,
        C::kRows);
  }
}

// ---------------------------------------------------------------------------
// K1's one pass (rfft_packed.cu, real N = 4096..2^17): the cluster route
// above generalised over the frame's size and the blocks that hold it. The
// complex frame of M = M1 * M2 points (M = 2^11..2^16) sits in the shared
// memory of C blocks, one block (C = 1) or one thread-block cluster of
// C = 2..8 blocks, and leaves as the packed real spectrum. M1 columns of M2
// points (n = n1 + M1*n2):
//   1. block r of the frame loads columns r*M1/C.. (each row of the frame
//      gives it a run of M1/C points) and runs step 1 of their M2-point
//      FFTs through its own shared memory;
//   2. it runs step 2 into registers and multiplies output k2 of column n1
//      by W_M^(n1*k2); after a barrier over the frame's blocks (a cluster
//      barrier, or __syncthreads() in one block) marks that every block
//      has read its columns, it stores each output into the tile of
//      its row in the block that owns the row (row_home): M2/C rows a block,
//      written by all C blocks, through distributed shared memory on a
//      cluster. Stores, unlike loads, do not wait for the remote block;
//   3. after a second barrier it runs its rows' M1-point FFTs in its own
//      shared memory and stores, with the split step, the packed bins of its
//      row pairs (j, R-j).
// The real inverse (K4, K6, K8's inverse) runs the same passes on conj(Z'),
// unpacked from the packed planes in step 1 with the columns in pairs (see
// fft_onepass), and stores conj(Z) as the samples in step 3.
// The frame goes to HBM once in and once out, and there is no scratch.
// Beside the cluster route it reads its twiddle tables into registers
// together with its first loads (StagedTable), runs its sub-DFTs on
// compile-time twiddles (dft_c), keeps its rows in place (InPlace) and
// exchanges by remote stores rather than loads. On an H100 these made the
// kernel at the cluster route's own shape (one 128 KB block an SM, split
// planes in and out) 8-14% slower than fft_cluster
// (tools/chip_phases.py --k1), so complex 2^17 keeps fft_cluster.

// pack_rows for the one-pass kernel's rows, kept as InPlace<L> keeps them:
// bin q of slot f at s[f*LD + (q % B)*AP + q / B]. Each thread keeps one
// slot (its row, partner slot and row twiddle) and walks that row's bins,
// where pack_rows looks the slot up again for every bin: on an H100 K1 ran
// faster this way (tools/k1_layouts.py; PERF.md).
template <int L, int LD, int H, int NT, int B, int AP>
__device__ __forceinline__ void pack_rows_tile(const float2* s, float* __restrict__ re,
                                               float* __restrict__ im, const float2* wrow,
                                               const float2* wk1, int tile, int rows) {
  static_assert(NT % (2 * H) == 0 && 2 * H * L % NT == 0, "one slot a thread, whole rounds");
  const int sf = threadIdx.x % (2 * H);
  const int row = pack_row_of<H>(tile, sf, rows);
  // Z[M-k] sits in the partner slot (rows 0 and R/2: the slot itself), at
  // bin L-1-k1 (row 0: L-k1).
  const float2* zs = s + sf * LD;
  const float2* zp = s + ((row == 0 || row == (rows >> 1)) ? sf : (sf ^ H)) * LD;
  const int c0 = row == 0 ? L : L - 1;
  const float2 wr = wrow[sf];
  constexpr int kStep = NT / (2 * H);  // bins k1 a round of the block covers
  const int k0 = threadIdx.x / (2 * H);
#pragma unroll
  for (int it = 0; it < L / kStep; ++it) {
    const int k1 = k0 + it * kStep;
    const int k = row + rows * k1;
    const float2 zk = zs[(k1 % B) * AP + k1 / B];
    if (k == 0) {
      re[0] = 2.f * (zk.x + zk.y);
      im[0] = 2.f * (zk.x - zk.y);
    } else {
      const int c = c0 - k1;
      const float2 zm = zp[(c % B) * AP + c / B];
      const float2 sum = make_float2(zk.x + zm.x, zk.y - zm.y);
      const float2 dif = make_float2(zk.x - zm.x, zk.y + zm.y);
      const float2 wd = cmul(cmul(wr, wk1[k1]), dif);
      re[k] = sum.x + wd.y;
      im[k] = sum.y - wd.x;
    }
  }
}

// The real inverse's store for the one-pass kernel's rows: bin k = row +
// R*k1 of the frame's forward DFT Z of conj(Z') is the sample pair (2k,
// 2k+1) of the unscaled inverse, conj(Z[k]), stored times `scale` at float2
// k of the frame's M float2 (`of`, kStoreFull: K6's store) or, kStoreTail
// (K4's overlap-save tail), only the kept half k >= M/2 (k1 >= L/2), at
// float2 k - M/2 of the frame's M/2. Each thread keeps one slot, as
// pack_rows_tile does, so a warp stores runs of consecutive bins.
template <int kStore, int L, int LD, int H, int NT, int B, int AP>
__device__ __forceinline__ void inverse_rows_tile(const float2* s, float2* __restrict__ of,
                                                  int tile, int rows, float scale) {
  constexpr int kK1 = kStore == kStoreTail ? L / 2 : 0;  // the first bin k1 stored
  constexpr int kStep = NT / (2 * H);
  static_assert(NT % (2 * H) == 0 && (L - kK1) % kStep == 0, "one slot a thread, whole rounds");
  const int sf = threadIdx.x % (2 * H);
  const int row = pack_row_of<H>(tile, sf, rows);
  const float2* zs = s + sf * LD;
  const int k0 = threadIdx.x / (2 * H);
  const int skip = rows * kK1;
#pragma unroll
  for (int it = 0; it < (L - kK1) / kStep; ++it) {
    const int k1 = kK1 + k0 + it * kStep;
    const float2 z = zs[(k1 % B) * AP + k1 / B];
    of[row + rows * k1 - skip] = make_float2(scale * z.x, -scale * z.y);
  }
}

// a * W_32^k, k < 16 a compile-time constant once the callers' loops
// unroll: W_16 constants for even k, the float64 cos / sin of the odd
// multiples of pi/16 rounded to float32 for odd k.
__device__ __forceinline__ float2 mul_w32(float2 a, int k) {
  constexpr float s1 = 0.98078528040323043f, s3 = 0.83146961230254524f,
                  s5 = 0.55557023301960218f, s7 = 0.19509032201612826f;
  switch (k) {
    case 1: return cmul(a, make_float2(s1, -s7));
    case 3: return cmul(a, make_float2(s3, -s5));
    case 5: return cmul(a, make_float2(s5, -s3));
    case 7: return cmul(a, make_float2(s7, -s1));
    case 9: return cmul(a, make_float2(-s7, -s1));
    case 11: return cmul(a, make_float2(-s5, -s3));
    case 13: return cmul(a, make_float2(-s3, -s5));
    case 15: return cmul(a, make_float2(-s1, -s7));
    default: return hst_reg::mul_w16(a, k / 2);
  }
}

// In-register R-point DFT (R = 2..32), natural order in and out, with
// compile-time twiddles: reg_fft.cuh's radix-2 core on W_16 constants up to
// 16 points; at 32 two 16-point DFTs (even and odd points) joined by W_32^k.
template <int R>
__device__ __forceinline__ void dft_c(float2 (&v)[R]) {
  if constexpr (R <= 16) {
    hst_reg::dft<R>(v);
  } else {
    static_assert(R == 32, "sub-DFTs of at most 32 points");
    float2 e[16], o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      e[i] = v[2 * i];
      o[i] = v[2 * i + 1];
    }
    hst_reg::dft<16>(e);
    hst_reg::dft<16>(o);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float2 t = mul_w32(o[k], k);
      v[k] = make_float2(e[k].x + t.x, e[k].y + t.y);
      v[k + 16] = make_float2(e[k].x - t.x, e[k].y - t.y);
    }
  }
}

// A sub-FFT of L = A*B points kept in place in its tile of shared memory
// (the one-pass kernel's rows): step 1 leaves its (k2, j1) output at
// k2*(A+1) + j1, and step 2 reads the A points of group k2 and writes its
// outputs k = k2 + B*k1 back at k2*(A+1) + k1. So no barrier falls between
// step 2's reads and writes and no thread holds more than one DFT; bin k
// sits at (k % B)*(A+1) + k / B. The odd strides (A+1 and the tile's kLd)
// keep a warp's accesses in distinct banks. The columns stay in natural
// order (stride M2 + 1): in this layout the exchange's remote accesses
// would scatter, and distributed shared memory wants a warp's accesses
// contiguous.
template <int L>
struct InPlace {
  static constexpr int kA = Sub<L>::kA, kB = Sub<L>::kB;
  static constexpr int kAp = kA + 1;        // group stride
  static constexpr int kLd = kB * kAp + 1;  // tile stride
};

template <int LM, int LCols, int C, int NT, int MinBlocks>
struct OnePass {
  static constexpr int kM = 1 << LM;
  static constexpr int kBlocks = C;                 // one frame
  static constexpr int kCols = 1 << LCols;          // M1 columns
  static constexpr int kColLen = kM / kCols;        // of M2 points
  static constexpr int kRows = kColLen;             // R = M2 rows
  static constexpr int kRowLen = kCols;             // of M1 points
  static constexpr int kOwnCols = kCols / C;        // columns a block
  static constexpr int kOwnRows = kRows / C;        // rows a block
  static constexpr int kThreads = NT;
  static constexpr int kMinBlocks = MinBlocks;      // blocks an SM, for the registers
  static constexpr int kLdC = kColLen + 1;            // column f at lsm[f*kLdC]
  static constexpr int kLdR = InPlace<kRowLen>::kLd;  // row slot f at lsm[f*kLdR]
  static constexpr int kFrame =  // float2: the columns, later the rows
      kOwnCols * kLdC > kOwnRows * kLdR ? kOwnCols * kLdC : kOwnRows * kLdR;
  // then the pack's twiddle tables (load_pack_twiddles) and load_twiddles'
  static constexpr int kSmem =
      (kFrame + kRowLen + kOwnRows + 2 * kTl + kM / 512) * (int)sizeof(float2);
};

// A table of E entries that a block of NT threads stages in shared memory
// in two steps: fetch() reads the thread's entries of the global table
// (entry i at tw[index(i)]) into registers, put() stores them, so the reads
// are in flight together with the frame's first loads.
template <int E, int NT>
struct StagedTable {
  static constexpr int kPer = (E + NT - 1) / NT;
  float2 r[kPer];

  template <class Index>
  __device__ __forceinline__ void fetch(const float2* __restrict__ tw, Index index) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = (int)threadIdx.x + u * NT;
      if (i < E) r[u] = __ldg(&tw[index(i)]);
    }
  }

  __device__ __forceinline__ void put(float2* dst) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = (int)threadIdx.x + u * NT;
      if (i < E) dst[i] = r[u];
    }
  }
};

// The two halves of a barrier over the blocks of one frame: a block
// arrives once its part is done and waits before it needs the others', so
// work between the two hides the barrier's latency. One block: the block
// barrier, at the wait. (Arrive releases and wait acquires this block's
// shared-memory accesses, the cluster barrier's default semantics.)
template <int C>
__device__ __forceinline__ void frame_arrive() {
  if constexpr (C > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ void frame_wait() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// The shared memory `lsm` of the frame's block r.
template <int C>
__device__ __forceinline__ float2* frame_smem(float2* lsm, int r) {
  if constexpr (C == 1) {
    return lsm;
  } else {
    return cg::this_cluster().map_shared_rank(lsm, r);
  }
}

// grid = frames * C blocks, block r of frame blockIdx.x / C (its rank in the
// cluster). Loads with kLoad (a, a_im): kLoadReal; kLoadStream with
// frame = hop t of (C, hops, M/2 float2) blocks, the first half zero at a
// channel's hop 0 (a_im unused); kLoadStreamPrev, the same with a_im the
// (C, M/2 float2) carried blocks as hop 0's first half; or kLoadUnpack, the packed planes a (re) and a_im
// (im) of the real inverse, unpacked in pairs (below). Stores with kStore:
// kStorePack, the packed planes out (re) and out_im (im); kStoreTail, the
// kept half of the real inverse, times `scale`, into the (frames, M) floats
// `out`; kStoreFull, the whole real inverse, times `scale`, into the
// (frames, 2M) floats `out`.
//
// The paired unpack (kLoadUnpack) mirrors unpack_pairs: the block's column
// slots hold columns and their partners, so packed bin idx = n1 + M1*j and
// its partner M - idx = (M1 - n1) + M1*(M2-1-j) (column 0: row M2 - j of
// its own) meet in the block's column tiles. One block (C = 1) holds every
// column, slot f column f, its partner in slot (M1 - f) mod M1; on a
// cluster slot f holds column pack_row_of<kOwnCols/2>(r, f), its partner in
// slot f ^ kOwnCols/2 (columns 0 and M1/2: their own), and the exchange
// stores column n1's outputs at element n1 of their rows, wherever the
// pairing put it. Each bin is read from HBM once: the loads go to the tiles
// with the twiddle tables, one barrier, each thread unpacks its bins from
// the tiles, a second barrier frees them for step 1's store. W_N^idx =
// W_N^n1 * W_2M2^j: the first read from the global table with the loads, one
// a column, the second W_512^(j*256/M2) from the staged tl (M2 <= 256).
template <class G, int kLoad, int kStore>
__global__ void __launch_bounds__(G::kThreads, G::kMinBlocks)
fft_onepass(const float* __restrict__ a, const float* __restrict__ a_im,
            float* __restrict__ out, float* __restrict__ out_im,
            const float2* __restrict__ tw, int log_n, int hops, float scale) {
  constexpr int m = G::kM, NT = G::kThreads, C = G::kBlocks;
  constexpr bool kPair = kLoad == kLoadUnpack;
  static_assert(kPair == (kStore != kStorePack), "the unpack goes with the inverse's stores");
  static_assert(!kPair || G::kColLen <= kTl / 2, "W_2M2 is read from the staged W_512");
  using RT = InPlace<G::kRowLen>;
  extern __shared__ float2 lsm[];
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const long long frame = blockIdx.x / C;
  const int tid = threadIdx.x;
  // Hop 0 of a channel takes its first half as zeros (kLoadStream) or from
  // the channel's carried block (kLoadStreamPrev).
  const bool first = (kLoad == kLoadStream || kLoad == kLoadStreamPrev) && frame % hops == 0;
  const float* lo = kLoad == kLoadStreamPrev ? a_im + (frame / hops) * (long long)m : a_im;
  // The twiddle tables after the frame: the pack's, then load_twiddles'
  // layout (tl, thi, tlo).
  constexpr int kHi = m / 512;
  float2* wk1 = lsm + G::kFrame;
  float2* wrow = wk1 + G::kRowLen;
  const Twiddles twd{wrow + G::kOwnRows, wrow + G::kOwnRows + kTl,
                     wrow + G::kOwnRows + kTl + kHi};
  StagedTable<kTl, NT> tl, tlo;
  StagedTable<kHi, NT> thi;
  StagedTable<G::kRowLen, NT> wk1s;
  StagedTable<G::kOwnRows, NT> wrows;
  tl.fetch(tw, [&](int i) { return i << (log_n - kTlLog); });
  tlo.fetch(tw, [](int i) { return i << 1; });
  thi.fetch(tw, [](int i) { return i << 10; });
  if constexpr (kStore == kStorePack) {
    wk1s.fetch(tw, [](int i) { return G::kRows * i; });
    wrows.fetch(tw, [&](int i) { return pack_row_of<G::kOwnRows / 2>(rank, i, G::kRows); });
  }

  // 1. The block's columns: M2-point FFTs, times W_M^(n1*k2), column slot f
  //    (n1 = col_of(f)) left at lsm[f*kLdC + k2].
  constexpr int CL = G::kColLen, CA = Sub<CL>::kA, CB = Sub<CL>::kB;
  constexpr int kPer0 = G::kOwnCols * CA / NT;  // step-1 DFTs a thread
  constexpr int kPer = G::kOwnCols * CB / NT;   // step-2 DFTs a thread
  static_assert(kPer0 >= 1 && kPer0 * NT == G::kOwnCols * CA && kPer * NT == G::kOwnCols * CB,
                "whole rounds of the column steps");
  constexpr int kHalf = G::kOwnCols / 2;
  const auto col_of = [rank](int f) {
    return kPair && C > 1 ? pack_row_of<kHalf>(rank, f, G::kCols) : rank * G::kOwnCols + f;
  };
  {
    // Task (f, j1), f fastest, so a warp's loads run along consecutive
    // columns, issued while the twiddle reads are in flight.
    float2 v[kPer0][CB];
    float2 wcol[kPer0];  // kLoadUnpack: W_N^n1 of the task's column
#pragma unroll
    for (int u = 0; u < kPer0; ++u) {
      const int t = tid + u * NT;
      const int col = col_of(t % G::kOwnCols);
      const int j1 = t / G::kOwnCols;
#pragma unroll
      for (int j2 = 0; j2 < CB; ++j2)
        v[u][j2] = load_elem<kPair ? kLoadSplit : kLoad>(a, lo, tw, frame,
                                                         col + G::kCols * (j1 + CA * j2), m,
                                                         first);
      if constexpr (kPair) wcol[u] = __ldg(&tw[col]);
    }
    tl.put(twd.tl);
    tlo.put(twd.tlo);
    thi.put(twd.thi);
    if constexpr (kStore == kStorePack) {
      wk1s.put(wk1);
      wrows.put(wrow);
    }
    if constexpr (kPair) {
#pragma unroll
      for (int u = 0; u < kPer0; ++u) {
        const int t = tid + u * NT;
#pragma unroll
        for (int j2 = 0; j2 < CB; ++j2)
          lsm[(t % G::kOwnCols) * G::kLdC + t / G::kOwnCols + CA * j2] = v[u][j2];
      }
    }
    __syncthreads();  // the twiddle tables (and the packed bins) are in place
    if constexpr (kPair) {
#pragma unroll
      for (int u = 0; u < kPer0; ++u) {
        const int t = tid + u * NT;
        const int f = t % G::kOwnCols;
        const int j1 = t / G::kOwnCols;
        const int col = col_of(f);
        const int g = C == 1 ? (G::kCols - f) & (G::kCols - 1)
                             : (col == 0 || 2 * col == G::kCols) ? f : f ^ kHalf;
        const float2* ps = lsm + g * G::kLdC;
#pragma unroll
        for (int j2 = 0; j2 < CB; ++j2) {
          const int j = j1 + CA * j2;
          v[u][j2] = col == 0 && j == 0
                         ? unpack_dc(v[u][j2])
                         : unpack_bin(v[u][j2], ps[col == 0 ? CL - j : CL - 1 - j],
                                      cmul(wcol[u], twd.tl[j * (kTl / 2 / CL)]));
        }
      }
      __syncthreads();  // every partner read is done: the tiles take step 1's outputs
    }
#pragma unroll
    for (int u = 0; u < kPer0; ++u) {
      const int t = tid + u * NT;
      dft_c<CB>(v[u]);
      step1_store<CL, true, G::kLdC>(lsm, v[u], t % G::kOwnCols, t / G::kOwnCols, twd.tl,
                                     kTlLog);
    }
  }
  __syncthreads();
  // 2. Step 2 of the columns, times W_M^(n1*k), then the exchange: once
  //    every block of the frame has read its columns, output k of column n1
  //    goes straight to the block that owns row k (row_home; a remote store
  //    through distributed shared memory on a cluster), into element n1 of
  //    that row's tile. A warp's stores run along consecutive columns (two
  //    runs, one descending, where the unpack pairs them). The step-2 DFTs
  //    run between the barrier's arrive and its wait.
  constexpr int L = G::kRowLen, A = RT::kA, B = RT::kB;
  {
    float2 v[kPer][CA];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * NT;
      const int f = t % G::kOwnCols;
      const int k2 = t / G::kOwnCols;
#pragma unroll
      for (int j1 = 0; j1 < CA; ++j1) v[u][j1] = lsm[f * G::kLdC + k2 * CA + j1];
    }
    frame_arrive<C>();  // this block has read its columns
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * NT;
      const int col = col_of(t % G::kOwnCols);
      const int k2 = t / G::kOwnCols;
      dft_c<CA>(v[u]);
#pragma unroll
      for (int k1 = 0; k1 < CA; ++k1)
        v[u][k1] = cmul(v[u][k1], tw_m(twd, (col * (k2 + CB * k1)) & (m - 1)));
    }
    frame_wait<C>();  // every block has read its columns: its memory takes rows now
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * NT;
      const int col = col_of(t % G::kOwnCols);
      const int k2 = t / G::kOwnCols;
#pragma unroll
      for (int k1 = 0; k1 < CA; ++k1) {
        int owner, slot;
        row_home<G::kRows, C>(k2 + CB * k1, owner, slot);
        frame_smem<C>(lsm, owner)[slot * G::kLdR + col] = v[u][k1];
      }
    }
  }
  frame_arrive<C>();
  frame_wait<C>();  // every row is in place

  // 3. The block's rows of M1 points: slot f holds row
  //    pack_row_of<kOwnRows/2>(rank, f); its tile at lsm[f*kLdR], in natural
  //    order, then as InPlace<M1> keeps it.
  constexpr int kPer1 = G::kOwnRows * A / NT;
  constexpr int kPer2 = G::kOwnRows * B / NT;
  static_assert(kPer1 >= 1 && kPer1 * NT == G::kOwnRows * A && kPer2 * NT == G::kOwnRows * B,
                "whole rounds of the row steps");
  {
    float2 v[kPer1][B];
#pragma unroll
    for (int u = 0; u < kPer1; ++u) {
      // Task (f, j1), f fastest.
      const int t = tid + u * NT;
      const int f = t % G::kOwnRows;
      const int j1 = t / G::kOwnRows;
#pragma unroll
      for (int j2 = 0; j2 < B; ++j2) v[u][j2] = lsm[f * G::kLdR + j1 + A * j2];
      dft_c<B>(v[u]);
    }
    __syncthreads();  // every step-1 read of the row tiles is done
#pragma unroll
    for (int u = 0; u < kPer1; ++u) {
      const int t = tid + u * NT;
      step1_store<L, true, G::kLdR, RT::kAp>(lsm, v[u], t % G::kOwnRows, t / G::kOwnRows,
                                             twd.tl, kTlLog);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer2; ++u) {
    // Task (f, k2): group k2 of row slot f, in place.
    const int t = tid + u * NT;
    float2* g = lsm + (t % G::kOwnRows) * G::kLdR + (t / G::kOwnRows) * RT::kAp;
    float2 w[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) w[j1] = g[j1];
    dft_c<A>(w);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) g[k1] = w[k1];
  }
  __syncthreads();
  if constexpr (kStore == kStorePack) {
    pack_rows_tile<L, G::kLdR, G::kOwnRows / 2, NT, B, RT::kAp>(
        lsm, out + frame * (long long)m, out_im + frame * (long long)m, wrow, wk1, rank,
        G::kRows);
  } else {
    constexpr int kOut = kStore == kStoreTail ? m / 2 : m;  // float2 a frame
    inverse_rows_tile<kStore, L, G::kLdR, G::kOwnRows / 2, NT, B, RT::kAp>(
        lsm, reinterpret_cast<float2*>(out) + frame * (long long)kOut, rank, G::kRows, scale);
  }
}

// K1's one-pass plan of complex M = 2^LM, M = 2^11..2^16 (also K2's
// forward and K8's two transforms at 2^13..2^16; hopper_fft._onepass_plan mirrors it): M1
// columns of M2 points on C blocks, two blocks an SM (<= 128 registers a
// thread at 256 threads, <= 64 at 512). A block holds 2048..8192 points;
// its columns give it runs of 32..128 points of every row. The threads
// follow tools/k1_layouts.py's measurements on an H100: 256 at the FastFIR
// main path's M = 2^15, 512 at 2^13, 2^14 and 2^16.
template <int LM>
struct K1Plan;
template <>
struct K1Plan<11> {
  using T = OnePass<11, 6, 1, 256, 2>;  // 64 x 32, one block (16 KB)
};
template <>
struct K1Plan<12> {
  using T = OnePass<12, 6, 1, 256, 2>;  // 64 x 64, one block (32 KB)
};
template <>
struct K1Plan<13> {
  using T = OnePass<13, 7, 1, 512, 2>;  // 128 x 64, one block (64 KB)
};
template <>
struct K1Plan<14> {
  using T = OnePass<14, 7, 2, 512, 2>;  // 128 x 128 on a 2-block cluster
};
template <>
struct K1Plan<15> {
  using T = OnePass<15, 7, 4, 256, 2>;  // 128 x 256 on 4 blocks
};
template <>
struct K1Plan<16> {
  using T = OnePass<16, 8, 8, 512, 2>;  // 256 x 256 on 8 blocks
};
template <int LM>
using K1Pass = typename K1Plan<LM>::T;

// ---------------------------------------------------------------------------
// Host launchers. Each sets its kernel's dynamic shared memory (above the
// 48 KB default) once a device and returns the first CUDA error; a size or
// a cluster that cannot run is an error, never a reason to take another
// route.

// Runs `prepare` (returning a CUDA error) once a device: `ready` holds the
// device it last succeeded on, one for each kernel instantiation.
template <class Prepare>
inline int once_per_device(int& ready, Prepare prepare) {
  int device = 0;
  int rc = (int)cudaGetDevice(&device);
  if (rc != 0 || device == ready) return rc;
  rc = prepare();
  if (rc == 0) ready = device;
  return rc;
}

template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A grid of `blocks` blocks, or an error where it passes the 2^31 - 1 a
// launch takes.
inline int grid_of(long long blocks, unsigned& grid) {
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  grid = (unsigned)blocks;
  return 0;
}

// The cluster kernel also checks that one cluster of 8 blocks with its
// shared memory fits the card (cudaOccupancyMaxActiveClusters >= 1).
template <int kLoad, int kStore>
inline int launch_cluster(long long frames, const float* a, const float* a_im, float* out,
                          float* out_im, const float2* tw, int log_n, cudaStream_t st) {
  auto kernel = fft_cluster<kLoad, kStore>;
  unsigned blocks = 0;
  int rc = grid_of(frames * Cl17::kBlocks, blocks);
  if (rc != 0) return rc;
  const dim3 grid(blocks);
  static int ready = -1;
  rc = once_per_device(ready, [&]() {
    int err = allow_smem(kernel, Cl17::kSmem);
    if (err != 0) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Cl17::kThreads);
    cfg.dynamicSmemBytes = Cl17::kSmem;
    cfg.stream = st;
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                              &cfg);
    if (err != 0) return err;
    return clusters < 1 ? (int)cudaErrorInvalidConfiguration : 0;
  });
  if (rc != 0) return rc;
  kernel<<<grid, Cl17::kThreads, Cl17::kSmem, st>>>(a, a_im, out, out_im, tw, log_n);
  return (int)cudaGetLastError();
}

// The launch of `frames` frames on G's route: grid = frames * C blocks, in
// clusters of C (`attr` holds the cluster's size; none for C = 1).
template <class G>
inline cudaLaunchConfig_t onepass_config(long long frames, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(frames * G::kBlocks));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::kBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G::kBlocks > 1 ? 1 : 0;
  return cfg;
}

// Sets G's dynamic shared memory for `kernel`, then gives in `resident` the
// frames the device holds at once: clusters of C blocks
// (cudaOccupancyMaxActiveClusters), or for C = 1 blocks an SM times the SMs.
template <class G, class Kernel>
inline int onepass_resident(Kernel kernel, int& resident) {
  int rc = allow_smem(kernel, G::kSmem);
  if (rc != 0) return rc;
  if (G::kBlocks == 1) {
    int per_sm = 0, device = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::kThreads,
                                                             G::kSmem);
    if (rc == 0) rc = (int)cudaGetDevice(&device);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    resident = per_sm * sms;
    return rc;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = onepass_config<G>(1, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(&resident, reinterpret_cast<const void*>(kernel),
                                             &cfg);
}

// One launch of G's route over `frames` frames (`hops`, `scale`: see
// fft_onepass). Once a device it also checks that one frame's blocks, with
// their shared memory, fit the card; a grid beyond 2^31 - 1 blocks is an
// error.
template <class G, int kLoad, int kStore = kStorePack>
inline int launch_onepass(long long frames, const float* a, const float* a_im, float* out,
                          float* out_im, const float2* tw, int log_n, cudaStream_t st,
                          int hops = 1, float scale = 1.f) {
  auto kernel = fft_onepass<G, kLoad, kStore>;
  static int ready = -1;
  const int rc = once_per_device(ready, [&]() {
    int resident = 0;
    const int err = onepass_resident<G>(kernel, resident);
    if (err != 0) return err;
    return resident < 1 ? (int)cudaErrorInvalidConfiguration : 0;
  });
  if (rc != 0) return rc;
  unsigned blocks = 0;
  const int grid = grid_of(frames * G::kBlocks, blocks);
  if (grid != 0) return grid;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = onepass_config<G>(frames, st, &attr);
  const int err =
      (int)cudaLaunchKernelEx(&cfg, kernel, a, a_im, out, out_im, tw, log_n, hops, scale);
  return err != 0 ? err : (int)cudaGetLastError();
}

template <int kLoad, int L>
inline int launch_cols_long(long long frames, int ncol, const float* a, const float* a_im,
                            float2* y, const float2* tf, cudaStream_t st) {
  using G = LongTile<L>;
  constexpr int smem = G::smem_cols(kLoad);
  unsigned grid = 0;
  int rc = grid_of(frames * (ncol / kTile), grid);
  if (rc != 0) return rc;
  static int ready = -1;
  rc = once_per_device(ready, [] { return allow_smem(fft_cols_long<kLoad, L>, smem); });
  if (rc != 0) return rc;
  fft_cols_long<kLoad, L><<<grid, G::kThreads, smem, st>>>(a, a_im, y, tf, ncol);
  return (int)cudaGetLastError();
}

template <int kStore, int L>
inline int launch_rows_long(long long frames, int rows, const float2* y, float* out,
                            float* out_im, const float2* tf, int lg1, cudaStream_t st) {
  using G = LongTile<L>;
  constexpr int smem = G::smem_rows(kStore);
  unsigned grid = 0;
  int rc = grid_of(frames * (rows / kTile), grid);
  if (rc != 0) return rc;
  static int ready = -1;
  rc = once_per_device(ready, [] { return allow_smem(fft_rows_long<kStore, L>, smem); });
  if (rc != 0) return rc;
  fft_rows_long<kStore, L><<<grid, G::kThreads, smem, st>>>(y, out, out_im, tf, rows, lg1);
  return (int)cudaGetLastError();
}

// The column pass at sub-FFT length `len` (128..1024).
template <int kLoad>
inline int cols_long(int len, long long frames, int ncol, const float* a, const float* a_im,
                     float2* y, const float2* tf, cudaStream_t st) {
  switch (len) {
    case 128: return launch_cols_long<kLoad, 128>(frames, ncol, a, a_im, y, tf, st);
    case 256: return launch_cols_long<kLoad, 256>(frames, ncol, a, a_im, y, tf, st);
    case 512: return launch_cols_long<kLoad, 512>(frames, ncol, a, a_im, y, tf, st);
    case 1024: return launch_cols_long<kLoad, 1024>(frames, ncol, a, a_im, y, tf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The row pass at sub-FFT length `len` (128..1024).
template <int kStore>
inline int rows_long(int len, long long frames, int rows, const float2* y, float* out,
                     float* out_im, const float2* tf, int lg1, cudaStream_t st) {
  switch (len) {
    case 128: return launch_rows_long<kStore, 128>(frames, rows, y, out, out_im, tf, lg1, st);
    case 256: return launch_rows_long<kStore, 256>(frames, rows, y, out, out_im, tf, lg1, st);
    case 512: return launch_rows_long<kStore, 512>(frames, rows, y, out, out_im, tf, lg1, st);
    case 1024: return launch_rows_long<kStore, 1024>(frames, rows, y, out, out_im, tf, lg1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole transform of `frames` frames at M = 2^17..2^28 (plan p): loads
// with kLoad (a, a_im), stores with kStore (out, out_im). `tw` is the
// twiddle table of p's route: the global table of N = 2M entries for
// kRouteCluster, the W_2048 table for the long routes (see the head of this file).
// `scratch` holds frames * M float2 for the long routes (the middle pass of
// kRouteLong3 runs in place in it) and is not read for kRouteCluster.
template <int kLoad, int kStore>
inline int run_fft_large(const Plan& p, long long frames, const float* a, const float* a_im,
                         float2* scratch, float* out, float* out_im, const float2* tw,
                         cudaStream_t st) {
  if (p.route == kRouteCluster && p.m == Cl17::kM)
    return launch_cluster<kLoad, kStore>(frames, a, a_im, out, out_im, tw, p.log_n, st);
  if ((p.route != kRouteLong && p.route != kRouteLong3) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int rc = cols_long<kLoad>(p.l_first, frames, p.m / p.l_first, a, a_im, scratch, tw, st);
  if (rc != 0) return rc;
  int lg1 = 0;
  if (p.route == kRouteLong3) {
    // Each of the frame's L1 rows of R1 = L2 * L3 points as a frame: L3
    // columns of L2 points, in place.
    rc = cols_long<kLoadReal>(p.l_mid, frames * p.l_first, p.l_last,
                              reinterpret_cast<const float*>(scratch), nullptr, scratch, tw,
                              st);
    if (rc != 0) return rc;
    lg1 = ilog2(p.l_first);
  }
  return rows_long<kStore>(p.l_last, frames, p.m / p.l_last, scratch, out, out_im, tw, lg1,
                           st);
}

}  // namespace hst
