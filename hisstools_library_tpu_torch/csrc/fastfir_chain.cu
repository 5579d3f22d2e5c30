// K5: the whole offline FastFIR chain, N = 2^14..2^17. Per channel, for
// each hop t of its (T, H) blocks:
//   X_t = rfft_packed([x[t-1] | x[t]])     (x[-1] = 0)
//   Y_t = sum_{lag < P} X_{t-1-lag} * H_lag  (X_{<0} = 0)
//   y_t = scale * rifft(Y_t)[H:]
// Packed products; the bin-0 lane (DC in re, Nyquist in im) multiplies two
// real values. (K8, the streaming block with a carried ring, runs split in
// fastfir_stream.cu: its ring is state that moves in natural bin order.)
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: fastfir_chain (:1685,
// _fastfir_kernel). The TPU kernel keeps each channel's spectra ring and
// H in VMEM (2*4*P*(N/2)*2 bytes, ~7.9 MB at the main path's N = 2^16,
// P = 15) and run the hop's DFTs as matmuls, so the hop spectra X_t and the
// accumulations Y_t never reach HBM. On Hopper neither that state nor one
// 2^16 frame (256 KB) fits a block's 227 KB, and blocks carry nothing from one
// to the next, so the chain runs on the two-pass four-step core
// (fft_common.cuh, M = N/2 = M1 * R: rows of M1 = l_last points) in three
// phases on one stream:
//   A. the forward column pass of every frame, reading [x[t-1] | x[t]] in
//      place (fft_common.cuh's fft_cols, kLoadStream), into a scratch
//      frame per hop;
//   B. one block per (channel, row pair (j, R-j)) walks the channel's hops
//      in chunks of kRows / 2 (32 rows up to M1 = 128, 16 at 256): the
//      forward row pass and the pack (bins k and M-k sit in rows j and
//      R-j), the MAC over the block's own ring of the last P spectra of its
//      2*M1 bins and their H (shared memory; a per-block global scratch,
//      read through L2, when P is too large for it), the lag-0 term, the
//      unpack and the inverse's row pass (the row-first inverse,
//      fft_common.cuh), written back to the same rows of the scratch
//      frames. In natural bin order a block's bins lie R apart; 4 blocks of
//      consecutive pairs form a cluster and move H for each other in runs
//      of 16 bytes (distributed shared memory);
//   C. the inverse's column pass, storing the kept half [H, N) with `scale`
//      folded in (K4's tail store).
// No (C, T, N/2) tensor of X or Y exists: HBM holds the signal, the output,
// H and the scratch frames.
//
// Phase B is latency-bound (two blocks an SM, each a chain of dependent
// steps; tools/k5_layouts.py times it without each step), so its design
// keeps bytes in flight and steps few:
//   - the rows of a chunk are requested by asynchronous 8-byte copies
//     (cp.async) straight into the FFT tile, chunk 0's at block start, so
//     they land while the prologue moves H; where a launch has more than
//     one chunk and a block has its SM to itself, the tiles are
//     double-buffered: chunk c+1's rows are requested as soon as chunk c's
//     have landed, so they land while chunk c computes (otherwise once
//     chunk c is stored, while the SM's other block runs);
//   - a chunk holds as many rows as the row DFTs keep every thread busy:
//     the DFTs run on reg_fft.cuh's register core (16 points a thread,
//     M1/16 threads a row, radix-16 stages exchanged within a warp), so a
//     chunk has five block barriers (after the forward row pass, the pack,
//     the MAC, the unpack and the inverse's store), at the main path's
//     T = 16 one chunk a block; the MAC walks the chunk 8 hops at a time;
//   - the prologue overlaps its latencies: the first batch of H loads and
//     the twiddle loads are in flight while the blocks of the
//     cluster meet at its first barrier, and the barrier after the hand-off
//     of H is split: arrive at once, wait only before the first MAC, so
//     chunk 0's forward row pass and pack run meanwhile;
//   - the ring is not zero-filled: lags before hop 0 are skipped (X_{<0} =
//     0), which also cuts the first hops' MAC to their valid lags.
// The rows are not staged by bulk copies (1-D TMA on an mbarrier): 1 KB
// copies through a staging tile measured slower than cp.async into the FFT
// tile.
//
// Bound on the H100: HBM bytes. The function must move the signal in, y out
// and H once (1.04 GB at the main path's (128, 16, 32768), P = 15: 0.31 ms at
// 3.35 TB/s). This design adds the scratch frame, written by A, read and
// written by B and read by C (4 x 537 MB there), and reads each signal block
// twice: ~3.3 GB, ~1.0 ms at peak, against ~5.3 GB for K2 -> K3 -> K4. The
// MAC reads ring and H from shared memory once per 8 hops (a register
// window slides over the hops), so neither bounds it.
#include <cooperative_groups.h>

#include "fft_common.cuh"
#include "reg_fft.cuh"

using namespace hst;
namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;         // blocks of consecutive row pairs a cluster
constexpr int kMacHops = 8;         // hops the MAC's register window spans
constexpr int kBatch = 16;          // values of H a thread has in flight
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kSmemSm = 233472;     // an SM's shared memory; 1 KB reserved a block

// Rows of a chunk: kThreads / (M1 / 16), the row DFTs' threads, at most 32.
__host__ __device__ constexpr int chunk_rows(int l) {
  return kThreads / (l / 16) < 32 ? kThreads / (l / 16) : 32;
}

struct Chain {
  float2* frames;                  // (C*T, M) scratch frames, rows of M1
  const float* h_re;               // (C, P, M) packed H, channels h_cs apart
  const float* h_im;
  long long h_cs;
  float2* gring;                   // (blocks, 2, P, 2*M1) when not in shared memory
  const float2* tw;
  int t, p, log_n, rows;
  int tiles;                       // FFT tiles: 2 double-buffers the chunks' rows
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 2 * tc rows of a chunk (row f: hop f / 2, row0 or row1) into the FFT
// tile, row f at tile + f * LD in reg_fft.cuh's padded slots, by 8-byte
// asynchronous copies from every thread; complete after
// cp.async.wait_group 0 and a block barrier.
template <int L, int LD>
__device__ __forceinline__ void copy_rows(float2* tile, const float2* fr, long long m,
                                          int row0, int row1, int tc) {
  for (int i = threadIdx.x; i < 2 * tc * L; i += kThreads) {
    const int f = i / L;
    const int e = i - f * L;
    const float2* src = fr + (long long)(f >> 1) * m + (long long)((f & 1) ? row1 : row0) * L + e;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(tile + f * LD + hst_reg::pad(e))),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float2 mac_term(float2 v, float2 h, bool lane0) {
  return lane0 ? make_float2(v.x * h.x, v.y * h.y) : cmul(v, h);
}

// The pack of bin k from Z[k] and its partner Z[M-k]:
// P[k] = (Z[k] + conj Z[M-k]) - i W_N^k (Z[k] - conj Z[M-k]).
__device__ __forceinline__ float2 pair_pack(float2 zk, float2 zm, float2 w) {
  const float2 sum = make_float2(zk.x + zm.x, zk.y - zm.y);
  const float2 dif = make_float2(zk.x - zm.x, zk.y + zm.y);
  const float2 wd = cmul(w, dif);
  return make_float2(sum.x + wd.y, sum.y - wd.x);
}

// The unpack of bin k for the inverse, conj(Z'[k]), from P[k] and P[M-k]
// (K4's loader).
__device__ __forceinline__ float2 pair_unpack(float2 pk, float2 pm, float2 w) {
  const float2 sum = make_float2(pk.x + pm.x, pk.y - pm.y);
  const float2 dif = make_float2(pk.x - pm.x, pk.y + pm.y);
  const float2 wd = cmul(make_float2(w.x, -w.y), dif);
  return make_float2(sum.x - wd.y, -(sum.y + wd.x));
}

// Item q <= L of hop h: a bin and its partner, slot f and column (the bin's
// k1) each. Block j != 0: bin (2h, q) of row j pairs with (2h + 1, L-1-q) of
// row R-j (items q < L). Block 0: row R/2 pairs within itself, (2h + 1, q)
// with (2h + 1, L-1-q) for q < L/2; row 0 holds (2h, u) and (2h, L-u) for
// u = q - L/2 + 1 < L/2, the self-partnered bin M/2 at u = L/2 and bin 0
// (DC, Nyquist: `dc`) at q = L. Returns false for no item.
__device__ __forceinline__ bool pair_of(int h, int q, int j, int L, int& fa, int& ca,
                                        int& fb, int& cb, bool& dc) {
  dc = false;
  if (j != 0) {
    fa = 2 * h;
    ca = q;
    fb = 2 * h + 1;
    cb = L - 1 - q;
    return q < L;
  }
  if (q < L / 2) {
    fa = fb = 2 * h + 1;
    ca = q;
    cb = L - 1 - q;
    return true;
  }
  const int u = q - L / 2 + 1;
  fa = fb = 2 * h;
  ca = u <= L / 2 ? u : 0;
  cb = u < L / 2 ? L - u : ca;
  dc = u > L / 2;
  return true;
}

// A cluster of G = kCluster blocks holds G consecutive pairs j0..j0+G-1,
// whose rows are G consecutive rows on each side: j0.. and R-j0-G+1..R-j0.
// In the packed planes (natural bin order) a block's own bins lie R apart,
// but for every (lag, k1) the G blocks' values of one side are one run of G
// consecutive floats. So each block of the cluster reads 1/G of the columns
// k1, whole runs, and hands each value to the block that owns its row
// (distributed shared memory). Index i of the range below is (side, lag, k1
// in the block's share, row offset rr); `tb` the owner, `row` its row, false
// for the one row that is not in a run: block 0's row R/2, which it moves
// itself. G = 4 measured faster than 8 (whole 32-byte sectors, but clusters
// of 8 hold 240 of 264 block slots and wait on more blocks) and 2.
__device__ __forceinline__ bool cluster_bin(int i, int L, int p, int rows, int j0, int rank,
                                            int& tb, int& row, int& lag, int& bin) {
  const int q = L / kCluster;
  const int rr = i & (kCluster - 1);
  int rest = i / kCluster;
  const int k1 = rank * q + rest % q;
  rest /= q;
  lag = rest % p;
  const int side = rest / p;
  tb = side == 0 ? rr : kCluster - 1 - rr;
  row = side == 0 ? j0 + rr : rows - j0 - (kCluster - 1) + rr;
  bin = side * L + k1;
  return side == 0 || j0 + tb != 0;
}

// Phase B: grid = C * R/2 blocks; the block of (channel c, pair j) owns rows
// row0 = j and row1 = R - j (j = 0: rows 0 and R/2, each its own partner),
// whose bins b < 2*L are k = row_(b / L) + R * (b % L). A chunk's kRows rows
// sit in the FFT tile `s`, slot f = 2*hop + (row f&1), each in L + L/16
// padded slots (hst_reg::pad), through the pack, the MAC and the unpack; two
// blocks fit an SM at the main path's P = 15. Dynamic shared memory, in
// order: the FFT tiles (chunk c in tile c mod a.tiles), the twiddles (5L),
// ring and H (2P rows of 2L, unless they live in the global scratch).
template <int L>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
    chain_mid(Chain a) {
  using RP = hst_reg::Plan<Sub<L>::kLog>;
  using hst_reg::pad;
  constexpr int NB = 2 * L;
  constexpr int LD = RP::kLd;               // a row's padded slots in the FFT tile
  constexpr int T = RP::kT;                 // threads a row in the row DFTs
  constexpr int kRows = chunk_rows(L);
  constexpr int kHops = kRows / 2;          // hops a chunk
  constexpr int kTileSlots = kRows * LD;
  extern __shared__ __align__(128) float2 dyn[];
  const int p = a.p;
  const bool in_smem = a.gring == nullptr;
  // The block's twiddles, read once here (in the global table those of its
  // bins lie R apart, so each warp's read touches 32 sectors): for bin
  // b = r*L + k1 of row_r, W_N^k for the pack and the unpack (twp) and
  // W_M^(k1*row_r) for the inverse row pass's store (twi); and W_2L^e,
  // e < L, for the row DFTs' stages (sw).
  float2* twp = dyn + a.tiles * kTileSlots;
  float2* twi = twp + NB;
  float2* sw = twi + NB;
  const int m = 1 << (a.log_n - 1);
  const int rows = a.rows;
  const int pairs = rows >> 1;
  const long long c = blockIdx.x / pairs;
  const int j = (int)(blockIdx.x - c * pairs);
  const int row0 = j;
  const int row1 = j == 0 ? pairs : rows - j;
  const int tid = threadIdx.x;
  const int chunks = (a.t + kHops - 1) / kHops;
  // Ring (slot s holds X_t with t = s mod P) and H, [P][NB] each.
  float2* ring = in_smem ? sw + L : a.gring + (long long)blockIdx.x * 2 * p * NB;
  float2* hs = ring + p * NB;
  const float* hr = a.h_re + c * a.h_cs;
  const float* hi = a.h_im + c * a.h_cs;
  float2* fr0 = a.frames + c * a.t * (long long)m;  // the channel's first frame
  const bool cluster_h = in_smem;  // H through the cluster
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();  // = j mod kCluster: pairs is a multiple of it

  // The cluster moves H by whole runs: index i of cluster_bin, kBatch
  // values a thread, all loads of a batch in flight before its first store
  // to the owner (distributed shared memory).
  float2 hv[kBatch];
  int to[kBatch], at[kBatch];
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      int row, lag, bin;
      to[u] = -1;
      if (i < 2 * p * L && cluster_bin(i, L, p, rows, j - rank, rank, to[u], row, lag, bin)) {
        const long long o = (long long)lag * m + row + (long long)rows * (bin % L);
        at[u] = lag * NB + bin;
        hv[u] = make_float2(__ldg(&hr[o]), __ldg(&hi[o]));
      } else {
        to[u] = -1;
      }
    }
  };
  auto store_batch = [&]() {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (to[u] < 0) continue;
      cl.map_shared_rank(hs, to[u])[at[u]] = hv[u];
    }
  };

  // Chunk 0's rows, the first batch of H and the twiddles are all in
  // flight before the blocks of the cluster meet (every block runs before
  // any writes to another; the twiddles are in place).
  const bool double_buffer = a.tiles == 2;
  copy_rows<L, LD>(dyn, fr0, m, row0, row1, min(kHops, a.t));
  if (cluster_h) load_batch(tid);
  for (int e = tid; e < L; e += kThreads) sw[e] = __ldg(&a.tw[e << (a.log_n - Sub<L>::kLog - 1)]);
  for (int b = tid; b < NB; b += kThreads) {
    const int k1 = b < L ? b : b - L;
    const int row = b < L ? row0 : row1;
    twp[b] = __ldg(&a.tw[row + rows * k1]);
    twi[b] = __ldg(&a.tw[((k1 * row) & (m - 1)) << 1]);
  }
  if (cluster_h) {
    cluster_arrive();
    cluster_wait();
    store_batch();
    for (int i0 = tid + kBatch * kThreads; i0 < 2 * p * L; i0 += kBatch * kThreads) {
      load_batch(i0);
      store_batch();
    }
    // Block 0's row R/2 is in no run: it moves it itself.
    for (int i = tid; i < (j == 0 ? p * L : 0); i += kThreads) {
      const int lag = i / L;
      const int k1 = i - lag * L;
      const long long o = (long long)lag * m + pairs + (long long)rows * k1;
      hs[lag * NB + L + k1] = make_float2(__ldg(&hr[o]), __ldg(&hi[o]));
    }
    cluster_arrive();  // waited on before the first MAC
  } else {
    // Each block its own bins (the global scratch), lags unrolled so that
    // several strided loads are in flight.
    for (int b = tid; b < NB; b += kThreads) {
      const int k = (b < L ? row0 : row1) + rows * (b < L ? b : b - L);
#pragma unroll 4
      for (int lag = 0; lag < p; ++lag) {
        const long long o = (long long)lag * m + k;
        hs[lag * NB + b] = make_float2(__ldg(&hr[o]), __ldg(&hi[o]));
      }
    }
    __syncthreads();  // the twiddles are in place
  }

  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kHops;
    const int tc = min(kHops, a.t - t0);
    // The row DFTs' threads for the chunk's 2 * tc live rows, whole warps.
    const int dft_threads = (2 * tc * T + 31) & ~31;
    float2* fr = fr0 + t0 * (long long)m;
    float2* s = dyn + (double_buffer ? (ci & 1) * kTileSlots : 0);

    // This chunk's rows: with one tile, requested now that the last chunk is
    // stored; with two, requested a chunk ahead. Once they have landed, the
    // next chunk's rows go into the tile the last chunk has left.
    if (!double_buffer && ci > 0) copy_rows<L, LD>(s, fr, m, row0, row1, tc);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (double_buffer && ci + 1 < chunks)
      copy_rows<L, LD>(dyn + ((ci + 1) & 1) * kTileSlots, fr + kHops * (long long)m, m, row0,
                       row1, min(kHops, a.t - t0 - kHops));

    // Forward row pass: row f by the T threads f*T.., its points tf + T*u
    // from the FFT tile where the copies landed, the DFT in registers,
    // natural order back into the tile.
    if (tid < dft_threads) {
      const int f = tid / T;
      const int tf = tid - f * T;
      float2* row_in = s + f * LD;
      float2 v[hst_reg::kR];
#pragma unroll
      for (int u = 0; u < hst_reg::kR; ++u) v[u] = row_in[pad(tf + T * u)];
      hst_reg::Stages<Sub<L>::kLog>::run(v, row_in, tf, sw);
    }
    __syncthreads();

    // Pack in place, a bin and its partner by one thread.
    for (int i = tid; i < tc * (L + 1); i += kThreads) {
      const int h = i / (L + 1);
      int fa, ca, fb, cb;
      bool dc;
      if (!pair_of(h, i - h * (L + 1), j, L, fa, ca, fb, cb, dc)) continue;
      const float2 za = s[fa * LD + pad(ca)];
      const float2 zb = s[fb * LD + pad(cb)];
      if (dc) {
        s[fa * LD] = make_float2(2.f * (za.x + za.y), 2.f * (za.x - za.y));
        continue;
      }
      s[fa * LD + pad(ca)] = pair_pack(za, zb, twp[(fa & 1) * L + ca]);
      if (fa != fb || ca != cb) s[fb * LD + pad(cb)] = pair_pack(zb, za, twp[(fb & 1) * L + cb]);
    }
    __syncthreads();
    if (ci == 0 && cluster_h) cluster_wait();  // every block's H is in place

    // MAC, bin by bin, kMacHops hops at a time: win[i] = X_{t1+i-1-lag}
    // slides down one hop per lag, so each ring and H value is read once per
    // kMacHops hops. X_{<0} = 0: lags reaching before hop 0 are skipped, and
    // the ring is never read where it holds nothing.
    for (int b = tid; b < NB; b += kThreads) {
      const int r = b < L ? 0 : 1;
      const int k1 = b - r * L;
      const int col = pad(k1);
      const bool lane0 = j == 0 && b == 0;
      for (int h0 = 0; h0 < tc; h0 += kMacHops) {
        const int t1 = t0 + h0;
        const int tm = min(kMacHops, tc - h0);
        const int lag_end = max(0, min(p, t1 + tm - 1));
        float2 x[kMacHops], win[kMacHops], acc[kMacHops];
#pragma unroll
        for (int i = 0; i < kMacHops; ++i) {
          x[i] = i < tm ? s[(2 * (h0 + i) + r) * LD + col] : make_float2(0.f, 0.f);
          acc[i] = make_float2(0.f, 0.f);
        }
        int slot = p > 0 ? ((t1 - 1) % p + p) % p : 0;  // X_{t1-1}
        win[0] = lag_end > 0 && t1 >= 1 ? ring[slot * NB + b] : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 1; i < kMacHops; ++i) win[i] = x[i - 1];
        for (int lag = 0; lag < lag_end; ++lag) {
          const float2 h = hs[lag * NB + b];
#pragma unroll
          for (int i = 0; i < kMacHops; ++i) {
            const float2 d = mac_term(win[i], h, lane0);
            acc[i].x += d.x;
            acc[i].y += d.y;
          }
#pragma unroll
          for (int i = kMacHops - 1; i > 0; --i) win[i] = win[i - 1];
          slot = slot == 0 ? p - 1 : slot - 1;
          if (lag + 1 < lag_end)
            win[0] = t1 - 2 - lag >= 0 ? ring[slot * NB + b] : make_float2(0.f, 0.f);
        }
        if (p > 0) {
          int ins = t1 % p;
#pragma unroll
          for (int i = 0; i < kMacHops; ++i) {
            if (i < tm) {
              ring[ins * NB + b] = x[i];
              ins = ins + 1 == p ? 0 : ins + 1;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMacHops; ++i)
          if (i < tm) s[(2 * (h0 + i) + r) * LD + col] = acc[i];
      }
    }
    __syncthreads();

    // Unpack in place for the inverse, a bin and its partner by one thread.
    for (int i = tid; i < tc * (L + 1); i += kThreads) {
      const int h = i / (L + 1);
      int fa, ca, fb, cb;
      bool dc;
      if (!pair_of(h, i - h * (L + 1), j, L, fa, ca, fb, cb, dc)) continue;
      const float2 pa = s[fa * LD + pad(ca)];
      const float2 pb = s[fb * LD + pad(cb)];
      if (dc) {
        s[fa * LD] = make_float2(pa.x + pa.y, -(pa.x - pa.y));
        continue;
      }
      s[fa * LD + pad(ca)] = pair_unpack(pa, pb, twp[(fa & 1) * L + ca]);
      if (fa != fb || ca != cb) s[fb * LD + pad(cb)] = pair_unpack(pb, pa, twp[(fb & 1) * L + cb]);
    }
    __syncthreads();

    // Inverse row pass (each row's DFT within its warp), times W_M^(n1*row),
    // back to the rows it came from.
    if (tid < dft_threads) {
      const int f = tid / T;
      const int tf = tid - f * T;
      float2* row = s + f * LD;
      float2 v[hst_reg::kR];
#pragma unroll
      for (int u = 0; u < hst_reg::kR; ++u) v[u] = row[pad(tf + T * u)];
      hst_reg::Stages<Sub<L>::kLog>::run(v, row, tf, sw);
    }
    __syncthreads();
    for (int i = tid; i < 2 * tc * L; i += kThreads) {
      const int f = i / L;
      const int n1 = i - f * L;
      const int row = (f & 1) ? row1 : row0;
      fr[(long long)(f >> 1) * m + (long long)row * L + n1] =
          cmul(s[f * LD + pad(n1)], twi[(f & 1) * L + n1]);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of chain_mid<L>: `tiles` FFT tiles, 5 * L
// twiddles, and ring and H of the block's 2 * L bins unless they live in
// the global scratch.
inline int mid_smem(int l, int p, bool ring_in_smem, int tiles) {
  return (int)sizeof(float2) *
         (tiles * chunk_rows(l) * (l + l / 16) + 5 * l + (ring_in_smem ? 2 * p * 2 * l : 0));
}

// Blocks of chain_mid an SM holds by shared memory (at most 2: registers).
inline int blocks_per_sm(int smem) {
  const int n = kSmemSm / (smem + 1024);
  return n < 2 ? n : 2;
}

// FFT tiles of a launch over t hops: two (the rows double-buffered) where it
// has more than one chunk and a block has its SM to itself with one tile,
// so that no other block's work covers its row loads; else one. Where two
// blocks share an SM a second tile gained at most 3.5% and cost up to 7.5%
// (tools/k5_layouts.py, variant two-tiles).
inline int mid_tiles(int l, int p, int t, bool ring_in_smem) {
  const bool more = t > chunk_rows(l) / 2 && mid_smem(l, p, ring_in_smem, 2) <= kSmemLimit;
  return more && blocks_per_sm(mid_smem(l, p, ring_in_smem, 1)) == 1 ? 2 : 1;
}

template <int L>
int launch_mid(const Chain& a, long long channels, cudaStream_t st) {
  const int smem = mid_smem(L, a.p, a.gring == nullptr, a.tiles);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(chain_mid<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(channels * (a.rows / 2));
  chain_mid<L><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

inline void launch_cols_tail(int len, long long frames, int ncol, const float2* y,
                             float* out, const float2* tw, int log_n, float scale,
                             cudaStream_t st) {
  const unsigned grid = (unsigned)(frames * (ncol / kTile));
  switch (len) {  // the column length l_first: 128 or 256 at N = 2^14..2^17
    case 128:
      fft_cols_tail<128><<<grid, kThreads, 0, st>>>(y, out, tw, log_n, ncol, scale);
      break;
    default:
      fft_cols_tail<256><<<grid, kThreads, 0, st>>>(y, out, tw, log_n, ncol, scale);
  }
}

}  // namespace

// Float2 of global ring scratch a channel needs at size n with p lags: 0
// while ring and H fit a block's shared memory, else 2 * p * (n / 2) (the
// ring and H of each of its R/2 blocks, 2 * p * 2 * M1 each).
extern "C" long long hst_fastfir_chain_ring_scratch(int n, int p) {
  const Plan pl = make_plan(n);
  if (mid_smem(pl.l_last, p, true, 1) <= kSmemLimit) return 0;
  return 2LL * p * pl.m;
}

// One call: phases A, B, C on `stream`. `scratch` holds C*T frames of N
// floats; `gring` is null when ring and H fit shared memory, else
// hst_fastfir_chain_ring_scratch's size a channel. N = 2^14..2^17.
extern "C" int hst_fastfir_chain(const float* x, const float* h_re, const float* h_im,
                                 long long h_cstride, float* y, void* scratch, void* gring,
                                 const void* tw, long long channels, int t, int p, int n,
                                 float scale, void* stream) {
  const Plan pl = make_plan(n);
  if (pl.route != kRouteTwoPass || n < (1 << 14)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = static_cast<const float2*>(tw);
  float2* frames = static_cast<float2*>(scratch);
  const long long nframes = channels * t;
  launch_cols<kLoadStream>(pl.l_first, nframes, pl.m / pl.l_first, x, nullptr, frames, w,
                           pl.log_n, pl.log_n - 1, t, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = gring == nullptr;
  const Chain a{frames, h_re, h_im, h_cstride, static_cast<float2*>(gring), w, t, p, pl.log_n,
                pl.m / pl.l_last, mid_tiles(pl.l_last, p, t, in_smem)};
  int rc = pl.l_last == 64    ? launch_mid<64>(a, channels, st)
           : pl.l_last == 128 ? launch_mid<128>(a, channels, st)
                              : launch_mid<256>(a, channels, st);
  if (rc != 0) return rc;
  launch_cols_tail(pl.l_first, nframes, pl.m / pl.l_first, frames, y, w, pl.log_n, scale, st);
  return (int)cudaGetLastError();
}
