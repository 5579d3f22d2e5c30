// The ring MAC: K7 lag_mac_ring, K15 lag_mac and K8's state kernel as one
// kernel (ring_mac.cuh states the function). Per channel,
//   Y_t = sum_{q < P} V[P + t - 1 - q] * H_q  (+ V[P + t] * L0),   t < T,
// as packed complex products: the bin-0 lane (DC in re, Nyquist in im)
// multiplies two real values, re = sum v.re*h.re, im = sum v.im*h.im.
//
// Three entry points, each a thin launch of the one kernel:
// - K7 (hst_lag_mac_ring): V = [hist (P rows) | X (T rows)], both read in
//   place; the new ring V[T : T+P] written to its own buffer (never hist).
//   Replaces hisstools_library_tpu/fft/pallas_kernels.py: lag_mac_ring
//   (_lag_mac_ring_kernel), which stages V contiguously in VMEM and patches
//   bin 0 afterwards in XLA.
// - K15 (hst_lag_mac): V = xpad[S :] of (C, S + T + P, K) spectra, S =
//   lead_skip leading rows ignored; no ring out. Replaces
//   hisstools_library_tpu/fft/pallas_kernels.py: lag_mac (_lag_mac_kernel),
//   whose (channel, bin-tile) block must fit VMEM; any T and P here.
// - K8's state kernel (hst_stream_state, and the middle launch of
//   hst_fastfir_stream in fastfir_stream.cu): K7's operands and the
//   optional lag-0 term X_t * L0.
// The matrix form (launch_ring_mac_matrix, the middle launch of
// hst_fastfir_stream_matrix) is a kernel of its own below: an N-in / M-out
// matrix whose pairs share one ring an input.
//
// Bound on the H100: HBM bytes. K7 reads H and hist (8*C*P*K each) and X
// (8*C*T*K) and writes Y (8*C*T*K) and the new ring (8*C*P*K): 1.68 GB at
// the two-tier far tier (C 128, T 4, P 14, K 32768), 1.73 GB at the
// collapsed section (128, 16, 58, 8192). The work is P + 1 complex
// multiply-adds a bin and hop (8 FP32 operations each), far below the bytes.
// So the design is the bytes' movement:
// - A block takes a tile of B = min(K, 256) consecutive bins of one channel,
//   one consumer thread a bin (K = 16..128: blocks of one or more warps).
// - A producer warp streams the rows the tile needs as items through
//   kStages shared-memory stages, each filled by 1-D bulk copies (TMA,
//   cp.async.bulk, one a plane: 2-4 an item) completing on the stage's
//   `full` mbarrier. Chunk [t0, t0 + tc) of TU hops is the items: the tc
//   rows V[P+t0+j], kRows to an item, then for each lag q the pair (H_q,
//   V[P+t0-1-q]). An item is 2-4 KB at B = 256. (Tiles of 256 / K channels
//   at a narrow K, one copy a plane and channel, measured slower than one
//   channel a block at every narrow shape: 64 small copies an item at K =
//   16; PERF.md, section 6, the ring MAC.)
// - The consumers release a stage on its `empty` mbarrier (one arrival a
//   warp) and the producer refills it, so up to kStages items are in flight
//   and no block-wide barrier runs per item.
// - A thread keeps the chunk's TU accumulators and a window of TU V values
//   in registers. The lag loop is unrolled TU times, so the window is a ring
//   indexed at compile time: V[P+t0-1-q] lands in the slot of the value no
//   output needs any more, and no value moves.
// - The new ring's rows are stored as they pass: V[P+t] from its X item,
//   the old ring's rows from chunk 0's lag items. No row is read twice.
// Every byte of the operands moves once when T <= kMaxHops; each further
// chunk re-reads H and P rows of V (16*C*P*K bytes a chunk).
#include "ring_mac.cuh"

namespace hst {
namespace {

constexpr int kBins = 256;             // the most consumer threads a block: a tile's bins
constexpr int kThreads = kBins + 32;   // and the producer warp
constexpr int kStages = 8;             // items in shared memory
constexpr int kMaxHops = 16;           // hops a chunk: accumulators a thread
constexpr int kMinBins = 16;           // the least K: a 64-byte row, bulk copies of 16-byte units
constexpr int kMinBlocks = 2;          // blocks an SM (__launch_bounds__): registers a thread
constexpr int kRows = 2;               // rows of V a row item carries (1 or 2)

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to complete.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// acc += v * h as a packed product, with h given as (h.x, hm, hx): hm = h.y
// and hx = h.x, or on the bin-0 lane hm = 0 and hx = h.y (two real products).
__device__ __forceinline__ void mac(float2& acc, float2 v, float hr, float hm, float hx) {
  acc.x = fmaf(v.x, hr, fmaf(-v.y, hm, acc.x));
  acc.y = fmaf(v.x, hm, fmaf(v.y, hx, acc.y));
}

// Grid: C * (K / B) blocks of 32 * ceil(B / 32) consumers and the producer
// warp; block (c, tb) owns bins b0 = tb * B .. b0 + B - 1 of channel c. TU
// (a power of two <= kMaxHops, at least min(T, kMaxHops)) hops a chunk of
// ceil(tc / kRows) row items and P lag items; item g sits in stage g mod
// kStages as plane runs of B floats: re, im of the row V[P+t0+j] (and of
// V[P+t0+j+1]), or of H_q and then of V[P+t0-1-q].
template <int TU>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ring_mac(RingMac a) {
  __shared__ __align__(128) float stage[kStages][4][kBins];
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ __align__(8) unsigned long long empty[kStages];
  const int t = a.t, p = a.p, k = a.k;
  const int bins = k < kBins ? k : kBins;
  const int consumers = (bins + 31) / 32 * 32;
  const int tiles = k / bins;
  const long long c = blockIdx.x / tiles;
  const int b0 = (int)(blockIdx.x - c * tiles) * bins;
  const int chunks = (t + TU - 1) / TU;
  const int last = t - (chunks - 1) * TU;  // hops of the last chunk
  const int per_chunk = (TU + kRows - 1) / kRows + p;  // items of every chunk but the last
  const int items = (chunks - 1) * per_chunk + (last + kRows - 1) / kRows + p;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (tid >= consumers) {
    // The producer warp: its lane 0 copies each item's plane runs.
    if (tid > consumers) return;
    const unsigned run = (unsigned)bins * sizeof(float);
    for (int g = 0; g < items; ++g) {
      const int s = g % kStages;
      if (g >= kStages) bar_wait(&empty[s], (unsigned)(g / kStages - 1) & 1u);
      const int ci = g / per_chunk;
      const int j = g - ci * per_chunk;
      const int t0 = ci * TU;
      const int tc = min(TU, t - t0);
      const int nx = (tc + kRows - 1) / kRows;  // the chunk's row items
      const bool row = j < nx;
      const int rows = row ? min(kRows, tc - j * kRows) : 1;  // V rows of the item
      const int q = j - nx;
      const int u = row ? p + t0 + j * kRows : p + t0 - 1 - q;  // its (first) V row
      bar_expect(&full[s], (row ? 2u * rows : 4u) * run);
      // V row u + r into planes 2 pl, 2 pl + 1.
      auto vrow = [&](int r, int pl) {
        const int ur = u + r;
        const bool first = ur < a.s_rows;
        const long long vo = first ? c * a.s_cs + (long long)ur * k + b0
                                   : c * a.x_cs + (long long)(ur - a.s_rows) * k + b0;
        bulk_copy(stage[s][2 * pl], (first ? a.sr : a.xr) + vo, run, &full[s]);
        bulk_copy(stage[s][2 * pl + 1], (first ? a.si : a.xi) + vo, run, &full[s]);
      };
      if (row) {
        vrow(0, 0);
        if (rows > 1) vrow(1, 1);
      } else {
        const long long ho = c * a.h_cs + (long long)q * k + b0;
        bulk_copy(stage[s][0], a.hr + ho, run, &full[s]);
        bulk_copy(stage[s][1], a.hi + ho, run, &full[s]);
        vrow(0, 1);
      }
    }
    return;
  }

  // The consumers: thread tid < B owns bin b0 + tid (a narrow tile's warp
  // has idle lanes).
  const bool live = tid < bins;
  const int bin = b0 + tid;
  const bool lane0 = bin == 0;
  const long long yc = c * t * (long long)k + bin;  // Y row 0 of this (channel, bin)
  const long long rc = c * p * (long long)k + bin;  // new ring slot 0
  const bool ring_out = a.nr != nullptr && live;
  const bool lag0 = a.l0r != nullptr;
  float l0r = 0.f, l0m = 0.f, l0x = 0.f;
  if (lag0 && live) {
    l0r = __ldg(&a.l0r[c * a.l0_cs + bin]);
    const float l0i = __ldg(&a.l0i[c * a.l0_cs + bin]);
    l0m = lane0 ? 0.f : l0i;
    l0x = lane0 ? l0i : l0r;
  }

  // Item g's values of this thread: the row (or H_q) in u, the next row (or
  // V) in v; then the stage back to the producer (one arrival a warp).
  int g = 0;
  auto take = [&](float2& u, float2& v, bool pair) {
    const int s = g % kStages;
    bar_wait(&full[s], (unsigned)(g / kStages) & 1u);
    u = make_float2(stage[s][0][tid], stage[s][1][tid]);
    if (pair) v = make_float2(stage[s][2][tid], stage[s][3][tid]);
    __syncwarp();
    if ((tid & 31) == 0) bar_arrive(&empty[s]);
    ++g;
  };

  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * TU;
    const int tc = min(TU, t - t0);
    // win[j mod TU] holds V[P+t0+j]: first the chunk's rows j = 0..tc-1.
    float2 acc[TU], win[TU];
#pragma unroll
    for (int i = 0; i < TU; ++i) {
      win[i] = make_float2(0.f, 0.f);
      acc[i] = make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < TU; i += kRows) {
      if (i < tc) {
        float2 x[2];
        take(x[0], x[1], kRows > 1 && i + 1 < tc);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (i + r < tc) {
            win[i + r] = x[r];
            if (lag0) mac(acc[i + r], x[r], l0r, l0m, l0x);
            const int slot = t0 + i + r - t + p;  // V[P+t0+i+r] is the new ring's slot u - T
            if (ring_out && slot >= 0) {
              a.nr[rc + (long long)slot * k] = x[r].x;
              a.ni[rc + (long long)slot * k] = x[r].y;
            }
          }
        }
      }
    }
    // Lag q: V[P+t0-1-q] (j = -1-q) takes slot (TU-1-q) mod TU, whose value
    // (j = TU-1-q) no output needs from this lag on; output i reads j = i-1-q.
    for (int q0 = 0; q0 < p; q0 += TU) {
#pragma unroll
      for (int qq = 0; qq < TU; ++qq) {
        const int q = q0 + qq;
        if (q < p) {
          float2 h, v;
          take(h, v, true);
          win[TU - 1 - qq] = v;
          const float hm = lane0 ? 0.f : h.y;
          const float hx = lane0 ? h.y : h.x;
#pragma unroll
          for (int i = 0; i < TU; ++i) mac(acc[i], win[(i - 1 - qq + TU) % TU], h.x, hm, hx);
          // The old ring's row V[P-1-q] (read here, in chunk 0, once) is the
          // new ring's slot P-1-q-T.
          const int slot = p - 1 - q - t;
          if (ring_out && ci == 0 && slot >= 0) {
            a.nr[rc + (long long)slot * k] = v.x;
            a.ni[rc + (long long)slot * k] = v.y;
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < TU; ++i) {
        if (i < tc) {
          a.yr[yc + (long long)(t0 + i) * k] = acc[i].x;
          a.yi[yc + (long long)(t0 + i) * k] = acc[i].y;
        }
      }
    }
  }
}

// Hops a chunk for t hops: the least power of two >= min(t, kMaxHops)
// (hopper_kernels._ring_mac_plan mirrors it).
int chunk_hops(int t) {
  int tu = 1;
  while (tu < t && tu < kMaxHops) tu <<= 1;
  return tu;
}

bool served(int k) {
  return k % kBins == 0 || (k >= kMinBins && k < kBins && (k & (k - 1)) == 0);
}

// -----------------------------------------------------------------------------
// The matrix form: Y_m = sum over inputs n of the ring MAC of V_n with H_m,n
// (ring_mac.cuh). Bound on the H100: HBM bytes, H (M N P K complex) once;
// at the 25 x 25 matrix's (T 8, P 17, K 8192) H and L0 are 0.737 of the
// 0.82 GB. So the design reads H once, and each input's V rows once a group
// of outputs:
// - A block takes a tile of kMxBins bins and a group of kMxGroup outputs
//   (blocks tile-major, group-minor, so the groups of one tile read its V
//   rows from L2 after the first), one consumer thread a bin.
// - A lag item is the group's H_m,n,q rows and the row V_n[P+t0-1-q], a row
//   item up to kMxGroup + 1 rows of V_n: 2 kMxGroup + 2 plane runs of
//   kMxBins floats a stage, filled by lanes of the producer warp in
//   parallel (one 1-D bulk copy each) on the stage's `full` mbarrier.
// - The producer walks the items in loops (no division per item): for each
//   chunk of TU <= kMxHops hops, for each input, its row items, then its P
//   lag items.
// - A thread keeps kMxGroup x TU accumulators and K7's window of TU V
//   values in registers, and adds the accumulators into a shared-memory
//   total after each input: each input's terms (1 + P a hop) are summed
//   apart, then the inputs, so the float32 sums stay as short as one
//   pair's (one chain over all inputs measured 11 dB lower SNR against
//   float64 at the matrix's shape).
// - The blocks of the first group store each input's new ring as its rows
//   pass.
// Five outputs a block and 128 bins: 128 registers a thread, three blocks an
// SM (the stages and the total, 70 KB a block); 1-D copies of 512 bytes.
constexpr int kMxBins = 128;   // bins a block: its consumer threads
constexpr int kMxGroup = 5;    // outputs a block
constexpr int kMxStages = 5;   // items in shared memory
constexpr int kMxHops = 8;     // hops a chunk: accumulators an output
constexpr int kMxPlanes = 2 * kMxGroup + 2;
constexpr int kMxDevices = 64;  // devices whose shared-memory opt-in is remembered

// V_n row u, plane im, from bin b0: the ring's rows first, then X's.
__device__ __forceinline__ const float* matrix_vrow(const RingMac& a, int n, int u, int im,
                                                    int b0) {
  if (u < a.s_rows) return (im ? a.si : a.sr) + n * a.s_cs + (long long)u * a.k + b0;
  return (im ? a.xi : a.xr) + n * a.x_cs + (long long)(u - a.s_rows) * a.k + b0;
}

// Dynamic shared memory: kMxStages stages of kMxPlanes runs, the total
// (kMxGroup x TU accumulators, re and im, a run each), then the mbarriers.
template <int TU>
constexpr int matrix_shared_bytes() {
  return (kMxStages * kMxPlanes + kMxGroup * TU * 2) * kMxBins * 4 + 2 * kMxStages * 8;
}

template <int TU>
__global__ void __launch_bounds__(kMxBins + 32) ring_mac_matrix(RingMac a, int inputs) {
  constexpr int kItemRows = kMxGroup + 1;  // V rows a row item carries
  constexpr unsigned kRun = kMxBins * sizeof(float);
  extern __shared__ __align__(128) float smem[];
  float(*stage)[kMxPlanes][kMxBins] = reinterpret_cast<float(*)[kMxPlanes][kMxBins]>(smem);
  float* total = smem + kMxStages * kMxPlanes * kMxBins;  // [kMxGroup * TU * 2][kMxBins]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(total + kMxGroup * TU * 2 * kMxBins);
  unsigned long long* empty = full + kMxStages;
  const int t = a.t, p = a.p, k = a.k;
  const int outs = (int)a.channels;
  const int groups = (outs + kMxGroup - 1) / kMxGroup;
  const int tb = blockIdx.x / groups;
  const int m0 = (blockIdx.x - tb * groups) * kMxGroup;
  const int gn = min(kMxGroup, outs - m0);  // the group's outputs
  const int b0 = tb * kMxBins;
  const int chunks = (t + TU - 1) / TU;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kMxStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kMxBins / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (tid >= kMxBins) {
    // The producer warp: lane 0 claims a stage, the lanes copy its runs.
    const int lane = tid - kMxBins;
    int g = 0;
    auto claim = [&](int s, unsigned bytes) {
      if (lane == 0) {
        if (g >= kMxStages) bar_wait(&empty[s], (unsigned)(g / kMxStages - 1) & 1u);
        bar_expect(&full[s], bytes);
      }
      __syncwarp();
    };
    for (int ci = 0; ci < chunks; ++ci) {
      const int t0 = ci * TU, tc = min(TU, t - t0);
      for (int n = 0; n < inputs; ++n) {
        for (int j0 = 0; j0 < tc; j0 += kItemRows, ++g) {  // rows V_n[P+t0+j0 ..]
          const int s = g % kMxStages;
          const int rows = min(kItemRows, tc - j0);
          claim(s, 2u * rows * kRun);
          if (lane < 2 * rows)
            bulk_copy(stage[s][lane], matrix_vrow(a, n, p + t0 + j0 + (lane >> 1), lane & 1, b0),
                      kRun, &full[s]);
        }
        // H of the pair (m0 + o, n) at channel (m0 + o) * inputs + n.
        const long long hn = ((long long)m0 * inputs + n) * a.h_cs + b0;
        for (int q = 0; q < p; ++q, ++g) {  // (H_m,n,q for the group, V_n[P+t0-1-q])
          const int s = g % kMxStages;
          claim(s, 2u * (gn + 1) * kRun);
          if (lane < 2 * gn) {
            const long long ho = hn + (long long)(lane >> 1) * inputs * a.h_cs + (long long)q * k;
            bulk_copy(stage[s][lane], (lane & 1 ? a.hi : a.hr) + ho, kRun, &full[s]);
          } else if (lane < 2 * gn + 2) {
            const int im = lane - 2 * gn;
            bulk_copy(stage[s][2 * kMxGroup + im], matrix_vrow(a, n, p + t0 - 1 - q, im, b0),
                      kRun, &full[s]);
          }
        }
      }
    }
    return;
  }

  // The consumers: thread tid owns bin b0 + tid of the group's outputs.
  const int bin = b0 + tid;
  const bool lane0 = bin == 0;
  const bool lag0 = a.l0r != nullptr;
  const bool ring_out = a.nr != nullptr && m0 == 0;
  int g = 0;
  auto take = [&]() {
    const int s = g % kMxStages;
    bar_wait(&full[s], (unsigned)(g / kMxStages) & 1u);
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if ((tid & 31) == 0) bar_arrive(&empty[s]);
    ++g;
  };
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * TU, tc = min(TU, t - t0);
#pragma unroll
    for (int r = 0; r < kMxGroup * TU * 2; ++r) total[r * kMxBins + tid] = 0.f;
    for (int n = 0; n < inputs; ++n) {
      const long long rc = (long long)n * p * k + bin;  // input n's new ring, slot 0
      float2 acc[kMxGroup][TU], win[TU];
#pragma unroll
      for (int i = 0; i < TU; ++i) {
        win[i] = make_float2(0.f, 0.f);
#pragma unroll
        for (int o = 0; o < kMxGroup; ++o) acc[o][i] = make_float2(0.f, 0.f);
      }
      // win[j mod TU] holds V_n[P+t0+j]: first the chunk's rows, with lag 0.
#pragma unroll
      for (int j0 = 0; j0 < TU; j0 += kItemRows) {
        if (j0 < tc) {
          const int s = take();
#pragma unroll
          for (int r = 0; r < kItemRows; ++r) {
            const int j = j0 + r;
            if (j < TU && j < tc) {
              const float2 x = make_float2(stage[s][2 * r][tid], stage[s][2 * r + 1][tid]);
              win[j] = x;
              if (lag0) {
#pragma unroll
                for (int o = 0; o < kMxGroup; ++o) {
                  if (o < gn) {
                    const long long lc = ((long long)(m0 + o) * inputs + n) * a.l0_cs + bin;
                    const float l0r = __ldg(&a.l0r[lc]), l0i = __ldg(&a.l0i[lc]);
                    mac(acc[o][j], x, l0r, lane0 ? 0.f : l0i, lane0 ? l0i : l0r);
                  }
                }
              }
              const int slot = t0 + j - t + p;  // V_n[P+t0+j] is the new ring's slot
              if (ring_out && slot >= 0) {
                a.nr[rc + (long long)slot * k] = x.x;
                a.ni[rc + (long long)slot * k] = x.y;
              }
            }
          }
          release(s);
        }
      }
      // Lag q, as ring_mac's: V_n[P+t0-1-q] takes window slot (TU-1-q) mod TU.
      for (int q0 = 0; q0 < p; q0 += TU) {
#pragma unroll
        for (int qq = 0; qq < TU; ++qq) {
          const int q = q0 + qq;
          if (q < p) {
            const int s = take();
            const float2 v = make_float2(stage[s][2 * kMxGroup][tid],
                                         stage[s][2 * kMxGroup + 1][tid]);
            win[TU - 1 - qq] = v;
#pragma unroll
            for (int o = 0; o < kMxGroup; ++o) {
              if (o < gn) {
                const float hr = stage[s][2 * o][tid], hi = stage[s][2 * o + 1][tid];
                const float hm = lane0 ? 0.f : hi, hx = lane0 ? hi : hr;
#pragma unroll
                for (int i = 0; i < TU; ++i) mac(acc[o][i], win[(i - 1 - qq + TU) % TU], hr, hm, hx);
              }
            }
            const int slot = p - 1 - q - t;  // the old ring's row V_n[P-1-q], in chunk 0
            if (ring_out && ci == 0 && slot >= 0) {
              a.nr[rc + (long long)slot * k] = v.x;
              a.ni[rc + (long long)slot * k] = v.y;
            }
            release(s);
          }
        }
      }
      // Input n's terms into the total (each thread its own bin's column).
#pragma unroll
      for (int o = 0; o < kMxGroup; ++o)
#pragma unroll
        for (int i = 0; i < TU; ++i) {
          total[(2 * (o * TU + i)) * kMxBins + tid] += acc[o][i].x;
          total[(2 * (o * TU + i) + 1) * kMxBins + tid] += acc[o][i].y;
        }
    }
#pragma unroll
    for (int o = 0; o < kMxGroup; ++o) {
      if (o < gn) {
        const long long yc = (long long)(m0 + o) * t * k + bin;
#pragma unroll
        for (int i = 0; i < TU; ++i) {
          if (i < tc) {
            a.yr[yc + (long long)(t0 + i) * k] = total[(2 * (o * TU + i)) * kMxBins + tid];
            a.yi[yc + (long long)(t0 + i) * k] = total[(2 * (o * TU + i) + 1) * kMxBins + tid];
          }
        }
      }
    }
  }
}

template <int TU>
int launch_matrix(const RingMac& a, int inputs, cudaStream_t st) {
  constexpr int bytes = matrix_shared_bytes<TU>();
  // The opt-in above 48 KB, once a device.
  static bool opted[kMxDevices] = {};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kMxDevices || !opted[dev]) {
    rc = (int)cudaFuncSetAttribute(ring_mac_matrix<TU>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != 0) return rc;
    if (dev < kMxDevices) opted[dev] = true;
  }
  const int groups = (int)((a.channels + kMxGroup - 1) / kMxGroup);
  const unsigned grid = (unsigned)(groups * (a.k / kMxBins));
  ring_mac_matrix<TU><<<grid, kMxBins + 32, bytes, st>>>(a, inputs);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_ring_mac(const RingMac& a, cudaStream_t st) {
  if (!served(a.k) || a.t < 1 || a.p < 1 || a.channels < 1) return (int)cudaErrorInvalidValue;
  const int bins = a.k < kBins ? a.k : kBins;
  const unsigned grid = (unsigned)(a.channels * (a.k / bins));
  const int threads = (bins + 31) / 32 * 32 + 32;
  switch (chunk_hops(a.t)) {
    case 1: ring_mac<1><<<grid, threads, 0, st>>>(a); break;
    case 2: ring_mac<2><<<grid, threads, 0, st>>>(a); break;
    case 4: ring_mac<4><<<grid, threads, 0, st>>>(a); break;
    case 8: ring_mac<8><<<grid, threads, 0, st>>>(a); break;
    default: ring_mac<16><<<grid, threads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// Chunks of the least power of two >= min(T, kMxHops) hops, as ring_mac's
// (hopper_kernels._ring_mac_matrix_plan mirrors it).
int launch_ring_mac_matrix(const RingMac& a, int inputs, cudaStream_t st) {
  if (a.k % kMxBins || a.t < 1 || a.p < 1 || a.channels < 1 || inputs < 1)
    return (int)cudaErrorInvalidValue;
  int tu = 1;
  while (tu < a.t && tu < kMxHops) tu <<= 1;
  switch (tu) {
    case 1: return launch_matrix<1>(a, inputs, st);
    case 2: return launch_matrix<2>(a, inputs, st);
    case 4: return launch_matrix<4>(a, inputs, st);
    default: return launch_matrix<8>(a, inputs, st);
  }
}

}  // namespace hst

// K7: hist (C, P, K) and X (C, T, K) contiguous, H (C, P, K) channels
// h_cstride floats apart; Y (C, T, K) and the new ring (C, P, K).
extern "C" int hst_lag_mac_ring(const float* sr, const float* si, const float* xr,
                                const float* xi, const float* hr, const float* hi,
                                long long h_cstride, float* yr, float* yi, float* nr, float* ni,
                                long long channels, int t, int p, int k, void* stream) {
  const hst::RingMac a{sr, si, (long long)p * k, p, xr, xi, (long long)t * k,
                       hr, hi, h_cstride, nullptr, nullptr, 0, yr, yi, nr, ni,
                       channels, t, p, k};
  return hst::launch_ring_mac(a, static_cast<cudaStream_t>(stream));
}

// K15: xpad (C, TP, K) contiguous with TP = skip + T + P, H as K7's; Y (C,
// T, K). V is xpad from row `skip` on, one source.
extern "C" int hst_lag_mac(const float* xr, const float* xi, const float* hr, const float* hi,
                           long long h_cstride, float* yr, float* yi, long long channels,
                           int tp, int t, int p, int k, int skip, void* stream) {
  const long long cs = (long long)tp * k;
  const long long off = (long long)skip * k;
  const hst::RingMac a{xr + off, xi + off, cs, tp - skip, xr, xi, cs,
                       hr, hi, h_cstride, nullptr, nullptr, 0, yr, yi, nullptr, nullptr,
                       channels, t, p, k};
  return hst::launch_ring_mac(a, static_cast<cudaStream_t>(stream));
}

// K8's state kernel alone: X (C, T, K) planes, ring (C, P, K) in and out
// (oldest-first), H (C, P, K) and the optional lag-0 L0 (C, K), channels
// h_cs / l0_cs floats apart; Y (C, T, K).
extern "C" int hst_stream_state(const float* xr, const float* xi, const float* rr,
                                const float* ri, const float* hr, const float* hi, long long h_cs,
                                const float* l0r, const float* l0i, long long l0_cs, float* yr,
                                float* yi, float* nr, float* ni, long long channels, int t, int p,
                                int k, void* stream) {
  const hst::RingMac a{rr, ri, (long long)p * k, p, xr, xi, (long long)t * k,
                       hr, hi, h_cs, l0r, l0i, l0_cs, yr, yi, nr, ni, channels, t, p, k};
  return hst::launch_ring_mac(a, static_cast<cudaStream_t>(stream));
}
