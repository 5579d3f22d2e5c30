// K9: one hop-boundary firing of a small partitioned section (N = 32..1024)
// in one launch. Per channel, with the ring oldest-first (slot P-1 newest):
//   E     = rfft_packed(frame)                    (the completed [prev | cur])
//   ring' = [ring[1:] | E]                        (new slot s = old slot s+1)
//   Y     = E * H[0] + sum_{s < P-1} ring[s+1] * H[P-1-s]
//   y     = scale * rifft(Y)[H:]                  (the next hop period's store)
// as packed products; the bin-0 lane (DC in re, Nyquist in im) multiplies two
// real values independently.
//
// The frame is read in place from the caller's staging buffer (channels
// `frame_cs` floats apart, any alignment), so a firing copies nothing first.
//
// Replaces hisstools_library_tpu/fft/pallas_kernels.py: hop_fire
// (_hop_fire_kernel). The TPU kernel runs both transforms as dense DFT
// matmuls on the MXU against N x N and H x N tables held in VMEM, which is
// what bounds its envelope (hop_fire_fits). On Hopper both transforms run on
// the register-DFT core of K10 / K11 (reg_fft.cuh): M = N/2 <= 512 complex
// points, 16 a thread, so a frame lives in one warp (T = M/16 lanes) and its
// exchanges need only __syncwarp. A block serves one frame group of F =
// 32/T frames (one warp's lanes): 32 blocks at the Zero preset's (C = 128,
// N = 256, P 3), 128 at N = 1024:
//
// 1. Warp 0 runs the transforms: it loads the frames in place (K10's
//    loader), runs the forward stages and packs bins k = tf + T*m (m < 16)
//    of its frame into registers, the layout K11's loader unpacks from.
// 2. The old ring's lag sum, sum_{s < P-1} ring[s+1] * H[P-1-s], does not
//    depend on the frame, so H helper warps (warps 1..H) take it while
//    warp 0 runs the forward (warp 0 summing its lags after the forward
//    added ~0.5 us a lag at P = 3, tools/fire_layouts.py). Helper h takes
//    lags h, h + H, ...; their rows are copied by cp.async (16 bytes a lane,
//    the group's F rows of M bins as one 512-float plane row) through a few
//    shared-memory stages a helper, the first issued at kernel entry. Each
//    lane copies and then reads only its own chunks (4 consecutive bins, 4
//    chunks a plane), so a stage needs cp.async.wait_group and no barrier.
//    The same chunks give ring' rows 0..P-2, stored as coalesced float4 in
//    natural bin order. Helper 0 also copies H[0].
// 3. Each helper stores its sum, and helper 0 H[0], in rows padded by
//    max(T, 4) floats, so warp 0's 32 lanes read their bins from distinct
//    banks (T >= 4); warp 0 puts E in such rows too. After the one block
//    barrier helper 0 stores E as ring' row P-1 (coalesced float4: from
//    warp 0, 32 scalar stores a lane in its bin order held the inverse back
//    by 0.2-0.5 us at N = 256), and warp 0 forms Y = E * H[0] + the helpers'
//    sums, takes each Y[M-k] from lane (T - tf) mod T by __shfl_sync (K11's
//    loader), runs the stages and stores the kept half of the conjugated
//    (even, odd) pairs, scaled.
//
// fire_plan below (mirrored by hopper_kernels._fire_plan) picks the helpers
// (one a kLagsPerHelper lags, 1..7), the stages a helper and the dynamic
// shared memory. The most any P = 1..kMaxP asks at an M (fire_max_bytes:
// the plans of 4 helpers x 4 stages, P = 14..17) is the kernel's opt-in.
//
// Bound on the H100: HBM bytes at large P (4CN in, 8CPK of ring and H each
// in, 8CPK of ring out, 4CK out: 402 MB at (128, 1024, P 256), 0.12 ms at
// 3.35 TB/s); at the Zero preset's (C = 128, N = 256, P = 3) 1.4 MB, and at
// (128, 1024, 3) 5.5 MB, far below a launch's own time: there warp 0's
// chain of dependent steps bounds it (at (128, 256, P 3): the launch ~0.9 us,
// the frames' load ~0.7, the forward to the barrier, then the MAC, inverse
// and store ~1.2; tools/fire_layouts.py's measurement variants).
#include <cstdint>

#include "reg_fft.cuh"

namespace {

using hst_reg::kR;
using hst_reg::pad;

constexpr int kLanes = 32;                  // a frame group: one warp's lanes
constexpr int kGroupFloats = kLanes * kR;   // F * M = 512: a group's plane row
constexpr int kChunks = kGroupFloats / 4;   // 16-byte chunks of a plane row
constexpr int kLaneChunks = kChunks / kLanes;
constexpr int kPlanes = 4;                  // a stage: ring re, ring im, H re, H im
constexpr int kMaxHelpers = 7;              // helper warps (256 threads with warp 0)
constexpr int kLagsPerHelper = 4;           // the plan adds a helper a this many lags
constexpr int kMaxStages = 4;               // stages a helper
constexpr int kStageBudget = 16;            // helpers x stages: 128 KB a block
constexpr int kMaxP = 256;                  // partitions (hop_fire_eligible)

struct FirePlan {
  int helpers, stages;
  int bytes;  // dynamic shared memory
};

// The plan of one firing at complex size M = 2^log_m with P partitions.
FirePlan fire_plan(int log_m, int p) {
  const int m = 1 << log_m, t = m / kR, f = kLanes / t;
  const int lags = p - 1;
  int h = (lags + kLagsPerHelper - 1) / kLagsPerHelper;
  h = h < 1 ? 1 : h > kMaxHelpers ? kMaxHelpers : h;
  const int per = (lags + h - 1) / h;
  int s = per < kMaxStages ? per : kMaxStages;
  if (s > kStageBudget / h) s = kStageBudget / h;
  const int fin = f * (m + (t > 4 ? t : 4));  // a plane of padded rows
  const int floats = (h + 2) * 2 * fin + h * s * kPlanes * kGroupFloats;
  return FirePlan{h, s, 4 * floats + 8 * (f * (m + m / 16) + m)};
}

// The most dynamic shared memory a firing at M = 2^log_m asks, over P.
int fire_max_bytes(int log_m) {
  int most = 0;
  for (int p = 1; p <= kMaxP; ++p) {
    const int b = fire_plan(log_m, p).bytes;
    most = b > most ? b : most;
  }
  return most;
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n (< kMaxStages) of the thread's groups are pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

__device__ __forceinline__ void st4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <int LOG_M, bool kPairs>
__global__ void __launch_bounds__(kLanes*(1 + kMaxHelpers))
hop_fire_kernel(const float* __restrict__ frame, long long frame_cs,
                const float* __restrict__ rin_re, const float* __restrict__ rin_im,
                const float* __restrict__ h_re, const float* __restrict__ h_im,
                long long h_cs, float* __restrict__ rout_re, float* __restrict__ rout_im,
                float* __restrict__ y, const float2* __restrict__ tw, long long channels,
                int p, int stages, float scale) {
  using P = hst_reg::Plan<LOG_M>;
  constexpr int M = P::kM, T = P::kT, F = kLanes / T;
  static_assert(T <= kLanes && F * M == kGroupFloats, "a frame group is one warp");
  constexpr int kLdFin = M + (T > 4 ? T : 4);  // a frame's padded row
  constexpr int kFin = F * kLdFin;             // a plane of padded rows
  extern __shared__ __align__(16) float smem[];
  const int helpers = blockDim.x / kLanes - 1;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* h0 = smem;                     // H[0] re, im in padded rows
  float* erow = h0 + 2 * kFin;          // E re, im in padded rows (ring' row P-1)
  float* sums = erow + 2 * kFin;        // each helper's sum re, im in padded rows
  float* stage0 = sums + helpers * 2 * kFin;
  float2* fb = reinterpret_cast<float2*>(stage0 + helpers * stages * kPlanes * kGroupFloats);
  float2* stw = fb + F * P::kLd;
  const long long c0 = (long long)blockIdx.x * F;

  if (warp > 0) {  // helper h = warp - 1: the old ring's lags h, h + H, ...
    const int hw = warp - 1, lags = p - 1;
    float* stage = stage0 + hw * stages * kPlanes * kGroupFloats;
    // Lane chunk j: bins b..b+3 of frame e >> LOG_M, at e of a plane row.
    int ce[kLaneChunks], cb[kLaneChunks], co[kLaneChunks];
    long long cch[kLaneChunks];
    bool clive[kLaneChunks];
#pragma unroll
    for (int j = 0; j < kLaneChunks; ++j) {
      ce[j] = 4 * (lane + kLanes * j);
      cb[j] = ce[j] & (M - 1);
      co[j] = (ce[j] >> LOG_M) * kLdFin + cb[j];
      cch[j] = c0 + (ce[j] >> LOG_M);
      clive[j] = cch[j] < channels;
    }
    // Lag item s (ring row s+1, H row P-1-s) into the stage at st.
    auto issue = [&](int s, float* st) {
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        const long long ch = clive[j] ? cch[j] : 0;
        const long long r = (ch * p + s + 1) * M + cb[j];
        const long long h = ch * h_cs + (long long)(p - 1 - s) * M + cb[j];
        copy16(st + ce[j], rin_re + r, clive[j]);
        copy16(st + kGroupFloats + ce[j], rin_im + r, clive[j]);
        copy16(st + 2 * kGroupFloats + ce[j], h_re + h, clive[j]);
        copy16(st + 3 * kGroupFloats + ce[j], h_im + h, clive[j]);
      }
    };
    if (hw == 0) {
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        const long long h = (clive[j] ? cch[j] : 0) * h_cs + cb[j];
        copy16(h0 + co[j], h_re + h, clive[j]);
        copy16(h0 + kFin + co[j], h_im + h, clive[j]);
      }
      commit();
    }
    for (int i = 0; i < stages; ++i) {
      const int s = hw + helpers * i;
      if (s < lags) issue(s, stage + i * kPlanes * kGroupFloats);
      commit();
    }
    float ar[4 * kLaneChunks], ai[4 * kLaneChunks];
#pragma unroll
    for (int i = 0; i < 4 * kLaneChunks; ++i) ar[i] = ai[i] = 0.f;
    for (int i = 0, s = hw; s < lags; ++i, s += helpers) {
      float* st = stage + (i % stages) * kPlanes * kGroupFloats;
      wait_pending(stages - 1);
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        const float4 vr = ld4(st + ce[j]), vi = ld4(st + kGroupFloats + ce[j]);
        const float4 hr = ld4(st + 2 * kGroupFloats + ce[j]);
        const float4 hi = ld4(st + 3 * kGroupFloats + ce[j]);
        if (clive[j]) {  // ring' row s
          const long long r = (cch[j] * p + s) * M + cb[j];
          st4(rout_re + r, vr);
          st4(rout_im + r, vi);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = at(vr, q), b = at(vi, q), c = at(hr, q), d = at(hi, q);
          if (q == 0 && cb[j] == 0) {  // the (DC, Nyquist) lane: two real products
            ar[4 * j] += a * c;
            ai[4 * j] += b * d;
          } else {
            ar[4 * j + q] += a * c - b * d;
            ai[4 * j + q] += a * d + b * c;
          }
        }
      }
      // The stage's reads are consumed above (in-order issue), so it refills.
      if (s + helpers * stages < lags) issue(s + helpers * stages, st);
      commit();
    }
    float* sw = sums + hw * 2 * kFin;
#pragma unroll
    for (int j = 0; j < kLaneChunks; ++j) {
      st4(sw + co[j], make_float4(ar[4 * j], ar[4 * j + 1], ar[4 * j + 2], ar[4 * j + 3]));
      st4(sw + kFin + co[j],
          make_float4(ai[4 * j], ai[4 * j + 1], ai[4 * j + 2], ai[4 * j + 3]));
    }
    wait_pending(0);  // H[0]
    __syncthreads();
    if (hw == 0) {  // ring' row P-1 = E, from warp 0's rows, as float4
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        if (!clive[j]) continue;
        const long long r = (cch[j] * p + p - 1) * M + cb[j];
        st4(rout_re + r, ld4(erow + co[j]));
        st4(rout_im + r, ld4(erow + kFin + co[j]));
      }
    }
    return;
  }

  // Warp 0: the frames' forward, while the helpers sum the lags.
  const int f = lane / T, tf = lane % T;
  const long long ch = c0 + f;
  const bool live = ch < channels;
  float2* fbf = fb + f * P::kLd;
  float2 v[kR];
  {
    const float* x = frame + (live ? ch : 0) * frame_cs;
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int i = tf + m * T;
      float2 z = make_float2(0.f, 0.f);
      if (live) {
        if constexpr (kPairs) {
          z = __ldg(reinterpret_cast<const float2*>(x) + i);
        } else {
          z = make_float2(__ldg(x + 2 * i), __ldg(x + 2 * i + 1));
        }
      }
      v[m] = z;
    }
  }
  for (int i = lane; i < M; i += kLanes) stw[i] = __ldg(&tw[i]);
  __syncwarp();
  hst_reg::Stages<LOG_M>::run(v, fbf, tf, stw);
  float2 e[kR];  // E at bins k = tf + T*m, also into erow for helper 0's store
  const int fr = f * kLdFin;
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    const int k = tf + m * T;
    const float2 zk = fbf[pad(k)];
    e[m] = k == 0 ? hst_smem::pack_bin0(zk)
                  : hst_smem::pack_bin(zk, fbf[pad(M - k)], stw[k]);
    erow[fr + k] = e[m].x;
    erow[kFin + fr + k] = e[m].y;
  }
  __syncthreads();

  // Y = E * H[0] + the helpers' sums.
  float2 yv[kR];
  {
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int k = tf + m * T;
      yv[m] = make_float2(sums[fr + k], sums[kFin + fr + k]);
    }
    for (int h = 1; h < helpers; ++h) {
      const float* sh = sums + h * 2 * kFin + fr;
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const int k = tf + m * T;
        yv[m].x += sh[k];
        yv[m].y += sh[kFin + k];
      }
    }
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int k = tf + m * T;
      const float hr = h0[fr + k], hi = h0[kFin + fr + k];
      yv[m] = k == 0 ? make_float2(e[m].x * hr + yv[m].x, e[m].y * hi + yv[m].y)
                     : make_float2(e[m].x * hr - e[m].y * hi + yv[m].x,
                                   e[m].x * hi + e[m].y * hr + yv[m].y);
    }
  }

  // The inverse (K11's loader): bin M - k of slot m is slot 15 - m of lane
  // (T - tf) mod T of the frame (tf = 0: its own slot 16 - m).
  auto unpack = [&](int m, float2 q) {
    const int k = tf + m * T;
    return k == 0 ? hst_smem::unpack_bin0(yv[m]) : hst_smem::unpack_bin(yv[m], q, stw[k]);
  };
  const int src = (T - tf) & (T - 1);
#pragma unroll
  for (int m = 0; m < kR / 2; ++m) {
    const int o = kR - 1 - m;
    float2 qm = yv[o], qo = yv[m];
    if constexpr (T > 1) {
      qm = make_float2(__shfl_sync(0xffffffffu, yv[o].x, src, T),
                       __shfl_sync(0xffffffffu, yv[o].y, src, T));
      qo = make_float2(__shfl_sync(0xffffffffu, yv[m].x, src, T),
                       __shfl_sync(0xffffffffu, yv[m].y, src, T));
    }
    if (tf == 0) {
      qm = yv[(kR - m) % kR];
      qo = yv[m + 1];
    }
    v[m] = unpack(m, qm);
    v[o] = unpack(o, qo);
  }
  hst_reg::Stages<LOG_M>::run(v, fbf, tf, stw);
  if (!live) return;
  // Kept half: points n = tf + T*m >= M/2 (m >= 8) are samples
  // (2n - M, 2n + 1 - M) of y, scale * conj.
  float2* out = reinterpret_cast<float2*>(y) + ch * (M / 2);
#pragma unroll
  for (int m = kR / 2; m < kR; ++m) {
    const int n = tf + m * T;
    const float2 z = fbf[pad(n)];
    out[n - M / 2] = make_float2(scale * z.x, -scale * z.y);
  }
}

template <int LOG_M, bool kPairs>
int launch_m(const float* frame, long long frame_cs, const float* rin_re,
             const float* rin_im, const float* h_re, const float* h_im, long long h_cs,
             float* rout_re, float* rout_im, float* y, const float2* tw,
             long long channels, int p, float scale, cudaStream_t stream) {
  auto kernel = hop_fire_kernel<LOG_M, kPairs>;
  constexpr int F = kLanes / hst_reg::Plan<LOG_M>::kT;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fire_max_bytes(LOG_M));
  if (attr != cudaSuccess) return (int)attr;
  const FirePlan pl = fire_plan(LOG_M, p);
  const unsigned blocks = (unsigned)((channels + F - 1) / F);
  kernel<<<blocks, kLanes * (1 + pl.helpers), pl.bytes, stream>>>(
      frame, frame_cs, rin_re, rin_im, h_re, h_im, h_cs, rout_re, rout_im, y, tw, channels,
      p, pl.stages, scale);
  return (int)cudaGetLastError();
}

template <bool kPairs>
int launch(const float* frame, long long frame_cs, const float* rin_re, const float* rin_im,
           const float* h_re, const float* h_im, long long h_cs, float* rout_re,
           float* rout_im, float* y, const float2* tw, long long channels, int p, int n,
           float scale, cudaStream_t s) {
#define HST_FIRE_CASE(LM)                                                                  \
  case LM:                                                                                 \
    return launch_m<LM, kPairs>(frame, frame_cs, rin_re, rin_im, h_re, h_im, h_cs, rout_re, \
                                rout_im, y, tw, channels, p, scale, s);
  switch (hst_reg::log2_c(n) - 1) {
    HST_FIRE_CASE(4)
    HST_FIRE_CASE(5)
    HST_FIRE_CASE(6)
    HST_FIRE_CASE(7)
    HST_FIRE_CASE(8)
    HST_FIRE_CASE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef HST_FIRE_CASE
}

}  // namespace

// frame: channel c's N floats at frame + c * frame_cstride (any alignment);
// rin_*, rout_*: (channels, P, N/2) contiguous, 16-byte aligned; h_*: row q of
// channel c at h + c * h_cstride + q * N/2 (h_cstride a multiple of 4, 0:
// broadcast; 16-byte aligned); y: (channels, N/2).
extern "C" int hst_hop_fire(const float* frame, long long frame_cstride,
                            const float* rin_re,
                            const float* rin_im, const float* h_re,
                            const float* h_im, long long h_cstride,
                            float* rout_re, float* rout_im, float* y,
                            const void* tw, long long channels, int p, int n,
                            float scale, void* stream) {
  if (n != (n & -n) || n < 32 || n > 1024 || p < 1 || p > kMaxP)
    return (int)cudaErrorInvalidValue;
  const bool pairs = (reinterpret_cast<uintptr_t>(frame) & 7) == 0 && frame_cstride % 2 == 0;
  const float2* tw2 = static_cast<const float2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pairs ? launch<true>(frame, frame_cstride, rin_re, rin_im, h_re, h_im, h_cstride,
                              rout_re, rout_im, y, tw2, channels, p, n, scale, s)
               : launch<false>(frame, frame_cstride, rin_re, rin_im, h_re, h_im, h_cstride,
                               rout_re, rout_im, y, tw2, channels, p, n, scale, s);
}
