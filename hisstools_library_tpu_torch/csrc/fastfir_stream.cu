// K8: one streaming process_block of the overlap-save chain, N = 2^14..2^17.
// Per channel, for each hop t of its (T, H) blocks, with the carried block
// x[-1] = prev and the carried ring (oldest-first: slot s holds X_{s-P}):
//   X_t = rfft_packed([x[t-1] | x[t]])
//   Y_t = sum_{lag < P} X_{t-1-lag} * H_lag  (+ X_t * L0, the lag-0 term)
//   y_t = scale * rifft(Y_t)[H:]
// and the new ring, oldest-first: slot s holds X_{T-P+s} (the old ring's
// slot T+s where T-P+s < 0). Packed products; the bin-0 lane (DC in re,
// Nyquist in im) multiplies two real values.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: fastfir_chain_stream
// (:1943, _fastfir_stream_kernel), which keeps each channel's ring and H in
// VMEM and runs the hop's DFTs as matmuls. On Hopper the state of one
// channel (3 P spectra: ring in, H, ring out; 12 MB at N = 2^17, P = 8) is
// far beyond a block, and the ring is carried state that the ring MAC (K7),
// the block -> stream hand-offs and the numpy state converters read in
// natural bin order. So the chain runs as three launches on one stream, each
// moving its bytes once, coalesced, in natural bin order:
//   1. the forward transform of every frame [x[t-1] | x[t]] in one HBM pass
//      (fft_large.cuh's fft_onepass on K1's plan: one block a frame at
//      N = 2^14, clusters of 2 / 4 / 8 blocks at 2^15 / 2^16 / 2^17), its
//      loader reading the two halves in place from x and the carried block
//      (kLoadStreamPrev): the packed X_t, (C, T, N/2) planes;
//   2. the state kernel (stream_state, below) over contiguous bin ranges of
//      each channel: Y_t and the new ring from X, the ring, H and L0;
//   3. the inverse in one HBM pass: K4's kernel (rifft_packed_tail.cu),
//      fft_onepass with the paired unpack in its column stage (kLoadUnpack,
//      each packed bin read once) and the tail store (kStoreTail: the kept
//      half [H, N), times `scale`).
//
// Bound on the H100: HBM bytes. The function must move x, prev, the ring in
// and out, H, L0 and y once: 1.78 GB at the single 2^17 section's (128, T 2,
// P 8), 0.53 ms at 3.35 TB/s. The design adds the spectra X and Y, each
// written once and read once, and reads each signal block twice (as the
// second half of its frame and the first half of the next): 2.35 GB there,
// 0.70 ms at peak; at the two-tier near tier (128, T 16, P 3, 2^14) 0.82 GB.
//
// The state kernel is memory-bound elementwise complex work (P + 1 complex
// products a bin and hop), so its design is the bytes' movement: a block
// takes kBins consecutive bins of one channel, a thread one bin, and walks
// the rows the bins need as a stream of items through a ring of kStages
// shared-memory stages, each filled by bulk asynchronous copies (1-D TMA,
// cp.async.bulk, completing on the stage's mbarrier): the chunk's X rows,
// then for each lag q the pair (H_q, V_{t0-1-q}), V the ring before hop 0
// and X after. kStages - 1 items are in flight while the block works on
// one. A thread keeps the chunk's (up to kMaxHops) accumulators and a window
// of V values in registers that slides down one hop a lag, so each row of
// H and V is read from shared memory once per chunk. Every byte of the
// ring, H and X moves once when T <= kMaxHops; a longer call re-reads H and
// the V rows once per further chunk of kMaxHops hops.
#include "fft_large.cuh"

using namespace hst;

namespace {

constexpr int kBins = 256;     // bins a block of the state kernel, one a thread
constexpr int kStages = 8;     // items in shared memory: kStages - 1 in flight
constexpr int kMaxHops = 16;   // hops a chunk: accumulators a thread
constexpr int kRowBytes = kBins * (int)sizeof(float);  // one plane's run of a row

struct State {
  const float* xr;   // (C, T, K) hop spectra X_t
  const float* xi;
  const float* rr;   // (C, P, K) carried ring, oldest-first
  const float* ri;
  const float* hr;   // (C, P, K) packed H, channels h_cs floats apart
  const float* hi;
  long long h_cs;
  const float* l0r;  // optional (C, K) lag-0 spectrum, channels l0_cs apart
  const float* l0i;
  long long l0_cs;
  float* yr;         // (C, T, K) Y_t
  float* yi;
  float* nr;         // (C, P, K) new ring, oldest-first
  float* ni;
  int t, p, k;
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"((unsigned)kRowBytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float2 mac_term(float2 v, float2 h, bool lane0) {
  return lane0 ? make_float2(v.x * h.x, v.y * h.y) : cmul(v, h);
}

// The state kernel: grid = C * (K / kBins) blocks, block (c, tile) owns bins
// b0 = tile * kBins .. b0 + kBins - 1 of channel c. TU (a power of two <=
// kMaxHops, at least min(T, kMaxHops)) hops a chunk. Items of chunk
// [t0, t0 + tc): j < tc the row X_{t0+j}; j = tc + q the pair (H_q,
// V_{t0-1-q}) with V_r = X_r for r >= 0 and the old ring's slot P + r
// before hop 0. Stage s holds item g (g mod kStages = s) as four plane runs:
// re, im of the X row or of H_q, then re, im of V.
template <int TU>
__global__ void __launch_bounds__(kBins, 2) stream_state(State a) {
  __shared__ __align__(128) float stage[kStages][4][kBins];
  __shared__ __align__(8) unsigned long long full[kStages];
  const int tiles = a.k / kBins;
  const long long c = blockIdx.x / tiles;
  const int b0 = (int)(blockIdx.x - c * tiles) * kBins;
  const int tid = threadIdx.x;
  const int t = a.t, p = a.p, k = a.k;
  const int chunks = (t + TU - 1) / TU;
  const int per_chunk = TU + p;          // items of every chunk but the last
  const int items = t + chunks * p;
  const long long xc = c * t * (long long)k + b0;   // row 0 of X (and Y) of the tile
  const long long rc = c * p * (long long)k + b0;   // slot 0 of the ring (in and out)

  // Item g into stage g mod kStages, by thread 0.
  auto issue = [&](int g) {
    const int s = g % kStages;
    const int ci = g / per_chunk;
    const int j = g - ci * per_chunk;
    const int t0 = ci * TU;
    const int tc = min(TU, t - t0);
    if (j < tc) {
      const long long o = xc + (long long)(t0 + j) * k;
      bar_expect(&full[s], 2 * kRowBytes);
      bulk_copy(stage[s][0], a.xr + o, &full[s]);
      bulk_copy(stage[s][1], a.xi + o, &full[s]);
      return;
    }
    const int q = j - tc;
    const int r = t0 - 1 - q;  // V_r
    const long long ho = c * a.h_cs + (long long)q * k + b0;
    const float* vr = r >= 0 ? a.xr + xc + (long long)r * k : a.rr + rc + (long long)(p + r) * k;
    const float* vi = r >= 0 ? a.xi + xc + (long long)r * k : a.ri + rc + (long long)(p + r) * k;
    bar_expect(&full[s], 4 * kRowBytes);
    bulk_copy(stage[s][0], a.hr + ho, &full[s]);
    bulk_copy(stage[s][1], a.hi + ho, &full[s]);
    bulk_copy(stage[s][2], vr, &full[s]);
    bulk_copy(stage[s][3], vi, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int g = 0; g < min(kStages, items); ++g) issue(g);
  }
  const int bin = b0 + tid;
  const bool lane0 = bin == 0;
  float2 l0 = make_float2(0.f, 0.f);
  if (a.l0r != nullptr) l0 = make_float2(__ldg(&a.l0r[c * a.l0_cs + bin]), __ldg(&a.l0i[c * a.l0_cs + bin]));
  __syncthreads();  // the barriers are initialised

  // Item g's values of this thread's bin (the two rows of a lag item), then
  // its stage back to thread 0 for item g + kStages.
  int g = 0;
  auto take = [&](float2& u, float2& v, bool pair) {
    const int s = g % kStages;
    bar_wait(&full[s], (unsigned)(g / kStages) & 1u);
    u = make_float2(stage[s][0][tid], stage[s][1][tid]);
    if (pair) v = make_float2(stage[s][2][tid], stage[s][3][tid]);
    __syncthreads();  // every thread has read stage s
    if (tid == 0 && g + kStages < items) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(g + kStages);
    }
    ++g;
  };

  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * TU;
    const int tc = min(TU, t - t0);
    float2 acc[TU], win[TU];
    // The chunk's X rows: win[i] = X_{t0+i}, acc[i] = X_{t0+i} * L0, and
    // X_t goes to the new ring's slot t - T + P where that is a slot.
#pragma unroll
    for (int i = 0; i < TU; ++i) {
      win[i] = make_float2(0.f, 0.f);
      acc[i] = make_float2(0.f, 0.f);
      if (i < tc) {
        float2 x, unused;
        take(x, unused, false);
        win[i] = x;
        acc[i] = mac_term(x, l0, lane0);
        const int slot = t0 + i - t + p;
        if (slot >= 0) {
          a.nr[rc + (long long)slot * k + tid] = x.x;
          a.ni[rc + (long long)slot * k + tid] = x.y;
        }
      }
    }
    // Lags: the window slides down one hop, V_{t0-1-q} enters at the top.
    for (int q = 0; q < p; ++q) {
      float2 h, v;
      take(h, v, true);
#pragma unroll
      for (int i = TU - 1; i > 0; --i) win[i] = win[i - 1];
      win[0] = v;
#pragma unroll
      for (int i = 0; i < TU; ++i) {
        const float2 d = mac_term(win[i], h, lane0);
        acc[i].x += d.x;
        acc[i].y += d.y;
      }
      // The old ring's slot P-1-q (read here, in chunk 0, once) survives as
      // the new ring's slot P-1-q-T.
      const int slot = p - 1 - q - t;
      if (ci == 0 && slot >= 0) {
        a.nr[rc + (long long)slot * k + tid] = v.x;
        a.ni[rc + (long long)slot * k + tid] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < TU; ++i) {
      if (i < tc) {
        a.yr[xc + (long long)(t0 + i) * k + tid] = acc[i].x;
        a.yi[xc + (long long)(t0 + i) * k + tid] = acc[i].y;
      }
    }
  }
}

// Hops a chunk of the state kernel for t hops: the least power of two >=
// min(t, kMaxHops) (hopper_fft._stream_plan mirrors it).
inline int chunk_hops(int t) {
  int tu = 1;
  while (tu < t && tu < kMaxHops) tu <<= 1;
  return tu;
}

int launch_state(const State& a, long long channels, cudaStream_t st) {
  if (a.k % kBins != 0 || a.t < 1 || a.p < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(channels * (a.k / kBins));
  switch (chunk_hops(a.t)) {
    case 1: stream_state<1><<<grid, kBins, 0, st>>>(a); break;
    case 2: stream_state<2><<<grid, kBins, 0, st>>>(a); break;
    case 4: stream_state<4><<<grid, kBins, 0, st>>>(a); break;
    case 8: stream_state<8><<<grid, kBins, 0, st>>>(a); break;
    default: stream_state<16><<<grid, kBins, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The transforms' plan: K1's one-pass plan at every size.
template <int LM>
using K8Pass = K1Pass<LM>;

// The forward (1) and the inverse (3) of the split chain at complex
// M = 2^LM = N/2.
template <int LM>
int transforms(bool forward, long long frames, const float* a, const float* a_im, float* out,
               float* out_im, const float2* tw, int hops, float scale, cudaStream_t st) {
  if (forward)
    return launch_onepass<K8Pass<LM>, kLoadStreamPrev, kStorePack>(frames, a, a_im, out, out_im,
                                                                   tw, LM + 1, st, hops);
  return launch_onepass<K8Pass<LM>, kLoadUnpack, kStoreTail>(frames, a, a_im, out, nullptr, tw,
                                                             LM + 1, st, 1, scale);
}

int transform(int n, bool forward, long long frames, const float* a, const float* a_im,
              float* out, float* out_im, const float2* tw, int hops, float scale,
              cudaStream_t st) {
  switch (ilog2(n) - 1) {
    case 13: return transforms<13>(forward, frames, a, a_im, out, out_im, tw, hops, scale, st);
    case 14: return transforms<14>(forward, frames, a, a_im, out, out_im, tw, hops, scale, st);
    case 15: return transforms<15>(forward, frames, a, a_im, out, out_im, tw, hops, scale, st);
    case 16: return transforms<16>(forward, frames, a, a_im, out, out_im, tw, hops, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The state kernel alone: X (C, T, K) planes, ring (C, P, K) in and out
// (oldest-first), H (C, P, K) and the optional lag-0 L0 (C, K), channels
// h_cs / l0_cs floats apart; Y (C, T, K). K a multiple of 256; every plane
// 16-byte aligned.
extern "C" int hst_stream_state(const float* xr, const float* xi, const float* rr,
                                const float* ri, const float* hr, const float* hi, long long h_cs,
                                const float* l0r, const float* l0i, long long l0_cs, float* yr,
                                float* yi, float* nr, float* ni, long long channels, int t, int p,
                                int k, void* stream) {
  const State a{xr, xi, rr, ri, hr, hi, h_cs, l0r, l0i, l0_cs, yr, yi, nr, ni, t, p, k};
  return launch_state(a, channels, static_cast<cudaStream_t>(stream));
}

// One K8 call, three launches on `stream`: x (C, T, H) hops, prev (C, H),
// ring (C, P, N/2) in and out, H and L0 as hst_stream_state takes them, y
// (C, T, H). `spectra` holds four (C*T, N/2) planes: X re, X im, Y re, Y im.
// N = 2^14..2^17.
extern "C" int hst_fastfir_stream(const float* x, const float* prev, const float* rin_re,
                                  const float* rin_im, const float* h_re, const float* h_im,
                                  long long h_cs, const float* l0_re, const float* l0_im,
                                  long long l0_cs, float* y, float* rout_re, float* rout_im,
                                  float* spectra, const void* tw, long long channels, int t,
                                  int p, int n, float scale, void* stream) {
  if (n < (1 << 14) || n > (1 << 17)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = static_cast<const float2*>(tw);
  const long long frames = channels * t;
  const int k = n / 2;
  float* xr = spectra;
  float* xi = xr + frames * k;
  float* yr = xi + frames * k;
  float* yi = yr + frames * k;
  int rc = transform(n, true, frames, x, prev, xr, xi, w, t, 1.f, st);
  if (rc != 0) return rc;
  const State a{xr, xi, rin_re, rin_im, h_re, h_im, h_cs, l0_re, l0_im, l0_cs,
                yr, yi, rout_re, rout_im, t, p, k};
  rc = launch_state(a, channels, st);
  if (rc != 0) return rc;
  return transform(n, false, frames, yr, yi, y, nullptr, w, 1, scale, st);
}
