// K16: the per-bin function of two packed real spectra, in one HBM pass.
//
//   conv    out = a * b * scale                                  (ir_convolve_real)
//   corr    out = a * conj(b) * scale                            (ir_correlate_real)
//   deconv  out = (a conj b) 0.25 / (|b|^2 0.25 + floor) * 2 scale  (ir_deconvolve)
//
// Operands are packed planes of K = N/2 bins a row (forward x2 scale, DC in
// re[0], Nyquist in im[0]). Lane 0 holds two independent real values: each
// is multiplied, or divided, with its partner's lane 0. In deconv the
// packed x2 scales are undone (0.25 on the product and on the power) and
// the result is the quotient's packed spectrum times ``scale``, so the
// pipeline's unpack, pack and output scale have nothing left to do. Every
// scale is a power of two, so folding it in is exact. The arithmetic is the
// plain versions' in their order, rounded at each step (__fmul_rn, __fadd_rn
// and __fsub_rn keep the compiler from contracting them into FMAs).
//
// Replaces no TPU kernel: the JAX package does these steps in jnp
// (ops/spectral.py ir_convolve_real / ir_correlate_real through
// core/types.py packed_mul, and models/pipeline.py ir_deconvolve on
// unpacked N/2 + 1 bins). Bound on the H100: HBM bytes, every input bin read
// once and every output bin written once, 8 bytes a bin and operand: at the
// sweep deconvolution's (128, 2^21) with one broadcast excitation row,
// 4.29 GB, 1.28 ms at 3.35 TB/s; at the 20 s convolution's (128, 2^20),
// 3.22 GB, 0.96 ms. A bin takes 8 to 12 FP32 operations, far below the
// ridge point.
//
// The pass: 16-byte loads and stores where K is a multiple of 4 and every
// plane is aligned (else one float a lane), a block a tile of 4096 bins of
// one row, the tiles walked row-fastest by a grid-stride loop so that the
// blocks in flight share a tile of a broadcast operand (row stride 0),
// which stays in L2 while the other operand streams past. Plain cached
// loads and stores: streaming hints (__ldcs, __stcs) were 2-4% slower at
// both path shapes (tools/bin_layouts.py).
//
// The deconvolution's floor, regularization * max_k |X_k|^2 over the N/2 + 1
// true bins of each excitation row, comes from bin_floor_kernel: one launch,
// blocks of a row fold their maxima into a per-row word by atomicMax on the
// float bits (|X|^2 >= 0, so the bits order as the values, and a NaN wins as
// torch's amax lets it), and the row's last block writes the floor and
// clears its two words, so the work buffer is zero again for the next
// launch on the stream. The division reads the floor from the device: no
// host sync.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                  // vectors a thread a tile
constexpr int kMaxGrid = 4096;              // blocks; more tiles loop
constexpr int kConv = 0, kCorr = 1, kDeconv = 2;

template <int V>
struct Lanes {
  float v[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> load(const float* p, long long i) {
  Lanes<V> out;
  if constexpr (V == 4) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    out.v[0] = t.x, out.v[1] = t.y, out.v[2] = t.z, out.v[3] = t.w;
  } else {
    out.v[0] = p[i];
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store(float* p, long long i, const Lanes<V>& x) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(p)[i] = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
    p[i] = x.v[0];
  }
}

// One bin: (ar + i ai) op (br + i bi); ``lane0`` takes DC and Nyquist apart.
template <int E>
__device__ __forceinline__ void bin(float ar, float ai, float br, float bi, float fl,
                                    float s, bool lane0, float& yr, float& yi) {
  if (lane0) {
    if constexpr (E == kDeconv) {
      yr = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(ar, br), 0.25f),
                               __fadd_rn(__fmul_rn(__fmul_rn(br, br), 0.25f), fl)), s);
      yi = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(ai, bi), 0.25f),
                               __fadd_rn(__fmul_rn(__fmul_rn(bi, bi), 0.25f), fl)), s);
    } else {
      yr = __fmul_rn(__fmul_rn(ar, br), s);
      yi = __fmul_rn(__fmul_rn(ai, bi), s);
    }
    return;
  }
  if constexpr (E == kConv) {
    yr = __fmul_rn(__fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)), s);
    yi = __fmul_rn(__fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br)), s);
  } else if constexpr (E == kCorr) {
    yr = __fmul_rn(__fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)), s);
    yi = __fmul_rn(__fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bi)), s);
  } else {
    const float d = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(br, br), __fmul_rn(bi, bi)), 0.25f), fl);
    const float nr = __fmul_rn(__fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)), 0.25f);
    const float ni = __fmul_rn(__fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bi)), 0.25f);
    yr = __fmul_rn(__fdiv_rn(nr, d), s);
    yi = __fmul_rn(__fdiv_rn(ni, d), s);
  }
}

// rows x K bins; a row's operand planes start ``*_rs`` floats apart (0: one
// row broadcast), its floor ``f_rs`` floats apart. V floats a load.
template <int E, int V>
__global__ void __launch_bounds__(kThreads)
bin_product_kernel(const float* __restrict__ ar, const float* __restrict__ ai, long long a_rs,
                   const float* __restrict__ br, const float* __restrict__ bi, long long b_rs,
                   const float* __restrict__ floors, long long f_rs,
                   float* __restrict__ yr, float* __restrict__ yi, long long rows,
                   long long k, float scale) {
  const long long kv = k / V;                              // vectors a row
  constexpr long long kTile = (long long)kThreads * kUnroll;
  const long long tiles = (kv + kTile - 1) / kTile;
  for (long long item = blockIdx.x; item < tiles * rows; item += gridDim.x) {
    const long long tile = item / rows;
    const long long row = item - tile * rows;
    const float* ra = ar + row * a_rs;
    const float* ia = ai + row * a_rs;
    const float* rb = br + row * b_rs;
    const float* ib = bi + row * b_rs;
    const float fl = E == kDeconv ? floors[row * f_rs] : 0.f;
    float* ry = yr + row * k;
    float* iy = yi + row * k;
    const long long first = tile * kTile + threadIdx.x;
    Lanes<V> xr[kUnroll], xi[kUnroll], hr[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the tile in flight first
      const long long i = first + (long long)u * kThreads;
      if (i < kv) {
        xr[u] = load<V>(ra, i), xi[u] = load<V>(ia, i);
        hr[u] = load<V>(rb, i), hi[u] = load<V>(ib, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = first + (long long)u * kThreads;
      if (i < kv) {
        Lanes<V> outr, outi;
#pragma unroll
        for (int j = 0; j < V; ++j)
          bin<E>(xr[u].v[j], xi[u].v[j], hr[u].v[j], hi[u].v[j], fl, scale, i == 0 && j == 0,
                 outr.v[j], outi.v[j]);
        store<V>(ry, i, outr);
        store<V>(iy, i, outi);
      }
    }
  }
}

// |X|^2 of packed bin i's candidates as float bits: lane 0's two real
// values apart, else re^2 + im^2.
__device__ __forceinline__ unsigned power_bits(float r, float m, bool lane0) {
  if (lane0) return max(__float_as_uint(__fmul_rn(r, r)), __float_as_uint(__fmul_rn(m, m)));
  return __float_as_uint(__fadd_rn(__fmul_rn(r, r), __fmul_rn(m, m)));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bin_floor_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long rows,
                 long long k, float reg, unsigned* __restrict__ work,
                 float* __restrict__ floors) {
  __shared__ unsigned warp_max[kThreads / 32];
  const long long kv = k / V;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* r = xr + row * k;
    const float* m = xi + row * k;
    unsigned best = 0u;
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < kv;
         i += (long long)gridDim.x * kThreads) {
      const Lanes<V> a = load<V>(r, i), b = load<V>(m, i);
#pragma unroll
      for (int j = 0; j < V; ++j) best = max(best, power_bits(a.v[j], b.v[j], i == 0 && j == 0));
    }
    best = __reduce_max_sync(0xffffffffu, best);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) best = max(best, warp_max[w]);
      atomicMax(&work[2 * row], best);
      __threadfence();
      if (atomicAdd(&work[2 * row + 1], 1u) == gridDim.x - 1) {  // the row's last block
        __threadfence();
        const unsigned peak = atomicExch(&work[2 * row], 0u);
        atomicExch(&work[2 * row + 1], 0u);
        floors[row] = __fmul_rn(reg, __fmul_rn(__uint_as_float(peak), 0.25f));
      }
    }
    __syncthreads();
  }
}

bool aligned(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <int E, int V>
void launch_product(const float* ar, const float* ai, long long a_rs, const float* br,
                    const float* bi, long long b_rs, const float* fl, long long f_rs,
                    float* yr, float* yi, long long rows, long long k, float scale,
                    cudaStream_t st) {
  const long long tiles = (k / V + (long long)kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long items = tiles * rows;
  const unsigned grid = (unsigned)(items < kMaxGrid ? items : kMaxGrid);
  bin_product_kernel<E, V><<<grid, kThreads, 0, st>>>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs,
                                                      yr, yi, rows, k, scale);
}

template <int E>
void dispatch_product(const float* ar, const float* ai, long long a_rs, const float* br,
                      const float* bi, long long b_rs, const float* fl, long long f_rs,
                      float* yr, float* yi, long long rows, long long k, float scale,
                      cudaStream_t st) {
  const bool vec = k % 4 == 0 && aligned(ar) && aligned(ai) && aligned(br) && aligned(bi) &&
                   aligned(yr) && aligned(yi);
  if (vec)
    launch_product<E, 4>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs, yr, yi, rows, k, scale, st);
  else
    launch_product<E, 1>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs, yr, yi, rows, k, scale, st);
}

}  // namespace

// epilogue: 0 conv, 1 corr, 2 deconv (``fl`` then holds a floor a b row).
extern "C" int hst_bin_product(const float* ar, const float* ai, long long a_rs,
                               const float* br, const float* bi, long long b_rs,
                               const float* fl, long long f_rs, float* yr, float* yi,
                               long long rows, long long k, int epilogue, float scale,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epilogue == kConv)
    dispatch_product<kConv>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs, yr, yi, rows, k, scale, st);
  else if (epilogue == kCorr)
    dispatch_product<kCorr>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs, yr, yi, rows, k, scale, st);
  else if (epilogue == kDeconv)
    dispatch_product<kDeconv>(ar, ai, a_rs, br, bi, b_rs, fl, f_rs, yr, yi, rows, k,
                              2.f * scale, st);  // the quotient's packed x2, exact
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ``work``: 2 x rows zero words (the wrapper's buffer for the stream; the
// launch leaves them zero).
extern "C" int hst_bin_floor(const float* xr, const float* xi, long long rows, long long k,
                             float reg, unsigned* work, float* floors, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && aligned(xr) && aligned(xi);
  const long long kv = vec ? k / 4 : k;
  long long per_row = (kv + kThreads - 1) / kThreads;      // one vector a thread
  const long long share = rows < 2048 ? 2048 / rows : 1;  // ~2048 blocks in all
  if (per_row > share) per_row = share;
  const dim3 grid((unsigned)per_row, (unsigned)(rows < 65535 ? rows : 65535));
  if (vec)
    bin_floor_kernel<4><<<grid, kThreads, 0, st>>>(xr, xi, rows, k, reg, work, floors);
  else
    bin_floor_kernel<1><<<grid, kThreads, 0, st>>>(xr, xi, rows, k, reg, work, floors);
  return (int)cudaGetLastError();
}
