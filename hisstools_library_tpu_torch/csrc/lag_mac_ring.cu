// K7 and K15: the partition MAC over rows V of one channel,
//   Y_t = sum_{p < P} V[P + t - 1 - p] * H_p,   t < T,
// as packed complex products. The packed bin-0 lane (DC in re, Nyquist in
// im) multiplies two real values independently: re = sum v.re*h.re,
// im = sum v.im*h.im.
//
// K7 (streaming, hst_lag_mac_ring): V = [hist (P rows) | X (T rows)], read
// in place from the two sources, and the new ring V[T : T + P]
// (oldest-first) written to its own buffer (it never aliases hist).
// Replaces hisstools_library_tpu/fft/pallas_kernels.py: lag_mac_ring
// (_lag_mac_ring_kernel), which stages V contiguously in VMEM and patches bin
// 0 afterwards in XLA; here bin 0 is handled in the kernel as in K3.
//
// K15 (zero-padded, hst_lag_mac): V = xpad[S :] of (C, S + T + P, K)
// spectra, S = lead_skip leading rows ignored; no ring out. Replaces
// hisstools_library_tpu/fft/pallas_kernels.py: lag_mac (_lag_mac_kernel),
// whose (channel, bin-tile) block must fit VMEM (lag_mac_fits); any T and P
// here.
//
// Bound on the H100: HBM bytes. K7 reads H and hist (8*C*P*K each) and X
// (8*C*T*K) and writes Y (8*C*T*K) and the new ring (8*C*P*K): 1.7 GB at both
// the two-tier far shape (C = 128, T = 4, P = 14, K = 32768) and the
// collapsed shape (128, 16, 58, 8192). K15 reads V (8*C*(T+P)*K) and H
// (8*C*P*K) and writes Y: ~0.2 GB at the staged FastFIR's (C = 128, T = 48,
// P = 47, K = 1024). One thread owns one (channel, bin) column: neighbouring
// threads touch neighbouring bins (coalesced) and no two threads share an
// output. A thread keeps TU <= 16 output rows in registers and slides a
// window of TU V rows down the lags, so each lag costs one V load and one H
// load for TU complex MACs (re-reading V and H once per output row instead
// put 15.6 GB through L1/L2 at the collapsed shape). H may be a row slice or
// a channel-broadcast view (channels h_cstride floats apart).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Rows of one channel's V: the first s_rows from s (channels s_cs floats
// apart), the rest from x (channels x_cs apart); rows K floats apart.
struct Rows {
  const float* sr;
  const float* si;
  long long s_cs;
  int s_rows;
  const float* xr;
  const float* xi;
  long long x_cs;
};

template <int TU>
__global__ void __launch_bounds__(kThreads)
lag_mac_kernel(Rows v, const float* __restrict__ hr, const float* __restrict__ hi,
               long long h_cstride, float* __restrict__ yr, float* __restrict__ yi,
               float* __restrict__ nr, float* __restrict__ ni, long long channels,
               int t, int p, int k) {
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= channels * k) return;
  const long long ch = col / k;
  const int bin = (int)(col - ch * k);
  const long long so = ch * v.s_cs + bin;  // s row 0 of this column
  const long long xo = ch * v.x_cs + bin;  // x row 0
  const long long yo = ch * t * (long long)k + bin;
  const long long ho = ch * h_cstride + bin;
  const bool lane0 = bin == 0;
  // V row r of this column.
  auto load = [&](int r, float& a, float& b) {
    if (r < v.s_rows) {
      a = __ldg(&v.sr[so + (long long)r * k]);
      b = __ldg(&v.si[so + (long long)r * k]);
    } else {
      a = __ldg(&v.xr[xo + (long long)(r - v.s_rows) * k]);
      b = __ldg(&v.xi[xo + (long long)(r - v.s_rows) * k]);
    }
  };
  for (int t0 = 0; t0 < t; t0 += TU) {
    // Window: wr/wi[u] = V[P - 1 - q + t0 + u] at lag q.
    float wr[TU], wi[TU], ar[TU], ai[TU];
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      ar[u] = 0.f;
      ai[u] = 0.f;
      wr[u] = 0.f;
      wi[u] = 0.f;
      if (t0 + u < t) load(p - 1 + t0 + u, wr[u], wi[u]);
    }
    for (int q = 0; q < p; ++q) {
      const float c = __ldg(&hr[ho + (long long)q * k]);
      const float d = __ldg(&hi[ho + (long long)q * k]);
      if (lane0) {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          ar[u] += wr[u] * c;
          ai[u] += wi[u] * d;
        }
      } else {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          ar[u] += wr[u] * c - wi[u] * d;
          ai[u] += wr[u] * d + wi[u] * c;
        }
      }
      if (q + 1 < p) {
#pragma unroll
        for (int u = TU - 1; u > 0; --u) {
          wr[u] = wr[u - 1];
          wi[u] = wi[u - 1];
        }
        load(p - 2 - q + t0, wr[0], wi[0]);
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (t0 + u < t) {
        yr[yo + (long long)(t0 + u) * k] = ar[u];
        yi[yo + (long long)(t0 + u) * k] = ai[u];
      }
    }
  }
  if (nr == nullptr) return;
  const long long no = ch * p * (long long)k + bin;  // new ring, (C, P, K)
  for (int s = 0; s < p; ++s) {
    float a, b;
    load(t + s, a, b);
    nr[no + (long long)s * k] = a;
    ni[no + (long long)s * k] = b;
  }
}

// Output rows per register window: the largest power of two <= min(T, 16).
int launch(const Rows& v, const float* hr, const float* hi, long long h_cstride,
           float* yr, float* yi, float* nr, float* ni, long long channels, int t,
           int p, int k, void* stream) {
  const unsigned blocks = (unsigned)((channels * k + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HST_LAUNCH(TU)                                                       \
  lag_mac_kernel<TU><<<blocks, kThreads, 0, st>>>(v, hr, hi, h_cstride, yr, yi, \
                                                  nr, ni, channels, t, p, k)
  if (t >= 16)
    HST_LAUNCH(16);
  else if (t >= 8)
    HST_LAUNCH(8);
  else if (t >= 4)
    HST_LAUNCH(4);
  else if (t >= 2)
    HST_LAUNCH(2);
  else
    HST_LAUNCH(1);
#undef HST_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hst_lag_mac_ring(const float* sr, const float* si,
                                const float* xr, const float* xi,
                                const float* hr, const float* hi,
                                long long h_cstride, float* yr, float* yi,
                                float* nr, float* ni, long long channels,
                                int t, int p, int k, void* stream) {
  const Rows v{sr, si, (long long)p * k, p, xr, xi, (long long)t * k};
  return launch(v, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k, stream);
}

extern "C" int hst_lag_mac(const float* xr, const float* xi, const float* hr,
                           const float* hi, long long h_cstride, float* yr,
                           float* yi, long long channels, int tp, int t, int p,
                           int k, int skip, void* stream) {
  const long long cs = (long long)tp * k;
  const Rows v{xr + (long long)skip * k, xi + (long long)skip * k, cs, tp - skip,
               xr, xi, cs};
  return launch(v, hr, hi, h_cstride, yr, yi, nullptr, nullptr, channels, t, p, k,
                stream);
}
