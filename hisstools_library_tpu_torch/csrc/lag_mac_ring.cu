// K7: streaming partition MAC with in-place ring reads.
//   V = [hist (P rows) | X (T rows)],   Y_t = sum_{p < P} V[P + t - 1 - p] * H_p,
//   new ring = V[T : T + P] (oldest-first),
// as packed complex products. The packed bin-0 lane (DC in re, Nyquist in
// im) multiplies two real values independently: re = sum v.re*h.re,
// im = sum v.im*h.im.
//
// Replaces hisstools_library_tpu/fft/pallas_kernels.py: lag_mac_ring
// (_lag_mac_ring_kernel). The TPU kernel stages V contiguously in VMEM and
// patches bin 0 afterwards in XLA; here V's rows are read in place from the
// two sources (no concatenation), bin 0 is handled in the kernel as in K3, and
// the new ring is written to its own buffer (it never aliases hist).
//
// Bound on the H100: HBM bytes. Read H and hist (8*C*P*K each) and X
// (8*C*T*K), write Y (8*C*T*K) and the new ring (8*C*P*K): 8*C*K*(3P + 2T),
// 1.7 GB at both the two-tier far shape (C = 128, T = 4, P = 14, K = 32768)
// and the collapsed shape (128, 16, 58, 8192). One thread owns one
// (channel, bin) column: neighbouring threads touch neighbouring bins
// (coalesced) and no two threads share an output. A thread keeps TU <= 16
// output rows in registers and slides a window of TU V rows down the lags, so
// each lag costs one V load and one H load for TU complex MACs (re-reading V
// and H once per output row instead put 15.6 GB through L1/L2 at the
// collapsed shape).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int TU>
__global__ void __launch_bounds__(kThreads)
lag_mac_ring_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                    const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ hr, const float* __restrict__ hi,
                    long long h_cstride, float* __restrict__ yr,
                    float* __restrict__ yi, float* __restrict__ nr,
                    float* __restrict__ ni, long long channels, int t, int p,
                    int k) {
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= channels * k) return;
  const long long ch = col / k;
  const int bin = (int)(col - ch * k);
  const long long so = ch * p * k + bin;  // hist row 0 of this column
  const long long xo = ch * t * k + bin;  // X row 0
  const long long ho = ch * h_cstride + bin;
  const bool lane0 = bin == 0;
  // V row r of this column.
  auto load = [&](int r, float& a, float& b) {
    if (r < p) {
      a = __ldg(&sr[so + (long long)r * k]);
      b = __ldg(&si[so + (long long)r * k]);
    } else {
      a = __ldg(&xr[xo + (long long)(r - p) * k]);
      b = __ldg(&xi[xo + (long long)(r - p) * k]);
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
        yr[xo + (long long)(t0 + u) * k] = ar[u];
        yi[xo + (long long)(t0 + u) * k] = ai[u];
      }
    }
  }
  for (int s = 0; s < p; ++s) {
    float a, b;
    load(t + s, a, b);
    nr[so + (long long)s * k] = a;
    ni[so + (long long)s * k] = b;
  }
}

template <int TU>
void launch(unsigned blocks, cudaStream_t st, const float* sr, const float* si,
            const float* xr, const float* xi, const float* hr, const float* hi,
            long long h_cstride, float* yr, float* yi, float* nr, float* ni,
            long long channels, int t, int p, int k) {
  lag_mac_ring_kernel<TU><<<blocks, kThreads, 0, st>>>(
      sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
}

}  // namespace

extern "C" int hst_lag_mac_ring(const float* sr, const float* si,
                                const float* xr, const float* xi,
                                const float* hr, const float* hi,
                                long long h_cstride, float* yr, float* yi,
                                float* nr, float* ni, long long channels,
                                int t, int p, int k, void* stream) {
  const long long cols = channels * k;
  const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Output rows per register window: the largest power of two <= min(T, 16).
  if (t >= 16)
    launch<16>(blocks, st, sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
  else if (t >= 8)
    launch<8>(blocks, st, sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
  else if (t >= 4)
    launch<4>(blocks, st, sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
  else if (t >= 2)
    launch<2>(blocks, st, sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
  else
    launch<1>(blocks, st, sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k);
  return (int)cudaGetLastError();
}
