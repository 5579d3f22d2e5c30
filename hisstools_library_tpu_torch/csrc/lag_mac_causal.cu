// K3: causal partition MAC over unpadded hop spectra.
//   Y_t = sum_{p < min(P, t)} X_{t-1-p} * H_p   (packed complex products),
// Y_0 = 0. The packed bin-0 lane (global bin 0 of each channel) holds two
// real values, DC in re and Nyquist in im, which multiply independently:
// re = sum x.re*h.re, im = sum x.im*h.im.
//
// Replaces hisstools_library_tpu/fft/pallas_kernels.py: lag_mac_causal
// (_lag_mac_causal_kernel). The TPU kernel reverses H by an exchange-matrix
// matmul because Mosaic could not lower a reversed slice; here H is indexed
// directly and that step does not exist. There is no partition-count limit.
//
// Bound on the H100: HBM bytes, 8*C*K*(2T + P) (X and H read once, Y written
// once), ~1.58 GB at the main path's C = 128, T = 16, P = 15, K = 32768; the
// 8*C*K*T*P FLOPs are ~0.5 GFLOP. One thread owns one (channel, bin) column,
// so neighbouring threads touch neighbouring bins (coalesced) and no two
// threads share an output. The column's X rows are re-read once per lag and
// are served from L1/L2 after the first read.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lag_mac_causal_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ hr, const float* __restrict__ hi,
                      float* __restrict__ yr, float* __restrict__ yi,
                      long long channels, int t, int p, int k) {
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= channels * k) return;
  const long long ch = col / k;
  const int bin = (int)(col - ch * k);
  const long long xo = ch * t * k + bin;
  const long long ho = ch * p * k + bin;
  const bool lane0 = bin == 0;
  for (int ti = 0; ti < t; ++ti) {
    float ar = 0.f, ai = 0.f;
    const int nv = ti < p ? ti : p;
    for (int q = 0; q < nv; ++q) {
      const long long xs = xo + (long long)(ti - 1 - q) * k;
      const long long hs = ho + (long long)q * k;
      const float a = __ldg(&xr[xs]), b = __ldg(&xi[xs]);
      const float c = __ldg(&hr[hs]), d = __ldg(&hi[hs]);
      if (lane0) {
        ar += a * c;
        ai += b * d;
      } else {
        ar += a * c - b * d;
        ai += a * d + b * c;
      }
    }
    yr[xo + (long long)ti * k] = ar;
    yi[xo + (long long)ti * k] = ai;
  }
}

}  // namespace

extern "C" int hst_lag_mac_causal(const float* xr, const float* xi,
                                  const float* hr, const float* hi, float* yr,
                                  float* yi, long long channels, int t, int p,
                                  int k, void* stream) {
  const long long cols = channels * k;
  const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  lag_mac_causal_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      xr, xi, hr, hi, yr, yi, channels, t, p, k);
  return (int)cudaGetLastError();
}
