// Shared-memory FFT core for the transforms whose frame fits one block
// (K12 fft_split up to 1024 points; its split-step helpers pack_bin /
// pack_bin0 and unpack_bin / unpack_bin0 also serve K10 / K10w, K11 / K11w
// and K9, which run on the register-DFT core reg_fft.cuh).
//
// A real transform of length N is an M = N/2 point complex FFT of
// z[n] = x[2n] + i x[2n+1] plus the split step that pairs bins k and M-k
// (see fft_common.cuh for the multi-pass form used above 2^15). Here the
// whole complex frame sits in shared memory, so every stage is one radix-2
// pass over shared memory with a barrier after it: dif() takes natural
// order in and leaves bit-reversed order out (decimation in frequency), and
// the caller reads Z[k] at brev(k), so no permutation pass is needed. A
// block may hold `rows` frames of M points each, back to back; the
// butterflies of all rows are spread over the block's threads.
//
// Twiddles come from one table tw[e] = exp(-2*pi*i*e/N), e < N, computed in
// float64 on the host and stored as float32 (W_M^e = tw[2e]); no fast-math
// intrinsics are used.
//
// Packed layout (HISSTools/vDSP): N/2 bins, forward scaled x2, DC in re[0],
// Nyquist in im[0]. Unscaled inverse: rifft(rfft(x)) = 2N x.
#pragma once

#include <cuda_runtime.h>

namespace hst_smem {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int brev(int k, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - bits));
}

// In-place radix-2 DIF over `rows` frames of 2^log_m points in `a`.
__device__ __forceinline__ void dif(float2* a, int log_m, int rows,
                                    const float2* __restrict__ tw, int log_n) {
  const int half_m = 1 << (log_m - 1);
  const int total = rows * half_m;
  for (int lh = log_m - 1; lh >= 0; --lh) {
    const int half = 1 << lh;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int row = b >> (log_m - 1);
      const int bb = b & (half_m - 1);
      const int j = bb & (half - 1);
      const int i0 = (row << log_m) + ((bb >> lh) << (lh + 1)) + j;
      const float2 u = a[i0];
      const float2 v = a[i0 + half];
      a[i0] = make_float2(u.x + v.x, u.y + v.y);
      const float2 d = make_float2(u.x - v.x, u.y - v.y);
      a[i0 + half] = j == 0 ? d : cmul(d, __ldg(&tw[j << (log_n - 1 - lh)]));
    }
    __syncthreads();
  }
}

// Packed bin k >= 1 of the real transform from Z[k] (zk) and Z[M-k] (zm):
// P[k] = (Z[k] + conj Z[M-k]) - i W_N^k (Z[k] - conj Z[M-k]); w = W_N^k.
__device__ __forceinline__ float2 pack_bin(float2 zk, float2 zm, float2 w) {
  const float2 sum = make_float2(zk.x + zm.x, zk.y - zm.y);
  const float2 dif = make_float2(zk.x - zm.x, zk.y + zm.y);
  const float2 wd = cmul(w, dif);
  return make_float2(sum.x + wd.y, sum.y - wd.x);
}

// Packed bin 0: DC 2(Re Z0 + Im Z0) in re, Nyquist 2(Re Z0 - Im Z0) in im.
__device__ __forceinline__ float2 pack_bin0(float2 z0) {
  return make_float2(2.f * (z0.x + z0.y), 2.f * (z0.x - z0.y));
}

// Element k >= 1 of the inverse's complex input, conjugated, from the packed
// bins P[k] (pk) and P[M-k] (pm); w = W_N^k. The forward transform of these
// elements is the conjugate of the unscaled inverse's (even, odd) pairs.
__device__ __forceinline__ float2 unpack_bin(float2 pk, float2 pm, float2 w) {
  const float2 q = make_float2(pm.x, -pm.y);
  const float2 sum = make_float2(pk.x + q.x, pk.y + q.y);
  const float2 dif = make_float2(pk.x - q.x, pk.y - q.y);
  const float2 wd = cmul(make_float2(w.x, -w.y), dif);
  return make_float2(sum.x - wd.y, -(sum.y + wd.x));
}

// Element 0 of the same, from the packed (DC, Nyquist) lane.
__device__ __forceinline__ float2 unpack_bin0(float2 p0) {
  return make_float2(p0.x + p0.y, -(p0.x - p0.y));
}

}  // namespace hst_smem
