// The ring MAC (csrc/ring_mac.cu): one kernel behind K7 lag_mac_ring, K15
// lag_mac and K8's state kernel. Per channel, over rows V[0 .. P+T) of K
// packed bins,
//   Y_t = sum_{q < P} V[P + t - 1 - q] * H_q  (+ V[P + t] * L0),   t < T,
// and, where asked, the new ring V[T .. T+P) (oldest-first). V row u comes
// from the first source for u < s_rows and from the second after it; each
// source, H and L0 has its own channel stride (0: one plane for every
// channel). Rows are K floats apart in every plane.
#pragma once

#include <cuda_runtime.h>

namespace hst {

struct RingMac {
  const float* sr;   // V rows u < s_rows: re, im; channels s_cs floats apart
  const float* si;
  long long s_cs;
  int s_rows;
  const float* xr;   // V rows u >= s_rows, from row 0; channels x_cs apart
  const float* xi;
  long long x_cs;
  const float* hr;   // (C, P, K) H, channels h_cs apart
  const float* hi;
  long long h_cs;
  const float* l0r;  // optional (C, K) lag-0 spectrum (null: none), l0_cs apart
  const float* l0i;
  long long l0_cs;
  float* yr;         // (C, T, K) Y, contiguous
  float* yi;
  float* nr;         // optional (C, P, K) new ring, contiguous (null: none)
  float* ni;
  long long channels;
  int t, p, k;
};

// Launches the ring MAC on `st`. K = 16, 32, 64, 128 or a multiple of 256;
// T, P >= 1; every plane's start and channel stride 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not serve.
int launch_ring_mac(const RingMac& a, cudaStream_t st);

// The matrix form, a kernel of its own: `a.channels` = M outputs over
// `inputs` = N inputs, each output the sum over the inputs,
//   Y_m,t = sum_n [ sum_{q < P} V_n[P + t - 1 - q] * H_m,n,q  (+ V_n[P + t] * L0_m,n) ].
// V_n comes from the sources at input n (s_cs / x_cs floats apart an input),
// H and L0 of the pair (m, n) at channel m * N + n (h_cs / l0_cs apart), Y is
// (M, T, K) and the new ring (N, P, K), one an input. K a multiple of 128;
// T, P >= 1; alignment as launch_ring_mac.
int launch_ring_mac_matrix(const RingMac& a, int inputs, cudaStream_t st);

}  // namespace hst
