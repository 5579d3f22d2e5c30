// K9: one hop-boundary firing of a small partitioned section (N = 32..1024)
// in one launch. Per channel, with the ring oldest-first (slot P-1 newest):
//   E     = rfft_packed(frame)                    (the completed [prev | cur])
//   ring' = [ring[1:] | E]                        (new slot s = old slot s+1)
//   Y     = sum_{s < P} ring'[s] * H[P-1-s]       (slot s holds lag P-1-s)
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
// what bounds its envelope (hop_fire_fits). On Hopper a frame of at most 512
// complex points (4 KB) fits shared memory whole, so no table: one block
// holds max(1, 256 / M) channels (M = N/2: one at N = 1024, two at N = 256),
// runs the forward radix-2 passes of smem_fft.cuh, packs in place, shifts
// the ring and takes the MAC from global memory (one thread per bin, the
// ring and H rows read once, the shifted ring written once), unpacks in place
// and runs the inverse passes, then stores the kept half. No VMEM model
// limits it: P <= 256 is the TPU package's unroll bound, kept for parity.
//
// Bound on the H100: the launch and the 2 log2(M) barriers of the shared
// passes. HBM traffic is 4CN in, 8CPK of ring and H each in, 8CPK of ring
// out and 4CK out (~1.4 MB at the Zero preset's (C = 128, N = 256, P = 3),
// 5.5 MB at (128, 1024, 3)).
#include "smem_fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPoints = 256;  // complex points per block, at least one row

__global__ void __launch_bounds__(kThreads)
hop_fire_kernel(const float* __restrict__ frame, long long frame_cs,
                const float* __restrict__ rin_re,
                const float* __restrict__ rin_im, const float* __restrict__ h_re,
                const float* __restrict__ h_im, long long h_cs,
                float* __restrict__ rout_re, float* __restrict__ rout_im,
                float* __restrict__ y, const float2* __restrict__ tw,
                long long channels, int p, int log_n, int rows, float scale) {
  using namespace hst_smem;
  extern __shared__ float2 a[];
  const int log_m = log_n - 1;
  const int m = 1 << log_m;  // complex points = packed bins = hop samples
  const int q = m >> 1;      // float2 per hop
  const long long c0 = (long long)blockIdx.x * rows;
  const int tid = threadIdx.x;
  const int pts = rows << log_m;

  // Frames as M complex points each, natural order; rows past the last
  // channel are zeros and never stored.
  for (int i = tid; i < pts; i += blockDim.x) {
    const long long ch = c0 + (i >> log_m);
    const float* f = frame + ch * frame_cs + 2 * (i & (m - 1));
    a[i] = ch < channels ? make_float2(f[0], f[1]) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  dif(a, log_m, rows, tw, log_n);

  // Pack in place: bin k at a[brev(k)], pairs (k, M-k) by one thread.
  for (int i = tid; i < rows * (q + 1); i += blockDim.x) {
    const int r = i / (q + 1);
    const int k = i - r * (q + 1);
    float2* ar = a + (r << log_m);
    if (k == 0) {
      ar[0] = pack_bin0(ar[0]);
      continue;
    }
    const int i1 = brev(k, log_m), i2 = brev(m - k, log_m);
    const float2 zk = ar[i1], zm = ar[i2];
    ar[i1] = pack_bin(zk, zm, __ldg(&tw[k]));
    if (k != q) ar[i2] = pack_bin(zm, zk, __ldg(&tw[m - k]));
  }
  __syncthreads();

  // Ring shift and MAC, one thread per (channel, bin).
  for (int i = tid; i < pts; i += blockDim.x) {
    const int r = i >> log_m;
    const int k = i & (m - 1);
    const long long ch = c0 + r;
    if (ch >= channels) continue;
    const int ik = (r << log_m) + brev(k, log_m);
    const float2 e = a[ik];
    const long long ro = ch * p * (long long)m + k;
    const float* hr = h_re + ch * h_cs + k;
    const float* hi = h_im + ch * h_cs + k;
    const bool lane0 = k == 0;
    float ar = 0.f, ai = 0.f;
    for (int s = 0; s < p; ++s) {
      float vr = e.x, vi = e.y;
      if (s + 1 < p) {
        vr = __ldg(&rin_re[ro + (long long)(s + 1) * m]);
        vi = __ldg(&rin_im[ro + (long long)(s + 1) * m]);
      }
      rout_re[ro + (long long)s * m] = vr;
      rout_im[ro + (long long)s * m] = vi;
      const float hc = __ldg(&hr[(long long)(p - 1 - s) * m]);
      const float hd = __ldg(&hi[(long long)(p - 1 - s) * m]);
      if (lane0) {
        ar += vr * hc;
        ai += vi * hd;
      } else {
        ar += vr * hc - vi * hd;
        ai += vr * hd + vi * hc;
      }
    }
    a[ik] = make_float2(ar, ai);
  }
  __syncthreads();

  // Unpack in place for the inverse (conjugated), then DIT.
  for (int i = tid; i < rows * (q + 1); i += blockDim.x) {
    const int r = i / (q + 1);
    const int k = i - r * (q + 1);
    float2* ar = a + (r << log_m);
    if (k == 0) {
      ar[0] = unpack_bin0(ar[0]);
      continue;
    }
    const int i1 = brev(k, log_m), i2 = brev(m - k, log_m);
    const float2 pk = ar[i1], pm = ar[i2];
    ar[i1] = unpack_bin(pk, pm, __ldg(&tw[k]));
    if (k != q) ar[i2] = unpack_bin(pm, pk, __ldg(&tw[m - k]));
  }
  __syncthreads();
  dit(a, log_m, rows, tw, log_n);

  // Kept half: samples (2k - M, 2k + 1 - M) = scale * conj(a[k]), k >= M/2.
  float2* y2 = reinterpret_cast<float2*>(y);
  for (int i = tid; i < rows * q; i += blockDim.x) {
    const int r = i / q;
    const int k = q + (i - r * q);
    const long long ch = c0 + r;
    if (ch >= channels) continue;
    const float2 v = a[(r << log_m) + k];
    y2[ch * q + (k - q)] = make_float2(scale * v.x, -scale * v.y);
  }
}

}  // namespace

extern "C" int hst_hop_fire(const float* frame, long long frame_cstride,
                            const float* rin_re,
                            const float* rin_im, const float* h_re,
                            const float* h_im, long long h_cstride,
                            float* rout_re, float* rout_im, float* y,
                            const void* tw, long long channels, int p, int n,
                            float scale, void* stream) {
  int log_n = 0;
  while ((1 << (log_n + 1)) <= n) ++log_n;
  const int m = n / 2;
  const int rows = m >= kBlockPoints ? 1 : kBlockPoints / m;
  const unsigned blocks = (unsigned)((channels + rows - 1) / rows);
  const int smem = rows * m * (int)sizeof(float2);
  hop_fire_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frame, frame_cstride, rin_re, rin_im, h_re, h_im, h_cstride, rout_re, rout_im, y,
      static_cast<const float2*>(tw), channels, p, log_n, rows, scale);
  return (int)cudaGetLastError();
}
