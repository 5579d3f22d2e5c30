// K8: the whole streaming process_block of one uniform section in one
// launch. Per channel, for each hop t of its (T, H) blocks:
//   E_t = rfft_packed([x[t-1] | x[t]])            (x[-1] = the carried block)
//   Y_t = sum_{p < P} V[P + t - 1 - p] * H_p  (+ E_t * L0, the lag-0 term)
//   y_t = scale * rifft(Y_t)[H:]
// over the virtual rows V = [ring (P, oldest-first) | E_0 .. E_{T-1}], and
// the new ring V[T : T + P], oldest-first. Packed products; the bin-0 lane
// (DC in re, Nyquist in im) multiplies two real values independently.
//
// Replaces hisstools_library_tpu/fft/pallas_fft.py: fastfir_chain_stream
// (_fastfir_stream_kernel). The TPU kernel keeps each channel's ring and H in
// VMEM and runs the hop's DFTs as MXU matmuls. On Hopper the per-channel ring
// and H (P x 64 KB each at N = 2^14) do not fit shared memory, but one frame
// does: M = N/2 complex points, 64 KB at N = 2^14 and 128 KB at 2^15. So one
// block owns one channel and walks its hops in order (hop t reads the spectra
// of hops t-1 .. t-P): the forward FFT, the pack, the unpack and the inverse
// run in shared memory (smem_fft.cuh), and only the MAC reads global memory
// (ring and H rows, served from L2 after the first hop). Each new spectrum is
// written once, straight to its slot in the new ring, or, when it leaves the
// ring within this call (T > P), to a scratch row; a thread reads back only
// the bins it wrote itself, so no barrier is needed for that. Frames above
// 2^15 do not fit one block; the multi-pass form is open work.
//
// Bound on the H100: the shared-memory radix-2 passes (2 log2(M) barriers per
// hop) and one block per channel: 128 blocks for 132 SMs at the near tier's
// C = 128. HBM traffic per call is 8*C*K*(2P + 2T) bytes plus the signal in
// and out (~0.4 GB at C = 128, T = 16, P = 3, K = 8192).
#include "smem_fft.cuh"

namespace {

constexpr int kThreads = 1024;

struct Rows {
  const float* rin_re;
  const float* rin_im;
  float* rout_re;
  float* rout_im;
  float* s_re;
  float* s_im;
  long long c;
  int t, p, m;

  // Offset and planes of virtual row r of this channel.
  __device__ __forceinline__ long long at(int r, const float** re,
                                          const float** im) const {
    if (r < p) {
      *re = rin_re;
      *im = rin_im;
      return (c * p + r) * (long long)m;
    }
    if (r >= t) {
      *re = rout_re;
      *im = rout_im;
      return (c * p + r - t) * (long long)m;
    }
    *re = s_re;
    *im = s_im;
    return (c * (t - p) + r - p) * (long long)m;
  }
};

__global__ void __launch_bounds__(kThreads)
fastfir_chain_stream_kernel(const float* __restrict__ x,
                            const float* __restrict__ prev,
                            const float* __restrict__ rin_re,
                            const float* __restrict__ rin_im,
                            const float* __restrict__ h_re,
                            const float* __restrict__ h_im, long long h_cs,
                            const float* __restrict__ l0_re,
                            const float* __restrict__ l0_im, long long l0_cs,
                            float* y, float* rout_re, float* rout_im,
                            float* s_re, float* s_im,
                            const float2* __restrict__ tw, int t, int p,
                            int log_n, float scale) {
  using namespace hst_smem;
  extern __shared__ float2 a[];
  const int log_m = log_n - 1;
  const int m = 1 << log_m;  // complex points = packed bins = hop samples
  const int q = m >> 1;      // float2 per hop block
  const long long c = blockIdx.x;
  const int tid = threadIdx.x;
  const Rows rows{rin_re, rin_im, rout_re, rout_im, s_re, s_im, c, t, p, m};

  // New-ring rows that come from the old ring (T < P).
  for (int s = 0; s + t < p; ++s) {
    const long long dst = (c * p + s) * (long long)m;
    const long long src = (c * p + t + s) * (long long)m;
    for (int k = tid; k < m; k += blockDim.x) {
      rout_re[dst + k] = __ldg(&rin_re[src + k]);
      rout_im[dst + k] = __ldg(&rin_im[src + k]);
    }
  }

  const float2* prev2 = reinterpret_cast<const float2*>(prev + c * m);
  const float2* x2 = reinterpret_cast<const float2*>(x + c * t * (long long)m);
  float2* y2 = reinterpret_cast<float2*>(y + c * t * (long long)m);
  const float* hr = h_re + c * h_cs;
  const float* hi = h_im + c * h_cs;

  for (int ti = 0; ti < t; ++ti) {
    // Frame [x[ti-1] | x[ti]] as M complex points, natural order.
    const float2* lo = ti == 0 ? prev2 : x2 + (long long)(ti - 1) * q;
    const float2* hi2 = x2 + (long long)ti * q;
    for (int n = tid; n < m; n += blockDim.x) a[n] = n < q ? lo[n] : hi2[n - q];
    __syncthreads();
    dif(a, log_m, 1, tw, log_n);

    // Pack in place: bin k at a[brev(k)], pairs (k, M-k) by one thread.
    for (int k = tid; k <= q; k += blockDim.x) {
      if (k == 0) {
        a[0] = pack_bin0(a[0]);
        continue;
      }
      const int i1 = brev(k, log_m), i2 = brev(m - k, log_m);
      const float2 zk = a[i1], zm = a[i2];
      a[i1] = pack_bin(zk, zm, __ldg(&tw[k]));
      if (k != q) a[i2] = pack_bin(zm, zk, __ldg(&tw[m - k]));
    }
    __syncthreads();

    // MAC over the ring rows, lag-0 term, store E_ti to its row of V.
    const float* er_base;
    const float* ei_base;
    const long long eo = rows.at(p + ti, &er_base, &ei_base);
    float* er = const_cast<float*>(er_base) + eo;
    float* ei = const_cast<float*>(ei_base) + eo;
    for (int k = tid; k < m; k += blockDim.x) {
      const int ik = brev(k, log_m);
      const float2 e = a[ik];
      const bool lane0 = k == 0;
      float ar = 0.f, ai = 0.f;
      for (int lag = 0; lag < p; ++lag) {
        const float* vr;
        const float* vi;
        const long long vo = rows.at(p - 1 - lag + ti, &vr, &vi) + k;
        const float va = vr[vo], vb = vi[vo];
        const float hc = __ldg(&hr[(long long)lag * m + k]);
        const float hd = __ldg(&hi[(long long)lag * m + k]);
        if (lane0) {
          ar += va * hc;
          ai += vb * hd;
        } else {
          ar += va * hc - vb * hd;
          ai += va * hd + vb * hc;
        }
      }
      if (l0_re != nullptr) {
        const float lc = __ldg(&l0_re[c * l0_cs + k]);
        const float ld = __ldg(&l0_im[c * l0_cs + k]);
        if (lane0) {
          ar += e.x * lc;
          ai += e.y * ld;
        } else {
          ar += e.x * lc - e.y * ld;
          ai += e.x * ld + e.y * lc;
        }
      }
      er[k] = e.x;
      ei[k] = e.y;
      a[ik] = make_float2(ar, ai);
    }
    __syncthreads();

    // Unpack in place for the inverse (conjugated), then DIT.
    for (int k = tid; k <= q; k += blockDim.x) {
      if (k == 0) {
        a[0] = unpack_bin0(a[0]);
        continue;
      }
      const int i1 = brev(k, log_m), i2 = brev(m - k, log_m);
      const float2 pk = a[i1], pm = a[i2];
      a[i1] = unpack_bin(pk, pm, __ldg(&tw[k]));
      if (k != q) a[i2] = unpack_bin(pm, pk, __ldg(&tw[m - k]));
    }
    __syncthreads();
    dit(a, log_m, 1, tw, log_n);

    // Kept half: samples (2k - M, 2k + 1 - M) = scale * conj(a[k]), k >= M/2.
    for (int k = q + tid; k < m; k += blockDim.x) {
      const float2 v = a[k];
      y2[(long long)ti * q + (k - q)] = make_float2(scale * v.x, -scale * v.y);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int hst_fastfir_chain_stream(
    const float* x, const float* prev, const float* rin_re,
    const float* rin_im, const float* h_re, const float* h_im,
    long long h_cstride, const float* l0_re, const float* l0_im,
    long long l0_cstride, float* y, float* rout_re, float* rout_im,
    float* s_re, float* s_im, const void* tw, long long channels, int t,
    int p, int n, float scale, void* stream) {
  int log_n = 0;
  while ((1 << (log_n + 1)) <= n) ++log_n;
  const int smem = (n / 2) * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fastfir_chain_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fastfir_chain_stream_kernel<<<(unsigned)channels, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      x, prev, rin_re, rin_im, h_re, h_im, h_cstride, l0_re, l0_im, l0_cstride,
      y, rout_re, rout_im, s_re, s_im, static_cast<const float2*>(tw), t, p,
      log_n, scale);
  return (int)cudaGetLastError();
}
