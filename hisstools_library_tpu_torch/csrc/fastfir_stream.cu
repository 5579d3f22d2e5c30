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
//   2. the ring MAC (ring_mac.cu, shared with K7 and K15) over contiguous
//      bin ranges of each channel: Y_t and the new ring from X, the ring, H
//      and L0;
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
// products a bin and hop): ring_mac.cu streams the ring, H and X by bulk
// copies through shared-memory stages and moves every byte once when T <=
// 16; a longer call re-reads H and the V rows once per further chunk of 16
// hops.
#include "fft_large.cuh"
#include "ring_mac.cuh"

using namespace hst;

namespace {

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
  const RingMac a{rin_re, rin_im, (long long)p * k, p, xr, xi, (long long)t * k,
                  h_re, h_im, h_cs, l0_re, l0_im, l0_cs, yr, yi, rout_re, rout_im,
                  channels, t, p, k};
  rc = launch_ring_mac(a, st);
  if (rc != 0) return rc;
  return transform(n, false, frames, yr, yi, y, nullptr, w, 1, scale, st);
}

// K8's matrix form, three launches on `stream`: an I-in / O-out matrix whose
// pairs share one carried history an input. x (I, T, H) hops and prev (I, H)
// of the inputs, ring (I, P, N/2) in and out, H (O * I, P, N/2) and L0
// (O * I, N/2) of the pairs (pair (o, i) at channel o * I + i, channels h_cs /
// l0_cs floats apart), y (O, T, H):
//   y_o,t = scale * rifft(sum_i [ring MAC of input i with H_o,i (+ X_i,t L0_o,i)])[H:].
// The forward transforms the I inputs' T frames, the ring MAC's matrix form
// sums over the inputs in its accumulators, the inverse turns the O outputs'
// T frames. `spectra` holds 2 (I + O) T rows of N/2 floats: X re, X im (I T
// rows each), Y re, Y im (O T rows each). N = 2^14..2^17.
extern "C" int hst_fastfir_stream_matrix(const float* x, const float* prev, const float* rin_re,
                                         const float* rin_im, const float* h_re,
                                         const float* h_im, long long h_cs, const float* l0_re,
                                         const float* l0_im, long long l0_cs, float* y,
                                         float* rout_re, float* rout_im, float* spectra,
                                         const void* tw, long long outputs, long long inputs,
                                         int t, int p, int n, float scale, void* stream) {
  if (n < (1 << 14) || n > (1 << 17) || inputs < 1 || inputs > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = static_cast<const float2*>(tw);
  const long long xf = inputs * t, yf = outputs * t;  // the inputs' and the outputs' frames
  const int k = n / 2;
  float* xr = spectra;
  float* xi = xr + xf * k;
  float* yr = xi + xf * k;
  float* yi = yr + yf * k;
  int rc = transform(n, true, xf, x, prev, xr, xi, w, t, 1.f, st);
  if (rc != 0) return rc;
  const RingMac a{rin_re, rin_im, (long long)p * k, p, xr, xi, (long long)t * k,
                  h_re, h_im, h_cs, l0_re, l0_im, l0_cs, yr, yi, rout_re, rout_im,
                  outputs, t, p, k};
  rc = launch_ring_mac_matrix(a, (int)inputs, st);
  if (rc != 0) return rc;
  return transform(n, false, yf, yr, yi, y, nullptr, w, 1, scale, st);
}
