// The two per-sample recurrences of the demodulators for Hopper (sm_90a),
// plain C interface.
//
// The JAX package runs them as lax.scan inside its jitted step, one device
// loop: the PLL of linear.c (ka9q_radio_tpu/models/linear.py:66-89) and the
// CTCSS Goertzel of fm.c (ka9q_radio_tpu/ops/iir.py:172-177). Neither is a
// TPU kernel. Run eagerly by PyTorch they would be one Python iteration per
// sample (about 25 elementwise launches a sample for the PLL: some 6,000 a
// 240-sample block), so each becomes one kernel here:
//   pll_scan        the whole per-sample body of models/linear.py
//                   pll_scan_plain: VCO mix, phase detector, pll_step, the
//                   in-phase and quadrature energy sums;
//   goertzel_block  s0 <- x + coeff s0 - s1, s1 <- s0 over a block
//                   (ops/iir.py goertzel_update_block).
//
// One thread owns one channel and keeps its state in registers for the
// whole block: the work is a chain of dependent operations per channel, so
// what bounds it is the latency of that chain (T steps of sincosf, atan2f
// and a dozen dependent float operations for the PLL), not bytes or
// throughput; the channels run side by side, up to the card's thread count.
// Samples are read and written straight from device memory: a channel's
// row is contiguous, so a thread's successive samples share cache lines.
//
// The file is compiled with -fmad=false and uses the full-precision
// sincosf/atan2f/hypotf, never the __ intrinsics: every operation rounds
// once, in the order of the plain versions, which PyTorch runs as one
// kernel an operation on the card.
#include <cuda_runtime.h>

namespace {

constexpr float kQ32ToRev = 2.3283064365386963e-10f;  // 2^-32
constexpr float kTwoPi = 6.2831854820251465f;         // float32(2 pi)
constexpr float kVcoHalf = 0.49999997f;                // VCO step clip, inside +-0.5 rev
constexpr float kTwo32 = 4294967296.0f;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pll_scan_kernel(const float2* __restrict__ bb, int C, int T, const float* __restrict__ k1,
                const float* __restrict__ k2, const unsigned char* __restrict__ locked,
                const unsigned char* __restrict__ square, const int* __restrict__ vco_in,
                const float* __restrict__ u_in, const float* __restrict__ phi_in,
                const int* __restrict__ wraps_in, float2* __restrict__ mixed,
                int* __restrict__ vco_out, float* __restrict__ u_out, float* __restrict__ phi_out,
                int* __restrict__ wraps_out, float* __restrict__ sig_out,
                float* __restrict__ noi_out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float K1 = k1[c], K2 = k2[c];
  const bool lk = locked[c] != 0, sq = square[c] != 0;
  unsigned int vco = (unsigned int)vco_in[c];
  float u = u_in[c], phi = phi_in[c];
  int wraps = wraps_in[c];
  float sig = 0.f, noi = 0.f;
  const float2* x = bb + (size_t)c * T;
  float2* y = mixed + (size_t)c * T;
  for (int t = 0; t < T; ++t) {
    // mix by the conjugate VCO
    const float ang = ((float)(int)vco * kQ32ToRev) * kTwoPi;
    float vs, vc;
    sincosf(ang, &vs, &vc);
    const float2 s = x[t];
    const float re = s.x * vc + s.y * vs;
    const float im = s.y * vc - s.x * vs;
    const float rr = re * re, ii = im * im, ri = re * im;
    const float d = rr - ii;
    // phase detector (linear.c:127-150): small-angle forms while locked
    float ph;
    if (lk) {
      if (sq) {
        ph = ri / (fabsf(d) > 1e-30f ? d : 1e-30f);
      } else {
        const float mag = hypotf(re, im);
        ph = mag > 0.f ? im / fmaxf(mag, 1e-30f) : 0.f;
      }
    } else {
      ph = sq ? 0.5f * atan2f(ri + im * re, d) : atan2f(im, re);
    }
    const float pe = ph / kTwoPi;
    // pll_step (osc.c:175-206)
    float un = u + K2 * pe;
    float dphi = un + K1 * pe;
    if ((dphi > 0.5f && pe > 0.f) || (dphi < -0.5f && pe < 0.f)) un = u;
    dphi = fminf(fmaxf(dphi, -0.5f), 0.5f);
    phi = phi + dphi;
    wraps += (phi > 1.f ? 1 : 0) - (phi < -1.f ? 1 : 0);
    phi = phi > 1.f ? phi - 1.f : (phi < -1.f ? phi + 1.f : phi);
    vco += (unsigned int)(int)(fminf(fmaxf(dphi, -kVcoHalf), kVcoHalf) * kTwo32);
    u = un;
    sig = sig + rr;
    noi = noi + ii;
    y[t] = make_float2(re, im);
  }
  vco_out[c] = (int)vco;
  u_out[c] = u;
  phi_out[c] = phi;
  wraps_out[c] = wraps;
  sig_out[c] = sig;
  noi_out[c] = noi;
}

__global__ void __launch_bounds__(kThreads)
goertzel_kernel(const float* __restrict__ x, int C, int T, const float* __restrict__ coeff,
                const float* __restrict__ s0_in, const float* __restrict__ s1_in,
                float* __restrict__ s0_out, float* __restrict__ s1_out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float k = coeff[c];
  float s0 = s0_in[c], s1 = s1_in[c];
  const float* xc = x + (size_t)c * T;
  for (int t = 0; t < T; ++t) {
    const float n = (xc[t] + k * s0) - s1;
    s1 = s0;
    s0 = n;
  }
  s0_out[c] = s0;
  s1_out[c] = s1;
}

}  // namespace

// All pointers are device pointers; bb and mixed [C, T] complex64 (float
// pairs), the rest [C]; locked and square one byte a channel (torch.bool);
// stream is a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int ka9q_pll_scan(const void* bb, int C, int T, const void* k1, const void* k2,
                             const void* locked, const void* square, const void* vco_in,
                             const void* u_in, const void* phi_in, const void* wraps_in,
                             void* mixed, void* vco_out, void* u_out, void* phi_out,
                             void* wraps_out, void* sig_out, void* noi_out, void* stream) {
  if (C <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  pll_scan_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)bb, C, T, (const float*)k1, (const float*)k2, (const unsigned char*)locked,
      (const unsigned char*)square, (const int*)vco_in, (const float*)u_in, (const float*)phi_in,
      (const int*)wraps_in, (float2*)mixed, (int*)vco_out, (float*)u_out, (float*)phi_out,
      (int*)wraps_out, (float*)sig_out, (float*)noi_out);
  return (int)cudaGetLastError();
}

// x [C, T] float32, coeff/s0/s1 [C] float32. Returns the cudaError_t.
extern "C" int ka9q_goertzel_block(const void* x, int C, int T, const void* coeff,
                                   const void* s0_in, const void* s1_in, void* s0_out,
                                   void* s1_out, void* stream) {
  if (C <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  goertzel_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, C, T, (const float*)coeff, (const float*)s0_in, (const float*)s1_in,
      (float*)s0_out, (float*)s1_out);
  return (int)cudaGetLastError();
}
