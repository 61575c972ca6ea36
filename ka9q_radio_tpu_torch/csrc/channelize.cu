// Fused tile channelizer for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_kernel` / `pallas_channelize` in
// ka9q_radio_tpu/ops/pallas_channelize.py. It computes what the plain
// PyTorch `tiled_channelize` (ka9q_radio_tpu_torch/ops/filterbank.py)
// computes, per channel c:
//   x[j]  = F[row(tile_lo[c] + j/128) * 128 + j%128] * resp[c, j]   (j < S)
//           rows clamp to [0, nrows) for a real master, wrap mod nrows for a
//           complex one; bins past m_bins read as zero;
//   Y[t]  = sum_j x[j] * E[j, t]                                   (t < olen)
//   Y     = conj(Y) for an inverted slice (real master, shift < 0);
//   out   = Y * exp(2 pi i ((slope[c] * (n - olen + t)) mod n) / n).
//
// What bounds it: at the rx888 shapes (C = 1000, S = 512, olen = 240) it
// does 123 M complex multiply-adds (about 1 GFLOP of FP32) on about 11 MB of
// unique bytes, so the FP32 issue rate bounds it, not memory. The product
// stays in FP32 FMAs: TF32 tensor cores keep about 3 decimal digits, too few
// for the 3e-5 * scale parity bound against the plain version.
//
// Design: kCPB channels per CTA. The CTA stages x for its channels in shared
// memory, then each thread owns output samples t and walks j over S, reading
// E[j, t] once (coalesced across the warp; E is one shared L2-resident
// constant) and using it for all kCPB channels, so the L2 traffic of E is
// C / kCPB copies per call. There is no span window: each channel reads its
// own rows straight from device memory, so sparse layouts run here too. The
// phase index (slope * t) mod n is exact in 64-bit integers; only the angle
// goes through sincosf.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kCPB = 4;  // channels per CTA

__global__ void __launch_bounds__(kThreads)
channelize_kernel(const float2* __restrict__ F, long long m_bins, int nrows,
                  int real_master, const float2* __restrict__ resp,
                  const int* __restrict__ tile_lo, const int* __restrict__ slope,
                  const int* __restrict__ shifts, const float2* __restrict__ E,
                  int C, int S, int olen, int n_bins, float w,
                  float2* __restrict__ out) {
  extern __shared__ float2 xs[];  // [kCPB][S]
  const int c0 = blockIdx.x * kCPB;
  for (int idx = threadIdx.x; idx < kCPB * S; idx += blockDim.x) {
    const int cc = idx / S;
    const int j = idx - cc * S;
    const int c = c0 + cc;
    float2 v = make_float2(0.f, 0.f);
    if (c < C) {
      int row = tile_lo[c] + j / kTile;
      if (real_master) {
        row = min(max(row, 0), nrows - 1);
      } else {
        row %= nrows;
        if (row < 0) row += nrows;
      }
      const long long bin = (long long)row * kTile + (j % kTile);
      if (bin < m_bins) {
        const float2 f = F[bin];
        const float2 r = resp[(long long)c * S + j];
        v.x = f.x * r.x - f.y * r.y;
        v.y = f.x * r.y + f.y * r.x;
      }
    }
    xs[idx] = v;
  }
  __syncthreads();

  const long long t0 = n_bins - olen;
  for (int t = threadIdx.x; t < olen; t += blockDim.x) {
    float ar[kCPB], ai[kCPB];
#pragma unroll
    for (int cc = 0; cc < kCPB; ++cc) {
      ar[cc] = 0.f;
      ai[cc] = 0.f;
    }
    const float2* e = E + t;
#pragma unroll 4
    for (int j = 0; j < S; ++j) {
      const float2 ej = e[(long long)j * olen];
#pragma unroll
      for (int cc = 0; cc < kCPB; ++cc) {
        const float2 x = xs[cc * S + j];
        ar[cc] = fmaf(x.x, ej.x, ar[cc]);
        ar[cc] = fmaf(-x.y, ej.y, ar[cc]);
        ai[cc] = fmaf(x.x, ej.y, ai[cc]);
        ai[cc] = fmaf(x.y, ej.x, ai[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < kCPB; ++cc) {
      const int c = c0 + cc;
      if (c < C) {
        const float yr = ar[cc];
        const float yi = (real_master && shifts[c] < 0) ? -ai[cc] : ai[cc];
        long long ph = ((long long)slope[c] * (t0 + t)) % n_bins;
        if (ph < 0) ph += n_bins;
        float s, co;
        sincosf(w * (float)ph, &s, &co);
        out[(long long)c * olen + t] = make_float2(yr * co - yi * s, yr * s + yi * co);
      }
    }
  }
}

}  // namespace

// All pointers are device pointers; stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ka9q_channelize(const void* F, long long m_bins, int nrows,
                               int real_master, const void* resp,
                               const void* tile_lo, const void* slope,
                               const void* shifts, const void* E, int C, int S,
                               int olen, int n_bins, float w, void* out,
                               void* stream) {
  const size_t smem = (size_t)kCPB * S * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + kCPB - 1) / kCPB;
  channelize_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)F, m_bins, nrows, real_master, (const float2*)resp,
      (const int*)tile_lo, (const int*)slope, (const int*)shifts,
      (const float2*)E, C, S, olen, n_bins, w, (float2*)out);
  return (int)cudaGetLastError();
}
