// Fused noise-floor (N0) estimate for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_noise_kernel` / `pallas_noise_est` in
// ka9q_radio_tpu/ops/pallas_channelize.py. It computes what the plain
// PyTorch estimate_noise_keys(gather_noise_bins(...))
// (ka9q_radio_tpu_torch/ops/noise.py) computes, per channel c:
//   the W-bin window of master energies |F|^2 placed from shift[c] (clamped
//   inside [DC, Nyquist] for a real master, wrapped through DC for a complex
//   one), order statistic i found exactly by a 31-step bisection on the
//   int32 view of the energies, statistic i+1 from two more passes, the
//   interpolated quantile q, the mean of the energies <= 1.5 q, scaled by
//   corr / denom.
// It also writes both order-statistic keys, which must equal the plain
// version's bit for bit; only the truncated-mean sum order differs.
//
// What bounds it: one read of W complex bins per channel (8 MB at the rx888
// shapes, C = 1000, W = 1024) against about 34 passes of 32-bit compares over
// the keys, so device-memory bytes bound it. The design keeps the keys in
// registers (kPerThread per thread) for all the passes: each pass is a
// block-wide count (warp shuffle reduction, then shared memory), and
// nothing but the window is read from device memory. Squares and sums use
// __fmul_rn/__fadd_rn so no multiply-add contraction changes the keys.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ int block_min(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = kIntMax;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s = min(s, red[i]);
  __syncthreads();
  return s;
}

__device__ __forceinline__ float block_sum_f(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int kPerThread>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const float2* __restrict__ F, long long m_bins, int real_master,
             const int* __restrict__ shifts, int W, int i_idx, int has_next,
             float w_lo, float w_hi, float cutoff, float corr, float denom,
             float* __restrict__ n0, int* __restrict__ keys_out) {
  __shared__ int red_i[kWarps];
  __shared__ float red_f[kWarps];
  const int c = blockIdx.x;
  const long long sh = shifts[c];
  long long start;
  if (real_master) {
    long long lo = (sh < 0 ? -sh : sh) - W / 2;
    lo = max(0LL, min(lo, m_bins - W));
    start = (lo / 128) * 128;
  } else {
    long long lo = sh - W / 2;
    lo = max(-(m_bins / 2), min(lo, (m_bins - 1) / 2 - (W - 1)));
    start = floor_div(lo, 128) * 128;
  }

  int key[kPerThread];
  bool valid[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    valid[k] = idx < W;
    key[k] = 0;
    if (valid[k]) {
      long long b = start + idx;
      if (!real_master) {
        b %= m_bins;
        if (b < 0) b += m_bins;
      }
      const float2 f = F[b];
      key[k] = __float_as_int(__fadd_rn(__fmul_rn(f.x, f.x), __fmul_rn(f.y, f.y)));
    }
  }

  // smallest v with count(keys <= v) >= i+1: 31 halvings of [0, 2^31 - 1]
  int lo = 0, hi = kIntMax;
  for (int step = 0; step < 31; ++step) {
    const int mid = lo + ((hi - lo) >> 1);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) cnt += (valid[k] && key[k] <= mid) ? 1 : 0;
    cnt = block_sum(cnt, red_i);
    if (cnt >= i_idx + 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int vi = lo;
  int v1 = vi;
  if (has_next) {
    int cnt_le = 0, mn = kIntMax;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (valid[k]) {
        if (key[k] <= vi) {
          ++cnt_le;
        } else {
          mn = min(mn, key[k]);
        }
      }
    }
    cnt_le = block_sum(cnt_le, red_i);
    mn = block_min(mn, red_i);
    v1 = cnt_le >= i_idx + 2 ? vi : mn;
  }

  const float q = __fadd_rn(__fmul_rn(__int_as_float(vi), w_lo),
                            __fmul_rn(__int_as_float(v1), w_hi));
  const float thresh = __fmul_rn(cutoff, q);
  float s = 0.f;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const float e = __int_as_float(key[k]);
    if (valid[k] && e <= thresh) {
      s += e;
      ++n;
    }
  }
  s = block_sum_f(s, red_f);
  n = block_sum(n, red_i);
  if (threadIdx.x == 0) {
    const float mean = __fdiv_rn(s, (float)max(n, 1));
    n0[c] = __fdiv_rn(__fmul_rn(mean, corr), denom);
    keys_out[2 * c] = vi;
    keys_out[2 * c + 1] = v1;
  }
}

}  // namespace

// All pointers are device pointers; stream is a cudaStream_t. W <= 4096.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ka9q_noise_est(const void* F, long long m_bins, int real_master,
                              const void* shifts, int C, int W, int i_idx,
                              int has_next, float w_lo, float w_hi, float cutoff,
                              float corr, float denom, void* n0, void* keys,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float2* f = (const float2*)F;
  const int* sh = (const int*)shifts;
  float* out = (float*)n0;
  int* k = (int*)keys;
  if (W <= 4 * kThreads) {
    noise_kernel<4><<<C, kThreads, 0, st>>>(f, m_bins, real_master, sh, W, i_idx,
                                            has_next, w_lo, w_hi, cutoff, corr,
                                            denom, out, k);
  } else if (W <= 8 * kThreads) {
    noise_kernel<8><<<C, kThreads, 0, st>>>(f, m_bins, real_master, sh, W, i_idx,
                                            has_next, w_lo, w_hi, cutoff, corr,
                                            denom, out, k);
  } else if (W <= 16 * kThreads) {
    noise_kernel<16><<<C, kThreads, 0, st>>>(f, m_bins, real_master, sh, W, i_idx,
                                             has_next, w_lo, w_hi, cutoff, corr,
                                             denom, out, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
