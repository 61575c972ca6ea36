// Fused noise-floor (N0) estimate for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_noise_kernel` / `pallas_noise_est` in
// ka9q_radio_tpu/ops/pallas_channelize.py. It computes what the plain
// PyTorch estimate_noise_keys(gather_noise_bins(...))
// (ka9q_radio_tpu_torch/ops/noise.py) computes, per channel c:
//   the W-bin window of master energies |F|^2 placed from shift[c] (clamped
//   inside [DC, Nyquist] for a real master, wrapped through DC for a complex
//   one), order statistic i found exactly by bisection on the int32 view of
//   the energies, statistic i+1 from one more count and min, the
//   interpolated quantile q, the mean of the energies <= 1.5 q, scaled by
//   corr / denom.
// It also writes both order-statistic keys, which must equal the plain
// version's bit for bit; only the truncated-mean sum order differs.
//
// What bounds it: one read of W complex bins per channel (8 MB at the rx888
// shapes, C = 1000, W = 1024) against about 35 passes of 32-bit compares
// over the keys, so device-memory bytes bound it. The earlier version gave
// each channel a 256-thread CTA whose every count was a block-wide
// reduction (~70 barriers a channel, 8 warps in lock-step) and ran at 7x
// its bound. Here one warp owns one channel:
//   - the window comes in with 16-byte loads (two bins; windows start on
//     128-bin boundaries and a complex master wraps only at whole tiles),
//     W / 32 keys a lane held in registers (32 at W = 1024) and sorted there
//     by a bitonic network; above W = 2048 they go to the warp's slice of
//     shared memory instead, unsorted;
//   - each bisection step is a per-lane count and one __reduce_add_sync:
//     on sorted registers the count is log2(W / 32) + 1 compares and
//     selects (halving a window of the lane's keys), not W / 32 compares
//     and adds; statistic i+1 is one count and one __reduce_min_sync, the
//     truncated mean a __shfl_xor_sync sum: no shared memory and no
//     __syncthreads;
//   - the search starts from the window's [max(min key, 0), max key], not
//     [0, 2^31 - 1]; the answer (the smallest v with count(keys <= v) >=
//     i + 1, clamped at 0 as the plain version's range is) is the same key,
//     in fewer steps;
//   - 4 channels a CTA: 250 CTAs at C = 1000.
// Squares and sums use __fmul_rn/__fadd_rn so no multiply-add contraction
// changes the keys.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // channels per CTA
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int energy_key(float re, float im) {
  return __float_as_int(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// a[] ascending: one layer (K, J) of a bitonic network, then the next;
// every index is a compile-time constant, so the keys stay in registers
template <int N, int K, int J>
__device__ __forceinline__ void bitonic_layer(int (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int l = i ^ J;
    if (l > i) {
      const int x = a[i], y = a[l];
      a[i] = (i & K) == 0 ? min(x, y) : max(x, y);
      a[l] = (i & K) == 0 ? max(x, y) : min(x, y);
    }
  }
  if constexpr (J > 1) {
    bitonic_layer<N, K, J / 2>(a);
  } else if constexpr (K < N) {
    bitonic_layer<N, 2 * K, K>(a);
  }
}

template <int N>
__device__ __forceinline__ void sort_keys(int (&a)[N]) {
  bitonic_layer<N, 2, 1>(a);
}

// #{w[j] <= v} of ascending w[0, 2H): keep the upper half where the lower
// half's last key is <= v, log2(2H) times (selects only); w is consumed
template <int H, int N>
__device__ __forceinline__ int count_window_le(int (&w)[N], int v) {
  const bool up = w[H - 1] <= v;
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = up ? w[H + j] : w[j];
  if constexpr (H > 1) {
    return (up ? H : 0) + count_window_le<H / 2>(w, v);
  } else {
    return (up ? H : 0) + (w[0] <= v ? 1 : 0);
  }
}

template <int N>
__device__ __forceinline__ int count_sorted_le(const int (&a)[N], int v) {
  int w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = a[j];
  return count_window_le<N / 2>(w, v);
}

// kKPL keys a lane in registers (W <= 32 * kKPL), or kKPL == 0: the keys in
// the warp's W-int slice of dynamic shared memory.
template <int kKPL>
__global__ void __launch_bounds__(kWarps * 32)
noise_kernel(const float2* __restrict__ F, long long m_bins, int real_master,
             const int* __restrict__ shifts, int C, int W, int i_idx, int has_next, float w_lo,
             float w_hi, float cutoff, float corr, float denom, float* __restrict__ n0,
             int* __restrict__ keys_out) {
  constexpr bool kSmem = kKPL == 0;
  extern __shared__ int ks_all[];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp leaves together
  int* ks = ks_all + (threadIdx.x >> 5) * W;

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

  // 64 bins a warp-wide load: lane takes bins 2 lane, 2 lane + 1
  const int nload = W / 64;
  int mn = kIntMax, mx = 0;
  auto load = [&](int i, int& k0, int& k1) {
    long long b = start + 64LL * i;
    if (!real_master) {
      b %= m_bins;
      if (b < 0) b += m_bins;
    }
    const float4 f = *reinterpret_cast<const float4*>(F + b + 2 * lane);
    k0 = energy_key(f.x, f.y);
    k1 = energy_key(f.z, f.w);
    mn = min(mn, min(k0, k1));
    mx = max(mx, max(k0, k1));
  };
  // Register keys are sorted per lane; slots past the window hold
  // kIntMax, which no count at v < kIntMax includes, no min above a key
  // below it needs, and no mean takes (it is a NaN).
  int key[kSmem ? 1 : kKPL];
  if constexpr (kSmem) {
    for (int i = 0; i < nload; ++i) {
      int k0, k1;
      load(i, k0, k1);
      *reinterpret_cast<int2*>(ks + 64 * i + 2 * lane) = make_int2(k0, k1);
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int i = 0; i < kKPL / 2; ++i) {
      key[2 * i] = key[2 * i + 1] = kIntMax;
      if (i < nload) load(i, key[2 * i], key[2 * i + 1]);
    }
    sort_keys(key);
  }
  // fn(key) over this lane's keys
  auto each = [&](auto fn) {
    if constexpr (kSmem) {
      for (int p = lane; p < W; p += 32) fn(ks[p]);
    } else {
#pragma unroll
      for (int j = 0; j < kKPL; ++j) fn(key[j]);
    }
  };

  int lo = max(__reduce_min_sync(kFull, mn), 0);
  int hi = max(__reduce_max_sync(kFull, mx), lo);
  // count(keys <= v) over the warp (v < kIntMax)
  auto count_le = [&](int v) {
    int n = 0;
    if constexpr (kSmem) {
      int n4[4] = {0, 0, 0, 0};
      for (int p = lane; p < W; p += 128)
#pragma unroll
        for (int q = 0; q < 4; ++q) n4[q] += ks[p + 32 * q] <= v ? 1 : 0;
      n = n4[0] + n4[1] + n4[2] + n4[3];
    } else {
      n = count_sorted_le(key, v);
    }
    return (int)__reduce_add_sync(kFull, (unsigned)n);
  };
  // smallest v in [lo, hi] with count(keys <= v) >= i + 1
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (count_le(mid) >= i_idx + 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int vi = lo;
  int v1 = vi;
  if (has_next) {
    int above = kIntMax;
    each([&](int k) {
      if (k > vi) above = min(above, k);
    });
    const int cnt_le = count_le(vi);
    above = __reduce_min_sync(kFull, above);
    v1 = cnt_le >= i_idx + 2 ? vi : above;
  }

  const float q = __fadd_rn(__fmul_rn(__int_as_float(vi), w_lo), __fmul_rn(__int_as_float(v1), w_hi));
  const float thresh = __fmul_rn(cutoff, q);
  float s = 0.f;
  int n = 0;
  each([&](int k) {
    const float e = __int_as_float(k);
    if (e <= thresh) {
      s += e;
      ++n;
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  n = (int)__reduce_add_sync(kFull, (unsigned)n);
  if (lane == 0) {
    const float mean = __fdiv_rn(s, (float)max(n, 1));
    n0[c] = __fdiv_rn(__fmul_rn(mean, corr), denom);
    keys_out[2 * c] = vi;
    keys_out[2 * c + 1] = v1;
  }
}

template <int kKPL>
int launch(const float2* F, long long m_bins, int real_master, const int* sh, int C, int W,
           int i_idx, int has_next, float w_lo, float w_hi, float cutoff, float corr, float denom,
           float* n0, int* keys, cudaStream_t st) {
  const size_t smem = kKPL == 0 ? (size_t)kWarps * W * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(noise_kernel<kKPL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  noise_kernel<kKPL><<<(C + kWarps - 1) / kWarps, kWarps * 32, smem, st>>>(
      F, m_bins, real_master, sh, C, W, i_idx, has_next, w_lo, w_hi, cutoff, corr, denom, n0,
      keys);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are device pointers, F 16-byte aligned; stream is a
// cudaStream_t. W is a multiple of 128, at most 4096. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ka9q_noise_est(const void* F, long long m_bins, int real_master,
                              const void* shifts, int C, int W, int i_idx, int has_next,
                              float w_lo, float w_hi, float cutoff, float corr, float denom,
                              void* n0, void* keys, void* stream) {
  const float2* f = (const float2*)F;
  const int* sh = (const int*)shifts;
  float* out = (float*)n0;
  int* k = (int*)keys;
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 128 || W > 4096) return (int)cudaErrorInvalidValue;
#define KA9Q_NOISE_LAUNCH(KPL) \
  launch<KPL>(f, m_bins, real_master, sh, C, W, i_idx, has_next, w_lo, w_hi, cutoff, corr, denom, out, k, st)
  if (W <= 128) return KA9Q_NOISE_LAUNCH(4);
  if (W <= 256) return KA9Q_NOISE_LAUNCH(8);
  if (W <= 512) return KA9Q_NOISE_LAUNCH(16);
  if (W <= 1024) return KA9Q_NOISE_LAUNCH(32);
  if (W <= 2048) return KA9Q_NOISE_LAUNCH(64);
  return KA9Q_NOISE_LAUNCH(0);
#undef KA9Q_NOISE_LAUNCH
}
