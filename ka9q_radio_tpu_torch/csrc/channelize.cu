// Fused tile channelizer for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_kernel` / `pallas_channelize` in
// ka9q_radio_tpu/ops/pallas_channelize.py. It computes what the plain
// PyTorch `tiled_channelize` (ka9q_radio_tpu_torch/ops/filterbank.py)
// computes, per channel c:
//   x[j]  = F[row(tile_lo[c] + j/128) * 128 + j%128] * resp[c, j]   (j < S)
//           rows clamp to [0, nrows) for a real master, wrap mod nrows for a
//           complex one; bins past m_bins read as zero; with several inputs
//           F is [B, ld] and the row is then read from row inputs[c] of it
//           (placed inside the channel's own stream first, offset after:
//           no clamped row reads the neighbouring stream);
//   Y[t]  = sum_j x[j] * E[j, t]                                   (t < olen)
//   Y     = conj(Y) for an inverted slice (real master, shift < 0);
//   out   = Y * exp(2 pi i ((slope[c] * (n - olen + t)) mod n) / n).
//
// Fold. E[j, t] = e^{2 pi i (j - n/2) t / n} / n is periodic in j with
// period n (rows j and j + n of the constant are bit-equal), so
//   Y[t] = sum_{k < n} xf[k] E[k, t],   xf[k] = sum_{j = k mod n, j < S} x[j]:
// the product needs n terms, not S (300 of 512 at the rx888 shapes).
//
// Product. One real GEMM on the tensor cores,
//   [Xr | Xi] (rows x 2n) . [[Er, Ei], [-Ei, Er]] (2n x 2 olen),
// output columns interleaved (2t = Re Y[t], 2t + 1 = Im Y[t]) so that each
// thread's accumulator pair is one complex sample, and K taken in chunks of
// 32 rows, each the Re and then the Im parts of 16 fold bins, so that any
// run of whole chunks is a run of fold bins. One TF32 pass keeps 11
// significant bits, too few for the 3e-5 * scale parity bound, so every
// product is split ("3xTF32"):
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,  a_hi = rna_tf32(a),
//   a_lo = rna_tf32(a - a_hi),
// which is accurate to about FP32. The constant operand (the real-block E,
// padded to the MMA's K and N, hi and lo already split, in K-major core
// matrices) is a group constant built once on the device
// (ops/cuda_channelize.py `channelize_operand`); only X is split here, with
// cvt.rna.tf32.f32. A 64-row tile (n <= 320, rx888's 300 included) runs
// wgmma.m64n32k8: each warpgroup takes 32 columns, A from registers, B from
// the ring through an unswizzled descriptor. Smaller tiles (16 or 32 rows,
// when a wider slice's X tile leaves less shared memory) run
// mma.sync.m16n8k8 on the same layout. A slice too wide for even a 16-row
// X tile (n > 1280) takes it in K segments of at most 2560 rows: gather and
// fold one segment's fold bins, run its chunks, then the next segment.
//
// What bounds it: at the rx888 shapes (C = 1000, n = 300, olen = 240) the
// folded product is 0.58 GFLOP, three times over for the split: 1.7 GFLOP
// of TF32 (3.5 us at 495 TFLOP/s) against ~11 MB of unique bytes (3.2 us
// at 3.35 TB/s). The design:
//   - grid: column tiles of 64 GEMM columns (32 samples) x row tiles of
//     16 * kWM channels (64 at n <= 320), one CTA an SM for its shared
//     memory; a thread block cluster of kCluster column tiles shares one
//     row tile: each CTA gathers and folds half of the rows (tile rows of F
//     times the response, 16-byte loads of bin pairs, kU pairs of kMT fold
//     terms in flight a thread) and writes them into the shared memory of
//     both CTAs (distributed shared memory). Clusters of 4 would halve the
//     gather again, but only 30 of them (120 SMs) are resident at this
//     shared memory, so 1,000 channels would take two waves;
//   - the constant streams through a 4-slot cp.async ring in 32-deep K
//     chunks (16 KB, 16-byte copies), two chunks ahead of the one in use
//     (the first two are in flight while the CTA gathers), so one chunk's
//     wgmma group may still run while the next chunk starts; the hi*hi
//     products and the two correction products accumulate in separate
//     registers;
//   - epilogue: conj of inverted slices and the phase index
//     (slope * t) mod n, exact in 32 bits from slope mod n (n^2 < 2^31);
//     only the angle goes through sincosf.
// The gather and the MMA loop run one after the other in a CTA. At the
// rx888 shapes the gathered rows (each read by the four clusters of a row
// tile) and the constant (read by every row tile) are about 72 MB through
// L2, which at the kernel's measured time (PERF.md) is about 3 TB/s: they,
// not the arithmetic, set the time. The earlier FP32-FMA version (all S
// terms) matched the plain version bit for bit at the rx888 shapes; this
// one matches it within rounding.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;    // master bins per tile row
constexpr int kThreads = 256;  // 8 warps
constexpr int kCols = 64;     // GEMM columns per CTA (32 complex samples)
constexpr int kKC = 32;       // K rows per chunk of the constant
constexpr int kStages = 4;    // chunks in the cp.async ring
constexpr int kAhead = 2;     // chunks loaded ahead of the one in use
constexpr int kChunkFloats = kKC * kCols * 2;  // hi and lo: 16 KB
constexpr int kCluster = 2;  // column tiles sharing one gather
constexpr int kU = 4;   // gather items a thread has in flight
constexpr int kMT = 2;  // fold terms of each loaded together

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m64n32k8 TF32 on the tensor cores for one warpgroup: A (its 64 rows x 8)
// from registers, each warp's four as in mma.sync.m16n8k8; B (8 x 32) from
// shared memory through a descriptor; d[4j + i] is the n8 tile j of the
// mma.sync accumulator layout.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], const unsigned (&a)[4],
                                           unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of a K-major, unswizzled 8 x 32 B tile at shared address
// saddr: core matrices of 8 columns x 4 k (128 contiguous bytes), the two
// k halves kLBO bytes apart, the four column groups kSBO bytes apart.
constexpr unsigned kLBO = 128, kSBO = 256;
__device__ __forceinline__ unsigned long long b_desc(unsigned saddr) {
  return (unsigned long long)((saddr & 0x3FFFF) >> 4) |
         ((unsigned long long)(kLBO >> 4) << 16) | ((unsigned long long)(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of d above the wait
__device__ __forceinline__ void fence_operand(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kWM: warps along the rows; the CTA holds 16 * kWM channels and its 8
// warps split the 64 columns kCols / (8 / kWM) apiece (kWM n8 tiles).
template <int kWM>
__global__ void __launch_bounds__(kThreads, 1)
channelize_kernel(const float2* __restrict__ F, long long m_bins, long long ld, int nrows,
                  int real_master, const int* __restrict__ inputs,
                  const float2* __restrict__ resp, const int* __restrict__ tile_lo,
                  const int* __restrict__ slope, const int* __restrict__ shifts,
                  const float4* __restrict__ Bop, int C, int S, int olen, int n_bins, int n_pad,
                  int kseg, int ncol, float w, float2* __restrict__ out) {
  constexpr int kRows = 16 * kWM;
  constexpr int kNT = kWM;  // n8 tiles a warp owns
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                          // [kStages][kChunkFloats]
  float* xs = smem + kStages * kChunkFloats;  // [kRows][xstride]: one K segment
  const int Kp = 2 * n_pad;
  const int xstride = kseg + 4;  // 4 words of skew: the A fragment loads hit 32 banks
  const int nchunks = Kp / kKC;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ct = blockIdx.x;  // column tile; >= ncol only pads the cluster
  const int c0 = blockIdx.y * kRows;
  const bool active = ct < ncol;
  const float4* bsrc = Bop + (size_t)ct * nchunks * (kChunkFloats / 4);

  // the row tile's first tile rows, inputs, ramp slopes mod n and conj flags
  __shared__ int s_lo[kRows], s_in[kRows], s_slope[kRows], s_inv[kRows];
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int c = c0 + r;
    s_lo[r] = c < C ? tile_lo[c] : 0;
    s_in[r] = c < C && inputs != nullptr ? inputs[c] : 0;
    s_slope[r] = c < C ? (slope[c] % n_bins + n_bins) % n_bins : 0;
    s_inv[r] = c < C && real_master && shifts[c] < 0;
  }

  auto load_chunk = [&](int ch) {
    if (active && ch < nchunks) {
      const float4* src = bsrc + (size_t)ch * (kChunkFloats / 4);
      float* dst = bs + (ch % kStages) * kChunkFloats;
      for (int i = threadIdx.x; i < kChunkFloats / 4; i += kThreads) cp_async16(dst + 4 * i, src + i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) load_chunk(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % kWM, wn = warp / kWM;
  const int g = lane >> 2, tig = lane & 3;
  // hi * hi products in acc, the two correction products in cor: two
  // independent MMA chains per n8 tile
  float acc[kNT][4], cor[kNT][4];
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jj][i] = cor[jj][i] = 0.f;
  const float* xa = xs + (wm * 16 + g) * xstride + tig;

  const int nterm = (S + n_bins - 1) / n_bins;  // fold terms of k = 0, the most
  // master bin of tile-frame position j from first tile row lo: rows clamp
  // (real master) or wrap (complex)
  auto tile_bin = [&](int lo, int j) -> long long {
    int row = lo + j / kTile;
    if (real_master) {
      row = min(max(row, 0), nrows - 1);
    } else {
      row %= nrows;
      if (row < 0) row += nrows;
    }
    return (long long)row * kTile + (j % kTile);
  };
  int ch = 0;  // next chunk of the constant
  for (int seg0 = 0; seg0 < Kp; seg0 += kseg) {
    const int kb0 = seg0 / 2;                          // the segment's first fold bin
    const int npair = min(kseg, Kp - seg0) / 4;        // its pairs of fold bins
    // gather and fold this CTA's share of the rows (r = rank mod cs) into
    // every CTA of the cluster: fold bin k = kb0 + p goes to Xs[r][32 (p / 16)
    // + p % 16] (Re) and 16 further on (Im). A thread takes kU items of two
    // neighbouring k at a time and issues the loads of kMT fold terms of all
    // of them before it uses any.
    cluster.sync();  // every peer has started, and is done with the last segment
    const int items = (kRows - rank + cs - 1) / cs * npair;
    for (int base = threadIdx.x; base < items; base += kThreads * kU) {
      float re[kU][2], im[kU][2];
#pragma unroll
      for (int u = 0; u < kU; ++u) re[u][0] = re[u][1] = im[u][0] = im[u][1] = 0.f;
      for (int m0 = 0; m0 < nterm; m0 += kMT) {
        float2 f[kU][kMT][2], x[kU][kMT][2];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int idx = base + u * kThreads;
          const int r = rank + cs * (idx / npair);
          const int c = c0 + r;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int k = kb0 + 2 * (idx % npair);
            const int j = k + (m0 + mt) * n_bins;
            const float2 z = make_float2(0.f, 0.f);
            f[u][mt][0] = f[u][mt][1] = x[u][mt][0] = x[u][mt][1] = z;
            if (idx < items && c < C && k < n_bins && j < S) {
              const float2* rc = resp + (long long)c * S;
              const float2* Fc = F + (long long)s_in[r] * ld;  // the channel's stream
              const long long bin = tile_bin(s_lo[r], j);
              if ((j & 1) == 0 && k + 1 < n_bins && bin + 1 < m_bins) {
                // j even: the pair's two bins share a tile row and 16 bytes
                // (ld is even: every stream's row starts 16-byte aligned)
                const float4 fv = *reinterpret_cast<const float4*>(Fc + bin);
                const float4 xv = *reinterpret_cast<const float4*>(rc + j);
                f[u][mt][0] = make_float2(fv.x, fv.y);
                f[u][mt][1] = make_float2(fv.z, fv.w);
                x[u][mt][0] = make_float2(xv.x, xv.y);
                x[u][mt][1] = make_float2(xv.z, xv.w);
              } else {
                if (bin < m_bins) {
                  f[u][mt][0] = Fc[bin];
                  x[u][mt][0] = rc[j];
                }
                const long long bin1 = tile_bin(s_lo[r], j + 1);
                if (k + 1 < n_bins && j + 1 < S && bin1 < m_bins) {
                  f[u][mt][1] = Fc[bin1];
                  x[u][mt][1] = rc[j + 1];
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 a = f[u][mt][e], b = x[u][mt][e];
              re[u][e] += a.x * b.x - a.y * b.y;
              im[u][e] += a.x * b.y + a.y * b.x;
            }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= items) break;
        const int p = 2 * (idx % npair);
        const int off = (rank + cs * (idx / npair)) * xstride + 32 * (p / 16) + p % 16;
        for (int q = 0; q < cs; ++q) {
          float* dst = cluster.map_shared_rank(xs, q);
          *reinterpret_cast<float2*>(dst + off) = make_float2(re[u][0], re[u][1]);
          *reinterpret_cast<float2*>(dst + off + 16) = make_float2(im[u][0], im[u][1]);
        }
      }
    }
    cluster.sync();  // the segment's X tile is in every CTA's shared memory
    if (!active) continue;

    for (; ch < (seg0 + 4 * npair) / kKC; ++ch) {
      cp_async_wait<kAhead - 1>();
      // the tensor cores read the chunk through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // chunk ch landed for all; chunk ch-kAhead's slot is free
      load_chunk(ch + kAhead);
      const float* bsm = bs + (ch % kStages) * kChunkFloats;
#pragma unroll
      for (int s = 0; s < kKC / 8; ++s) {
        const int k0 = ch * kKC - seg0 + s * 8;
        const float a[4] = {xa[k0], xa[8 * xstride + k0], xa[k0 + 4], xa[8 * xstride + k0 + 4]};
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[i] = to_tf32(a[i]);
          alo[i] = to_tf32(a[i] - __uint_as_float(ahi[i]));
        }
        // chunk layout: [k8 step s][column half][hi, lo][4 column groups]
        // [2 k halves][8 columns][4 k], 256 floats a (s, half, part)
        if constexpr (kWM == 4) {
          // warpgroup wn takes the 32 columns of half wn
          const unsigned base = (unsigned)__cvta_generic_to_shared(bsm + (s * 2 + wn) * 512);
          wgmma_fence();
          wgmma_tf32(cor, alo, b_desc(base));
          wgmma_tf32(cor, ahi, b_desc(base + 1024));
          wgmma_tf32(acc, ahi, b_desc(base));
        } else {
#pragma unroll
          for (int jj = 0; jj < kNT; ++jj) {
            const int j8 = wn * kNT + jj;  // n8 tile of the CTA's 8
            const float* b = bsm + (s * 2 + j8 / 4) * 512 + (j8 % 4) * 64 + g * 4 + tig;
            const unsigned bh0 = __float_as_uint(b[0]), bh1 = __float_as_uint(b[32]);
            mma_tf32(cor[jj], alo, bh0, bh1);
            mma_tf32(acc[jj], ahi, bh0, bh1);
            mma_tf32(cor[jj], ahi, __float_as_uint(b[256]), __float_as_uint(b[288]));
          }
        }
      }
      if constexpr (kWM == 4) {
        wgmma_commit();
        // chunk ch-1's products are done: its slot is free to be loaded
        // kStages - kAhead = 2 chunks on, after the next barrier
        wgmma_wait<1>();
      }
    }
  }
  if (!active) return;
  if constexpr (kWM == 4) {
    wgmma_wait<0>();
    fence_operand(acc);
    fence_operand(cor);
  }

  // accumulator (row g [+8], columns 2 tig, 2 tig + 1) = (Re, Im) Y[t];
  // the phase index (slope * (t0 + t)) mod n is exact in 32 bits (n^2 < 2^31)
  const int t0 = n_bins - olen;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int t = (ct * 8 + wn * kNT + jj) * 4 + tig;
    if (t >= olen) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      const int c = c0 + r;
      if (c >= C) continue;
      const float yr = acc[jj][2 * h] + cor[jj][2 * h];
      const float y1 = acc[jj][2 * h + 1] + cor[jj][2 * h + 1];
      const float yi = s_inv[r] ? -y1 : y1;
      const int ph = (int)((unsigned)(s_slope[r] * (t0 + t)) % (unsigned)n_bins);
      float sn, co;
      sincosf(w * (float)ph, &sn, &co);
      out[(long long)c * olen + t] = make_float2(yr * co - yi * sn, yr * sn + yi * co);
    }
  }
}

size_t smem_bytes(int wm, int kseg) {
  return sizeof(float) * ((size_t)kStages * kChunkFloats + (size_t)16 * wm * (kseg + 4));
}

template <int kWM>
int launch(const void* F, long long m_bins, long long ld, int nrows, int real_master,
           const void* inputs, const void* resp, const void* tile_lo, const void* slope,
           const void* shifts, const void* Bop, int C, int S, int olen, int n_bins, int n_pad,
           int kseg, float w, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(kWM, kseg);
  cudaError_t err = cudaFuncSetAttribute(channelize_kernel<kWM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ncol = (2 * olen + kCols - 1) / kCols;
  const int cs = ncol < kCluster ? ncol : kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ncol + cs - 1) / cs * cs, (C + 16 * kWM - 1) / (16 * kWM), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, channelize_kernel<kWM>, (const float2*)F, m_bins, ld, nrows,
                           real_master, (const int*)inputs, (const float2*)resp,
                           (const int*)tile_lo, (const int*)slope, (const int*)shifts,
                           (const float4*)Bop, C, S, olen, n_bins, n_pad, kseg, ncol, w,
                           (float2*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

constexpr size_t kSmemMax = 232448 - 4 * 64 * sizeof(int);  // a block's limit, less s_lo etc.

// Row tile (16 kWM channels) and K rows of X per segment for the padded
// fold n_pad: the most rows (64, 32, 16) whose whole X tile (2 n_pad K rows)
// fits in shared memory; else 16 rows and segments of the most whole chunks
// that fit (2560 K rows, 1280 fold bins).
void plan(int n_pad, int* wm, int* kseg) {
  for (*wm = 4; *wm >= 1; *wm >>= 1)
    if (smem_bytes(*wm, 2 * n_pad) <= kSmemMax) {
      *kseg = 2 * n_pad;
      return;
    }
  *wm = 1;
  *kseg = (int)((kSmemMax / sizeof(float) - kStages * kChunkFloats) / 16 - 4) / kKC * kKC;
}

}  // namespace

// All pointers are device pointers; stream is a cudaStream_t. Bop is the
// constant for (n_bins, olen) from channelize_operand, n_pad = n_bins rounded up
// to 16. inputs is null for one spectrum F [m_bins]; else F is [B, ld], ld
// even, and inputs[c] < B. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ka9q_channelize(const void* F, long long m_bins, long long ld, int nrows,
                               int real_master, const void* inputs, const void* resp,
                               const void* tile_lo, const void* slope, const void* shifts,
                               const void* Bop, int C, int S, int olen, int n_bins, int n_pad,
                               float w, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int wm, kseg;
  plan(n_pad, &wm, &kseg);
  switch (wm) {
    case 4:
      return launch<4>(F, m_bins, ld, nrows, real_master, inputs, resp, tile_lo, slope, shifts,
                       Bop, C, S, olen, n_bins, n_pad, kseg, w, out, st);
    case 2:
      return launch<2>(F, m_bins, ld, nrows, real_master, inputs, resp, tile_lo, slope, shifts,
                       Bop, C, S, olen, n_bins, n_pad, kseg, w, out, st);
    default:
      return launch<1>(F, m_bins, ld, nrows, real_master, inputs, resp, tile_lo, slope, shifts,
                       Bop, C, S, olen, n_bins, n_pad, kseg, w, out, st);
  }
}
