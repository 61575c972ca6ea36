// Fused tile channelizer for Hopper (sm_90a), plain C interface for ctypes:
// kernel A of the port, in two designs that compute the same function, a
// one-shot grid and a persistent one (ops/cuda_channelize.py
// `channelize_plan` picks one from the launch's shape and the card's SMs).
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
// Product. Both designs run it on the tensor cores in split ("3xTF32")
// precision: one TF32 pass keeps 11 significant bits, too few for the
// 3e-5 * scale parity bound, so every product is split,
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,  a_hi = rna_tf32(a),
//   a_lo = rna_tf32(a - a_hi),
// which is accurate to about FP32, of X with cvt.rna.tf32.f32 in the
// kernel, of the constant as channelize_operand splits it.
//
// The one-shot design (channelize_kernel, every launch of few row tiles):
// one real GEMM,
//   [Xr | Xi] (rows x 2n) . [[Er, Ei], [-Ei, Er]] (2n x 2 olen),
// output columns interleaved (2t = Re Y[t], 2t + 1 = Im Y[t]) so that each
// thread's accumulator pair is one complex sample, and K taken in chunks of
// 32 rows, each the Re and then the Im parts of 16 fold bins, so that any
// run of whole chunks is a run of fold bins. The constant operand (the
// real-block E, padded to the MMA's K and N, hi and lo already split, in
// K-major core matrices) is a group constant built once on the device
// (`channelize_operand`). A 64-row tile (n <= 320, rx888's 300 included)
// runs wgmma.m64n32k8: each warpgroup takes 32 columns, A from registers, B
// from the ring through an unswizzled descriptor. Smaller tiles (16 or 32
// rows, when a wider slice's X tile leaves less shared memory) run
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
//
// The persistent design (channelize_kernel_persist, below) replaces that
// grid where it is many waves deep. At the flagship (C 32,728, n 300, olen
// 240) the one-shot grid is 8 column tiles x 512 row tiles, 4,096 one-shot
// CTAs in about 31 waves, each gathering half its row tile and then
// streaming 19 chunks of the constant, nothing overlapping the two: the
// constant (2.49 MB) read by every row tile, 1.27 GB, and every row
// gathered by the four clusters of its row tile, 1.05 GB, so 2.3 GB
// through L2 a launch, about 2.5 TB/s at its 0.915 ms, against 57 GFLOP of
// TF32 (0.115 ms at the peak). The persistent design gathers each row once
// (0.27 GB: 512 master and 512 response bins a channel), reads of the
// constant only its n values, 2.4 KB a CTA, and writes 63 MB: about 0.33 GB
// a launch. The gather runs under the products, so what bounds it is the
// tensor cores: 61 GFLOP of wgmma (olen padded to 256) at 132 SMs, 0.124 ms
// at the peak, against about 0.27 ms of m64n32k8 steps measured without
// the gather (PERF.md §6). Its N is 32 channels because X's hi and lo parts
// for a row tile share the 227 KB of shared memory with nothing else.
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
// keeps the compiler from moving the definitions of A fragments computed in
// registers past the wgmma.fence that opens the step reading them
__device__ __forceinline__ void fence_fragment(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
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

// ---------------------------------------------------------------------------
// The persistent design (launches of many row tiles; ops/cuda_channelize.py
// `channelize_plan` picks it). One CTA an SM, each walking row tiles of
// kPRows channels (tile = blockIdx.x, += gridDim.x). The product runs
// transposed,
//   Y^T [olen x rows] = E^T [olen x n] . X^T [n x rows],
// as wgmma.m64n32k8 with the constant as A, in registers, and X^T as B, in
// shared memory (its TF32 hi and lo parts, each [n_pad / 4][kPRows][4]).
// Warpgroups 0 and 1 multiply: in each pass over K, kPMT M tiles of 32
// samples each (Re and Im of a sample in rows g and g + 8 of a warp's 16).
// Warpgroup 2 gathers and folds: each row once a launch, a k8 step of the
// next row tile at a time, into the X rows that the last pass of the row
// tile before has done with, so that the gather runs under the products.
// Each k8 step of X has a `full` barrier (the gatherers wrote it) and an
// `empty` one (every multiplying warp is done with it).
//
// The constant is not read from device memory in the loop: its entries are
// E[k, t] = T[((k - n/2) (n - olen + t)) mod n], n values (the
// tiled_idft_matrix), so each CTA copies the n values out of E once into a
// table, and each thread looks up its A fragments there, a k8 step at a
// time, and splits them as channelize_operand does (the operand's bits).
//
// Only the Re-x rows of the real-block constant are used ([Er, Ei]): its
// Im-x rows [-Ei, Er] are the same numbers, so X's Im parts run against
// them into a second accumulator Q, and Y = (P_re - Q_im) + i (P_im +
// Q_re). The products are the one-shot kernel's (the TF32 split is odd,
// rna(-x) = -rna(x)); only the order of the sum over K differs. The three
// split products of a step go into one accumulator, smallest first.
constexpr int kPRows = 32;       // channels a row tile (the wgmma's N)
constexpr int kPThreads = 384;   // two multiplying warpgroups and a gathering one
constexpr int kPMT = 2;          // M tiles of 32 output samples a warpgroup holds
constexpr int kPMaxN = 320;      // the table's entries: n_bins <= n_pad <= 320
constexpr int kPSteps = kPMaxN / 8;  // k8 steps of X, at most
constexpr int kPD = 4;           // k8 steps a gatherer has in flight

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\nbra LAB_WAIT;\nLAB_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// arrives on the barrier if `on` (a predicate, not a branch)
__device__ __forceinline__ void mbar_arrive_if(unsigned bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((unsigned)on)
      : "memory");
}

// Descriptor of a K-major, unswizzled B tile of 32 channels x 8 k at shared
// address saddr: core matrices of 8 channels x 4 k (128 contiguous bytes),
// the next 4 k kPRows * 16 bytes on, the next 8 channels 128 bytes on.
__device__ __forceinline__ unsigned long long x_desc(unsigned saddr) {
  return (unsigned long long)((saddr & 0x3FFFF) >> 4) |
         ((unsigned long long)((kPRows * 16) >> 4) << 16) | ((unsigned long long)(128 >> 4) << 32);
}

__global__ void __launch_bounds__(kPThreads, 1)
channelize_kernel_persist(const float2* __restrict__ F, long long m_bins, long long ld,
                          int nrows, int real_master, const int* __restrict__ inputs,
                          const float2* __restrict__ resp, const int* __restrict__ tile_lo,
                          const int* __restrict__ slope, const int* __restrict__ shifts,
                          const float2* __restrict__ E, int C, int S, int olen, int n_bins,
                          int n_pad, float w, float2* __restrict__ out) {
  // [X: Re hi, Re lo, Im hi, Im lo, each [n_pad / 4][kPRows][4]][table: the n values of
  // E][full, empty barriers of each k8 step]
  extern __shared__ __align__(128) float psm_f[];
  const int xsz = n_pad * kPRows, nsteps = n_pad / 8;
  float2* tab = reinterpret_cast<float2*>(psm_f + 4 * xsz);
  const unsigned xs0 = (unsigned)__cvta_generic_to_shared(psm_f);
  const unsigned full0 = (unsigned)__cvta_generic_to_shared(tab + kPMaxN);
  const unsigned empty0 = full0 + 8 * kPSteps;
  __shared__ int g_lo[kPRows], g_in[kPRows], e_slope[kPRows], e_inv[kPRows];

  const int n = n_bins, half_n = n_bins / 2, t0 = n_bins - olen;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup and its warp, through a shuffle: the compiler then knows
  // them uniform over the warp, and every path to a wgmma warpgroup-uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int w4 = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  if (tid == 0) {
    for (int s = 0; s < nsteps; ++s) {
      mbar_init(full0 + 8 * s, 128);  // every gatherer
      mbar_init(empty0 + 8 * s, 8);   // a lane of every multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the table: T[m] = E[k, olen - 1] for k = (n/2 - m) mod n
  for (int m = tid; m < n; m += kPThreads)
    tab[m] = E[(size_t)((half_n - m + n) % n) * olen + olen - 1];
  __syncthreads();
  const int ntiles = (C + kPRows - 1) / kPRows;

  if (wg == 2) {
    // the gatherers: a k8 step of a row tile is 128 items, one a thread: fold
    // bins k, k + 1 (k = 8 s + 4 grp + 2 sub) of channel r, the Re and Im
    // parts' TF32 hi and lo to [k / 4][r][k % 4] of each X array
    const int gt = tid - 256, sub = gt & 1, r = (gt >> 1) % kPRows, grp = gt / (2 * kPRows);
    const int nterm = (S + n_bins - 1) / n_bins;
    const int off = (grp * kPRows + r) * 4 + 2 * sub;
    int it = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int c = tile * kPRows + r;
      asm volatile("bar.sync 2, 128;\n" ::: "memory");  // done with the last tile's rows
      if (gt < kPRows) {
        const int ch = tile * kPRows + gt;
        g_lo[gt] = ch < C ? tile_lo[ch] : 0;
        g_in[gt] = ch < C && inputs != nullptr ? inputs[ch] : 0;
      }
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      const int lo_r = g_lo[r];
      const float2* rc = resp + (long long)c * S;
      const float2* Fc = F + (long long)g_in[r] * ld;
      auto tile_bin = [&](int j) -> long long {
        int row = lo_r + j / kTile;
        if (real_master) {
          row = min(max(row, 0), nrows - 1);
        } else {
          row %= nrows;
          if (row < 0) row += nrows;
        }
        return (long long)row * kTile + (j % kTile);
      };
      for (int s0 = 0; s0 < nsteps; s0 += kPD) {
        float re[kPD][2], im[kPD][2];
#pragma unroll
        for (int u = 0; u < kPD; ++u) re[u][0] = re[u][1] = im[u][0] = im[u][1] = 0.f;
        for (int m0 = 0; m0 < nterm; m0 += kMT) {
          float2 f[kPD][kMT][2], x[kPD][kMT][2];
#pragma unroll
          for (int u = 0; u < kPD; ++u) {
            const int k = 8 * (s0 + u) + 4 * grp + 2 * sub;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              const int j = k + (m0 + mt) * n_bins;
              const float2 z = make_float2(0.f, 0.f);
              f[u][mt][0] = f[u][mt][1] = x[u][mt][0] = x[u][mt][1] = z;
              if (s0 + u < nsteps && c < C && k < n_bins && j < S) {
                const long long bin = tile_bin(j);
                if ((j & 1) == 0 && k + 1 < n_bins && bin + 1 < m_bins) {
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
                  const long long bin1 = tile_bin(j + 1);
                  if (k + 1 < n_bins && j + 1 < S && bin1 < m_bins) {
                    f[u][mt][1] = Fc[bin1];
                    x[u][mt][1] = rc[j + 1];
                  }
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kPD; ++u)
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
        for (int u = 0; u < kPD; ++u) {
          const int s = s0 + u;
          if (s >= nsteps) break;
          float hi[4], lo[4];
          const float v[4] = {re[u][0], re[u][1], im[u][0], im[u][1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = __uint_as_float(to_tf32(v[e]));
            lo[e] = __uint_as_float(to_tf32(v[e] - hi[e]));
          }
          // the multiplying warps are done with step s of the last row tile
          mbar_wait(empty0 + 8 * s, (it & 1) ^ 1);
          float* xs = psm_f + s * 2 * kPRows * 4 + off;
          *reinterpret_cast<float2*>(xs) = make_float2(hi[0], hi[1]);
          *reinterpret_cast<float2*>(xs + xsz) = make_float2(lo[0], lo[1]);
          *reinterpret_cast<float2*>(xs + 2 * xsz) = make_float2(hi[2], hi[3]);
          *reinterpret_cast<float2*>(xs + 3 * xsz) = make_float2(lo[2], lo[3]);
          // the tensor cores read X through the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive_if(full0 + 8 * s, true);
        }
      }
    }
    return;
  }

  // the multiplying warpgroups
  const int g = lane >> 2, tig = lane & 3;
  const int nmt = (olen + 31) / 32;                          // M tiles
  const int npass = (nmt + 2 * kPMT - 1) / (2 * kPMT);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int c0 = tile * kPRows;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the last tile's epilogues are done
    if (tid < kPRows) {
      const int c = c0 + tid;
      e_slope[tid] = c < C ? (slope[c] % n_bins + n_bins) % n_bins : 0;
      e_inv[tid] = c < C && real_master && shifts[c] < 0;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int p = 0; p < npass; ++p) {
      const int mt0 = 2 * kPMT * p + kPMT * wg;
      const bool last = p == npass - 1;
      // this thread's A fragments of M tile mt0 + u: sample t = 32 (mt0 +
      // u) + 8 w4 + g, fold bins k8 + tig and + 4; the table index of the
      // first, and what four and eight more fold bins add (mod n). M tiles
      // past the last sample run on zero fragments (no branch around a wgmma)
      int mi[kPMT], d4[kPMT], d8[kPMT];
      bool valid[kPMT];
#pragma unroll
      for (int u = 0; u < kPMT; ++u) {
        const int t = 32 * (mt0 + u) + 8 * w4 + g;
        valid[u] = t < olen;
        const int tt = (t0 + t) % n;
        d4[u] = (4 * tt) % n;
        d8[u] = (8 * tt) % n;
        mi[u] = ((tig - half_n + n) * tt) % n;
      }
      // P = E^T . Xr^T, Q = E^T . Xi^T: [M tile][n8 tile of 8 channels][4]
      float P[kPMT][4][4], Q[kPMT][4][4];
#pragma unroll
      for (int u = 0; u < kPMT; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) P[u][j][i] = Q[u][j][i] = 0.f;
#pragma unroll
      for (int u = 0; u < kPMT; ++u) {
        fence_operand(P[u]);
        fence_operand(Q[u]);
      }
      // two sets of A fragments, so that a step's lookups never write the
      // registers the tensor cores may still read for the step before
      unsigned ahi[2][kPMT][4], alo[2][kPMT][4];
      for (int k16 = 0; k16 < n_pad; k16 += 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k8 = k16 + 8 * h, s = k8 / 8;
#pragma unroll
          for (int u = 0; u < kPMT; ++u) {
            int m2 = mi[u] + d4[u];
            if (m2 >= n) m2 -= n;
            const float2 z = make_float2(0.f, 0.f);
            const float2 va = valid[u] && k8 + tig < n ? tab[mi[u]] : z;
            const float2 vb = valid[u] && k8 + tig + 4 < n ? tab[m2] : z;
            // rows g (Re) and g + 8 (Im) of the sample, fold bins k8 + tig, + 4
            const float a[4] = {va.x, va.y, vb.x, vb.y};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ahi[h][u][i] = to_tf32(a[i]);
              alo[h][u][i] = to_tf32(a[i] - __uint_as_float(ahi[h][u][i]));
            }
            mi[u] += d8[u];
            if (mi[u] >= n) mi[u] -= n;
            fence_fragment(ahi[h][u]);
            fence_fragment(alo[h][u]);
          }
          if (p == 0) mbar_wait(full0 + 8 * s, it & 1);  // the gatherers wrote step s
          // B: X^T's fold bins k8 .. k8 + 7 (two groups of 4, kPRows * 16 bytes apart)
          const unsigned xk = xs0 + (k8 / 4) * kPRows * 16;
          const unsigned long long rh = x_desc(xk), rl = x_desc(xk + 4 * xsz),
                                   ih = x_desc(xk + 8 * xsz), il = x_desc(xk + 12 * xsz);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < kPMT; ++u) {
            wgmma_tf32(P[u], alo[h][u], rh);
            wgmma_tf32(Q[u], alo[h][u], ih);
          }
#pragma unroll
          for (int u = 0; u < kPMT; ++u) {
            wgmma_tf32(P[u], ahi[h][u], rl);
            wgmma_tf32(Q[u], ahi[h][u], il);
          }
#pragma unroll
          for (int u = 0; u < kPMT; ++u) {
            wgmma_tf32(P[u], ahi[h][u], rh);
            wgmma_tf32(Q[u], ahi[h][u], ih);
          }
          wgmma_commit();
          wgmma_wait<1>();
          // the step before is done with its X: the last pass hands it back
          if (s > 0) mbar_arrive_if(empty0 + 8 * (s - 1), last && lane == 0);
        }
      }
      wgmma_wait<0>();
      mbar_arrive_if(empty0 + 8 * (nsteps - 1), last && lane == 0);
#pragma unroll
      for (int u = 0; u < kPMT; ++u) {
        fence_operand(P[u]);
        fence_operand(Q[u]);
      }

      // accumulator (rows g, g + 8: Re, Im of sample t; columns 2 tig, 2 tig
      // + 1 of n8 tile j: channels 8 j + 2 tig + cc)
#pragma unroll
      for (int u = 0; u < kPMT; ++u) {
        const int t = 32 * (mt0 + u) + 8 * w4 + g;
        if (!valid[u]) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 8 * j + 2 * tig + cc;
            const int c = c0 + r;
            if (c >= C) continue;
            const float yr = P[u][j][cc] - Q[u][j][2 + cc];
            const float y1 = P[u][j][2 + cc] + Q[u][j][cc];
            const float yi = e_inv[r] ? -y1 : y1;
            const int ph = (int)((unsigned)(e_slope[r] * (t0 + t)) % (unsigned)n_bins);
            float sn, co;
            sincosf(w * (float)ph, &sn, &co);
            out[(long long)c * olen + t] = make_float2(yr * co - yi * sn, yr * sn + yi * co);
          }
      }
    }
  }
}

size_t persist_smem_bytes(int n_pad) {
  return sizeof(float) * 4 * (size_t)n_pad * kPRows + sizeof(float2) * kPMaxN + 16 * kPSteps;
}

int launch_persist(const void* F, long long m_bins, long long ld, int nrows, int real_master,
                   const void* inputs, const void* resp, const void* tile_lo, const void* slope,
                   const void* shifts, const void* E, int C, int S, int olen, int n_bins,
                   int n_pad, float w, void* out, cudaStream_t stream) {
  const size_t smem = persist_smem_bytes(n_pad);
  if (smem > kSmemMax || n_pad > kPMaxN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(channelize_kernel_persist,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (C + kPRows - 1) / kPRows;
  channelize_kernel_persist<<<min(ntiles, sms), kPThreads, smem, stream>>>(
      (const float2*)F, m_bins, ld, nrows, real_master, (const int*)inputs, (const float2*)resp,
      (const int*)tile_lo, (const int*)slope, (const int*)shifts, (const float2*)E, C, S, olen,
      n_bins, n_pad, w, (float2*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are device pointers; stream is a cudaStream_t. Bop is the
// constant for (n_bins, olen) from channelize_operand, n_pad = n_bins rounded up
// to 16, E the [S, olen] IDFT matrix it was built from. inputs is null for
// one spectrum F [m_bins]; else F is [B, ld], ld even, and inputs[c] < B.
// persist picks the persistent design (the caller's channelize_plan; it reads
// E), else the one-shot one (it reads Bop). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ka9q_channelize(const void* F, long long m_bins, long long ld, int nrows,
                               int real_master, const void* inputs, const void* resp,
                               const void* tile_lo, const void* slope, const void* shifts,
                               const void* Bop, const void* E, int C, int S, int olen, int n_bins,
                               int n_pad, float w, int persist, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (persist)
    return launch_persist(F, m_bins, ld, nrows, real_master, inputs, resp, tile_lo, slope,
                          shifts, E, C, S, olen, n_bins, n_pad, w, out, st);
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
