// The linear demodulator's tail for Hopper (sm_90a), plain C interface.
//
// One block of a linear group without PLL, envelope, stereo or filter2
// (usb, lsb, a cw offset, wspr's fixed gain), from kernel A's [C, N]
// baseband to the muted audio, in one pass. It computes what the plain
// chain computes (ops/cuda_tail.py `linear_tail_plain`: filterbank.py
// fine_tune, the mean |bb|^2, models/linear.py linear_demod with
// ops/agc.py agc_block), per channel row:
//   1. fine tune: acc + adj, sample i rotated by cis(2 pi (acc + i inc)
//      2^-32) in wrapping 32-bit arithmetic; the new acc;
//   2. bb_power, the mean of |bb|^2;
//   3. the CW shift's Q32 NCO, applied where shift_inc != 0; the new
//      shift_acc on every row;
//   4. the AGC's one decision a block (2 ms sub-block peak, block RMS,
//      noise amplitude, hang counter, recovery) and its ramp
//      gain0 exp(i log(gain_change)); the new gain gain0 gain_change^N;
//      manual_gain where the AGC is off;
//   5. mono I detection and output_power;
//   6. the SNR squelch sequencer (squelch_state, squelch_open, the am_dc
//      reset) and the mute: zeros on muted rows.
//
// What bounds it: device-memory bytes. A row is read once (N complex) and
// its audio written once (N float); the chain it replaces ran ~165 PyTorch
// kernels a block over whole [C, N] tensors (int64 NCO ramps, each
// torch.where and dtype conversion a pass of its own). One warp owns one
// row: lane-strided 8-byte loads and 4-byte stores are whole 128-byte lines
// a warp, the sums are warp shuffles, and the row's rotated real parts and
// powers wait in the warp's slice of shared memory (8 N bytes) between the
// decision-free first pass and the second, which needs the block's AGC
// decision; nothing but the audio and the [C] results goes back to device
// memory. Any N up to 29,056 runs: a CTA takes as many rows (up to 8) as
// 48 KB of shared memory holds, a longer row a CTA of its own.
//
// The file is compiled with -fmad=false and uses the full-precision
// sincosf/expf/logf/powf, never the __ intrinsics: every operation rounds
// once, in the order of the plain chain, which PyTorch runs one kernel an
// operation. Only the sums' order differs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kQ32ToRev = 2.3283064365386963e-10f;    // 2^-32
constexpr float kTwoPi = 6.2831854820251465f;           // float32(2 pi)
constexpr float kSqrt2 = 1.41421353816986083984375f;    // float32(1.4142135)
constexpr float kEps = 1e-30f;
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;  // loads a lane issues before it computes on them
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSharedDefault = 48 * 1024;  // a CTA's shared memory without opting in
constexpr size_t kMaxShared = 227 * 1024;      // an sm_90 CTA's opt-in limit
constexpr int kMaxDevices = 64;

// the inputs, in the order of ops/cuda_tail.py _TAIL_IN; every pointer is
// [C] but bb [C, N] complex64; bools are one byte a channel
struct In {
  const float2* bb;
  const int* acc_q32;
  const int* inc_q32;
  const int* adj_q32;
  const float* n0;
  const float* gain;
  const int* hangcount;
  const int* shift_acc;
  const float* am_dc;
  const int* squelch_state;
  const unsigned char* squelch_open;
  const unsigned char* agc_enable;
  const float* headroom;
  const int* hangtime_samples;
  const float* recovery_per_sample;
  const float* threshold;
  const float* bandwidth;
  const float* manual_gain;
  const int* shift_inc_q32;
  const float* open_thr;
  const float* close_thr;
  const int* squelch_tail;
  const unsigned char* snr_squelch_enable;
};
constexpr int kNIn = 23;
static_assert(sizeof(In) == kNIn * sizeof(void*), "In is a list of pointers");

// the outputs, in the order of ops/cuda_tail.py _TAIL_OUT; audio [C, N]
struct Out {
  int* acc_q32;
  float* bb_power;
  float* gain;
  int* hangcount;
  int* shift_acc;
  float* am_dc;
  int* squelch_state;
  unsigned char* squelch_open;
  float* audio;
  float* output_power;
  float* snr;
  unsigned char* send;
  unsigned char* pll_lock;
};
constexpr int kNOut = 13;
static_assert(sizeof(Out) == kNOut * sizeof(void*), "Out is a list of pointers");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the phasor of Q32 phase word q: (cos, sin) of (q 2^-32) 2 pi
__device__ __forceinline__ void cis_q32(unsigned q, float* c, float* s) {
  const float ang = ((float)(int)q * kQ32ToRev) * kTwoPi;
  sincosf(ang, s, c);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
linear_tail_kernel(In in, Out out, int C, int N, long long ld, int sps, int nslices,
                   int hang_peak, float inv_n, float inv_sps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // a whole warp: nothing below waits on a CTA barrier
  float* pw = smem + (size_t)warp * 2 * N;  // |bb|^2 after the CW shift
  float* re = pw + N;                        // Re bb after the CW shift

  // -- pass 1: fine tune, bb_power, CW shift, the powers the AGC reads --
  const float2* x = in.bb + c * ld;
  const unsigned acc = (unsigned)in.acc_q32[c] + (unsigned)in.adj_q32[c];
  const unsigned inc = (unsigned)in.inc_q32[c];
  const unsigned sacc = (unsigned)in.shift_acc[c], sinc = (unsigned)in.shift_inc_q32[c];
  float psum = 0.f;
  for (int i0 = lane; i0 < N; i0 += 32 * kUnroll) {
    float2 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = i0 + 32 * k;
      v[k] = i < N ? x[i] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = i0 + 32 * k;
      if (i < N) {
        float co, si;
        cis_q32(acc + inc * (unsigned)i, &co, &si);
        float a = v[k].x * co - v[k].y * si;
        float b = v[k].x * si + v[k].y * co;
        psum += a * a + b * b;
        if (sinc != 0u) {
          cis_q32(sacc + sinc * (unsigned)i, &co, &si);
          const float a2 = a * co - b * si;
          b = a * si + b * co;
          a = a2;
        }
        pw[i] = a * a + b * b;
        re[i] = a;
      }
    }
  }
  const float bb_power = warp_sum(psum) * inv_n;
  __syncwarp();

  // -- the AGC's decision (agc_block): the 2 ms sub-block peak first --
  float pk = 0.f;
  for (int s = lane; s < nslices; s += 32) {
    const float* p = pw + (size_t)s * sps;
    float t = 0.f;
    for (int j = 0; j < sps; ++j) t += p[j];
    pk = fmaxf(pk, t * inv_sps);
  }
  const float peak = sqrtf(warp_max(pk));
  const float gain = in.gain[c];
  const int hang = in.hangcount[c];
  const float headroom = in.headroom[c], threshold = in.threshold[c];
  const float bandwidth = in.bandwidth[c], n0 = in.n0[c];
  const bool enable = in.agc_enable[c] != 0;
  const float ampl = sqrtf(bb_power);
  const float bn = sqrtf(bandwidth * fmaxf(n0, 0.f));  // noise amplitude
  float gc = 1.f, g0 = gain;
  int nh = hang;
  if (enable) {
    if (peak * gain > kSqrt2 * headroom) {  // clamp at once, hang 80 ms
      g0 = kSqrt2 * headroom / fmaxf(peak, kEps);
      nh = hang_peak;
    } else if (ampl * gain > headroom) {  // strong: down to the target over the block
      gc = powf(fmaxf(headroom / (ampl * gain + kEps), kEps), inv_n);
      nh = in.hangtime_samples[c];
    } else if (bn * gain > threshold * headroom) {  // noisy: down, the hang kept
      gc = powf(fmaxf(threshold * headroom / (bn * gain + kEps), kEps), inv_n);
    } else if (hang > 0) {  // hold
      nh = max(hang - N, 0);
    } else {  // recover
      gc = in.recovery_per_sample[c];
    }
  }
  const float lg = logf(gc);
  const float new_gain = g0 * powf(gc, (float)N);

  // -- the SNR squelch sequencer (linear.c:344-388) --
  const bool sq_en = in.snr_squelch_enable[c] != 0;
  const float open_thr = in.open_thr[c], close_thr = in.close_thr[c];
  const float snr = sq_en ? bb_power / fmaxf(n0 * bandwidth, kEps) - 1.f : INFINITY;
  int sq = in.squelch_state[c];
  sq = (!sq_en || snr >= open_thr) ? in.squelch_tail[c] + 4
                                   : ((sq > 0 && snr < close_thr) ? sq - 1 : sq);
  const bool was_open = in.squelch_open[c] != 0;
  const bool open = (sq_en && snr < close_thr)
                        ? false
                        : ((sq_en && !was_open && snr > open_thr) ? true : (was_open || !sq_en));
  const bool mute = sq < 4 || !open;  // 3..1 emit zeros, 0 fully closed, >= 4 open

  // -- pass 2: the gain ramp, mono I, output_power; zeros where muted --
  float* y = out.audio + (size_t)c * N;
  float opow = 0.f;
  if (mute) {
    for (int i = lane; i < N; i += 32) y[i] = 0.f;
  } else {
    const float manual = in.manual_gain[c];
    float osum = 0.f;
    for (int i = lane; i < N; i += 32) {
      const float g = enable ? g0 * expf((float)i * lg) : manual;
      const float a = g * re[i];
      y[i] = a;
      osum += a * a;
    }
    opow = 2.f * (warp_sum(osum) * inv_n);  // +3 dB mono
  }
  if (lane == 0) {
    out.acc_q32[c] = (int)(acc + inc * (unsigned)N);
    out.bb_power[c] = bb_power;
    out.gain[c] = new_gain;
    out.hangcount[c] = nh;
    out.shift_acc[c] = (int)(sacc + sinc * (unsigned)N);
    out.am_dc[c] = (sq_en && open && !was_open) ? 0.f : in.am_dc[c];
    out.squelch_state[c] = sq;
    out.squelch_open[c] = open;
    out.output_power[c] = opow;
    out.snr[c] = snr;
    out.send[c] = sq > 0;  // RTP frames still flow during the closing tail
    out.pll_lock[c] = 0;
  }
}

}  // namespace

// in: kNIn device pointers, out: kNOut (the structs' order); C rows of N
// samples, bb's rows ld samples apart (the per-element channelizer's
// baseband is a column slice of its inverse FFT); sps samples a sub-block
// and nslices sub-blocks of the AGC's peak; hang_peak the hang after a peak
// clamp (80 ms of samples); inv_n and inv_sps the chain's float32 1/N and
// 1/sps; stream a cudaStream_t. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue where one row's 8 N bytes of shared memory do not
// fit in 227 KB).
extern "C" int ka9q_linear_tail(int C, int N, long long ld, int sps, int nslices, int hang_peak,
                                float inv_n, float inv_sps, const void* const* in,
                                void* const* out, void* stream) {
  if (C <= 0 || N <= 0 || ld < N || sps <= 0 || nslices <= 0 || (size_t)nslices * sps > (size_t)N)
    return (int)cudaErrorInvalidValue;
  // as many warps (rows) a CTA as 48 KB holds; a row past it (N > 6,144)
  // alone in its CTA, opted in once a device
  const size_t row = (size_t)N * 2 * sizeof(float);
  if (row > kMaxShared) return (int)cudaErrorInvalidValue;
  const size_t fit = kSharedDefault / row;
  const int warps = fit >= (size_t)kMaxWarps ? kMaxWarps : fit > 0 ? (int)fit : 1;
  const size_t shared = row * warps;
  if (shared > kSharedDefault) {
    static bool opted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      e = cudaFuncSetAttribute(linear_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxShared);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = true;
    }
  }
  In i;
  Out o;
  const void** ip = reinterpret_cast<const void**>(&i);
  void** op = reinterpret_cast<void**>(&o);
  for (int k = 0; k < kNIn; ++k) ip[k] = in[k];
  for (int k = 0; k < kNOut; ++k) op[k] = out[k];
  linear_tail_kernel<<<(C + warps - 1) / warps, warps * 32, shared, (cudaStream_t)stream>>>(
      i, o, C, N, ld, sps, nslices, hang_peak, inv_n, inv_sps);
  return (int)cudaGetLastError();
}
