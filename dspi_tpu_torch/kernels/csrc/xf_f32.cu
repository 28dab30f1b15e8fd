// Float crossfeed of the RP2350 chain for Hopper (sm_90a).
//
// The stereo one-pole low-pass + first-order allpass recurrence of the
// crossfeed (usb_audio.c:737-749), which the JAX package runs as a lax.scan
// over the segment (dspi_tpu/chain/pipeline.py:594-611, xf_body) and has no
// TPU kernel for.  Eagerly in PyTorch that scan would be ~14 launches a
// sample, ~86k a segment, so the port runs it as this kernel.  Same
// function, bit for bit, as dspi_tpu_torch/kernels/xf_f32_cuda.py:
// xf_f32_plain: every multiply, add and subtract is __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into a fused multiply-add.
//
// What bounds it on this card: memory.  Per sample and stream it moves 16
// bytes (two words in, two out) and runs 14 float operations, so at the
// headline's 6144 x 16384 the bytes take longer than the operations.  What
// keeps the bytes from flowing is latency: 16384 streams are only ~124
// threads an SM, too few loads in flight at one a thread.
//
// Design: the Q28 crossfeed's (xf_q28.cu).  One thread owns one stream;
// its four state words (lp L, lp R, ap L, ap R) stay in registers over the
// whole segment and the thread walks all T samples, so each word is read
// once and written once and the [T, B] time-major layout coalesces every
// access across a warp.  The inputs come through a ring of kStages tiles in
// shared memory, each tile kTile samples of the thread's own L and R
// column, filled by cp.async in 4-byte granules and committed one group a
// tile: while the thread walks tile k, tiles k+1 .. k+kStages-1 are in
// flight.  A thread reads back only what it copied itself, so
// cp.async.wait_group is the only wait and no barrier is needed; a ragged
// last tile copies and walks only its rows.  The three coefficients are
// the same for every stream ([3]) or the stream's own ([3, B], per-stream
// parameters); each thread reads its three once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 16;      // samples a stage
constexpr int kStages = 4;     // 4 x 2 x 16 x 64 words: 32 KB a block

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's newest groups are pending
template <int n>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__global__ void __launch_bounds__(kThreads)
xf_kernel(const float* __restrict__ l, const float* __restrict__ r,
          const float* __restrict__ coef, const float* __restrict__ s_in,
          float* __restrict__ out_l, float* __restrict__ out_r,
          float* __restrict__ s_out, int T, int B, int lane) {
  // [stage][L or R][sample in tile][thread]: a warp's accesses of one
  // sample hit 32 consecutive banks
  __shared__ float ring[kStages][2][kTile][kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  // coef [3], or [3, B] per lane
  const float* c = lane ? coef + b : coef;
  const size_t cs = lane ? sB : 1;
  const float lp_a0 = c[0], lp_b1 = c[cs], ap_a = c[2 * cs];
  float lpL = s_in[b], lpR = s_in[sB + b];
  float apL = s_in[2 * sB + b], apR = s_in[3 * sB + b];

  const int tiles = (T + kTile - 1) / kTile;
  // copies tile k's rows of this thread's column into its stage
  auto fetch = [&](int k) {
    const int t0 = k * kTile, st = k % kStages;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (t0 + j < T) {
        const size_t i = static_cast<size_t>(t0 + j) * sB + b;
        copy4(&ring[st][0][j][tid], l + i);
        copy4(&ring[st][1][j][tid], r + i);
      }
    }
  };
  // one group a tile, empty past the end, so that the count of pending
  // groups says which tile has landed
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) fetch(k);
    commit();
  }
  for (int k = 0; k < tiles; ++k) {
    if (k + kStages - 1 < tiles) fetch(k + kStages - 1);
    commit();
    wait_pending<kStages - 1>();                    // tile k has landed
    const int t0 = k * kTile, st = k % kStages;
    const int rows = min(kTile, T - t0);
    for (int j = 0; j < rows; ++j) {
      const size_t i = static_cast<size_t>(t0 + j) * sB + b;
      const float ml = ring[st][0][j][tid], mr = ring[st][1][j][tid];
      const float lp_l = add(mul(lp_a0, ml), mul(lp_b1, lpL));
      const float lp_r = add(mul(lp_a0, mr), mul(lp_b1, lpR));
      const float ap_l = add(mul(ap_a, lp_l), apL);
      apL = sub(lp_l, mul(ap_a, ap_l));
      const float ap_r = add(mul(ap_a, lp_r), apR);
      apR = sub(lp_r, mul(ap_a, ap_r));
      lpL = lp_l;
      lpR = lp_r;
      out_l[i] = add(sub(ml, lp_l), ap_r);
      out_r[i] = add(sub(mr, lp_r), ap_l);
    }
  }
  s_out[b] = lpL;
  s_out[sB + b] = lpR;
  s_out[2 * sB + b] = apL;
  s_out[3 * sB + b] = apR;
}

}  // namespace

// l, r float [T, B]; coef float [3] (lp_a0, lp_b1, ap_a), or [3, B] with
// lane; s_in float [4, B] (lp L, lp R, ap L, ap R) -> out_l, out_r float
// [T, B], s_out float [4, B].  T >= 1, B >= 1.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dspi_xf_f32(const void* l, const void* r, const void* coef,
                           const void* s_in, void* out_l, void* out_r,
                           void* s_out, int T, int B, int lane,
                           void* stream) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  xf_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(r),
      static_cast<const float*>(coef), static_cast<const float*>(s_in),
      static_cast<float*>(out_l), static_cast<float*>(out_r),
      static_cast<float*>(s_out), T, B, lane);
  return static_cast<int>(cudaGetLastError());
}
