// Q28 crossfeed of the RP2040 chain for Hopper (sm_90a).
//
// The stereo one-pole low-pass + first-order allpass recurrence of the
// crossfeed (usb_audio.c:1064-1073), which the JAX package runs as a
// lax.scan over the segment (dspi_tpu/chain/pipeline.py:1069-1088) and has
// no TPU kernel for.  Eagerly in PyTorch that scan would be ~50 launches a
// sample, ~300k a segment, so the port runs it as this kernel.  Same
// function, bit for bit, as dspi_tpu_torch/kernels/xf_cuda.py:xf_q28_plain.
//
// What bounds it on this card: memory.  Per sample and stream it moves 16
// bytes (two words in, two out) and runs ~64 int32 operations, so at the
// headline's 6144 x 16384 the bytes take longer than the operations.  The
// loop-carried chain is at most two fast_mul_q28 deep a sample, ~0.15 ms
// over such a segment.  What keeps the bytes from flowing is latency: by
// Little's law the card's 3.35 TB/s at ~0.7 us needs ~2.3 MB in flight,
// ~18 KB an SM, and 16384 streams are only ~124 threads an SM.
//
// Design: one thread owns one stream; its four state words (lp L, lp R,
// ap L, ap R) stay in registers over the whole segment and the thread
// walks all T samples, so each word is read once and written once and the
// [T, B] time-major layout coalesces every access across a warp.  The
// inputs come through a ring of kStages tiles in shared memory, each tile
// kTile samples of the thread's own L and R column, filled by cp.async in
// 4-byte granules (any B, any alignment) and committed one group a tile:
// while the thread walks tile k, tiles k+1 .. k+kStages-1 are in flight,
// 384 bytes a thread, ~47 KB an SM at 16384 streams.  A thread reads back
// only what it copied itself, so cp.async.wait_group is the only wait and
// no barrier is needed; a ragged last tile (T not a multiple of kTile, or
// T < kTile) copies and walks only its rows.  Outputs are stored directly,
// coalesced across the warp.  The three coefficients are the same for
// every stream ([3]) or the stream's own ([3, B], per-stream parameters):
// either way each thread reads its three words once and keeps their split
// halves in registers.

// Integer semantics: adds, subtracts, multiplies and the left shift run on
// uint32_t (signed overflow is undefined in C++); the >> 12 and >> 16 are
// arithmetic shifts of the wrapped int32, as core/qmath.q28_mul has them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 16;      // samples a stage
constexpr int kStages = 4;     // 4 x 2 x 16 x 64 words: 32 KB a block

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ void copy4(int32_t* dst, const int32_t* src) {
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

struct Half {
  int32_t h, l;
};
__device__ __forceinline__ Half split(int32_t v) { return {v >> 16, v & 0xFFFF}; }

// fast_mul_q28 (dsp_pipeline.c:47-59) with a pre-split coefficient
__device__ __forceinline__ int32_t qmul(Half a, int32_t v) {
  const Half b = split(v);
  const uint32_t high = static_cast<uint32_t>(a.h) * static_cast<uint32_t>(b.h);
  const int32_t mid = static_cast<int32_t>(
      static_cast<uint32_t>(a.h) * static_cast<uint32_t>(b.l) +
      static_cast<uint32_t>(a.l) * static_cast<uint32_t>(b.h));
  return static_cast<int32_t>((high << 4) + static_cast<uint32_t>(mid >> 12));
}

__global__ void __launch_bounds__(kThreads)
xf_kernel(const int32_t* __restrict__ l, const int32_t* __restrict__ r,
          const int32_t* __restrict__ coef, const int32_t* __restrict__ s_in,
          int32_t* __restrict__ out_l, int32_t* __restrict__ out_r,
          int32_t* __restrict__ s_out, int T, int B, int lane) {
  // [stage][L or R][sample in tile][thread]: a warp's accesses of one
  // sample hit 32 consecutive banks
  __shared__ int32_t ring[kStages][2][kTile][kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  // coef [3], or [3, B] per lane
  const int32_t* c = lane ? coef + b : coef;
  const size_t cs = lane ? sB : 1;
  const Half lp_a0 = split(c[0]), lp_b1 = split(c[cs]),
             ap_a = split(c[2 * cs]);
  int32_t lpL = s_in[b], lpR = s_in[sB + b];
  int32_t apL = s_in[2 * sB + b], apR = s_in[3 * sB + b];

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
      const int32_t ml = ring[st][0][j][tid], mr = ring[st][1][j][tid];
      const int32_t lp_l = add(qmul(lp_a0, ml), qmul(lp_b1, lpL));
      const int32_t lp_r = add(qmul(lp_a0, mr), qmul(lp_b1, lpR));
      const int32_t ap_l = add(qmul(ap_a, lp_l), apL);
      apL = sub(lp_l, qmul(ap_a, ap_l));
      const int32_t ap_r = add(qmul(ap_a, lp_r), apR);
      apR = sub(lp_r, qmul(ap_a, ap_r));
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

// l, r int32 [T, B]; coef int32 [3] (lp_a0, lp_b1, ap_a), or [3, B] with
// lane; s_in int32 [4, B] (lp L, lp R, ap L, ap R) -> out_l, out_r int32
// [T, B], s_out int32 [4, B].  T >= 1, B >= 1.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dspi_xf_q28(const void* l, const void* r, const void* coef,
                           const void* s_in, void* out_l, void* out_r,
                           void* s_out, int T, int B, int lane,
                           void* stream) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  xf_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(coef), static_cast<const int32_t*>(s_in),
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_r),
      static_cast<int32_t*>(s_out), T, B, lane);
  return static_cast<int>(cudaGetLastError());
}
