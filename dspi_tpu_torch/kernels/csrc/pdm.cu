// PDM delta-sigma modulator for Hopper (sm_90a).
//
// Replaces the TPU kernel dspi_tpu/kernels/pdm_pallas.py:_pdm_kernel (with
// its per-sample body _modulate_sample).  Same function, bit for bit: per
// stream and sample, clip and fade-in, the enable/fade-out machine, then 8
// chunks of xorshift32 TPDF dither through the Q14 noise shaper and 32
// bit steps each, then the leaky integrators (pdm_generator.c:320-397).
// Out: 8 words per sample, the silence word while the hardware is stopped.
//
// What bounds it on this card: integer latency, not memory.  Per sample
// and stream it moves 36 bytes (4 in, 32 out) but runs 256 bit steps that
// form one serial dependency chain.  The time axis is a true recurrence,
// so the only parallel axis is the stream axis: 16384 streams are 512
// warps on the 528 warp schedulers of 132 SMs, one warp a scheduler and
// nothing to hide its latency.  So a segment takes about T x 256 x (the
// bit step's chain latency), and above 528 warps, where some schedulers
// hold two, the bit step's issue count.
//
// What the design does about it:
//  * one thread owns one stream; its 13 state words stay in registers for
//    the whole segment and the thread loops over all T samples, so device
//    memory sees each input word once and each output word once, and the
//    [T, B] / [T, 8, B] time-major layouts make every load and store
//    coalesced across a warp.  The next sample's input is loaded one
//    sample ahead, so no sample waits on a load;
//  * the bit step moves from the integer ALU to both integer pipes.  With
//    g = errm + t65 carried beside e2d = err2 + dither and the sign mask
//    m = e2d >> 31 (0 if the bit is 1, else -1),
//        e2d' = (e2d + g) + m * -131070;   g' = (g + t65) + m * -65535
//    (m & c == m * -c for m in {0, -1}, wrapping): six instructions, the
//    two products and an add on the FMA pipe, where masks would put five
//    of them on the ALU.  The products are written in PTX
//    so that the compiler cannot fold them back into masks.  The chain is
//    a shift and a product, but the next sum e2d + g waits on both
//    products, which issue one behind the other on the same pipe: ptxas
//    schedules the step in 12 SM clocks.  On an H100 80GB HBM3 at 700 W,
//    issuing the g product first ran ~1% faster at 16,384 streams and ~4%
//    at 17,408; a form that carries s = e2d + g as well (every product
//    from m and a sum known before m; 7 instructions, 10 clocks as
//    scheduled) ran 2-6% slower, and 12% slower at 17,408 streams, where
//    issue counts;
//  * the chunk boundary's chain (err2 -> noise shaper -> dither -> e2d) is
//    five operations: the shaper's input is raw - acc with acc =
//    (acc * 248 >> 8) + (err2 >> 14), so its output is
//    q0 - B0 * (err2 >> 14), and q0, with the xorshift, is computed a chunk
//    ahead (shaper_input);
//  * 128 threads a block, so each block's four warps land on the four
//    schedulers of one SM and 16384 streams fill 128 SMs with exactly one
//    warp a scheduler.
//
// The CPU tests cannot run this kernel, so tests/test_torch_pdm.py
// transcribes its arithmetic (_shaper_input, _kernel_sample, _kernel_words)
// statement for statement and holds that against the plain version.  A
// change to the bit step, the chunk boundary or shaper_input here must be
// made there too; the card tests (tests/test_torch_cuda.py) and
// chip_smoke.py hold the kernel itself against the plain version.

// Integer semantics: every add and multiply that may wrap runs on
// uint32_t (signed overflow is undefined in C++); >> on int32_t is
// arithmetic in nvcc, which the arithmetic shifts need; the xorshift's
// logical shifts run on uint32_t.
//
// State layout at the boundary: int32 [16, B] rows
//   0 err, 1 err2, 2 ns_x1, 3 ns_x2, 4 ns_y1, 5 ns_y2, 6 ns_acc,
//   7 rng (uint32 bits), 8 fade_in_pos, 9 pdm_enabled, 10 hw_running,
//   11 fade_out_pos, 12 fade_base_pcm, 13..15 padding (copied through).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunks = 8;
constexpr int32_t kClip = 29500;
constexpr int32_t kFadeSamples = 1024;
constexpr int kFadeShift = 10;
constexpr uint32_t kDitherMask = 0x1FF;
constexpr int kLeakShift = 16;
constexpr int32_t kSilence = static_cast<int32_t>(0xAAAAAAAAu);
constexpr int32_t kB0 = 15778;
constexpr int32_t kB1 = -31556;
constexpr int32_t kB2 = 15778;
constexpr int32_t kA1 = 31531;
constexpr int32_t kA2 = 15580;
constexpr int kThreads = 128;

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
// a * b + c, wrapping, kept a multiply-add (an IMAD) by writing it in PTX
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// arithmetic >> 31: 0 for v >= 0, all ones for v < 0
__device__ __forceinline__ uint32_t sign_mask(uint32_t v) {
  uint32_t r;
  asm("shr.s32 %0, %1, 31;" : "=r"(r) : "r"(v));
  return r;
}
__device__ __forceinline__ uint32_t xorshift32(uint32_t r) {
  r ^= r << 13;
  r ^= r >> 17;
  r ^= r << 5;
  return r;
}
// a chunk's noise-shaper input that does not depend on err2
// (pdm_generator.c:89-108): with acc' = a + q, a = acc * 248 >> 8,
// q = err2 >> 14 and inp = raw - acc', the shaper's total is
// q0 - B0 * q, q0 = B0 * (raw - a) + B1 x1 + B2 x2 + A1 y1 - A2 y2
struct Shaper {
  uint32_t rng;
  int32_t raw, a, q0;
};
__device__ __forceinline__ Shaper shaper_input(uint32_t rng, int32_t acc,
                                               int32_t x1, int32_t x2,
                                               int32_t y1, int32_t y2) {
  Shaper n;
  n.rng = xorshift32(rng);
  n.raw = static_cast<int32_t>(n.rng & kDitherMask) -
          static_cast<int32_t>(kDitherMask >> 1);
  n.a = mul(acc, 248) >> 8;
  n.q0 = add(mul(kB0, sub(n.raw, n.a)),
             sub(add(add(mul(kB1, x1), mul(kB2, x2)), mul(kA1, y1)),
                 mul(kA2, y2)));
  return n;
}

__global__ void __launch_bounds__(kThreads)
pdm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ s_in,
           int32_t* __restrict__ words, int32_t* __restrict__ s_out,
           int T, int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  int32_t err = s_in[0 * sB + b], err2 = s_in[1 * sB + b];
  int32_t x1 = s_in[2 * sB + b], x2 = s_in[3 * sB + b];
  int32_t y1 = s_in[4 * sB + b], y2 = s_in[5 * sB + b];
  int32_t acc = s_in[6 * sB + b];
  uint32_t rng = static_cast<uint32_t>(s_in[7 * sB + b]);
  int32_t fade = s_in[8 * sB + b];
  const int32_t ena = s_in[9 * sB + b];
  int32_t run = s_in[10 * sB + b];
  int32_t fout = s_in[11 * sB + b];
  int32_t base = s_in[12 * sB + b];
  const bool enab = ena != 0;

  int32_t xn = x[b];
  for (int t = 0; t < T; ++t) {
    const int32_t xt = xn;
    if (t + 1 < T) xn = x[static_cast<size_t>(t + 1) * sB + b];
    int32_t* w = words + static_cast<size_t>(t) * kChunks * sB + b;
    // chunk 0's shaper input depends on the state alone: computed here,
    // beside the machine, and thrown away if the sample is silent
    Shaper n = shaper_input(rng, acc, x1, x2, y1, y2);

    // enable/fade-out machine (pdm_generator.c:320-364): fade_out_pos
    // counts down first; the slot where it reaches 0 stops the hardware
    // without modulating; a fading stream ramps the held base, input
    // ignored
    const bool fading_out = !enab && fout > 0;
    if (fading_out) fout -= 1;
    if (fading_out && fout == 0) run = 0;
    const bool act = enab || (fading_out && fout >= 1);

    int32_t pcm = min(max(xt >> 14, -kClip), kClip);
    const bool fading = fade < kFadeSamples;
    if (fading) pcm = (pcm * fade) >> kFadeShift;   // |pcm*fade| < 2^25
    if (enab && fading) fade += 1;
    if (enab) base = pcm;
    const int32_t target =
        enab ? pcm + 32768 : ((base * fout) >> kFadeShift) + 32768;

    if (!act) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) w[c * sB] = kSilence;
      continue;
    }

    const uint32_t t65 = static_cast<uint32_t>(sub(target, 65535));
    uint32_t g = static_cast<uint32_t>(sub(err, 65535)) + t65;  // errm + t65
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      // the chunk-boundary chain: err2 -> q -> dither -> e2d
      const int32_t q = err2 >> 14;                 // (err2 >> 8) >> 6
      const int32_t dither = static_cast<int32_t>(
          mad(static_cast<uint32_t>(q), static_cast<uint32_t>(-kB0),
              static_cast<uint32_t>(n.q0))) >> 14;
      rng = n.rng;
      acc = add(n.a, q);
      x2 = x1;
      x1 = sub(n.raw, acc);
      y2 = y1;
      y1 = dither;
      // the next chunk's input, off the chain: issued beside this chunk's
      // bit steps
      if (c + 1 < kChunks) n = shaper_input(rng, acc, x1, x2, y1, y2);

      uint32_t e2d = static_cast<uint32_t>(add(err2, dither));
      uint32_t u = 1;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t m = sign_mask(e2d);          // 0 if bit==1 else -1
        const uint32_t s = e2d + g;
        const uint32_t gt = g + t65;
        g = mad(m, 0xFFFF0001u, gt);                // + (m & 65535)
        e2d = mad(m, 0xFFFE0002u, s);               // + (m & 131070)
        u = mad(u, 2u, m);
      }
      w[c * sB] = static_cast<int32_t>(u - 1u);
      err2 = sub(static_cast<int32_t>(e2d), dither);
    }
    err = add(sub(static_cast<int32_t>(g), static_cast<int32_t>(t65)), 65535);
    err = sub(err, err >> kLeakShift);
    err2 = sub(err2, err2 >> kLeakShift);
  }

  s_out[0 * sB + b] = err;
  s_out[1 * sB + b] = err2;
  s_out[2 * sB + b] = x1;
  s_out[3 * sB + b] = x2;
  s_out[4 * sB + b] = y1;
  s_out[5 * sB + b] = y2;
  s_out[6 * sB + b] = acc;
  s_out[7 * sB + b] = static_cast<int32_t>(rng);
  s_out[8 * sB + b] = fade;
  s_out[9 * sB + b] = ena;
  s_out[10 * sB + b] = run;
  s_out[11 * sB + b] = fout;
  s_out[12 * sB + b] = base;
  for (int r = 13; r < 16; ++r) s_out[r * sB + b] = s_in[r * sB + b];
}

}  // namespace

// x int32 [T, B]; s_in int32 [16, B] -> words int32 [T, 8, B], s_out
// int32 [16, B].  Launches on `stream` and returns cudaGetLastError().
extern "C" int dspi_pdm_segment(const void* x, const void* s_in, void* words,
                                void* s_out, int T, int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  pdm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(s_in),
      static_cast<int32_t*>(words), static_cast<int32_t*>(s_out), T, B);
  return static_cast<int>(cudaGetLastError());
}
