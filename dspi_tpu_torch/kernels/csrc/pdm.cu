// PDM delta-sigma modulator for Hopper (sm_90a).
//
// Replaces the TPU kernel dspi_tpu/kernels/pdm_pallas.py:_pdm_kernel (with
// its per-sample body _modulate_sample).  Same function, bit for bit: per
// stream and sample, clip and fade-in, the enable/fade-out machine, then 8
// chunks of xorshift32 TPDF dither through the Q14 noise shaper and 32
// bit steps each, then the leaky integrators (pdm_generator.c:320-397).
// Out: 8 words per sample, the silence word while the hardware is stopped.
//
// What bounds it on this card: integer issue and latency, not memory.  Per
// sample and stream it moves 36 bytes (4 in, 32 out) but runs ~1,750
// int32 operations, most of them in 256 bit steps of 6 operations that
// form one serial dependency chain; the integer pipes issue 64 of them per
// SM and clock.
// The time axis is a true recurrence, so the only parallel axis is the
// stream axis: at 16384 streams that is about one warp per scheduler of
// the 132 SMs, and each warp's time is its chain's latency.
//
// What the design does about it:
//  * one thread owns one stream; its 13 state words stay in registers for
//    the whole segment and the thread loops over all T samples, so device
//    memory sees each input word once and each output word once, and the
//    [T, B] / [T, 8, B] time-major layouts make every load and store
//    coalesced across a warp;
//  * 64 threads per block, so that 16384 streams make 256 blocks and
//    every one of the 132 SMs gets work (128-thread blocks would leave
//    some SMs idle);
//  * the bit step is reassociated so that its serial chain is three
//    dependent operations (shift, and, three-input add) instead of four:
//    with g = errm + t65 carried beside e2d = err2 + dither,
//        m = e2d >> 31;  e2d += g + (m & 131070);  g += t65 + (m & 65535)
//    which is the sign-mask step of the TPU kernel with its two adds
//    merged.  Integer adds wrap, so the reassociation is exact.
//
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
constexpr int kThreads = 64;

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

  for (int t = 0; t < T; ++t) {
    const int32_t xt = x[static_cast<size_t>(t) * sB + b];
    int32_t* w = words + static_cast<size_t>(t) * kChunks * sB + b;

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

    const int32_t t65 = sub(target, 65535);
    int32_t g = add(sub(err, 65535), t65);          // errm + t65
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      rng ^= rng << 13;
      rng ^= rng >> 17;
      rng ^= rng << 5;
      const int32_t raw = static_cast<int32_t>(rng & kDitherMask) -
                          static_cast<int32_t>(kDitherMask >> 1);
      // noise-shaped dither (pdm_generator.c:89-108)
      acc = add(mul(acc, 248) >> 8, (err2 >> 8) >> 6);
      const int32_t inp = sub(raw, acc);
      const int32_t total =
          sub(add(add(add(mul(kB0, inp), mul(kB1, x1)), mul(kB2, x2)),
                  mul(kA1, y1)),
              mul(kA2, y2));
      const int32_t dither = total >> 14;
      x2 = x1;
      x1 = inp;
      y2 = y1;
      y1 = dither;

      int32_t e2d = add(err2, dither);
      uint32_t u = 1;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int32_t m = e2d >> 31;                 // 0 if bit==1 else -1
        e2d = add(add(e2d, g), m & 131070);
        g = add(g, add(t65, m & 65535));
        u = u + u + static_cast<uint32_t>(m);
      }
      w[c * sB] = static_cast<int32_t>(u - 1u);
      err2 = sub(e2d, dither);
    }
    err = add(sub(g, t65), 65535);
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
