// Q28 EQ cascades of the RP2040 chain for Hopper (sm_90a).
//
// Replaces the TPU kernel dspi_tpu/kernels/eq_pallas.py:_cascade_block
// (called through _core and its front door q28_cascades) in its scalar
// coefficient mode with uniform packets.  Same function, bit for bit: G
// independent cascades over one segment, each an optional 2-filter
// loudness prefix with per-cascade run-time bypass, NB TDF2 bands in the
// firmware's truncating fast_mul_q28, and an optional leveller RMS
// envelope written at the last sample of every tc-sample packet
// (dsp_process_rp2040.S:225-394, usb_audio.c:1022-1100, leveller.c:150-156).
// The plain version is dspi_tpu_torch/kernels/eq.py:q28_cascades_plain.
//
// What bounds it on this card: integer issue and latency, not memory.  Per
// sample, stream and cascade it moves 8 bytes (one word in, one out) and
// runs 32 int32 operations a band (5 split multiplies of 5 operations, the
// two splits they share, 3 adds) and 22 for the envelope: ~400 for the
// master cascade (loudness + 10 bands + envelope), 320 for an output's 10
// bands.  Within a sample the bands form one serial chain (each band's
// output is the next band's input), so a thread's time is that chain's
// latency unless other warps hide it; at the headline's 16384 streams the
// master call has two warps per scheduler and the output call five.
//
// What the design does about it:
//  * one thread owns one (cascade, stream); blockIdx.y is the cascade and
//    a loop over the whole segment replaces the TPU grid's time axis.
//    Band states and the envelope stay in registers for the segment, so
//    device memory sees each input and output word once, and the [G, T, B]
//    time-major layout makes every load and store coalesced across a warp;
//  * the band count and the two flags are template parameters (one
//    instantiation per NB in 0..12 and flag pair), so the band loop
//    unrolls and every state index is a compile-time register;
//  * coefficients are the same for every stream of a cascade: the block
//    loads its cascade's rows once into shared memory, already split into
//    the (v >> 16, v & 0xFFFF) halves fast_mul_q28 uses, so the loop reads
//    them warp-uniformly and never re-splits them (eq_pallas.py:71-99 does
//    the same hoist); the sample's and the band output's halves are shared
//    by the multiplies that take them;
//  * the next sample's load is issued before the current sample's chain,
//    so its latency hides behind the arithmetic;
//  * the ragged edge of the stream axis is masked here; the TPU kernel's
//    lane padding, stream tiles and VMEM budget have no counterpart.
//
// Integer semantics: every add, subtract, multiply and left shift that may
// wrap runs on uint32_t (signed overflow is undefined in C++); the >> 12
// and >> 16 are arithmetic shifts of the wrapped int32, as
// core/qmath.q28_mul computes them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBands = 12;

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// A Q28 operand split into fast_mul_q28's halves (dsp_pipeline.c:50-52).
struct Half {
  int32_t h, l;
};
__device__ __forceinline__ Half split(int32_t v) { return {v >> 16, v & 0xFFFF}; }

// fast_mul_q28 on split operands: (ah*bh << 4) + ((ah*bl + al*bh) >> 12).
__device__ __forceinline__ int32_t qmul(int32_t ah, int32_t al, Half b) {
  const uint32_t high = static_cast<uint32_t>(ah) * static_cast<uint32_t>(b.h);
  const int32_t mid = static_cast<int32_t>(
      static_cast<uint32_t>(ah) * static_cast<uint32_t>(b.l) +
      static_cast<uint32_t>(al) * static_cast<uint32_t>(b.h));
  return static_cast<int32_t>((high << 4) + static_cast<uint32_t>(mid >> 12));
}

// One TDF2 band, one sample (dsp_process_rp2040.S:263-365).  c holds the
// band's split coefficients: b0h b0l b1h b1l b2h b2l a1h a1l a2h a2l.
__device__ __forceinline__ int32_t band(const int32_t* c, int32_t& s1,
                                        int32_t& s2, int32_t xin) {
  const Half xs = split(xin);
  const int32_t out = add(qmul(c[0], c[1], xs), s1);
  const Half os = split(out);
  const int32_t s1n = add(sub(qmul(c[2], c[3], xs), qmul(c[6], c[7], os)), s2);
  s2 = sub(qmul(c[4], c[5], xs), qmul(c[8], c[9], os));
  s1 = s1n;
  return out;
}

template <int NB, bool LOUD, bool ENV>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ cf,
               const int32_t* __restrict__ s_in,
               const int32_t* __restrict__ scal, int32_t* __restrict__ y,
               int32_t* __restrict__ env, int32_t* __restrict__ s_out, int T,
               int B, int tc) {
  constexpr int kLoud = LOUD ? 2 : 0;
  constexpr int kRows = kLoud + NB;
  constexpr int kS = 2 * kRows + (ENV ? 1 : 0);
  __shared__ int32_t cs[(kRows > 0 ? kRows : 1) * 10];

  const int g = blockIdx.y;
  for (int i = threadIdx.x; i < kRows * 5; i += kThreads) {
    const int32_t v = cf[static_cast<size_t>(g) * kRows * 5 + i];
    cs[2 * i] = v >> 16;
    cs[2 * i + 1] = v & 0xFFFF;
  }
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  int32_t s[kS > 0 ? kS : 1];
  const int32_t* sg = s_in + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) s[r] = sg[r * sB];
  const bool byp0 = LOUD && scal[4 * g + 0] != 0;
  const bool byp1 = LOUD && scal[4 * g + 1] != 0;
  const Half a_rms = split(ENV ? scal[4 * g + 2] : 0);
  const Half one_minus = split(ENV ? scal[4 * g + 3] : 0);

  const int32_t* xg = x + static_cast<size_t>(g) * T * sB + b;
  int32_t* yg = y + static_cast<size_t>(g) * T * sB + b;
  int32_t* eg = ENV ? env + static_cast<size_t>(g) * (T / tc) * sB + b
                    : nullptr;
  int32_t xn = xg[0];
  int k = 0;
  size_t pkt = 0;
  for (int t = 0; t < T; ++t) {
    int32_t cur = xn;
    if (t + 1 < T) xn = xg[static_cast<size_t>(t + 1) * sB];
    if (LOUD) {
      // a bypassed loudness filter freezes output and state
      // (usb_audio.c:1022-1031); the flags are uniform over the block
      if (!byp0) cur = band(cs, s[0], s[1], cur);
      if (!byp1) cur = band(cs + 10, s[2], s[3], cur);
    }
#pragma unroll
    for (int j = kLoud; j < kRows; ++j)
      cur = band(cs + 10 * j, s[2 * j], s[2 * j + 1], cur);
    if (ENV) {
      const Half q = split(cur);
      const Half sq = split(qmul(q.h, q.l, q));
      s[kS - 1] = add(qmul(a_rms.h, a_rms.l, split(s[kS - 1])),
                      qmul(one_minus.h, one_minus.l, sq));
      if (++k == tc) {
        k = 0;
        eg[pkt * sB] = s[kS - 1];
        ++pkt;
      }
    }
    yg[static_cast<size_t>(t) * sB] = cur;
  }

  int32_t* so = s_out + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) so[r * sB] = s[r];
}

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, int32_t*, int32_t*, int32_t*, int, int,
                        int);

template <bool LOUD, bool ENV, int NB = 0>
Kernel pick(int nb) {
  if constexpr (NB > kMaxBands) {
    return nullptr;
  } else {
    return nb == NB ? cascade_kernel<NB, LOUD, ENV> : pick<LOUD, ENV, NB + 1>(nb);
  }
}

}  // namespace

// x int32 [G, T, B]; cf int32 [G, (2 if has_loud) + nb, 5]; s_in int32
// [G, S, B]; scal int32 [G, 4] -> y int32 [G, T, B], env int32
// [G, T / tc, B] (has_env only; may be null otherwise), s_out int32
// [G, S, B].  T >= 1, B >= 1, and T a multiple of tc when has_env.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dspi_eq_q28(const void* x, const void* cf, const void* s_in,
                           const void* scal, void* y, void* env, void* s_out,
                           int G, int T, int B, int nb, int has_loud,
                           int has_env, int tc, void* stream) {
  const Kernel k =
      has_loud ? (has_env ? pick<true, true>(nb) : pick<true, false>(nb))
               : (has_env ? pick<false, true>(nb) : pick<false, false>(nb));
  if (k == nullptr || G < 1 || G > 65535 || T < 1 || B < 1 ||
      (has_env && (tc < 1 || T % tc != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(cf),
      static_cast<const int32_t*>(s_in), static_cast<const int32_t*>(scal),
      static_cast<int32_t*>(y), static_cast<int32_t*>(env),
      static_cast<int32_t*>(s_out), T, B, tc);
  return static_cast<int>(cudaGetLastError());
}
