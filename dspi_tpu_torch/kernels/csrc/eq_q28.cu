// Q28 EQ cascades of the RP2040 chain for Hopper (sm_90a).
//
// Replaces the TPU kernel dspi_tpu/kernels/eq_pallas.py:_cascade_block
// (called through _core and its front door q28_cascades) in all three of
// its modes: per-cascade coefficients with uniform packets, per-lane
// coefficients (lane_cf, eq_pallas.py:142-149,166-169,180-182,189-190) and
// variable-packet schedules (the dense envelope and packet-end gather,
// eq_pallas.py:196-197,305-311,352-354).  Same function, bit for bit: G
// independent cascades over one segment, each an optional 2-filter
// loudness prefix with run-time bypass, NB TDF2 bands in the firmware's
// truncating fast_mul_q28, and an optional leveller RMS envelope written at
// the last sample of every packet (dsp_process_rp2040.S:225-394,
// usb_audio.c:1022-1100, leveller.c:150-156).  The plain version is
// dspi_tpu_torch/kernels/eq.py:q28_cascades_plain.
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
//  * the band count, the two flags and the coefficient mode are template
//    parameters (one instantiation per NB in 0..12, flag pair and mode),
//    so the band loop unrolls and every state index is a compile-time
//    register;
//  * per-cascade coefficients are the same for every stream of a block:
//    the block loads its cascade's rows once into shared memory, already
//    split into the (v >> 16, v & 0xFFFF) halves fast_mul_q28 uses, so the
//    loop reads them warp-uniformly and never re-splits them
//    (eq_pallas.py:71-99 does the same hoist);
//  * per-lane coefficients (LANE) would be ~120 more live values a thread,
//    on top of a loop that already holds up to 200 registers, so each
//    thread stages its own lane's rows in shared memory, pre-split the same
//    way (the split is deterministic, so no word changes), laid out
//    [row * 10 + k][lane] so that a warp's 32 reads of one value fall in 32
//    banks.  A thread reads only what it wrote: no barrier, and a
//    volatile read, or nvcc forwards the stores and holds the words in
//    registers after all.  For the master call's 12 rows that is
//    120 x 64 x 4 B = 30 KB a block.
//    Bypass flags and envelope alphas are per lane too (scal [G, 4, B]),
//    so a bypass there is a select, not a branch: lanes of one warp may
//    differ, and the warp would otherwise diverge;
//  * packets: an outer loop walks the packets and an inner loop their
//    samples, so the envelope is stored at each packet's end without a
//    test per sample.  Uniform packets end every tc samples; a schedule
//    passes its end indices (cumsum(sched) - 1) as a small int32 array,
//    read one packet ahead.  No dense envelope and no time padding: the
//    TPU needed both for its fixed time blocks;
//  * the sample and the band output's halves are shared by the multiplies
//    that take them, and the next sample's load is issued before the
//    current sample's chain, so its latency hides behind the arithmetic;
//  * the ragged edge of the stream axis is masked here; the TPU kernel's
//    lane padding, stream tiles and VMEM budget have no counterpart.
//
// Integer semantics: every add, subtract, multiply and left shift that may
// wrap runs on uint32_t (signed overflow is undefined in C++); the >> 12
// and >> 16 are arithmetic shifts of the wrapped int32, as
// core/qmath.q28_mul computes them.

#include <cstdint>
#include <type_traits>

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
// band's split coefficients b0h b0l b1h b1l b2h b2l a1h a1l a2h a2l, STRIDE
// words apart (1 for a cascade's shared row, kThreads for a lane's column).
template <int STRIDE, typename Ptr>
__device__ __forceinline__ int32_t band(Ptr c, int32_t& s1, int32_t& s2,
                                        int32_t xin) {
  const Half xs = split(xin);
  const int32_t out = add(qmul(c[0], c[STRIDE], xs), s1);
  const Half os = split(out);
  const int32_t s1n =
      add(sub(qmul(c[2 * STRIDE], c[3 * STRIDE], xs),
              qmul(c[6 * STRIDE], c[7 * STRIDE], os)),
          s2);
  s2 = sub(qmul(c[4 * STRIDE], c[5 * STRIDE], xs),
           qmul(c[8 * STRIDE], c[9 * STRIDE], os));
  s1 = s1n;
  return out;
}

// A loudness filter with a per-lane bypass: computed always, kept or not
// by a select (a bypassed filter freezes output and state,
// usb_audio.c:1022-1031).
template <int STRIDE, typename Ptr>
__device__ __forceinline__ int32_t band_or_bypass(Ptr c, int32_t& s1,
                                                  int32_t& s2, int32_t xin,
                                                  bool bypass) {
  int32_t n1 = s1, n2 = s2;
  const int32_t out = band<STRIDE>(c, n1, n2, xin);
  s1 = bypass ? s1 : n1;
  s2 = bypass ? s2 : n2;
  return bypass ? xin : out;
}

template <int NB, bool LOUD, bool ENV, bool LANE>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ cf,
               const int32_t* __restrict__ s_in,
               const int32_t* __restrict__ scal,
               const int32_t* __restrict__ ends, int32_t* __restrict__ y,
               int32_t* __restrict__ env, int32_t* __restrict__ s_out, int T,
               int B, int npkt, int tc) {
  constexpr int kLoud = LOUD ? 2 : 0;
  constexpr int kRows = kLoud + NB;
  constexpr int kS = 2 * kRows + (ENV ? 1 : 0);
  constexpr int kStride = LANE ? kThreads : 1;
  __shared__ int32_t cs[(kRows > 0 ? kRows : 1) * 10 * kStride];

  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kThreads + lane;
  const size_t sB = static_cast<size_t>(B);
  if (!LANE) {
    for (int i = lane; i < kRows * 5; i += kThreads) {
      const int32_t v = cf[static_cast<size_t>(g) * kRows * 5 + i];
      cs[2 * i] = v >> 16;
      cs[2 * i + 1] = v & 0xFFFF;
    }
    __syncthreads();
  }
  if (b >= B) return;
  if (LANE) {
    // this lane's column of cf [G, kRows, 5, B], split; read back by this
    // thread only
    const int32_t* cg = cf + static_cast<size_t>(g) * kRows * 5 * sB + b;
#pragma unroll
    for (int i = 0; i < kRows * 5; ++i) {
      const int32_t v = cg[i * sB];
      cs[(2 * i) * kThreads + lane] = v >> 16;
      cs[(2 * i + 1) * kThreads + lane] = v & 0xFFFF;
    }
  }
  // a lane's column is read through a volatile pointer (see the top)
  using CoefPtr =
      typename std::conditional<LANE, const volatile int32_t*,
                                const int32_t*>::type;
  const CoefPtr cl = LANE ? cs + lane : cs;

  int32_t s[kS > 0 ? kS : 1];
  const int32_t* sg = s_in + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) s[r] = sg[r * sB];
  // scalars: scal [G, 4] per cascade, or [G, 4, B] per lane
  auto scalar = [&](int j) {
    return LANE ? scal[(static_cast<size_t>(g) * 4 + j) * sB + b]
                : scal[4 * g + j];
  };
  const bool byp0 = LOUD && scalar(0) != 0;
  const bool byp1 = LOUD && scalar(1) != 0;
  const Half a_rms = split(ENV ? scalar(2) : 0);
  const Half one_minus = split(ENV ? scalar(3) : 0);

  const int32_t* xg = x + static_cast<size_t>(g) * T * sB + b;
  int32_t* yg = y + static_cast<size_t>(g) * T * sB + b;
  int32_t* eg = ENV ? env + static_cast<size_t>(g) * npkt * sB + b : nullptr;
  // without an envelope the whole segment is one "packet"
  const int n_chunks = ENV ? npkt : 1;
  auto chunk_end = [&](int p) {
    return !ENV ? T - 1 : ends != nullptr ? ends[p] : (p + 1) * tc - 1;
  };
  int end = chunk_end(0);
  int32_t xn = xg[0];
  int t = 0;
  for (int p = 0; p < n_chunks; ++p) {
    const int next_end = p + 1 < n_chunks ? chunk_end(p + 1) : T - 1;
    for (; t <= end; ++t) {
      int32_t cur = xn;
      if (t + 1 < T) xn = xg[static_cast<size_t>(t + 1) * sB];
      if (LOUD) {
        if (LANE) {
          cur = band_or_bypass<kStride>(cl, s[0], s[1], cur, byp0);
          cur = band_or_bypass<kStride>(cl + 10 * kStride, s[2], s[3], cur,
                                        byp1);
        } else {
          // the flags are uniform over the block: a branch
          if (!byp0) cur = band<1>(cl, s[0], s[1], cur);
          if (!byp1) cur = band<1>(cl + 10, s[2], s[3], cur);
        }
      }
#pragma unroll
      for (int j = kLoud; j < kRows; ++j)
        cur = band<kStride>(cl + 10 * j * kStride, s[2 * j], s[2 * j + 1],
                            cur);
      if (ENV) {
        const Half q = split(cur);
        const Half sq = split(qmul(q.h, q.l, q));
        s[kS - 1] = add(qmul(a_rms.h, a_rms.l, split(s[kS - 1])),
                        qmul(one_minus.h, one_minus.l, sq));
      }
      yg[static_cast<size_t>(t) * sB] = cur;
    }
    if (ENV) eg[static_cast<size_t>(p) * sB] = s[kS - 1];
    end = next_end;
  }

  int32_t* so = s_out + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) so[r * sB] = s[r];
}

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, int32_t*, int32_t*,
                        int32_t*, int, int, int, int);

template <bool LOUD, bool ENV, bool LANE, int NB = 0>
Kernel pick(int nb) {
  if constexpr (NB > kMaxBands) {
    return nullptr;
  } else {
    return nb == NB ? cascade_kernel<NB, LOUD, ENV, LANE>
                    : pick<LOUD, ENV, LANE, NB + 1>(nb);
  }
}

template <bool LANE>
Kernel pick_flags(int nb, int has_loud, int has_env) {
  return has_loud ? (has_env ? pick<true, true, LANE>(nb)
                             : pick<true, false, LANE>(nb))
                  : (has_env ? pick<false, true, LANE>(nb)
                             : pick<false, false, LANE>(nb));
}

}  // namespace

// x int32 [G, T, B]; cf int32 [G, (2 if has_loud) + nb, 5], or
// [G, (2 if has_loud) + nb, 5, B] with lane; s_in int32 [G, S, B]; scal
// int32 [G, 4], or [G, 4, B] with lane; ends int32 [npkt], the last sample
// of each packet (strictly increasing, the last T - 1), or null for
// uniform packets of tc samples (then npkt = T / tc) -> y int32 [G, T, B],
// env int32 [G, npkt, B] (has_env only; may be null otherwise), s_out
// int32 [G, S, B].  T >= 1, B >= 1.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dspi_eq_q28(const void* x, const void* cf, const void* s_in,
                           const void* scal, const void* ends, void* y,
                           void* env, void* s_out, int G, int T, int B,
                           int nb, int has_loud, int has_env, int lane,
                           int npkt, int tc, void* stream) {
  const Kernel k = lane ? pick_flags<true>(nb, has_loud, has_env)
                        : pick_flags<false>(nb, has_loud, has_env);
  const bool packets_ok =
      !has_env || (ends != nullptr ? npkt >= 1
                                   : tc >= 1 && T % tc == 0 && npkt == T / tc);
  if (k == nullptr || G < 1 || G > 65535 || T < 1 || B < 1 || !packets_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(cf),
      static_cast<const int32_t*>(s_in), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(y),
      static_cast<int32_t*>(env), static_cast<int32_t*>(s_out), T, B, npkt,
      tc);
  return static_cast<int>(cudaGetLastError());
}
