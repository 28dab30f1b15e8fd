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
// What bounds it on this card: integer issue, not memory.  Per sample,
// stream and cascade it moves 8 bytes (one word in, one out) and runs 15
// multiplies a band (three 16 x 16 partial products a fast_mul_q28, five
// of them) and 9 for the envelope, on the FMA pipe at 64 a clock per SM,
// beside ~8 instructions a band that only the integer ALU takes (the
// operand splits and the >> 12) and adds that either pipe takes.  Within
// a sample the bands form one serial chain (each band's output is the
// next band's input), so a thread's time is that chain's latency unless
// other warps hide it.
//
// Per-cascade coefficients (cascade_kernel):
//  * one thread owns one (cascade, stream); blockIdx.y is the cascade and
//    a loop over the whole segment replaces the TPU grid's time axis.
//    Band states and the envelope stay in registers for the segment, so
//    device memory sees each input and output word once, and the [G, T, B]
//    time-major layout makes every load and store coalesced across a warp;
//  * the band count and the two flags are template parameters (one
//    instantiation per NB in 0..12 and flag pair), so the band loop
//    unrolls and every state index is a compile-time register;
//  * the coefficients are the same for every stream of a block: the block
//    loads its cascade's rows once into shared memory, already split into
//    the (v >> 16, v & 0xFFFF) halves fast_mul_q28 uses, so the loop reads
//    them warp-uniformly (one broadcast a read) and never re-splits them
//    (eq_pallas.py:71-99 does the same hoist);
//  * the next sample's load is issued before the current sample's chain,
//    and a schedule's next packet end is read a packet ahead.
//
// Per-lane coefficients (lane_cf, lane_kernel), the per-stream serving
// layout: every stream has its own rows, 10 split words a row, 120 for the
// master cascade (loudness + 10 bands).  Reading them back from shared
// memory every sample costs a warp-wide shared load per word, 120 / 100 a
// sample for the master / output cascade: more wavefronts than the
// multiply bound has clocks.  Held in registers instead, they leave ~2
// warps a scheduler for the master call (34,816 recurrences at the hetero
// path's 17,408 lanes), too few to hide a 12-band serial chain a sample.
// So:
//  * one thread owns one (cascade, stream) and holds its rows' split
//    coefficients, states and envelope in registers.  They are staged
//    through shared memory and read back once through a volatile pointer:
//    ptxas must then hold the split words, where it otherwise keeps the
//    raw rows and re-splits them every sample (twice the ALU-only work);
//  * the bands are skewed across samples: in step i band j runs sample
//    i - j on band j - 1's output of step i - 1, and the envelope sample
//    i - rows.  The rows of one step are independent of each other, so a
//    warp issues ~12 chains at once and the loop-carried path is one
//    band.  In the first and the last `depth` steps (the rows, less one
//    without the envelope) some stage has no sample and keeps its state
//    by a select; the steps between have no test;
//  * a bypassed loudness filter (a per-lane flag for the whole segment)
//    becomes an identity band (b0 = 1.0, the rest 0, state 0), which
//    passes its input through word for word, and its frozen state is
//    copied from s_in to s_out at the end: no select in the sample loop;
//  * one warp a block (32 streams), so the call's warps spread over the
//    SMs to within one warp; the input is loaded two samples ahead.
// tests/test_torch_eq.py (_lane_pipeline) transcribes this schedule and
// holds it to the plain version on the CPU: keep the two in step.
//
// Both walk packets in an outer loop and samples in an inner one, so the
// envelope is stored at each packet's end without a test per sample.
// Uniform packets end every tc samples; a schedule passes its end indices
// (cumsum(sched) - 1) as a small int32 array.  No dense envelope and no
// time padding: the TPU needed both for its fixed time blocks.  The ragged
// edge of the stream axis is masked here; the TPU kernel's lane padding,
// stream tiles and VMEM budget have no counterpart.
//
// Integer semantics: every add, subtract, multiply and left shift that may
// wrap runs on uint32_t (signed overflow is undefined in C++); the >> 12
// and >> 16 are arithmetic shifts of the wrapped int32, as
// core/qmath.q28_mul computes them.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBands = 12;
// lane_cf: one warp a block, a thread a stream
constexpr int kLaneThreads = 32;
constexpr int32_t kQ28One = 1 << 28;

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
// band's split coefficients b0h b0l b1h b1l b2h b2l a1h a1l a2h a2l.
__device__ __forceinline__ int32_t band(const int32_t* c, int32_t& s1,
                                        int32_t& s2, int32_t xin) {
  const Half xs = split(xin);
  const int32_t out = add(qmul(c[0], c[1], xs), s1);
  const Half os = split(out);
  const int32_t s1n =
      add(sub(qmul(c[2], c[3], xs), qmul(c[6], c[7], os)), s2);
  s2 = sub(qmul(c[4], c[5], xs), qmul(c[8], c[9], os));
  s1 = s1n;
  return out;
}

// The leveller's RMS envelope, one sample (leveller.c:150-156).
__device__ __forceinline__ int32_t envelope(Half a_rms, Half one_minus,
                                            int32_t e, int32_t cur) {
  const Half q = split(cur);
  const Half sq = split(qmul(q.h, q.l, q));
  return add(qmul(a_rms.h, a_rms.l, split(e)),
             qmul(one_minus.h, one_minus.l, sq));
}

template <int NB, bool LOUD, bool ENV>
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
  __shared__ int32_t cs[(kRows > 0 ? kRows : 1) * 10];

  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kThreads + lane;
  const size_t sB = static_cast<size_t>(B);
  for (int i = lane; i < kRows * 5; i += kThreads) {
    const int32_t v = cf[static_cast<size_t>(g) * kRows * 5 + i];
    cs[2 * i] = v >> 16;
    cs[2 * i + 1] = v & 0xFFFF;
  }
  __syncthreads();
  if (b >= B) return;

  int32_t s[kS > 0 ? kS : 1];
  const int32_t* sg = s_in + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) s[r] = sg[r * sB];
  // scal [G, 4]: the flags are uniform over the block, so a bypass is a
  // branch
  const bool byp0 = LOUD && scal[4 * g] != 0;
  const bool byp1 = LOUD && scal[4 * g + 1] != 0;
  const Half a_rms = split(ENV ? scal[4 * g + 2] : 0);
  const Half one_minus = split(ENV ? scal[4 * g + 3] : 0);

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
        if (!byp0) cur = band(cs, s[0], s[1], cur);
        if (!byp1) cur = band(cs + 10, s[2], s[3], cur);
      }
#pragma unroll
      for (int j = kLoud; j < kRows; ++j)
        cur = band(cs + 10 * j, s[2 * j], s[2 * j + 1], cur);
      if (ENV) s[kS - 1] = envelope(a_rms, one_minus, s[kS - 1], cur);
      yg[static_cast<size_t>(t) * sB] = cur;
    }
    if (ENV) eg[static_cast<size_t>(p) * sB] = s[kS - 1];
    end = next_end;
  }

  int32_t* so = s_out + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kS; ++r) so[r * sB] = s[r];
}

// One (cascade, stream) of the lane_cf kernel: its rows' split
// coefficients and states, each band's output of the previous step and the
// envelope, all in registers.
template <int NB, bool LOUD, bool ENV>
struct LaneRows {
  static constexpr int kRows = (LOUD ? 2 : 0) + NB;
  static constexpr int kS = 2 * kRows + (ENV ? 1 : 0);
  static constexpr int kRa = kRows > 0 ? kRows : 1;
  // a sample leaves the last band kLagY steps after it entered the first;
  // the envelope runs kRows steps behind, the last stage kDepth
  static constexpr int kLagY = kRows > 0 ? kRows - 1 : 0;
  static constexpr int kDepth = ENV ? kRows : kLagY;
  int32_t c[kRa][10];
  int32_t s1[kRa], s2[kRa];
  int32_t v[kRa];
  int32_t e;
  Half a_rms, one_minus;

  // Step i: band j runs sample i - j on band j - 1's output of step i - 1
  // (band 0 on xin, sample i), the envelope sample i - kRows on the last
  // band's (xin without bands).  Returns the last band's output, sample
  // i - kLagY.  With GUARD, a stage whose sample lies outside [0, T) keeps
  // its state (its output is never used).
  template <bool GUARD>
  __device__ __forceinline__ int32_t step(int32_t xin, int i, int T) {
    auto on = [&](int j) { return !GUARD || (i - j >= 0 && i - j < T); };
    if (ENV) {
      const int32_t ne =
          envelope(a_rms, one_minus, e, kRows > 0 ? v[kRa - 1] : xin);
      e = on(kRows) ? ne : e;
    }
#pragma unroll
    for (int j = kRows - 1; j >= 0; --j) {
      int32_t n1 = s1[j], n2 = s2[j];
      v[j] = band(c[j], n1, n2, j == 0 ? xin : v[j > 0 ? j - 1 : 0]);
      s1[j] = on(j) ? n1 : s1[j];
      s2[j] = on(j) ? n2 : s2[j];
    }
    return kRows > 0 ? v[kRa - 1] : xin;
  }
};

// x[i] from the two-sample prefetch (xn, xn2), which moves one sample on
__device__ __forceinline__ int32_t next_x(int32_t& xn, int32_t& xn2,
                                          const int32_t* xg, size_t sB, int i,
                                          int T) {
  const int32_t cur = xn;
  xn = xn2;
  xn2 = i + 2 < T ? xg[static_cast<size_t>(i + 2) * sB] : 0;
  return cur;
}

template <int NB, bool LOUD, bool ENV>
__global__ void __launch_bounds__(kLaneThreads)
lane_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ cf,
            const int32_t* __restrict__ s_in,
            const int32_t* __restrict__ scal,
            const int32_t* __restrict__ ends, int32_t* __restrict__ y,
            int32_t* __restrict__ env, int32_t* __restrict__ s_out, int T,
            int B, int npkt, int tc) {
  using Rows = LaneRows<NB, LOUD, ENV>;
  constexpr int kRows = Rows::kRows;
  constexpr int kS = Rows::kS;
  constexpr int kLagY = Rows::kLagY;
  constexpr int kDepth = Rows::kDepth;
  __shared__ int32_t stage[Rows::kRa * 10][kLaneThreads];

  const int g = blockIdx.y;
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int32_t* sg = s_in + static_cast<size_t>(g) * kS * sB + b;
  const int32_t* lg = scal + static_cast<size_t>(g) * 4 * sB + b;

  Rows th;
  unsigned frozen = 0;                         // bypassed loudness rows
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ident = LOUD && r < 2 && lg[r * sB] != 0;
    frozen |= ident ? 1u << r : 0u;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int32_t v =
          ident ? (k == 0 ? kQ28One : 0)
                : cf[((static_cast<size_t>(g) * kRows + r) * 5 + k) * sB + b];
      stage[r * 10 + 2 * k][threadIdx.x] = v >> 16;
      stage[r * 10 + 2 * k + 1][threadIdx.x] = v & 0xFFFF;
    }
    th.s1[r] = ident ? 0 : sg[2 * r * sB];
    th.s2[r] = ident ? 0 : sg[(2 * r + 1) * sB];
  }
  // read back through a volatile pointer: a thread reads only what it
  // wrote, and ptxas must then hold the words in registers
  const volatile int32_t* vs = &stage[0][0];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int w = 0; w < 10; ++w)
      th.c[r][w] = vs[(r * 10 + w) * kLaneThreads + threadIdx.x];
#pragma unroll
  for (int r = 0; r < Rows::kRa; ++r) th.v[r] = 0;
  th.e = ENV ? sg[(kS - 1) * sB] : 0;
  th.a_rms = split(ENV ? lg[2 * sB] : 0);
  th.one_minus = split(ENV ? lg[3 * sB] : 0);

  const int32_t* xg = x + static_cast<size_t>(g) * T * sB + b;
  int32_t* yg = y + static_cast<size_t>(g) * T * sB + b;
  int32_t* eg = ENV ? env + static_cast<size_t>(g) * npkt * sB + b : nullptr;
  auto chunk_end = [&](int p) {
    return ends != nullptr ? ends[p] : (p + 1) * tc - 1;
  };
  // the step after which the envelope holds packet p's last sample
  int p = 0;
  int store_at = ENV ? chunk_end(0) + kRows : INT_MAX;
  auto store_env = [&]() {
    eg[static_cast<size_t>(p) * sB] = th.e;
    ++p;
    store_at = p < npkt ? chunk_end(p) + kRows : INT_MAX;
  };
  int32_t xn = xg[0];
  int32_t xn2 = T > 1 ? xg[sB] : 0;
  int i = 0;
  // fill: the later stages have no sample yet (no envelope ends here)
  for (; i < kDepth; ++i) {
    const int32_t out =
        th.template step<true>(next_x(xn, xn2, xg, sB, i, T), i, T);
    if (i - kLagY >= 0 && i - kLagY < T)
      yg[static_cast<size_t>(i - kLagY) * sB] = out;
  }
  // every stage on a sample of the segment: no guard, and the envelope
  // stored between runs of steps.  Two steps an iteration, so that this
  // loop, the sample loop, is the longest of the kernel's loops.
  while (i < T) {
    const int stop = store_at < T ? store_at : T - 1;
#pragma unroll 2
    for (; i <= stop; ++i)
      yg[static_cast<size_t>(i - kLagY) * sB] =
          th.template step<false>(next_x(xn, xn2, xg, sB, i, T), i, T);
    if (ENV && i - 1 == store_at) store_env();
  }
  // drain: the first stages have run out of samples
  for (; i < T + kDepth; ++i) {
    const int32_t out = th.template step<true>(0, i, T);
    if (i - kLagY < T) yg[static_cast<size_t>(i - kLagY) * sB] = out;
    if (ENV && i == store_at) store_env();
  }

  int32_t* so = s_out + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool keep = frozen & (1u << r);
    so[2 * r * sB] = keep ? sg[2 * r * sB] : th.s1[r];
    so[(2 * r + 1) * sB] = keep ? sg[(2 * r + 1) * sB] : th.s2[r];
  }
  if (ENV) so[(kS - 1) * sB] = th.e;
}

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, int32_t*, int32_t*,
                        int32_t*, int, int, int, int);

template <bool LOUD, bool ENV, bool LANE, int NB = 0>
Kernel pick(int nb) {
  if constexpr (NB > kMaxBands) {
    return nullptr;
  } else if (nb == NB) {
    return LANE ? lane_kernel<NB, LOUD, ENV> : cascade_kernel<NB, LOUD, ENV>;
  } else {
    return pick<LOUD, ENV, LANE, NB + 1>(nb);
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
// int32 [G, S, B], not overlapping s_in.  T >= 1, B >= 1.  Launches on
// `stream` and returns cudaGetLastError().
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
  const int per_block = lane ? kLaneThreads : kThreads;
  const dim3 grid((B + per_block - 1) / per_block, G);
  k<<<grid, lane ? kLaneThreads : kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(cf),
      static_cast<const int32_t*>(s_in), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(y),
      static_cast<int32_t*>(env), static_cast<int32_t*>(s_out), T, B, npkt,
      tc);
  return static_cast<int>(cudaGetLastError());
}
