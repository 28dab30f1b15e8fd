// Float EQ cascades of the RP2350 chain for Hopper (sm_90a).
//
// A port-only kernel: the JAX package has no TPU kernel for the float
// chain's per-sample recurrences and runs them as lax.scan over the
// segment, scan A (dspi_tpu/chain/pipeline.py:418-485: loudness, master EQ
// and the leveller envelope) and scan B (:626-639: the per-output EQ).
// Eagerly in PyTorch a scan is ~100 launches a sample, so the port runs
// both as this kernel.  Same function, bit for bit, as
// dspi_tpu_torch/kernels/eq_f32.py:f32_cascades_plain: independent
// cascades over one segment, each an optional 2-filter loudness prefix
// (general SVFs with run-time bypass), NB bands of per-row kinds (TDF2, or
// an SVF with the low-pass, high-pass, peaking or shelf mix; SKIP pads),
// and an optional leveller RMS envelope, flushed below 1e-30 and written at
// the last sample of every packet (dsp_pipeline.c:282-365,
// usb_audio.c:690-702, leveller.c:150-156).
//
// Rounding: every multiply, add and subtract is __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into a fused multiply-add, so each
// rounds as the plain version's torch ops (and the firmware's C) do, and
// the kernel equals the plain version on the card bit for bit.
//
// What bounds it on this card: float32 issue.  Per sample, stream and
// cascade it moves 8 bytes (one word in, one out) and runs 9 operations a
// TDF2 band, 12-17 an SVF band, 17 a loudness filter and 4 for the
// envelope, all on the FMA pipe (no contraction: a multiply and an add are
// two instructions); at the headline's 11 cascades of 10 bands that is
// ~3x longer than the 8.9 GB of a segment take.  What keeps a kernel of
// this function from that bound: (1) band kinds read at run time, a
// compare and a branch per band and sample, which also cut the sample
// loop into blocks the compiler cannot schedule across; (2) each sample
// one serial chain through every row (a row's output is the next row's
// input), ~60 dependent operations a sample, with only ~2 warps a
// scheduler in the master call (2 cascades) to hide them; (3) an input
// fetched one sample ahead, less than a DRAM latency once (1) and (2) go.
//
// Design:
//  * one library per band-kinds signature: the wrapper (eq_f32_cuda.py)
//    packs a cascade's band count, band kinds (3 bits a band), loudness,
//    envelope and per-lane flags into a 64-bit code and builds this source
//    with -DEQF_SIG=<code> at first use.  The row loop unrolls into
//    straight-line code for exactly those kinds: a SKIP row has no code
//    and no registers, and the sample loop has no kind compare or branch.
//    The C entry refuses a code other than its own.  A call whose
//    cascades differ in signature launches once a signature, each launch
//    given its cascades' indices (groups), reading and writing them in
//    place;
//  * the rows are skewed across samples: at step t, row r (the loudness
//    rows, then the live bands) works on sample t - r, taking the output
//    its predecessor made at step t - 1 from a register.  The rows of one
//    step are independent, so a thread's critical path a step is one
//    row's own state recurrence (4-5 dependent operations), not the
//    cascade's; the envelope and the store take the sample leaving the
//    last row.  The skew only changes when an operation issues, never its
//    operands, so the result is the same bit for bit.  The rows - 1 steps
//    at each end of the segment, where some rows have no sample, run once a
//    segment in a masked form;
//  * the full steps' inputs come through a ring of kStages tiles of kTile
//    steps in shared memory, filled by cp.async from the thread's own
//    column (as xf_f32.cu): while a thread walks tile k, tiles k+1 ..
//    k+kStages-1 are in flight, 12-24 steps ahead.  A thread reads back
//    only what it copied, so cp.async.wait_group is the only wait;
//  * one thread owns one (cascade, stream); states and coefficients (only
//    the columns a row's kind reads, from the cascade's row or, per lane,
//    the stream's own column) stay in registers for the segment, and the
//    [G, T, B] time-major layout makes every load and store coalesced;
//  * packets: the envelope is flushed and stored where the sample leaving
//    the last row is its packet's last, a compare and predicated
//    instructions a sample (no branch); the wrapper passes the packet ends
//    (uniform or a schedule's) as a small int32 array;
//  * 64-thread blocks.  Instances without loudness rows (the output call,
//    9 cascades) are held to 128 registers, 16 warps an SM: 2.18 waves at
//    16384 streams.  Held to 20 warps (96 registers, 1.75 waves) they ran
//    within 0.5% of that there, and 10% slower per lane at 17,408 lanes,
//    whose schedule then stalls more (PERF.md).  The master call (2
//    cascades, <= 8 warps an SM) takes the registers it needs.
//
// Per-cascade coefficients stay in vector registers, like per-lane ones
// (no FP32 instruction of the sample loop reads a uniform register or a
// constant-bank operand): the cascade is picked at run time (blockIdx.y),
// and a table of rows in the kernel's parameters would need the rows,
// which the device computes each segment, copied to the host first.

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

#ifndef EQF_SIG
#error "build with -DEQF_SIG=<packed signature> (kernels/eq_f32_cuda.py)"
#endif

namespace {

constexpr int kThreads = 64;
constexpr int kStages = 4;       // tiles in the ring, 4-8 KB a block
constexpr int kMaxBands = 12;
constexpr int kCols = 11;        // sva1..svm2, b0, b1, b2, a1, a2
constexpr float kTiny = 1e-30f;
enum Kind : int { kSkip = 0, kTdf2 = 1, kLp = 2, kHp = 3, kPeak = 4,
                  kShelf = 5, kLoudRow = 6 };

// The packed signature (eq_f32_cuda.py:signature): bits 0-3 the band
// count, 4 loudness, 5 envelope, 6 per-lane coefficients, 8 + 3j the kind
// of band j.
#define HD __host__ __device__ constexpr
HD int sig_nb(uint64_t s) { return static_cast<int>(s & 0xF); }
HD bool sig_loud(uint64_t s) { return (s >> 4) & 1; }
HD bool sig_env(uint64_t s) { return (s >> 5) & 1; }
HD bool sig_lane(uint64_t s) { return (s >> 6) & 1; }
HD int sig_kind(uint64_t s, int j) {
  return static_cast<int>((s >> (8 + 3 * j)) & 7);
}
HD int sig_loud_rows(uint64_t s) { return sig_loud(s) ? 2 : 0; }
HD int sig_live(uint64_t s) {
  int n = 0;
  for (int j = 0; j < sig_nb(s); ++j) n += sig_kind(s, j) != kSkip;
  return n;
}
HD bool sig_valid(uint64_t s) {
  if (sig_nb(s) > kMaxBands || (s & 0x80) || (s >> (8 + 3 * kMaxBands)))
    return false;
  for (int j = 0; j < kMaxBands; ++j)
    if (j < sig_nb(s) ? sig_kind(s, j) > kShelf : sig_kind(s, j) != kSkip)
      return false;
  return true;
}
// The cascade row (coefficients and state pair) of live row r: the
// loudness rows, then the bands that are not SKIP, in order.
HD int sig_row(uint64_t s, int r) {
  if (r < sig_loud_rows(s)) return r;
  int k = r - sig_loud_rows(s);
  for (int j = 0; j < sig_nb(s); ++j) {
    if (sig_kind(s, j) == kSkip) continue;
    if (k == 0) return sig_loud_rows(s) + j;
    --k;
  }
  return -1;
}
HD int sig_row_kind(uint64_t s, int r) {
  return r < sig_loud_rows(s) ? kLoudRow
                              : sig_kind(s, sig_row(s, r) -
                                                sig_loud_rows(s));
}
// the coefficients a kind reads, and the column of its k-th
HD int n_coef(int kind) {
  return kind == kTdf2 ? 5 : kind == kLp ? 3
       : kind == kHp || kind == kPeak ? 4 : 6;
}
HD int coef_col(int kind, int k) {
  return kind == kTdf2 ? 6 + k
       : (kind == kHp || kind == kPeak) && k == 3 ? 4 : k;
}
#undef HD

static_assert(sig_valid(EQF_SIG), "EQF_SIG is not a packed signature");

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
// a store and a load under a predicate, so that the packet-end work of
// the sample loop needs no branch
__device__ __forceinline__ void store_if(bool p, float* a, float v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(__cvta_generic_to_global(a)),
      "f"(v), "r"(static_cast<int>(p)));
}
__device__ __forceinline__ int load_if(bool p, const int32_t* a, int old) {
  int v = old;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q ld.global.nc.b32 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(__cvta_generic_to_global(a)), "r"(static_cast<int>(p)));
  return v;
}

// One row, one sample (dsp_pipeline.c:298-364, usb_audio.c:697-702).  A
// TDF2 row's c holds b0, b1, b2, a1, a2; an SVF row's a1, a2, a3 and its
// mix terms (m1 for high-pass and peaking; m0, m1, m2 for shelf and
// loudness).  A bypassed loudness filter keeps its input and its state.
template <int K>
__device__ __forceinline__ float step_row(const float* c, float& s1,
                                          float& s2, float xin, bool byp) {
  if constexpr (K == kTdf2) {
    const float out = add(mul(c[0], xin), s1);
    const float s1n = add(sub(mul(c[1], xin), mul(c[3], out)), s2);
    s2 = sub(mul(c[2], xin), mul(c[4], out));
    s1 = s1n;
    return out;
  } else {
    const float v3 = sub(xin, s2);
    const float v1 = add(mul(c[0], s1), mul(c[1], v3));
    const float v2 = add(add(s2, mul(c[1], s1)), mul(c[2], v3));
    float out;
    if constexpr (K == kLp) {
      out = v2;
    } else if constexpr (K == kHp) {
      out = sub(add(xin, mul(c[3], v1)), v2);
    } else if constexpr (K == kPeak) {
      out = add(xin, mul(c[3], v1));
    } else {
      out = add(add(mul(c[3], xin), mul(c[4], v1)), mul(c[5], v2));
    }
    const float n1 = sub(mul(2.0f, v1), s1), n2 = sub(mul(2.0f, v2), s2);
    if constexpr (K == kLoudRow) {
      s1 = byp ? s1 : n1;
      s2 = byp ? s2 : n2;
      return byp ? xin : out;
    } else {
      s1 = n1;
      s2 = n2;
      return out;
    }
  }
}

// Live row r of one step: at step t it works on sample t - r.  MASKED (the
// segment's first and last rows - 1 steps) keeps the state of a row that
// has no sample at this step.
template <uint64_t SIG, int r, bool MASKED>
__device__ __forceinline__ void row_at(const float* c, float& s1, float& s2,
                                       float in, float& o, bool byp, int t,
                                       int T) {
  constexpr int K = sig_row_kind(SIG, r);
  if constexpr (MASKED) {
    float n1 = s1, n2 = s2;
    o = step_row<K>(c, n1, n2, in, byp);
    if (static_cast<unsigned>(t - r) < static_cast<unsigned>(T)) {
      s1 = n1;
      s2 = n2;
    }
  } else {
    o = step_row<K>(c, s1, s2, in, byp);
  }
}

// Every live row of one step, each on its own input: independent.
template <uint64_t SIG, bool MASKED, int... Rs>
__device__ __forceinline__ void rows_at(std::integer_sequence<int, Rs...>,
                                        float (*c)[6], float* s1, float* s2,
                                        const float* in, float* o, bool byp0,
                                        bool byp1, int t, int T) {
  (row_at<SIG, Rs, MASKED>(c[Rs], s1[Rs], s2[Rs], in[Rs], o[Rs],
                           Rs == 0 ? byp0 : byp1, t, T),
   ...);
}

template <uint64_t SIG>
__global__ void __launch_bounds__(kThreads, sig_loud(SIG) ? 4 : 8)
cascade_kernel(const float* __restrict__ x, const float* __restrict__ cf,
               const float* __restrict__ s_in,
               const float* __restrict__ scal,
               const int32_t* __restrict__ groups,
               const int32_t* __restrict__ ends, float* __restrict__ y,
               float* __restrict__ env, float* __restrict__ s_out, int T,
               int B, int npkt) {
  constexpr int NB = sig_nb(SIG);
  constexpr bool LOUD = sig_loud(SIG), ENV = sig_env(SIG),
                 LANE = sig_lane(SIG);
  constexpr int NL = sig_loud_rows(SIG);
  constexpr int R = NL + sig_live(SIG);         // live rows
  constexpr int L = R > 0 ? R - 1 : 0;          // the skew: steps a sample
  constexpr int NR = NL + NB;                   // rows of cf and s_in
  constexpr int S = 2 * NR + (ENV ? 1 : 0);
  constexpr int RA = R > 0 ? R : 1;
  // steps a tile and a loop iteration: 8 (~1,100 instructions) at the
  // output call's ~140 instructions a step, 4 at the master call's ~200
  constexpr int kTile = LOUD ? 4 : 8;

  // [stage][step in tile][thread]: a warp's accesses of one step hit 32
  // consecutive banks
  __shared__ float ring[kStages][kTile][kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;
  const int g = groups != nullptr ? groups[blockIdx.y] : blockIdx.y;
  const size_t sB = static_cast<size_t>(B);

  // row r's coefficients: cf [G, NR, 11], or [G, NR, 11, B] per lane
  float c[RA][6];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kind = sig_row_kind(SIG, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k < n_coef(kind)) {
        const size_t i = (static_cast<size_t>(g) * NR + sig_row(SIG, r)) *
                             kCols + coef_col(kind, k);
        c[r][k] = LANE ? cf[i * sB + b] : cf[i];
      }
    }
  }
  auto scalar = [&](int k) {
    return LANE ? scal[(static_cast<size_t>(g) * 4 + k) * sB + b]
                : scal[4 * g + k];
  };
  const bool byp0 = LOUD && scalar(0) != 0.0f;
  const bool byp1 = LOUD && scalar(1) != 0.0f;
  const float a_rms = ENV ? scalar(2) : 0.0f;
  const float one_minus = ENV ? scalar(3) : 0.0f;

  const float* sg = s_in + static_cast<size_t>(g) * S * sB + b;
  float s1[RA], s2[RA], in[RA], o[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    s1[r] = r < R ? sg[2 * sig_row(SIG, r) * sB] : 0.0f;
    s2[r] = r < R ? sg[(2 * sig_row(SIG, r) + 1) * sB] : 0.0f;
    in[r] = o[r] = 0.0f;
  }
  float e = ENV ? sg[(S - 1) * sB] : 0.0f;

  const float* xg = x + static_cast<size_t>(g) * T * sB + b;
  float* yg = y + static_cast<size_t>(g) * T * sB + b;
  float* eg = ENV ? env + static_cast<size_t>(g) * npkt * sB + b : nullptr;
  // the sink's packet: its envelope word and its last sample; ends holds
  // a sentinel past the last packet, so the walk needs no clamp
  float* ep = eg;
  const int32_t* np = ends;
  int next_end = ENV ? *np : 0;

  // The sample s leaving the last row: the envelope, flushed and stored
  // when s ends its packet, and the output word.
  auto sink = [&](int s, float v) {
    if constexpr (ENV) {
      e = add(mul(a_rms, e), mul(one_minus, mul(v, v)));
      const bool fire = s == next_end;
      e = fire && e < kTiny ? 0.0f : e;     // leveller.c:154-156
      store_if(fire, ep, e);
      ep += fire ? sB : 0;
      np += fire;
      next_end = load_if(fire, np, next_end);
    }
    yg[static_cast<size_t>(s) * sB] = v;
  };
  // Step t: row 0 takes x[t], row r the output row r - 1 made at step
  // t - 1; the sink takes sample t - L.
  auto step = [&](auto masked, int t, float xin) {
    constexpr bool M = decltype(masked)::value;
    in[0] = xin;
    rows_at<SIG, M>(std::make_integer_sequence<int, R>{}, c, s1, s2, in, o,
                    byp0, byp1, t, T);
    const float v = R > 0 ? o[RA - 1] : xin;
#pragma unroll
    for (int r = RA - 1; r > 0; --r) in[r] = o[r - 1];
    const int s = t - L;
    if (!M || static_cast<unsigned>(s) < static_cast<unsigned>(T)) sink(s, v);
  };
  using Masked = std::true_type;
  using Full = std::false_type;

  // the first L steps: rows r > t have no sample yet
#pragma unroll 1
  for (int t = 0; t < L; ++t)
    step(Masked{}, t, t < T ? xg[static_cast<size_t>(t) * sB] : 0.0f);

  // steps L .. T-1 have every row busy: whole tiles of them, staged
  const int tiles = T > L ? (T - L) / kTile : 0;
  if (tiles > 0) {
    const float* xs = xg + static_cast<size_t>(L) * sB;
    // tile k's inputs into its stage; past the last tile, the last tile
    // again (into a stage already walked), so that no copy needs a branch
    auto fetch = [&](int k) {
      const float* src = xs + static_cast<size_t>(min(k, tiles - 1)) *
                                  kTile * sB;
      float* dst = &ring[k % kStages][0][tid];
#pragma unroll
      for (int j = 0; j < kTile; ++j) copy4(dst + j * kThreads, src + j * sB);
    };
    // one group a tile, so that the count of pending groups says which
    // tile has landed
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      fetch(k);
      commit();
    }
    for (int k = 0; k < tiles; ++k) {
      fetch(k + kStages - 1);
      commit();
      wait_pending<kStages - 1>();                  // tile k has landed
      const float* st = &ring[k % kStages][0][tid];
      const int t0 = L + k * kTile;
#pragma unroll
      for (int i = 0; i < kTile; ++i) step(Full{}, t0 + i, st[i * kThreads]);
    }
  }

  // the rest: the steps of a last partial tile, then L steps in which
  // rows r <= t - T have no sample left
#pragma unroll 1
  for (int t = L + tiles * kTile; t < T + L; ++t)
    step(Masked{}, t, t < T ? xg[static_cast<size_t>(t) * sB] : 0.0f);

  float* so = s_out + static_cast<size_t>(g) * S * sB + b;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    so[2 * sig_row(SIG, r) * sB] = s1[r];
    so[(2 * sig_row(SIG, r) + 1) * sB] = s2[r];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {             // a SKIP band keeps its state
    if (sig_kind(SIG, j) == kSkip) {
      so[2 * (NL + j) * sB] = sg[2 * (NL + j) * sB];
      so[(2 * (NL + j) + 1) * sB] = sg[(2 * (NL + j) + 1) * sB];
    }
  }
  if (ENV) so[(S - 1) * sB] = e;
}

}  // namespace

// sig: the packed signature this library was built for (EQF_SIG); any
// other code is refused.  x float [G, T, B]; cf float [G, NR, 11], or
// [G, NR, 11, B] per lane (NR = (2 with loudness) + nb); s_in float
// [G, S, B]; scal float [G, 4], or [G, 4, B] per lane; groups int32 [n],
// the cascades of G this launch runs (each of this signature), or null for
// cascades 0 .. n-1; ends int32 [npkt + 1], the last sample of each
// packet (strictly increasing, the last T - 1), then a sentinel >= T
// (with the envelope only; else null) -> y float [G, T, B], env float
// [G, npkt, B] (with the envelope only; else null), s_out float [G, S, B],
// not overlapping s_in, each written at the launch's cascades only.
// T >= 1, B >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int dspi_eq_f32(uint64_t sig, const void* x, const void* cf,
                           const void* s_in, const void* scal,
                           const void* groups, const void* ends, void* y,
                           void* env, void* s_out, int n, int T, int B,
                           int npkt, void* stream) {
  constexpr uint64_t kSig = EQF_SIG;
  if (sig != kSig || n < 1 || n > 65535 || T < 1 || B < 1 ||
      (sig_env(kSig) && (ends == nullptr || npkt < 1 || env == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads, n);
  cascade_kernel<kSig><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cf),
      static_cast<const float*>(s_in), static_cast<const float*>(scal),
      static_cast<const int32_t*>(groups), static_cast<const int32_t*>(ends),
      static_cast<float*>(y), static_cast<float*>(env),
      static_cast<float*>(s_out), T, B, npkt);
  return static_cast<int>(cudaGetLastError());
}

// The instance's block size, registers a thread and resident blocks an
// SM (the CUDA runtime's attributes and occupancy calculator): a launch
// over n cascades of B streams runs in n * ceil(B / threads) /
// (blocks_per_sm * SMs) waves.
extern "C" int dspi_eq_f32_occupancy(int* threads, int* registers,
                                     int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t rc =
      cudaFuncGetAttributes(&attr, cascade_kernel<EQF_SIG>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cascade_kernel<EQF_SIG>, kThreads, 0));
}
