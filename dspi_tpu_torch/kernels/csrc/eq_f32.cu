// Float EQ cascades of the RP2350 chain for Hopper (sm_90a).
//
// A port-only kernel: the JAX package has no TPU kernel for the float
// chain's per-sample recurrences and runs them as lax.scan over the
// segment, scan A (dspi_tpu/chain/pipeline.py:418-485: loudness, master EQ
// and the leveller envelope) and scan B (:626-639: the per-output EQ).
// Eagerly in PyTorch a scan is ~100 launches a sample, so the port runs
// both as this kernel.  Same function, bit for bit, as
// dspi_tpu_torch/kernels/eq_f32.py:f32_cascades_plain: G independent
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
// cascade it moves 8 bytes (one word in, one out) and runs ~9 operations
// a TDF2 band, ~12-17 an SVF band and 5 for the envelope, all on the FMA
// pipe (no contraction: a multiply and an add are two instructions), plus
// the kind branches; at the headline's 11 cascades of ~10 bands that is
// more time than the 8.9 GB of a segment take.  Within a sample the bands
// form one serial chain (each band's output is the next band's input), so
// a thread's time is that chain's latency unless other warps hide it: the
// output call (9 cascades) has ~35 warps an SM, the master call (2) ~8.
//
// Design (a first kernel, kept simple):
//  * one thread owns one (cascade, stream); blockIdx.y is the cascade and
//    a loop over the whole segment replaces the scan.  Band states and the
//    envelope stay in registers for the segment, so device memory sees each
//    input and output word once, and the [G, T, B] time-major layout makes
//    every load and store coalesced across a warp;
//  * the band count and the loudness, envelope and per-lane flags are
//    template parameters (one instantiation per NB in 0..12 and flag set),
//    so the band loop unrolls and every state index is a register;
//  * each row's coefficients are loaded once into registers, only those its
//    kind reads (a TDF2 row b0..a2, an SVF row a1..a3 and the mix terms of
//    its output), from the cascade's row or, per lane (the per-stream
//    serving layout), from the stream's own column.  Kinds are per row and
//    a block is one cascade, so a kind's branch is uniform over the block
//    and never diverges;
//  * a loudness bypass flag (per cascade, or per lane) is a select after
//    the filter, as the plain version's torch.where;
//  * the next sample's load is issued before the current sample's chain.
// Packets are walked in an outer loop and samples in an inner one, so the
// envelope is flushed and stored at each packet's end without a test per
// sample.  Uniform packets end every tc samples; a schedule passes its end
// indices (cumsum(sched) - 1) as a small int32 array, as eq_q28.cu does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBands = 12;
constexpr int kCols = 11;          // sva1..svm2, b0, b1, b2, a1, a2
constexpr float kTiny = 1e-30f;
enum Kind : int { kSkip = 0, kTdf2 = 1, kLp = 2, kHp = 3, kPeak = 4,
                  kShelf = 5 };

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// The general SVF (the loudness shelf and the shelf band): c = a1, a2, a3,
// m0, m1, m2; s1, s2 = ic1, ic2.  v1 and v2 out, the state stepped.
__device__ __forceinline__ void svf(const float* c, float ic1, float ic2,
                                    float xin, float& v1, float& v2) {
  const float v3 = sub(xin, ic2);
  v1 = add(mul(c[0], ic1), mul(c[1], v3));
  v2 = add(add(ic2, mul(c[1], ic1)), mul(c[2], v3));
}

// One band, one sample (dsp_pipeline.c:298-364).  A TDF2 row's c holds
// b0, b1, b2, a1, a2; an SVF row's a1, a2, a3, m0, m1, m2.
__device__ __forceinline__ float band(int kind, const float* c, float& s1,
                                      float& s2, float xin) {
  if (kind == kSkip) return xin;
  if (kind == kTdf2) {
    const float out = add(mul(c[0], xin), s1);
    const float s1n = add(sub(mul(c[1], xin), mul(c[3], out)), s2);
    s2 = sub(mul(c[2], xin), mul(c[4], out));
    s1 = s1n;
    return out;
  }
  float v1, v2;
  svf(c, s1, s2, xin, v1, v2);
  float out;
  if (kind == kLp) {
    out = v2;
  } else if (kind == kHp) {
    out = sub(add(xin, mul(c[4], v1)), v2);
  } else if (kind == kPeak) {
    out = add(xin, mul(c[4], v1));
  } else {
    out = add(add(mul(c[3], xin), mul(c[4], v1)), mul(c[5], v2));
  }
  s1 = sub(mul(2.0f, v1), s1);
  s2 = sub(mul(2.0f, v2), s2);
  return out;
}

// The loudness shelf with its run-time bypass (usb_audio.c:697-702): a
// bypassed filter keeps its input and its state.
__device__ __forceinline__ float loud(const float* c, float& s1, float& s2,
                                      float xin, bool bypass) {
  float v1, v2;
  svf(c, s1, s2, xin, v1, v2);
  const float out =
      add(add(mul(c[3], xin), mul(c[4], v1)), mul(c[5], v2));
  const float n1 = sub(mul(2.0f, v1), s1), n2 = sub(mul(2.0f, v2), s2);
  s1 = bypass ? s1 : n1;
  s2 = bypass ? s2 : n2;
  return bypass ? xin : out;
}

// The columns of the 11 a row's kind reads, in the order band() and
// loud() take them (-1: not read, left 0).
__device__ __forceinline__ int column(int kind, int k) {
  if (kind == kTdf2) return k < 5 ? 6 + k : -1;
  if (kind == kSkip || k >= 6) return -1;
  if (k < 3) return k;                     // a1, a2, a3
  if (kind == kLp) return -1;
  if (kind == kHp || kind == kPeak) return k == 4 ? 4 : -1;   // m1
  return k;                                 // shelf: m0, m1, m2
}

template <int NB, bool LOUD, bool ENV, bool LANE>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const float* __restrict__ x, const float* __restrict__ cf,
               const float* __restrict__ s_in,
               const float* __restrict__ scal,
               const int32_t* __restrict__ kinds,
               const int32_t* __restrict__ ends, float* __restrict__ y,
               float* __restrict__ env, float* __restrict__ s_out, int T,
               int B, int npkt, int tc) {
  constexpr int kLoud = LOUD ? 2 : 0;
  constexpr int kRows = kLoud + NB;
  constexpr int kRa = kRows > 0 ? kRows : 1;
  constexpr int kS = 2 * kRows + (ENV ? 1 : 0);

  const int g = blockIdx.y;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  // a row's column k: cf [G, rows, 11], or [G, rows, 11, B] per lane
  auto coef = [&](int r, int k) {
    const size_t i = (static_cast<size_t>(g) * kRows + r) * kCols + k;
    return LANE ? cf[i * sB + b] : cf[i];
  };
  auto scalar = [&](int k) {
    return LANE ? scal[(static_cast<size_t>(g) * 4 + k) * sB + b]
                : scal[4 * g + k];
  };
  int kind[NB > 0 ? NB : 1];
  float c[kRa][6];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kd = r < kLoud ? kShelf : kinds[g * NB + (r - kLoud)];
    if (r >= kLoud) kind[r - kLoud] = kd;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int col = column(kd, k);
      c[r][k] = col < 0 ? 0.0f : coef(r, col);
    }
  }
  float s1[kRa], s2[kRa];
  const float* sg = s_in + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s1[r] = sg[2 * r * sB];
    s2[r] = sg[(2 * r + 1) * sB];
  }
  float e = ENV ? sg[(kS - 1) * sB] : 0.0f;
  const bool byp0 = LOUD && scalar(0) != 0.0f;
  const bool byp1 = LOUD && scalar(1) != 0.0f;
  const float a_rms = ENV ? scalar(2) : 0.0f;
  const float one_minus = ENV ? scalar(3) : 0.0f;

  const float* xg = x + static_cast<size_t>(g) * T * sB + b;
  float* yg = y + static_cast<size_t>(g) * T * sB + b;
  float* eg = ENV ? env + static_cast<size_t>(g) * npkt * sB + b : nullptr;
  // without an envelope the whole segment is one "packet"
  const int n_chunks = ENV ? npkt : 1;
  auto chunk_end = [&](int p) {
    return !ENV ? T - 1 : ends != nullptr ? ends[p] : (p + 1) * tc - 1;
  };
  int end = chunk_end(0);
  float xn = xg[0];
  int t = 0;
  for (int p = 0; p < n_chunks; ++p) {
    const int next_end = p + 1 < n_chunks ? chunk_end(p + 1) : T - 1;
    for (; t <= end; ++t) {
      float cur = xn;
      if (t + 1 < T) xn = xg[static_cast<size_t>(t + 1) * sB];
      if (LOUD) {
        cur = loud(c[0], s1[0], s2[0], cur, byp0);
        cur = loud(c[1], s1[1], s2[1], cur, byp1);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
        cur = band(kind[j], c[kLoud + j], s1[kLoud + j], s2[kLoud + j], cur);
      if (ENV) e = add(mul(a_rms, e), mul(one_minus, mul(cur, cur)));
      yg[static_cast<size_t>(t) * sB] = cur;
    }
    if (ENV) {
      e = e < kTiny ? 0.0f : e;      // leveller.c:154-156, packet ends only
      eg[static_cast<size_t>(p) * sB] = e;
    }
    end = next_end;
  }

  float* so = s_out + static_cast<size_t>(g) * kS * sB + b;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    so[2 * r * sB] = s1[r];
    so[(2 * r + 1) * sB] = s2[r];
  }
  if (ENV) so[(kS - 1) * sB] = e;
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const int32_t*, const int32_t*, float*,
                        float*, float*, int, int, int, int);

template <bool LOUD, bool ENV, bool LANE, int NB = 0>
Kernel pick(int nb) {
  if constexpr (NB > kMaxBands) {
    return nullptr;
  } else if (nb == NB) {
    return cascade_kernel<NB, LOUD, ENV, LANE>;
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

// x float [G, T, B]; cf float [G, (2 if has_loud) + nb, 11], or
// [G, (2 if has_loud) + nb, 11, B] with lane; s_in float [G, S, B]; scal
// float [G, 4], or [G, 4, B] with lane; kinds int32 [G, nb] (0 SKIP, 1
// TDF2, 2-5 SVF low-pass, high-pass, peaking, shelf; may be null when nb
// is 0); ends int32 [npkt], the last sample of each packet (strictly
// increasing, the last T - 1), or null for uniform packets of tc samples
// (then npkt = T / tc) -> y float [G, T, B], env float [G, npkt, B]
// (has_env only; may be null otherwise), s_out float [G, S, B], not
// overlapping s_in.  T >= 1, B >= 1.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dspi_eq_f32(const void* x, const void* cf, const void* s_in,
                           const void* scal, const void* kinds,
                           const void* ends, void* y, void* env, void* s_out,
                           int G, int T, int B, int nb, int has_loud,
                           int has_env, int lane, int npkt, int tc,
                           void* stream) {
  const Kernel k = lane ? pick_flags<true>(nb, has_loud, has_env)
                        : pick_flags<false>(nb, has_loud, has_env);
  const bool packets_ok =
      !has_env || (ends != nullptr ? npkt >= 1
                                   : tc >= 1 && T % tc == 0 && npkt == T / tc);
  if (k == nullptr || G < 1 || G > 65535 || T < 1 || B < 1 || !packets_ok ||
      (nb > 0 && kinds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cf),
      static_cast<const float*>(s_in), static_cast<const float*>(scal),
      static_cast<const int32_t*>(kinds), static_cast<const int32_t*>(ends),
      static_cast<float*>(y), static_cast<float*>(env),
      static_cast<float*>(s_out), T, B, npkt, tc);
  return static_cast<int>(cudaGetLastError());
}
