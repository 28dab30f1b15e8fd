// The leveller's block phase (PASS 2.5), both chains, for Hopper (sm_90a):
// two kernels a segment, from the envelope's packet ends to the gained
// master L/R.
//
// lev_gain, once a packet and lane: the gain computer over the packet-end
// envelope (leveller.c:147-206 / 274-331: rms_db, the knee, the slope,
// makeup, max gain, the gate), the attack/release smoothing of the gain
// in dB with alpha^n for the packet's n samples (leveller.c:182-185,
// 223-227) and the linear gain exp10(gdb / 20), Q28 on the RP2040 chain.
// lev_apply, once a sample: the gain ramp from the last packet's gain to
// this one's (leveller.c:216-221 / 343-352), the 480-sample lookahead
// ring, the limiter's cap (leveller.c:240-255 / 369-379) and the gained
// output.  The JAX package runs both as XLA element-wise ops and
// lax.scans (dspi_tpu/chain/pipeline.py:487-577 float, :964-1063 Q28) and
// has no TPU kernel for them.  Eagerly in PyTorch they are ~900 launches a
// segment (the integer fmath polynomials over [Npkt, B], the ramp, det_div
// over every sample), so the port runs them as these kernels.
//
// Same functions, bit for bit, as dspi_tpu_torch/kernels/lev_cuda.py's
// lev_gain_plain and lev_apply_plain: log2_f32, exp2_f32, pow_f32,
// det_recip and mul_det are core/fmath.py's integer algorithms as they
// stand; every lone float operation is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn in the torch form's order, every int <-> float conversion
// explicit, and the library is built without -ftz (a denormal survives as
// it does in PyTorch's element-wise ops) and with nothing left to contract.
// Integer adds and the Q28 product's partial sums run on uint32_t (signed
// overflow is undefined in C++); >> is arithmetic, as on torch's int32.
//
// What bounds them on this card.  lev_apply moves bytes: two [Ttot, B]
// planes in, two out, the ring's 480 rows of each side in and out and
// the packet gains (1.74 GB at 6144 x 16,384, 0.52 ms at 3.35 TB/s); the
// limiter's reciprocal runs only where the ramp's gain is above unity and
// the sample is not zero.  One thread takes a (packet, lane) pair and
// walks the packet's samples, so every load and store coalesces across a
// warp and the ramp's sequential sum (float) or running quotient (Q28)
// stays in registers: 0.66 / 0.72 ms (float / Q28) measured on an H100
// 80GB HBM3 at 700 W, against ~40 / ~53 ms for the torch form.
// lev_gain is [Npkt, B] work (25 MB at 128 x 16,384) whose integer
// polynomials bound it at 0.02 ms (163-173 ALU-only instructions a
// lane-packet on uniform packets, alpha^n hoisted out of the loop), but
// each packet's smoothing waits for the last: one thread a lane walks the
// packets, ~4 warps an SM, and latency holds it at 0.10-0.11 ms, against
// ~125-165 ms for the torch form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGainThreads = 64;
constexpr int kApplyThreads = 128;
constexpr int32_t kQ28One = 1 << 28;

// core/fmath.py's constants: log2's Q28 odd-series coefficients c1..c9
// (_LOG2_CQ), exp2's Q30 coefficients c0..c7 (_EXP2_CQ), sqrt(2) in Q29,
// the reciprocal's seed
constexpr int32_t kLog2C1 = 774541002, kLog2C3 = 258180330,
                  kLog2C5 = 154909441, kLog2C7 = 110523154,
                  kLog2C9 = 91170044;
constexpr int32_t kExp2C0 = 1073741824, kExp2C1 = 744261129,
                  kExp2C2 = 257941057, kExp2C3 = 59598471,
                  kExp2C4 = 10322243, kExp2C5 = 1442191, kExp2C6 = 153489,
                  kExp2C7 = 23243;
constexpr int32_t kSqrt2Q29 = 759250112;
constexpr int32_t kRcpSeedA = 757935405;
constexpr int32_t kRcpSeedB = 252645135;
// the float32 constants of the reference, exactly
constexpr float kLog10of2 = 0x1.344136p-2f;   // fmath._LOG10_2
constexpr float kLog2of10 = 0x1.a934fp+1f;    // fmath._LOG2_10
constexpr float kInv20 = 0x1.99999ap-5f;      // float32(1) / float32(20)
constexpr float kTiny = 0x1.4484cp-100f;      // float32(1e-30)
constexpr float kCeil = 0x1.6a786cp-1f;       // LEVELLER_LIMITER_CEIL

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// low 32 bits of ((int64)a * b) >> sh, arithmetic (fmath._mul_shift)
__device__ __forceinline__ int32_t mul_shift(int64_t a, int64_t b, int sh) {
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<uint64_t>((a * b) >> sh)));
}

// torch.maximum / torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7FC00000) : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7FC00000) : fminf(a, b);
}

// qmath.f32_to_i32: truncate toward zero, saturate, NaN -> 0
__device__ __forceinline__ int32_t f32_to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  return __float2int_rz(fminf(fmaxf(x, -2147483648.0f), 2147483520.0f));
}

// 2^58 / dn for dn in [2^29, 2^30): linear seed, three Q29 Newton steps
__device__ __forceinline__ int32_t recip_core(int32_t dn) {
  int32_t y = sub(kRcpSeedA, mul_shift(kRcpSeedB, dn, 29));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int32_t t = mul_shift(dn, y, 29);
    y = mul_shift(y, sub(1 << 30, t), 29);
  }
  return y;
}

__device__ __forceinline__ float det_recip(float b) {
  const int32_t bits = __float_as_int(b);
  const int32_t e = ((bits >> 23) & 0xFF) - 127;
  const int32_t y = recip_core(((bits & 0x7FFFFF) << 6) | (1 << 29));
  const int32_t ex = min(max(127 - e, 1), 254);
  const uint32_t scale = (static_cast<uint32_t>(ex) << 23) |
                         (static_cast<uint32_t>(bits) & 0x80000000u);
  const float r = __fmul_rn(__int2float_rn(y), 0x1p-29f);
  return __fmul_rn(r, __uint_as_float(scale));
}

__device__ __forceinline__ float log2_f32(float x) {
  const int32_t bits = __float_as_int(x);
  int32_t e = ((bits >> 23) & 0xFF) - 127;
  int32_t m = ((bits & 0x7FFFFF) << 6) | (1 << 29);
  if (m >= kSqrt2Q29) {
    m >>= 1;
    e += 1;
  }
  const int32_t num = m - (1 << 29);
  const int32_t den = m + (1 << 29);
  const bool hi = den >= (1 << 30);
  int32_t r = recip_core(hi ? den >> 1 : den);
  if (hi) r >>= 1;
  const int32_t z = mul_shift(num, r, 28);                    // Q30
  const int32_t z2 = mul_shift(z, z, 30);
  int32_t p = kLog2C9;
  p = add(mul_shift(p, z2, 30), kLog2C7);
  p = add(mul_shift(p, z2, 30), kLog2C5);
  p = add(mul_shift(p, z2, 30), kLog2C3);
  p = add(mul_shift(p, z2, 30), kLog2C1);
  const int32_t zp = mul_shift(z, p, 28);
  return __fadd_rn(__int2float_rn(e),
                   __fmul_rn(__int2float_rn(zp), 0x1p-30f));
}

__device__ __forceinline__ float exp2_f32(float x) {
  const float n = floorf(x);
  const int32_t f = f32_to_i32(__fmul_rn(__fsub_rn(x, n), 0x1p30f));
  int32_t p = kExp2C7;
  p = add(mul_shift(p, f, 30), kExp2C6);
  p = add(mul_shift(p, f, 30), kExp2C5);
  p = add(mul_shift(p, f, 30), kExp2C4);
  p = add(mul_shift(p, f, 30), kExp2C3);
  p = add(mul_shift(p, f, 30), kExp2C2);
  p = add(mul_shift(p, f, 30), kExp2C1);
  p = add(mul_shift(p, f, 30), kExp2C0);
  const int32_t ni = min(max(__float2int_rz(n), -126), 127);
  const float r = __fmul_rn(__int2float_rn(p), 0x1p-30f);
  return __fmul_rn(r, __int_as_float((ni + 127) << 23));
}

// a**b for a > 0, with a == 0 -> 0 and a == 1 -> 1 exactly
__device__ __forceinline__ float pow_f32(float a, float b) {
  float out = exp2_f32(__fmul_rn(b, log2_f32(a > 0.0f ? a : 1.0f)));
  if (a == 0.0f) out = 0.0f;
  if (a == 1.0f) out = 1.0f;
  return out;
}

// float32 a*b as fmath.mul_det computes it in integers: a 24 x 24-bit
// mantissa product in 64 bits, round to nearest even, denormal operands
// and results flushed to a signed zero, overflow clamped
__device__ __forceinline__ float mul_det(float a, float b) {
  const uint32_t ab = __float_as_uint(a), bb = __float_as_uint(b);
  const uint32_t sign = (ab ^ bb) & 0x80000000u;
  const int ea = static_cast<int>((ab >> 23) & 0xFF);
  const int eb = static_cast<int>((bb >> 23) & 0xFF);
  const uint64_t ma = (ab & 0x7FFFFFu) | (1u << 23);
  const uint64_t mb = (bb & 0x7FFFFFu) | (1u << 23);
  const uint64_t prod = ma * mb;                   // in [2^46, 2^48)
  const int top = static_cast<int>((prod >> 47) & 1);
  const int sh = top + 23;
  const uint64_t keep = prod >> sh;
  const uint64_t rem = prod & ((1ull << sh) - 1);
  const uint64_t half = 1ull << (sh - 1);
  const uint64_t round_up = (rem > half) | ((rem == half) & (keep & 1));
  uint64_t mant = keep + round_up;                 // may carry to 2^24
  const int carry = static_cast<int>((mant >> 24) & 1);
  if (carry) mant >>= 1;
  const int e = ea + eb - 127 + top + carry;
  uint32_t out;
  if (ea == 0 || eb == 0 || e <= 0) {
    out = sign;                                    // FZ in and out
  } else if (e >= 255) {
    out = sign | 0x7F7FFFFFu;                      // clamp overflow
  } else {
    out = sign | (static_cast<uint32_t>(e) << 23) |
          (static_cast<uint32_t>(mant) & 0x7FFFFFu);
  }
  return __uint_as_float(out);
}

// core/qmath.q28_mul (firmware fast_mul_q28)
__device__ __forceinline__ int32_t q28_mul(int32_t a, int32_t b) {
  const int32_t ah = a >> 16, al = a & 0xFFFF;
  const int32_t bh = b >> 16, bl = b & 0xFFFF;
  const uint32_t high = static_cast<uint32_t>(ah) * static_cast<uint32_t>(bh);
  const int32_t mid = static_cast<int32_t>(
      static_cast<uint32_t>(ah) * static_cast<uint32_t>(bl) +
      static_cast<uint32_t>(al) * static_cast<uint32_t>(bh));
  return static_cast<int32_t>((high << 4) + static_cast<uint32_t>(mid >> 12));
}

// The chain's number format: float32 samples and gains, or Q28 int32.
// env() reads a packet-end envelope as the gain computer's float.
struct Float {
  using T = float;
  static __device__ __forceinline__ float env(float v) { return v; }
  static __device__ __forceinline__ float gain(float g) { return g; }
};
struct Q28 {
  using T = int32_t;
  static __device__ __forceinline__ float env(int32_t v) {
    return __fmul_rn(__int2float_rn(v), 0x1p-28f);
  }
  static __device__ __forceinline__ int32_t gain(float g) {
    return f32_to_i32(__fmul_rn(g, 268435456.0f));
  }
};

// packet k's first row and its length: uniform packets of tc rows, or a
// schedule's packet ends
__device__ __forceinline__ void packet(const int* ends, int tc, int k,
                                       int* start, int* n) {
  if (ends) {
    *start = k ? ends[k - 1] : 0;
    *n = ends[k] - *start;
  } else {
    *start = k * tc;
    *n = tc;
  }
}

// lev: the 11 parameter rows (pack.build_params' order), [11] or, with
// lane, [11, B].  kSched: packets given by `ends`, so alpha^n is computed
// again in the loop when n moves; uniform packets compute it once, before
// the loop, and the loop holds only what runs every packet.
template <class F, bool kSched>
__global__ void __launch_bounds__(kGainThreads)
lev_gain(const typename F::T* __restrict__ env_l,
         const typename F::T* __restrict__ env_r,
         const float* __restrict__ lev, int lane,
         const float* __restrict__ gdb0, const typename F::T* __restrict__ g0,
         const int* __restrict__ ends, int tc, int npkt, int B,
         typename F::T* __restrict__ g_cur, float* __restrict__ gdb_out,
         typename F::T* __restrict__ g_out,
         typename F::T* __restrict__ gprev_out) {
  using T = typename F::T;
  const int b = blockIdx.x * kGainThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const size_t lrow = lane ? sB : 1;       // row r at r * lrow
  const float* lv = lev + (lane ? b : 0);
  const float a_att = lv[1 * lrow], a_rel = lv[2 * lrow];
  const float thresh = lv[3 * lrow], knee = lv[4 * lrow];
  const float gate = lv[5 * lrow], max_gain = lv[7 * lrow];
  const float makeup = lv[8 * lrow], slope = lv[9 * lrow];
  const float inv_two_knee = lv[10 * lrow];
  const float half = __fmul_rn(knee, 0.5f);
  const float th_hi = __fadd_rn(thresh, half);
  const float th_lo = __fsub_rn(thresh, half);

  float gdb = gdb0[b];
  T g = g0[b], g_prev = g;
  int last_n = kSched ? -1 : tc;
  float pow_att = 0.0f, pow_rel = 0.0f;
  if (!kSched) {
    pow_att = pow_f32(a_att, __int2float_rn(tc));
    pow_rel = pow_f32(a_rel, __int2float_rn(tc));
  }
  for (int k = 0; k < npkt; ++k) {
    const size_t at = static_cast<size_t>(k) * sB + b;
    // the gain computer (dB) over the packet-end envelope
    const float rms_sq = tmax(F::env(env_l[at]), F::env(env_r[at]));
    const float rms_db = __fmul_rn(
        10.0f, __fmul_rn(log2_f32(__fadd_rn(rms_sq, kTiny)), kLog10of2));
    float gc;
    if (rms_db > th_hi) {
      gc = 0.0f;
    } else if (rms_db >= th_lo) {
      const float d = __fsub_rn(th_hi, rms_db);
      gc = __fmul_rn(__fmul_rn(__fmul_rn(slope, d), d), inv_two_knee);
    } else {
      gc = __fmul_rn(__fsub_rn(thresh, rms_db), slope);
    }
    gc = tmin(__fadd_rn(gc, makeup), max_gain);
    if (rms_db < gate) gc = 0.0f;
    // alpha^n for the packet's n samples, computed again only when n moves
    if (kSched) {
      const int n = ends[k] - (k ? ends[k - 1] : 0);
      if (n != last_n) {
        pow_att = pow_f32(a_att, __int2float_rn(n));
        pow_rel = pow_f32(a_rel, __int2float_rn(n));
        last_n = n;
      }
    }
    // attack or release, both products rounded on their own
    const float alpha = gc < gdb ? pow_att : pow_rel;
    gdb = __fadd_rn(mul_det(alpha, gdb),
                    mul_det(__fsub_rn(1.0f, alpha), gc));
    g_prev = g;
    g = F::gain(exp2_f32(__fmul_rn(__fmul_rn(gdb, kInv20), kLog2of10)));
    g_cur[at] = g;
  }
  gdb_out[b] = gdb;
  g_out[b] = g;
  gprev_out[b] = g_prev;
}

// the ramp's running gain over one packet: the firmware's sequential
// g += step in float, g_prev + trunc(diff * i / (n - 1)) in Q28 (its
// quotient carried as Q * i + floor(R * i / D), exactly)
struct FloatRamp {
  float g, step;
  __device__ __forceinline__ FloatRamp(float gp, float gc, int n) {
    if (n == 1) {
      g = gc;
      step = 0.0f;
    } else {
      g = gp;
      step = __fmul_rn(__fsub_rn(gc, gp),
                       __fdiv_rn(1.0f, __int2float_rn(n - 1)));
    }
  }
  __device__ __forceinline__ float value() const { return g; }
  __device__ __forceinline__ void next() { g = __fadd_rn(g, step); }
};
struct Q28Ramp {
  int32_t base;
  int64_t q;
  uint32_t Q, R, D, r;
  bool neg;
  __device__ __forceinline__ Q28Ramp(int32_t gp, int32_t gc, int n) {
    const int32_t diff = sub(gc, gp);               // int32 wrap, as C
    neg = diff < 0;
    const uint32_t mag = neg ? 0u - static_cast<uint32_t>(diff)
                             : static_cast<uint32_t>(diff);
    D = n > 1 ? static_cast<uint32_t>(n - 1) : 1u;
    Q = mag / D;
    R = mag % D;
    q = 0;
    r = 0;
    base = n == 1 ? gc : gp;
    if (n == 1) Q = R = 0;
  }
  __device__ __forceinline__ int32_t value() const {
    const int64_t v = static_cast<int64_t>(base) + (neg ? -q : q);
    return static_cast<int32_t>(static_cast<uint32_t>(
        static_cast<uint64_t>(v)));
  }
  __device__ __forceinline__ void next() {
    q += Q;
    r += R;
    if (r >= D) {
      r -= D;
      q += 1;
    }
  }
};

// the limiter's cap and the gained sample pair
__device__ __forceinline__ void limit(float l, float r, float g, float* ol,
                                      float* orr) {
  const float peak = tmax(fabsf(l), fabsf(r));
  float ge = g;
  if (peak > 0.0f && g > 1.0f) {
    const float mg = __fmul_rn(kCeil, det_recip(peak));
    if (mg < g) ge = mg > 1.0f ? mg : 1.0f;
  }
  *ol = __fmul_rn(l, ge);
  *orr = __fmul_rn(r, ge);
}
__device__ __forceinline__ void limit(int32_t l, int32_t r, int32_t g,
                                      int32_t* ol, int32_t* orr) {
  const float peak =
      tmax(fabsf(__fmul_rn(__int2float_rn(l), 0x1p-28f)),
           fabsf(__fmul_rn(__int2float_rn(r), 0x1p-28f)));
  int32_t ge = g;
  if (g > kQ28One && peak > 0.0f) {
    const int32_t mg = f32_to_i32(
        __fmul_rn(__fmul_rn(kCeil, det_recip(peak)), 268435456.0f));
    if (mg < g) ge = max(mg, kQ28One);
  }
  *ol = q28_mul(l, ge);
  *orr = q28_mul(r, ge);
}

template <class T, class Ramp>
__global__ void __launch_bounds__(kApplyThreads)
lev_apply(const T* __restrict__ xl, const T* __restrict__ xr,
          const T* __restrict__ g_cur, const T* __restrict__ g0,
          const T* __restrict__ ring, T* __restrict__ ring_out, int L,
          const int* __restrict__ ends, int tc, int npkt, int Ttot, int B,
          T* __restrict__ out_l, T* __restrict__ out_r) {
  const int b = blockIdx.x * kApplyThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const size_t ring_r = static_cast<size_t>(L) * sB;   // ring [2, L, B]
  int start, n;
  packet(ends, tc, k, &start, &n);
  const T gc = g_cur[static_cast<size_t>(k) * sB + b];
  const T gp = k ? g_cur[static_cast<size_t>(k - 1) * sB + b] : g0[b];
  Ramp ramp(gp, gc, n);
  // rows [start, end) of the planes, whatever the ends hold
  start = min(max(start, 0), Ttot);
  const int end = max(min(start + n, Ttot), start);
  for (int t = start; t < end; ++t) {
    // the delayed sample: the ring for t < L, else the input L back
    const size_t at = t < L ? static_cast<size_t>(t) * sB + b
                            : static_cast<size_t>(t - L) * sB + b;
    const T l = t < L ? ring[at] : xl[at];
    const T r = t < L ? ring[ring_r + at] : xr[at];
    const size_t o = static_cast<size_t>(t) * sB + b;
    limit(l, r, ramp.value(), &out_l[o], &out_r[o]);
    ramp.next();
  }
  if (!L) return;
  // the new ring is the last L rows of concat(ring, x): this packet's
  // rows among them, and, when the segment is shorter than the ring, a
  // share of the old ring's tail
  for (int t = max(start, Ttot - L); t < end; ++t) {
    const size_t at = static_cast<size_t>(t - Ttot + L) * sB + b;
    const size_t from = static_cast<size_t>(t) * sB + b;
    ring_out[at] = xl[from];
    ring_out[ring_r + at] = xr[from];
  }
  for (int j = k; j < L - Ttot; j += npkt) {
    const size_t at = static_cast<size_t>(j) * sB + b;
    const size_t from = static_cast<size_t>(Ttot + j) * sB + b;
    ring_out[at] = ring[from];
    ring_out[ring_r + at] = ring[ring_r + from];
  }
}

// one lev_gain launch: the uniform or the schedule instance of format F
template <class F>
void launch_gain(const void* env_l, const void* env_r, const void* lev,
                 int lane, const void* gdb0, const void* g0, const int* ends,
                 int tc, int npkt, int B, void* g_cur, void* gdb_out,
                 void* g_out, void* gprev_out, int blocks, cudaStream_t s) {
  using T = typename F::T;
  auto* kernel = ends ? lev_gain<F, true> : lev_gain<F, false>;
  kernel<<<blocks, kGainThreads, 0, s>>>(
      static_cast<const T*>(env_l), static_cast<const T*>(env_r),
      static_cast<const float*>(lev), lane, static_cast<const float*>(gdb0),
      static_cast<const T*>(g0), ends, tc, npkt, B, static_cast<T*>(g_cur),
      static_cast<float*>(gdb_out), static_cast<T*>(g_out),
      static_cast<T*>(gprev_out));
}

}  // namespace

// env_l, env_r [Npkt, B] (float, or int32 with q28); lev float [11], or
// [11, B] with lev_lane; gdb0 float [B]; g0 [B] (float, or int32 with q28);
// ends int [Npkt] (a schedule's packet ends) or null for packets of tc
// samples -> g_cur [Npkt, B], gdb_out float [B], g_out and gprev_out [B]
// (the last packet's gain and the one before it).  Npkt >= 1, B >= 1.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dspi_lev_gain(const void* env_l, const void* env_r,
                             const void* lev, int lev_lane, const void* gdb0,
                             const void* g0, const void* ends, int tc,
                             int npkt, int B, int q28, void* g_cur,
                             void* gdb_out, void* g_out, void* gprev_out,
                             void* stream) {
  if (npkt < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kGainThreads - 1) / kGainThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (q28) {
    launch_gain<Q28>(env_l, env_r, lev, lev_lane, gdb0, g0, e, tc, npkt, B,
                     g_cur, gdb_out, g_out, gprev_out, blocks, s);
  } else {
    launch_gain<Float>(env_l, env_r, lev, lev_lane, gdb0, g0, e, tc, npkt, B,
                       g_cur, gdb_out, g_out, gprev_out, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// xl, xr [Ttot, B]; g_cur [Npkt, B]; g0 [B] (the gain before the first
// packet); ring [2, L, B] and ring_out [2, L, B], or null with L = 0 (no
// lookahead); ends as dspi_lev_gain's -> out_l, out_r [Ttot, B].  All
// float, or all int32 with q28.  1 <= Npkt <= 65535, B >= 1.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dspi_lev_apply(const void* xl, const void* xr,
                              const void* g_cur, const void* g0,
                              const void* ring, void* ring_out, int L,
                              const void* ends, int tc, int npkt, int Ttot,
                              int B, int q28, void* out_l, void* out_r,
                              void* stream) {
  if (npkt < 1 || npkt > 65535 || B < 1 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kApplyThreads - 1) / kApplyThreads, npkt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (q28) {
    using T = int32_t;
    lev_apply<T, Q28Ramp><<<grid, kApplyThreads, 0, s>>>(
        static_cast<const T*>(xl), static_cast<const T*>(xr),
        static_cast<const T*>(g_cur), static_cast<const T*>(g0),
        static_cast<const T*>(ring), static_cast<T*>(ring_out), L, e, tc,
        npkt, Ttot, B, static_cast<T*>(out_l), static_cast<T*>(out_r));
  } else {
    using T = float;
    lev_apply<T, FloatRamp><<<grid, kApplyThreads, 0, s>>>(
        static_cast<const T*>(xl), static_cast<const T*>(xr),
        static_cast<const T*>(g_cur), static_cast<const T*>(g0),
        static_cast<const T*>(ring), static_cast<T*>(ring_out), L, e, tc,
        npkt, Ttot, B, static_cast<T*>(out_l), static_cast<T*>(out_r));
  }
  return static_cast<int>(cudaGetLastError());
}
