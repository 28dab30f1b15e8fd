// The segment tail of both chains for Hopper (sm_90a): from the output
// buffers PASS 4-5 leave (the matrix mix and the per-output EQ) to all
// that a segment reports of them, in one pass over the planes.  Float
// chain usb_audio.c:885-940, Q28 chain :1203-1257.  For each output o,
// lane b and row t:
//
//   1. gain: o's gain of the packet that holds the row.  Float
//      g == 0 ? 0 : y * g (one IEEE product, __fmul_rn); Q28 fast_mul_q15
//      (q15.cu's product, int32 wrap-around).  A muted output is 0, a
//      disabled one is left as it came.
//   2. delay: a delayed output reads the gained value dly rows back, or
//      the time-ordered ring of the gained values before the segment
//      (the window of concat(ring, gained) at D - dly), and writes the new
//      ring, the last D rows of that concat.
//   3. peaks: max |value| a lane over the segment, the S/PDIF channels and
//      the sub.  Float |v| keeps NaN (torch's amax propagates it); Q28
//      |INT_MIN| wraps to INT_MIN, as torch.abs does.
//   4. s24: float f32_to_i32(clamp(v, -1, 1) * 8388607) (NaN gives 0),
//      Q28 clip_s24((v + 32) >> 6) with the add wrapping; each channel's
//      words summed a lane mod 2^32.  A pair with both channels disabled
//      gives zeros.
//   5. sub: the PDM kernel's input, int32 Q28: float f32_to_i32(v * 2^28),
//      Q28 the value itself.
//   6. the delayed planes ([nout, T, B]) and the s24 words ([ns2, T, B])
//      only when asked for (emit "full", the wire encoder).
//
// Same function, word for word, as
// dspi_tpu_torch/kernels/tail_cuda.py:segment_tail_plain.
//
// What bounds it on this card: bytes.  Each output plane is read once, the
// sub written once, the rings read and written once: 4.30 GB a segment at
// 6144 x 16384 on the float chain's 9 outputs with 256-row rings (1.28 ms
// at 3.35 TB/s), 2.55 GB on the Q28 chain's 5.
//
// Design: the outputs share nothing but the rows of the peaks and sums,
// so a block is one output (grid z), kThreads threads of 4 neighbouring
// lanes each (16-byte loads and stores) and kRows rows; a thread keeps
// only its output's packet, gains, peaks and sums in registers (78 at 4
// lanes, so an SM holds many warps), and loads kAhead rows' words before
// it uses the first.  A delayed output at row t reads its plane at row
// t - dly, so every row of every plane is read by exactly one thread and
// nothing leans on the L2; the rows before the segment come from the old
// ring.  Per-lane delays and lane counts that are not a multiple of 4
// take the instances of one lane a thread.  A thread steps its packet,
// and loads that packet's gains, as its source row passes the packet's
// end (uniform packets of tc rows, or the schedule's end rows).  The
// peaks and sums merge across row blocks with integer atomics: max of the
// sign-cleared float bits (NaN's bits lie above every number's) or of the
// int32 |v|, and the uint32 sum; neither depends on the order, so every
// run gives the same words.  Blocks past the rows' blocks write the
// output's new ring.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 128;     // threads a block, along the lanes
constexpr int kRows = 64;         // rows a block walks
constexpr int kAhead = 4;         // rows whose words a thread loads at once
constexpr int kMaxOut = 9;        // the float chain's outputs

struct Args {
  const uint32_t* x[kMaxOut];     // each output's plane before its gain
  const uint32_t* gain;           // [nout, npkt, 1 | B]
  const int32_t* ends;            // [npkt] packet end rows, or null
  const int32_t* dly;             // [nlines] or [nlines, B]
  const uint32_t* ring;           // [nlines, D, B], time-ordered
  uint32_t* ring_out;             // [nlines, D, B]
  int32_t* peak;                  // [spdif + 1, B]
  uint32_t* sum;                  // [spdif, B]
  uint32_t* out;                  // [nout, T, B] or null
  uint32_t* s24;                  // [spdif, T, B] or null
  uint32_t* sub;                  // [T, B] or null
  int line[kMaxOut];              // each output's delay line, or -1
  unsigned enabled, muted, pair_on;
  int sub_peak;
  int nout, spdif, npkt, tc, T, B, D;
  int gain_lane, dly_lane, nchunk;
};

template <int V>
struct Words {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Words<V> load(const uint32_t* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r.w[0] = q.x; r.w[1] = q.y; r.w[2] = q.z; r.w[3] = q.w;
  } else {
    r.w[0] = *p;
  }
  return r;
}

// planes written here are not read again by this kernel: stream them
template <int V>
__device__ __forceinline__ void store(uint32_t* p, const Words<V>& r) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]));
  } else {
    __stcs(p, r.w[0]);
  }
}

__device__ __forceinline__ uint32_t q15(uint32_t s, uint32_t g) {
  const uint32_t sh = static_cast<uint32_t>(static_cast<int32_t>(s) >> 16);
  const uint32_t sl = s & 0xFFFFu;
  const uint32_t gh = static_cast<uint32_t>(static_cast<int32_t>(g) >> 16);
  const uint32_t gl = g & 0xFFFFu;
  return ((sh * g + sl * gh) << 1) + ((sl * gl) >> 15);
}

template <bool Q>
__device__ __forceinline__ uint32_t gained(uint32_t x, uint32_t g) {
  if constexpr (Q) {
    return q15(x, g);
  } else {
    const float gf = __uint_as_float(g);
    return gf == 0.0f ? 0u
                      : __float_as_uint(__fmul_rn(__uint_as_float(x), gf));
  }
}

// f32_to_i32 (vcvt.s32.f32): truncate toward zero, saturate, NaN -> 0
__device__ __forceinline__ int32_t f2i(float v) {
  if (v != v) return 0;
  if (v >= 2147483648.0f) return INT_MAX;
  if (v <= -2147483648.0f) return INT_MIN;
  return __float2int_rz(v);
}

template <bool Q>
__device__ __forceinline__ uint32_t s24_word(uint32_t v) {
  if constexpr (Q) {
    const int32_t r = static_cast<int32_t>(v + 32u) >> 6;
    return static_cast<uint32_t>(min(max(r, -0x800000), 0x7FFFFF));
  } else {
    float f = __uint_as_float(v);
    if (f != f) return 0u;
    f = f < -1.0f ? -1.0f : (f > 1.0f ? 1.0f : f);
    return static_cast<uint32_t>(__float2int_rz(__fmul_rn(f, 8388607.0f)));
  }
}

template <bool Q>
__device__ __forceinline__ uint32_t sub_word(uint32_t v) {
  if constexpr (Q) {
    return v;
  } else {
    return static_cast<uint32_t>(
        f2i(__fmul_rn(__uint_as_float(v), 268435456.0f)));
  }
}

// |v| as a key whose int32 order is the peak's: the float's bits with the
// sign cleared (NaN above inf), or the wrapped int32 |v|
template <bool Q>
__device__ __forceinline__ int32_t peak_key(uint32_t v) {
  if constexpr (Q) {
    return static_cast<int32_t>(v) < 0 ? static_cast<int32_t>(0u - v)
                                       : static_cast<int32_t>(v);
  } else {
    return static_cast<int32_t>(v & 0x7FFFFFFFu);
  }
}

// the last packet takes every row left, so no row reads past the gains
__device__ __forceinline__ int packet_end(const Args& a, int k) {
  if (k >= a.npkt - 1) return INT_MAX;
  return a.ends != nullptr ? a.ends[k] : (k + 1) * a.tc;
}

__device__ __forceinline__ int packet_of(const Args& a, int r) {
  if (a.ends == nullptr) return min(r / a.tc, a.npkt - 1);
  int lo = 0, hi = a.npkt - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a.ends[mid] > r) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// an output's source row's packet, its end and its gains, a lane each
template <int V>
struct Packet {
  int k, end;
  uint32_t g[V];
};

template <int V>
__device__ __forceinline__ void load_gains(const Args& a, int o, int b,
                                           Packet<V>& p) {
  const size_t stride = a.gain_lane ? static_cast<size_t>(a.B) : 1;
  const uint32_t* row = a.gain + (static_cast<size_t>(o) * a.npkt + p.k)
                        * stride;
#pragma unroll
  for (int j = 0; j < V; ++j) p.g[j] = row[a.gain_lane ? b + j : 0];
}

template <int V>
__device__ __forceinline__ void seek(const Args& a, int o, int r, int b,
                                     Packet<V>& p) {
  p.k = packet_of(a, max(r, 0));
  p.end = packet_end(a, p.k);
  load_gains(a, o, b, p);
}

// output o's packet stepped to row s >= 0, and its gains applied to v,
// the plane's words there
template <bool Q, int V>
__device__ __forceinline__ void gain(const Args& a, int o, int s, int b,
                                     Packet<V>& p, Words<V>& v) {
  while (s >= p.end) {
    ++p.k;
    p.end = packet_end(a, p.k);
    load_gains(a, o, b, p);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v.w[j] = gained<Q>(v.w[j], p.g[j]);
}

// the rings' blocks: ring_out[line][j] = concat(ring, gained)[T + j]
template <bool Q, int V>
__device__ void ring_rows(const Args& a, int o, int line, int b, int c) {
  const int j0 = c * kRows, j1 = min(j0 + kRows, a.D);
  const size_t D = a.D, B = a.B;
  const bool on = (a.enabled >> o) & 1u, mute = on && ((a.muted >> o) & 1u);
  const uint32_t* ring = a.ring + line * D * B + b;
  uint32_t* ring_out = a.ring_out + line * D * B + b;
  Packet<V> p;
  seek(a, o, a.T + j0 - a.D, b, p);
  for (int j = j0; j < j1; ++j) {
    const int s = a.T + j - a.D;
    Words<V> v = {};
    if (s < 0) {
      v = load<V>(ring + (a.T + j) * B);
    } else if (!mute) {
      v = load<V>(a.x[o] + s * B + b);
      if (on) gain<Q, V>(a, o, s, b, p, v);
    }
    store<V>(ring_out + j * B, v);
  }
}

// a block: one output (blockIdx.z), kThreads x V lanes, kRows rows (or,
// past the rows' blocks, the output's new ring)
template <bool Q, int V>
__global__ void __launch_bounds__(kThreads) tail_kernel(const Args a) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int o = blockIdx.z;
  if (b >= a.B) return;
  const int line = a.line[o];
  if (static_cast<int>(blockIdx.y) >= a.nchunk) {
    if (line >= 0) ring_rows<Q, V>(a, o, line, b, blockIdx.y - a.nchunk);
    return;
  }
  const bool spdif = o < a.spdif, sub = o == a.nout - 1;
  if (!spdif && !sub && a.out == nullptr) return;     // nothing to report
  const bool on = (a.enabled >> o) & 1u, mute = on && ((a.muted >> o) & 1u);
  const bool pair = spdif && ((a.pair_on >> (o / 2)) & 1u);
  const bool peaked = spdif || (sub && a.sub_peak);
  const int r0 = blockIdx.y * kRows, r1 = min(r0 + kRows, a.T);
  const size_t B = a.B, T = a.T, D = a.D;
  int d = 0;
  if (line >= 0) {
    d = min(max(a.dly[a.dly_lane ? line * B + b : line], 0), a.D);
  }
  const uint32_t* x = a.x[o] + b;
  const uint32_t* ring = line >= 0 ? a.ring + (line * D + D) * B + b
                                   : nullptr;
  uint32_t* out = a.out != nullptr ? a.out + o * T * B + b : nullptr;
  uint32_t* s24 = a.s24 != nullptr && spdif ? a.s24 + o * T * B + b
                                            : nullptr;
  uint32_t* subp = sub && a.sub != nullptr ? a.sub + b : nullptr;
  Packet<V> p;
  seek(a, o, r0 - d, b, p);
  int32_t peak[V];
  uint32_t sum[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    peak[j] = Q ? INT_MIN : 0;
    sum[j] = 0u;
  }
  for (int t0 = r0; t0 < r1; t0 += kAhead) {
    // kAhead rows' words first, so that their loads are in flight together
    Words<V> in[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int s = t0 + r - d;
      in[r] = {};
      if (t0 + r < r1 && (s < 0 || !mute)) {
        in[r] = load<V>(s >= 0 ? x + s * B
                               : ring + s * static_cast<int64_t>(B));
      }
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int t = t0 + r, s = t - d;
      if (t >= r1) break;
      Words<V> v = in[r];
      if (s >= 0 && on && !mute) gain<Q, V>(a, o, s, b, p, v);
      if (out != nullptr) store<V>(out + t * B, v);
      if (peaked) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          peak[j] = max(peak[j], peak_key<Q>(v.w[j]));
        }
      }
      if (spdif) {
        Words<V> w;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          w.w[j] = pair ? s24_word<Q>(v.w[j]) : 0u;
          sum[j] += w.w[j];
        }
        if (s24 != nullptr) store<V>(s24 + t * B, w);
      }
      if (subp != nullptr) {
        Words<V> w;
#pragma unroll
        for (int j = 0; j < V; ++j) w.w[j] = sub_word<Q>(v.w[j]);
        store<V>(subp + t * B, w);
      }
    }
  }
  int32_t* pk = a.peak + (spdif ? o : a.spdif) * B + b;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (peaked) {
      atomicMax(pk + j, peak[j]);
    } else if (sub && Q && blockIdx.y == 0) {
      atomicMax(pk + j, 0);     // a disabled sub's peak is 0, not INT_MIN
    }
    if (pair) atomicAdd(a.sum + o * B + b + j, sum[j]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool Q>
void launch(const Args& a, dim3 g, bool vec, cudaStream_t s) {
  if (vec) {
    tail_kernel<Q, 4><<<g, kThreads, 0, s>>>(a);
  } else {
    tail_kernel<Q, 1><<<g, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// The segment tail of one segment.  q28: the planes are the Q28 chain's
// int32 (else float32).  x: nout planes [T, B] before their gains; gain
// [nout, npkt, 1] (gain_lane 0) or [nout, npkt, B], float32 or Q15 int32;
// ends int32 [npkt], each packet's end row (the last T), or null for
// packets of tc rows.  line[o]: output o's delay line or -1; dly int32
// [nlines] (dly_lane 0) or [nlines, B], each in 0..D; ring [nlines, D, B]
// time-ordered, ring_out the same shape.  enabled, muted: bit o for output
// o.  spdif: the S/PDIF channels, outputs 0..spdif-1 (even, < nout); the
// sub is output nout - 1.  peak int32 [spdif + 1, B] set to 0 (float) or
// INT_MIN (Q28), sum [spdif, B] set to 0; out [nout, T, B], s24 [spdif, T,
// B] and sub [T, B] written where not null.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dspi_tail(int q28, const void* const* x, int nout,
                         const void* gain, int gain_lane, const void* ends,
                         int npkt, int tc, const void* dly, int dly_lane,
                         const int* line, const void* ring, void* ring_out,
                         int D, unsigned enabled, unsigned muted, int spdif,
                         void* peak, void* sum, void* out, void* s24,
                         void* sub, int T, int B, void* stream) {
  if (nout < 1 || nout > kMaxOut || spdif < 0 || spdif % 2 != 0 ||
      spdif >= nout || T < 1 || B < 1 || npkt < 1 ||
      (ends == nullptr && tc < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  bool lines = false;
  bool vec = B % 4 == 0 && !dly_lane;
  for (int o = 0; o < nout; ++o) {
    a.x[o] = static_cast<const uint32_t*>(x[o]);
    a.line[o] = line[o];
    lines = lines || line[o] >= 0;
    vec = vec && aligned16(x[o]);
  }
  if (lines && (D < 1 || dly == nullptr || ring == nullptr ||
                ring_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const planes[] = {ring, ring_out, out, s24, sub};
  for (const void* p : planes) vec = vec && (p == nullptr || aligned16(p));
  a.gain = static_cast<const uint32_t*>(gain);
  a.ends = static_cast<const int32_t*>(ends);
  a.dly = static_cast<const int32_t*>(dly);
  a.ring = static_cast<const uint32_t*>(ring);
  a.ring_out = static_cast<uint32_t*>(ring_out);
  a.peak = static_cast<int32_t*>(peak);
  a.sum = static_cast<uint32_t*>(sum);
  a.out = static_cast<uint32_t*>(out);
  a.s24 = static_cast<uint32_t*>(s24);
  a.sub = static_cast<uint32_t*>(sub);
  a.enabled = enabled;
  a.muted = muted;
  for (int p = 0; p < spdif / 2; ++p) {
    if ((enabled >> (2 * p)) & 3u) a.pair_on |= 1u << p;
  }
  a.sub_peak = (enabled >> (nout - 1)) & 1u;
  a.nout = nout;
  a.spdif = spdif;
  a.npkt = npkt;
  a.tc = tc;
  a.T = T;
  a.B = B;
  a.D = lines ? D : 0;
  a.gain_lane = gain_lane;
  a.dly_lane = dly_lane;
  a.nchunk = (T + kRows - 1) / kRows;
  const int rings = lines ? (D + kRows - 1) / kRows : 0;
  if (a.nchunk + rings > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = (B + (vec ? 3 : 0)) / (vec ? 4 : 1);
  const dim3 g((vecs + kThreads - 1) / kThreads, a.nchunk + rings, nout);
  const auto s = static_cast<cudaStream_t>(stream);
  if (q28) {
    launch<true>(a, g, vec, s);
  } else {
    launch<false>(a, g, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
