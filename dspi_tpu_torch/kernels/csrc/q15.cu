// The Q28 chain's Q15 products, fast_mul_q15 (config.h:556-567), for
// Hopper (sm_90a): the matrix mix (PASS 4, usb_audio.c:1075-1100) and the
// per-packet output gains (usb_audio.c:1203-1212).
//
// fast_mul_q15 splits the sample s and the gain g into 16-bit halves
// (sh = s >> 16 arithmetic, sl = s & 0xFFFF; gh, gl alike) and returns
// (hh << 17) + (mid << 1) + (ll >> 15) mod 2^32, hh = sh*gh, mid = sh*gl +
// sl*gh, ll = sl*gl unsigned.  In PyTorch (core/qmath.py:q15_mul) that is
// ~22 whole-plane passes a product, several in int64.  Here it is 32-bit
// registers, in uint32 so that every wrap is defined: since gh << 16 + gl
// = g, (hh << 17) + (mid << 1) = (sh*g + sl*gh) << 1 mod 2^32, so a
// product is three multiplies, a shift and a shift-add, the same word as
// the firmware's for every sample and gain (INT32_MIN and INT32_MAX among
// them).  Same functions, word for word, as
// dspi_tpu_torch/kernels/q15_cuda.py:q15_mix_plain and q15_gain_plain.
//
// What bounds it on this card: bytes.  The mix reads bl and br once and
// writes each enabled output (7 int32 planes at 5 outputs, 2.82 GB at
// 6144 x 16384); the gains read and write each output once, in place
// (0.81 GB an output); 2.04 ms a segment at 3.35 TB/s.  The arithmetic,
// ~100 instructions a lane-row (15 products of 5 each, the splits and the
// mix's adds), needs ~0.3 ms of the card's integer issue.
//
// Design: a thread owns 4 neighbouring lanes (one 16-byte load or store a
// row; neighbouring threads on neighbouring lanes) and walks a block of
// rows.  Gains are the same for all lanes ([nout] mix, [Npkt, 1] gain) or
// per lane ([nout, B], [Npkt, B]); a thread loads its lanes' gains once
// (the mix) or once a packet its row block enters (the gains).  Packets
// are uniform (tc rows each) or the 44.1 kHz schedule's, given by their
// end rows; a row block finds its first packet by a search of the ends.
// A lane count that is not a multiple of 4 leaves rows unaligned for
// 16-byte access, so those calls take the instances of one lane a thread.
// q15_gain writes its plane in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads a block, along the lanes
constexpr int kRows = 32;         // rows a block walks
constexpr int kMaxOut = 5;        // the Q28 chain's outputs

struct Outs {
  int32_t* p[kMaxOut];            // each enabled output's plane
  int idx[kMaxOut];               // its output index, the gains' row
};

__device__ __forceinline__ uint32_t q15(uint32_t s, uint32_t g) {
  const uint32_t sh = static_cast<uint32_t>(static_cast<int32_t>(s) >> 16);
  const uint32_t sl = s & 0xFFFFu;
  const uint32_t gh = static_cast<uint32_t>(static_cast<int32_t>(g) >> 16);
  const uint32_t gl = g & 0xFFFFu;
  return ((sh * g + sl * gh) << 1) + ((sl * gl) >> 15);
}

template <int V>
struct Words {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Words<V> load(const int32_t* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    r.w[0] = q.x; r.w[1] = q.y; r.w[2] = q.z; r.w[3] = q.w;
  } else {
    r.w[0] = static_cast<uint32_t>(*p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(int32_t* p, const Words<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
    *p = static_cast<int32_t>(r.w[0]);
  }
}

// out[o] = q15(bl, g[0][o]) + q15(br, g[1][o]) mod 2^32 for the N enabled
// outputs; gains [2, nout] (LANE false) or [2, nout, B]
template <int N, bool LANE, int V>
__global__ void __launch_bounds__(kThreads)
q15_mix(const int32_t* __restrict__ bl, const int32_t* __restrict__ br,
        const int32_t* __restrict__ gains, Outs outs, int nout, int T,
        int B) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (b >= B) return;
  const size_t stride = LANE ? static_cast<size_t>(B) : 1;
  uint32_t g0[N][V], g1[N][V];
#pragma unroll
  for (int o = 0; o < N; ++o) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const size_t lane = LANE ? b + j : 0;
      g0[o][j] = gains[outs.idx[o] * stride + lane];
      g1[o][j] = gains[(nout + outs.idx[o]) * stride + lane];
    }
  }
  const int r1 = min(static_cast<int>(blockIdx.y + 1) * kRows, T);
#pragma unroll 2
  for (int r = blockIdx.y * kRows; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * B + b;
    const Words<V> l = load<V>(bl + at), rr = load<V>(br + at);
#pragma unroll
    for (int o = 0; o < N; ++o) {
      Words<V> y;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        y.w[j] = q15(l.w[j], g0[o][j]) + q15(rr.w[j], g1[o][j]);
      }
      store<V>(outs.p[o] + at, y);
    }
  }
}

// x[r] = q15(x[r], gain[packet of r]) in place; gain [Npkt, 1] (LANE
// false) or [Npkt, B]; packets tc rows each, or ending at ends[k]
template <bool LANE, int V>
__global__ void __launch_bounds__(kThreads)
q15_gain(int32_t* __restrict__ x, const int32_t* __restrict__ gain,
         const int32_t* __restrict__ ends, int npkt, int tc, int T, int B) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (b >= B) return;
  const size_t stride = LANE ? static_cast<size_t>(B) : 1;
  int r = blockIdx.y * kRows;
  const int r1 = min(r + kRows, T);
  // the packet of the block's first row: the first whose end lies past it
  int k;
  if (ends != nullptr) {
    int lo = 0, hi = npkt - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ends[mid] > r) hi = mid; else lo = mid + 1;
    }
    k = lo;
  } else {
    k = min(r / tc, npkt - 1);
  }
  while (r < r1) {
    uint32_t g[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] = gain[k * stride + (LANE ? b + j : 0)];
    }
    // the last packet takes every row left, so no row reads past the gains
    const int end = k == npkt - 1 ? r1
                    : min(r1, ends != nullptr ? ends[k] : (k + 1) * tc);
#pragma unroll 4
    for (; r < end; ++r) {
      int32_t* at = x + static_cast<size_t>(r) * B + b;
      Words<V> y = load<V>(at);
#pragma unroll
      for (int j = 0; j < V; ++j) y.w[j] = q15(y.w[j], g[j]);
      store<V>(at, y);
    }
    ++k;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

dim3 grid(int T, int B, int V) {
  const int vecs = (B + V - 1) / V;
  return dim3((vecs + kThreads - 1) / kThreads, (T + kRows - 1) / kRows);
}

template <int N>
void launch_mix(const int32_t* bl, const int32_t* br, const int32_t* gains,
                int lane, const Outs& outs, int nout, int T, int B,
                bool vec, cudaStream_t s) {
  const dim3 g = grid(T, B, vec ? 4 : 1);
  if (vec && lane) {
    q15_mix<N, true, 4><<<g, kThreads, 0, s>>>(bl, br, gains, outs, nout,
                                                T, B);
  } else if (vec) {
    q15_mix<N, false, 4><<<g, kThreads, 0, s>>>(bl, br, gains, outs, nout,
                                                 T, B);
  } else if (lane) {
    q15_mix<N, true, 1><<<g, kThreads, 0, s>>>(bl, br, gains, outs, nout,
                                                T, B);
  } else {
    q15_mix<N, false, 1><<<g, kThreads, 0, s>>>(bl, br, gains, outs, nout,
                                                 T, B);
  }
}

}  // namespace

// bl, br int32 [T, B]; gains int32 [2, nout] (lane 0) or [2, nout, B]
// (lane 1); the n enabled outputs' indices idx[n] and planes outs[n], each
// int32 [T, B] -> outs[i] = q15(bl, gains[0][idx[i]]) + q15(br,
// gains[1][idx[i]]).  1 <= n <= 5, T >= 1, B >= 1.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int dspi_q15_mix(const void* bl, const void* br, const void* gains,
                            int lane, int nout, int n, const int* idx,
                            void* const* outs, int T, int B, void* stream) {
  if (n < 1 || n > kMaxOut || nout < n || T < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Outs o{};
  bool vec = B % 4 == 0 && aligned16(bl) && aligned16(br);
  for (int i = 0; i < n; ++i) {
    o.p[i] = static_cast<int32_t*>(outs[i]);
    o.idx[i] = idx[i];
    vec = vec && aligned16(outs[i]);
  }
  const auto* l = static_cast<const int32_t*>(bl);
  const auto* r = static_cast<const int32_t*>(br);
  const auto* g = static_cast<const int32_t*>(gains);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch_mix<1>(l, r, g, lane, o, nout, T, B, vec, s); break;
    case 2: launch_mix<2>(l, r, g, lane, o, nout, T, B, vec, s); break;
    case 3: launch_mix<3>(l, r, g, lane, o, nout, T, B, vec, s); break;
    case 4: launch_mix<4>(l, r, g, lane, o, nout, T, B, vec, s); break;
    default: launch_mix<5>(l, r, g, lane, o, nout, T, B, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// x int32 [T, B], in place; gain int32 [npkt, 1] (lane 0) or [npkt, B]
// (lane 1); ends int32 [npkt], each packet's end row (the last T), or null
// for packets of tc rows (T = npkt * tc) -> x[r] = q15(x[r], gain[k]), k
// the packet of row r.  npkt >= 1, T >= 1, B >= 1.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int dspi_q15_gain(void* x, const void* gain, const void* ends,
                             int lane, int npkt, int tc, int T, int B,
                             void* stream) {
  if (npkt < 1 || T < 1 || B < 1 || (ends == nullptr && tc < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = B % 4 == 0 && aligned16(x);
  auto* xp = static_cast<int32_t*>(x);
  const auto* g = static_cast<const int32_t*>(gain);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 gr = grid(T, B, vec ? 4 : 1);
  if (vec && lane) {
    q15_gain<true, 4><<<gr, kThreads, 0, s>>>(xp, g, e, npkt, tc, T, B);
  } else if (vec) {
    q15_gain<false, 4><<<gr, kThreads, 0, s>>>(xp, g, e, npkt, tc, T, B);
  } else if (lane) {
    q15_gain<true, 1><<<gr, kThreads, 0, s>>>(xp, g, e, npkt, tc, T, B);
  } else {
    q15_gain<false, 1><<<gr, kThreads, 0, s>>>(xp, g, e, npkt, tc, T, B);
  }
  return static_cast<int>(cudaGetLastError());
}
