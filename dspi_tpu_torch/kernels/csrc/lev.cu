// The leveller's block-rate attack/release smoothing, both chains, for
// Hopper (sm_90a).
//
// Once a packet the leveller moves its smoothed gain (dB) toward the gain
// computer's target: alpha = target < gdb ? att^n : rel^n, then
// gdb = alpha*gdb + (1-alpha)*target with both products rounded on their
// own (leveller.c:182-185, 223-227).  The JAX package runs it as the
// lax.scan lev_step (dspi_tpu/chain/pipeline.py:518-527 float, :992-999
// Q28) and has no TPU kernel for it.  Eagerly in PyTorch the same loop is
// ~120 launches a packet (two mul_det of ~55 int64 tensor ops each, a
// where, a subtract and an add), ~15.4k a segment of 128 packets, so the
// port runs it as this kernel, one launch a segment.  Same function, bit
// for bit, as dspi_tpu_torch/kernels/lev_cuda.py:lev_smooth_plain:
// mul_det is core/fmath.py's integer algorithm as it stands (a 24 x 24-bit
// mantissa product in 64 bits, round to nearest even, denormal operands
// and results flushed to a signed zero, overflow clamped to the largest
// finite float), and the two lone float operations are __fsub_rn and
// __fadd_rn, built without -ftz, so a denormal sum survives as it does in
// PyTorch's elementwise ops.  No float multiply is left to contract.
//
// What bounds it on this card: neither bytes nor operations but the
// recurrence's latency.  It moves gc in and gdbs out, 8 bytes a
// lane-packet (16.8 MB at 128 x 16,384, 5.0 us at 3.35 TB/s; per-lane
// alpha tables add 8 more), and its packet loop issues 107 per-thread
// instructions a lane-packet, 76 of them on the integer ALU alone (the
// 64-bit mantissa product's shifts, masks and compares), which bound it
// at 9.5 us there (64 ALU operations a clock an SM).  But each packet
// waits for the last, and 16,384 lanes at a thread each are only ~4 warps
// an SM, one a scheduler, to hide a packet's dependent chain: 0.072 ms
// measured on an H100 80GB HBM3 at 700 W, against ~150 ms for the
// PyTorch loop on the same card.
//
// Design: one thread a lane walks all packets with gdb in a register.  The
// [Npkt, B] layout makes every load and store coalesce across a warp.  The
// packet loop reads kAhead packets' inputs into registers before it runs
// their recurrence, so the loads of a group are in flight together and off
// the chain.  The alpha tables are [Npkt, 1] (uniform parameters, lane
// stride 0) or [Npkt, B] (per-lane parameters, lane stride 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 8;      // packets whose inputs are loaded together

// float32 a*b as core/fmath.py:mul_det computes it in integers
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

__global__ void __launch_bounds__(kThreads)
lev_smooth(const float* __restrict__ gc, const float* __restrict__ pow_att,
           const float* __restrict__ pow_rel,
           const float* __restrict__ gdb0, float* __restrict__ gdbs,
           int npkt, int B, int lane) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  // alpha tables [Npkt, 1]: row k at k; [Npkt, B]: row k at k * B + b
  const size_t arow = lane ? sB : 1;
  const float* pa = pow_att + (lane ? b : 0);
  const float* pr = pow_rel + (lane ? b : 0);
  float gdb = gdb0[b];
  for (int k0 = 0; k0 < npkt; k0 += kAhead) {
    const int n = min(kAhead, npkt - k0);
    float g[kAhead], att[kAhead], rel[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < n) {
        const size_t k = static_cast<size_t>(k0 + j);
        g[j] = gc[k * sB + b];
        att[j] = pa[k * arow];
        rel[j] = pr[k * arow];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < n) {
        const float alpha = g[j] < gdb ? att[j] : rel[j];
        gdb = __fadd_rn(mul_det(alpha, gdb),
                        mul_det(__fsub_rn(1.0f, alpha), g[j]));
        gdbs[static_cast<size_t>(k0 + j) * sB + b] = gdb;
      }
    }
  }
}

}  // namespace

// gc float [Npkt, B] (the gain computer's targets, dB); pow_att, pow_rel
// float [Npkt, 1], or [Npkt, B] with lane; gdb0 float [B] -> gdbs float
// [Npkt, B], the smoothed gain after each packet.  Npkt >= 1, B >= 1.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dspi_lev_smooth(const void* gc, const void* pow_att,
                               const void* pow_rel, const void* gdb0,
                               void* gdbs, int npkt, int B, int lane,
                               void* stream) {
  if (npkt < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  lev_smooth<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gc), static_cast<const float*>(pow_att),
      static_cast<const float*>(pow_rel), static_cast<const float*>(gdb0),
      static_cast<float*>(gdbs), npkt, B, lane);
  return static_cast<int>(cudaGetLastError());
}
