// The float block lowering's packet carries (dspi_tpu_torch/chain/mxu.py)
// for Hopper (sm_90a): each sequential carry of a segment as one launch.
//
// carry: _apply_blocked's loop over packets.  The input responses of a
// block matrix [[Tx, U], [V, W]] are hoisted into two batched products
// over the whole segment (y = Tx x, vx = V x, cuBLAS); what is left is
// the state's walk over the packets,
//
//     y[k] += U_j s_k,    s_{k+1} = vx[k] + W_j s_k,    j = k % P,
//
// with P = 1 (one matrix for every packet), a periodic schedule's pattern
// length, or the packet count (one matrix a packet).  Batch axes A (the
// group's, grouped serving; the batched outputs') index the matrices and
// the data alike.  env_carry: env_packet_ends' recurrence over the packet
// ends, e = a^T_k e + c[k] with the firmware's flush of e < 1e-30 to 0
// (leveller.c:150-156), both channels in one launch.
//
// The JAX package runs both as Python loops of XLA ops (the port's plain
// versions, kernels/carry_cuda.py); no TPU kernel.  Eagerly in PyTorch a
// segment takes four launches a carry step and ten an envelope packet,
// ~3,300 launches at 48 kHz, and the host's dispatch of them sets the
// block cells' pace, so the port runs each carry as one launch here.
//
// What bounds them on this card: bytes.  y is read and written once and
// vx read once (the matrices, a few KB, are read from shared memory);
// per chain-A channel at 128 x 48 rows x 16,384 lanes, S = 24, ~1.0 GB,
// 0.30 ms at 3.35 TB/s.  One thread a (lane, batch index) walks the
// packets with its state in registers; every global load and store
// coalesces across a warp's lanes.  A step's matrices sit in shared
// memory, read by a whole warp at one address (a broadcast): staged once
// when P = 1, else once a step between two barriers.  The rows of y are
// taken eight at a time, their eight loads issued before the sums that
// use them.  What holds it back is the loads' latency: 16,384 lanes of one
// batch index are one warp a scheduler.  So where the lanes and batch
// indices give fewer than kWantThreads threads, Q threads (2 or 4) share a
// lane's rows of y, each a contiguous Q-th of them, each advancing the
// whole state itself (the W products repeated Q times, the same numbers
// in each), and Q times the warps hide the loads' latency.
//
// Arithmetic: float32 FFMA, nothing lower.  Each dot product over the
// state index is summed in that index's order (__fmul_rn, then
// __fmaf_rn), then added to y[k] or vx[k] with __fadd_rn (cuBLAS's
// products a step matched it bit for bit at the float cells' shapes on an
// H100; the card tests allow 1e-6 for another order).  env_carry is
// __fmul_rn then __fadd_rn, PyTorch's two element-wise ops, so it equals
// the plain loop bit for bit.  The library is built without fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;                      // rows of y a chunk
constexpr int kMaxParts = 4;                  // threads a lane, at most
constexpr int64_t kWantThreads = 65536;       // ~16 warps on each of 132 SMs
constexpr int kEnvThreads = 128;
constexpr float kTiny = 0x1.4484cp-100f;      // float32(1e-30)

template <int S>
__device__ __forceinline__ float dot(const float* m, const float (&s)[S]) {
  float acc = __fmul_rn(m[0], s[0]);
#pragma unroll
  for (int i = 1; i < S; ++i) acc = __fmaf_rn(m[i], s[i], acc);
  return acc;
}

// R rows of y[k] from row r: their loads first, then their sums
template <int S, int R>
__device__ __forceinline__ void rows(float* yk, int64_t G, const float* su,
                                     int r, const float (&s)[S]) {
  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = yk[(r + i) * G];
#pragma unroll
  for (int i = 0; i < R; ++i)
    yk[(r + i) * G] = __fadd_rn(v[i], dot<S>(su + (r + i) * S, s));
}

// y [N, A, Ry, G], vx [N, A, S, G], s0 [A, S, G] -> sF [A, S, G];
// U [P, A, Ry, S], W [P, A, S, S].  Block (kThreads / Q lanes, Q parts),
// grid (ceil(G / (kThreads / Q)), A).
template <int S>
__global__ void __launch_bounds__(kThreads)
carry_kernel(float* __restrict__ y, const float* __restrict__ vx,
             const float* __restrict__ s0, const float* __restrict__ U,
             const float* __restrict__ W, int N, int P, int A, int Ry, int G,
             float* __restrict__ sF) {
  extern __shared__ float smem[];
  float* su = smem;                   // U_j [Ry, S]
  float* sw = smem + Ry * S;          // W_j [S, S]
  const int a = blockIdx.y;
  const int Q = blockDim.y, q = threadIdx.y;
  const int tid = q * blockDim.x + threadIdx.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = q * Ry / Q, r1 = (q + 1) * Ry / Q;   // this part's rows
  const bool live = g < G;
  const int64_t Gs = G;
  float s[S];
#pragma unroll
  for (int i = 0; i < S; ++i)
    s[i] = live ? s0[(static_cast<int64_t>(a) * S + i) * Gs + g] : 0.0f;

  auto stage = [&](int j) {
    const int64_t m = static_cast<int64_t>(j) * A + a;
    const float* u = U + m * Ry * S;
    const float* w = W + m * S * S;
    for (int i = tid; i < Ry * S; i += kThreads) su[i] = u[i];
    for (int i = tid; i < S * S; i += kThreads) sw[i] = w[i];
  };
  if (P == 1) {
    stage(0);
    __syncthreads();
  }
  for (int k = 0; k < N; ++k) {
    if (P > 1) {
      __syncthreads();                // every warp is done with step k - 1's
      stage(k % P);
      __syncthreads();
    }
    if (!live) continue;
    const int64_t ka = static_cast<int64_t>(k) * A + a;
    float* yk = y + ka * Ry * Gs + g;
    const float* vk = vx + ka * S * Gs + g;
    float nx[S];
#pragma unroll
    for (int o = 0; o < S; ++o) nx[o] = vk[o * Gs];
    int r = r0;
    for (; r + kRows <= r1; r += kRows) rows<S, kRows>(yk, Gs, su, r, s);
    for (; r < r1; ++r) rows<S, 1>(yk, Gs, su, r, s);
#pragma unroll
    for (int o = 0; o < S; ++o)
      nx[o] = __fadd_rn(nx[o], dot<S>(sw + o * S, s));
#pragma unroll
    for (int o = 0; o < S; ++o) s[o] = nx[o];
  }
  if (live && q == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i)
      sF[(static_cast<int64_t>(a) * S + i) * Gs + g] = s[i];
  }
}

template <int S>
int launch_carry(float* y, const float* vx, const float* s0, const float* U,
                 const float* W, int N, int P, int A, int Ry, int G,
                 float* sF, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Ry + S) * S * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        carry_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int Q = 1;
  while (Q < kMaxParts && Ry >= 2 * Q * kRows &&
         static_cast<int64_t>(G) * A * 2 * Q <= kWantThreads)
    Q *= 2;
  const int lanes = kThreads / Q;
  const dim3 grid((G + lanes - 1) / lanes, A);
  carry_kernel<S><<<grid, dim3(lanes, Q), smem, stream>>>(
      y, vx, s0, U, W, N, P, A, Ry, G, sF);
  return static_cast<int>(cudaGetLastError());
}

// cl, cr [Npkt, B]; aT element (k, b) at aT[k * aT_k + b * aT_b] (a packet
// axis of stride 0 for uniform packets, a lane stride of 0 for one alpha);
// e0 = (el0, er0) [B] -> out_l, out_r [Npkt, B].  Grid (ceil(B / 128), 2).
__global__ void __launch_bounds__(kEnvThreads)
env_kernel(const float* __restrict__ aT, int64_t aT_k, int64_t aT_b,
           const float* __restrict__ cl, const float* __restrict__ cr,
           const float* __restrict__ el0, const float* __restrict__ er0,
           int npkt, int B, float* __restrict__ out_l,
           float* __restrict__ out_r) {
  const int b = blockIdx.x * kEnvThreads + threadIdx.x;
  if (b >= B) return;
  const bool right = blockIdx.y == 1;
  const float* c = right ? cr : cl;
  float* out = right ? out_r : out_l;
  const int64_t Bs = B;
  float e = right ? er0[b] : el0[b];
#pragma unroll 4
  for (int k = 0; k < npkt; ++k) {
    e = __fadd_rn(__fmul_rn(aT[k * aT_k + b * aT_b], e), c[k * Bs + b]);
    e = e < kTiny ? 0.0f : e;
    out[k * Bs + b] = e;
  }
}

}  // namespace

// The matrix carry (see carry_kernel): float32 tensors, contiguous; S even
// in [2, 28]; 1 <= P, N % P == 0; 1 <= A <= 65535; Ry, G >= 1.  Updates y
// in place, writes sF.  Launches on `stream` and returns cudaGetLastError()
// (or the shared-memory attribute's error).
extern "C" int dspi_carry(void* y, const void* vx, const void* s0,
                          const void* U, const void* W, int N, int P, int A,
                          int Ry, int S, int G, void* sF, void* stream) {
  if (N < 1 || P < 1 || N % P || A < 1 || A > 65535 || Ry < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* yp = static_cast<float*>(y);
  const float* vp = static_cast<const float*>(vx);
  const float* sp = static_cast<const float*>(s0);
  const float* up = static_cast<const float*>(U);
  const float* wp = static_cast<const float*>(W);
  float* fp = static_cast<float*>(sF);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define DSPI_CARRY_CASE(n) \
  case n:                  \
    return launch_carry<n>(yp, vp, sp, up, wp, N, P, A, Ry, G, fp, st);
    DSPI_CARRY_CASE(2) DSPI_CARRY_CASE(4) DSPI_CARRY_CASE(6)
    DSPI_CARRY_CASE(8) DSPI_CARRY_CASE(10) DSPI_CARRY_CASE(12)
    DSPI_CARRY_CASE(14) DSPI_CARRY_CASE(16) DSPI_CARRY_CASE(18)
    DSPI_CARRY_CASE(20) DSPI_CARRY_CASE(22) DSPI_CARRY_CASE(24)
    DSPI_CARRY_CASE(26) DSPI_CARRY_CASE(28)
#undef DSPI_CARRY_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The envelope carry (see env_kernel): float32; cl, cr, el0, er0
// contiguous; npkt, B >= 1.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dspi_env_carry(const void* aT, long long aT_k, long long aT_b,
                              const void* cl, const void* cr,
                              const void* el0, const void* er0, int npkt,
                              int B, void* out_l, void* out_r,
                              void* stream) {
  if (npkt < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kEnvThreads - 1) / kEnvThreads, 2);
  env_kernel<<<grid, kEnvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aT), aT_k, aT_b,
      static_cast<const float*>(cl), static_cast<const float*>(cr),
      static_cast<const float*>(el0), static_cast<const float*>(er0), npkt,
      B, static_cast<float*>(out_l), static_cast<float*>(out_r));
  return static_cast<int>(cudaGetLastError());
}
