// Kernel K2 for Hopper: the KKT backward of the converged box-constrained
// LQR fixed point of the pendulum, one example per thread.
//
// Replaces the TPU kernel mpc_tpu/ops/fused_bwd.py:_make_bwd_kernel
// (lines 251-410, with _bwd_ctrl_solve's n_ctrl = 1 branches and
// _bwd_vv_update), which lays a tile of 1024 examples on the vector
// lanes and, for a batch-shared cost, accumulates the batch-reduced
// gradient in an SMEM block that stays resident across its sequential
// grid.  Per example it runs three passes over t:
//   1. reverse: the differential Riccati recursion on (C, -r) with the
//      active controls pinned (K = 0, k = 0), storing K[t], k[t];
//   2. forward: the differential rollout from dx_0 = 0 (pinned du = 0),
//      storing dx[t], du[t], and dC = -1/2 (dtau (x) tau + tau (x) dtau),
//      dc = -dtau;
//   3. reverse: the costate and differential-costate recursions, which
//      emit dF[t], df[t] from lam[t+1], dlam[t+1] on the fly (so lambda is
//      never stored), and dx_init = -dlam[0].
// T (MPC_T) is a compile-time constant, n_state = 3 and n_ctrl = 1; the
// loops over t are not unrolled, so the build time does not grow with T.
// K, k, dx and du (8*T floats) live in the thread's local memory.  The
// plain PyTorch version is mpc_tpu_torch/ops/fused_bwd.py:
// fused_kkt_backward_plain, in the same order.
//
// Batch-shared cost (MPC_COST_SHARED): dC [T, 4, 4] and dc [T, 4] are
// summed over the batch deterministically and without atomics.  Blocks
// run in parallel and in no order, so the TPU's resident accumulator has
// no counterpart: each block sums its threads for every t (shuffles down
// each warp, then the warps in order) into one row of a [n_blocks, T, 20]
// scratch, and a second kernel sums those rows in block order.  Two
// launches on the same inputs give the same bits.  A thread past the
// batch (b >= B) computes on example 0's data and contributes exactly 0.
//
// Bound on the card: bytes.  Per example and step the kernel reads F, r,
// x*, u* and the mask (~80 B) and writes dF and df (~60 B) against ~440
// operations (k2_flops, k2_bytes), ~10x below the card's ratio of float32
// rate to memory rate.  This first version is latency-bound instead: one
// thread walks its example's three passes sequentially, and B = 1024
// fills 16 blocks of 64 threads.

#include <cuda_runtime.h>

#ifndef MPC_T
#error "compile with -DMPC_T=<horizon>"
#endif
#ifndef MPC_HAS_I
#error "compile with -DMPC_HAS_I=0 or 1"
#endif
#ifndef MPC_COST_SHARED
#error "compile with -DMPC_COST_SHARED=0 or 1"
#endif

namespace mpc_bwd {

constexpr int T = MPC_T;
constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kHasI = MPC_HAS_I != 0;
constexpr bool kCostShared = MPC_COST_SHARED != 0;
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = NTAU * NTAU + NTAU;  // dC and dc entries of one step
constexpr int kReduceThreads = 128;

struct Operands {
  int B;
  const float* C;  // [T, 1 or B, 4, 4]
  long long sCt, sCb;
  const float* c;  // [T, 1 or B, 4]
  long long sct, scb;
  const float* F;     // [T-1, B, 3, 4]
  const float* rx;    // [T, B, 3]
  const float* ru;    // [T, B]
  const float* x;     // [T, B, 3]
  const float* u;     // [T, B]
  const float* I;     // [T, B], 1.0 = pinned; unused without MPC_HAS_I
  int has_f;
  float* dxi;      // [B, 3]
  float* dC;       // [T, B, 4, 4]; unused when shared
  float* dc;       // [T, B, 4]; unused when shared
  float* dF;       // [T-1, B, 3, 4]
  float* df;       // [T-1, B, 3]
  float* partial;  // [n_blocks, T, 20] when shared
};

// ((a0 b0 + a1 b1) + a2 b2)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

__global__ void __launch_bounds__(kThreads)
    kkt_bwd_kernel(const Operands op) {
  const int gb = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = gb < op.B;
  if (!kCostShared && !valid) return;  // ragged tail: masked, not padded
  // past the batch, a thread of a shared-cost block still takes part in
  // the block sums: it reads example 0 and contributes 0
  const int b = valid ? gb : 0;
  const int B = op.B;
  const float* Cb = op.C + b * op.sCb;
  const float* cb = op.c + b * op.scb;

  float K[T][NS], k[T];
  float dx[T][NS], du[T];

  // ---- 1. differential Riccati on (C, -r), active set pinned ----------
  float V[NS][NS], v[NS];
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const float* Ct = Cb + t * op.sCt;
    const long long o = (long long)t * B + b;
    const float r[NTAU] = {op.rx[o * NS], op.rx[o * NS + 1],
                           op.rx[o * NS + 2], op.ru[o]};
    float Qt[NTAU][NTAU], qt[NTAU];
    if (t == T - 1) {
#pragma unroll
      for (int a = 0; a < NTAU; ++a) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Qt[a][j] = Ct[4 * a + j];
        qt[a] = -r[a];
      }
    } else {
      const float* Fp = op.F + o * (NS * NTAU);
      float F[NS][NTAU];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j) F[i][j] = Fp[4 * i + j];
      float W[NS][NTAU];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j)
          W[i][j] = dot3(V[i][0], V[i][1], V[i][2], F[0][j], F[1][j], F[2][j]);
#pragma unroll
      for (int a = 0; a < NTAU; ++a) {
#pragma unroll
        for (int j = a; j < NTAU; ++j) {
          Qt[a][j] = Ct[4 * a + j] +
                     dot3(F[0][a], F[1][a], F[2][a], W[0][j], W[1][j], W[2][j]);
          Qt[j][a] = Qt[a][j];
        }
        qt[a] = -r[a] + dot3(F[0][a], F[1][a], F[2][a], v[0], v[1], v[2]);
      }
    }
    // the n_ctrl = 1 control solve (_bwd_ctrl_solve, fused_bwd.py:162-198)
    const float Quu = Qt[3][3];
    const float qu = qt[3];
    const float inv = 1.f / Quu;
    bool free_u = true;
    if (kHasI) free_u = op.I[o] < 0.5f;
    const float kt = free_u ? -qu * inv : 0.f;
    float Kt[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) Kt[j] = free_u ? -Qt[3][j] * inv : 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) K[t][j] = Kt[j];
    k[t] = kt;
    // cost-to-go (_bwd_vv_update, fused_bwd.py:201-226)
    float QK[NS][NS], KQuu[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int j = 0; j < NS; ++j) QK[i][j] = Qt[i][3] * Kt[j];
      KQuu[i] = Quu * Kt[i];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = i; j < NS; ++j) {
        V[i][j] = ((Qt[i][j] + QK[i][j]) + QK[j][i]) + Kt[i] * KQuu[j];
        V[j][i] = V[i][j];
      }
    const float quk = qu + Quu * kt;
#pragma unroll
    for (int i = 0; i < NS; ++i) v[i] = (qt[i] + Qt[i][3] * kt) + Kt[i] * quk;
  }

  // ---- 2. differential rollout from dx_0 = 0, with dC and dc ----------
  __shared__ float red[kWarps][kRed];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dxc[NS] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const long long o = (long long)t * B + b;
    float dut = dot3(K[t][0], K[t][1], K[t][2], dxc[0], dxc[1], dxc[2]) + k[t];
    if (kHasI && op.I[o] > 0.5f) dut = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) dx[t][i] = dxc[i];
    du[t] = dut;
    const float d[NTAU] = {dxc[0], dxc[1], dxc[2], dut};
    const float tau[NTAU] = {op.x[o * NS], op.x[o * NS + 1], op.x[o * NS + 2],
                             op.u[o]};
    float g[kRed];
#pragma unroll
    for (int i = 0; i < NTAU; ++i) {
#pragma unroll
      for (int j = i; j < NTAU; ++j) {
        g[4 * i + j] = -0.5f * (d[i] * tau[j] + tau[i] * d[j]);
        g[4 * j + i] = g[4 * i + j];
      }
      g[16 + i] = -d[i];
    }
    if (kCostShared) {
#pragma unroll
      for (int e = 0; e < kRed; ++e) {
        float s = valid ? g[e] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) red[warp][e] = s;
      }
      __syncthreads();
      if (threadIdx.x < kRed) {
        float s = red[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
        op.partial[((long long)blockIdx.x * T + t) * kRed + threadIdx.x] = s;
      }
      __syncthreads();  // red is rewritten at the next step
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) op.dC[o * 16 + e] = g[e];
#pragma unroll
      for (int i = 0; i < NTAU; ++i) op.dc[o * NTAU + i] = g[16 + i];
    }
    if (t < T - 1) {
      const float* Fp = op.F + o * (NS * NTAU);
      float nx[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        nx[i] = dot3(Fp[4 * i], Fp[4 * i + 1], Fp[4 * i + 2], d[0], d[1], d[2]) +
                Fp[4 * i + 3] * d[3];
#pragma unroll
      for (int i = 0; i < NS; ++i) dxc[i] = nx[i];
    }
  }
  if (!valid) return;  // past the last block sum: nothing left to share

  // ---- 3. costate recursions, dF and df on the fly --------------------
  float lam_n[NS], dlam_n[NS];
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const float* Ct = Cb + t * op.sCt;
    const float* ct = cb + t * op.sct;
    const long long o = (long long)t * B + b;
    const float tau[NTAU] = {op.x[o * NS], op.x[o * NS + 1], op.x[o * NS + 2],
                             op.u[o]};
    const float d[NTAU] = {dx[t][0], dx[t][1], dx[t][2], du[t]};
    float lam[NS], dlam[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float* Ci = Ct + 4 * i;
      lam[i] = (dot3(Ci[0], Ci[1], Ci[2], tau[0], tau[1], tau[2]) +
                Ci[3] * tau[3]) + ct[i];
      dlam[i] = (dot3(Ci[0], Ci[1], Ci[2], d[0], d[1], d[2]) + Ci[3] * d[3]) -
                op.rx[o * NS + i];
    }
    if (t < T - 1) {
      const float* Fp = op.F + o * (NS * NTAU);
      float* dFp = op.dF + o * (NS * NTAU);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j)
          dFp[4 * i + j] = -(dlam_n[i] * tau[j] + lam_n[i] * d[j]);
        op.df[o * NS + i] = op.has_f ? -dlam_n[i] : 0.f;
      }
      float nl[NS], ndl[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        nl[i] = lam[i] + dot3(Fp[i], Fp[4 + i], Fp[8 + i], lam_n[0], lam_n[1],
                              lam_n[2]);
        ndl[i] = dlam[i] + dot3(Fp[i], Fp[4 + i], Fp[8 + i], dlam_n[0],
                                dlam_n[1], dlam_n[2]);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        lam[i] = nl[i];
        dlam[i] = ndl[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      lam_n[i] = lam[i];
      dlam_n[i] = dlam[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) op.dxi[(long long)b * NS + i] = -dlam_n[i];
}

// The second pass of the shared-cost reduction: entry e of [T, 20] is
// the sum of the blocks' partials in block order.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* partial, int n_blocks, float* dC,
                           float* dc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= T * kRed) return;
  float s = partial[e];
  for (int blk = 1; blk < n_blocks; ++blk)
    s += partial[(long long)blk * T * kRed + e];
  const int t = e / kRed;
  const int i = e % kRed;
  if (i < 16)
    dC[t * 16 + i] = s;
  else
    dc[t * NTAU + i - 16] = s;
}

}  // namespace mpc_bwd

extern "C" int mpc_fused_kkt_bwd_threads() { return mpc_bwd::kThreads; }

// Launches K2 on ``stream`` (and, for a shared cost, its block-order
// sum); returns the cudaError_t of the launches.
extern "C" int mpc_fused_kkt_bwd(
    int B, const float* C, long long sCt, long long sCb, const float* c,
    long long sct, long long scb, const float* F, const float* rx,
    const float* ru, const float* x, const float* u, const float* I,
    int has_f, float* dxi, float* dC, float* dc, float* dF, float* df,
    float* partial, void* stream) {
  if (B <= 0 || (mpc_bwd::kHasI && I == nullptr) ||
      (mpc_bwd::kCostShared && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const mpc_bwd::Operands op{B,  C,  sCt, sCb, c,  sct, scb,   F,  rx,
                             ru, x,  u,   I,   has_f, dxi, dC, dc, dF,
                             df, partial};
  const int blocks = (B + mpc_bwd::kThreads - 1) / mpc_bwd::kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  mpc_bwd::kkt_bwd_kernel<<<blocks, mpc_bwd::kThreads, 0, s>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !mpc_bwd::kCostShared) return (int)err;
  const int n = mpc_bwd::T * mpc_bwd::kRed;
  mpc_bwd::reduce_partials_kernel<<<(n + mpc_bwd::kReduceThreads - 1) /
                                        mpc_bwd::kReduceThreads,
                                    mpc_bwd::kReduceThreads, 0, s>>>(
      partial, blocks, dC, dc);
  return (int)cudaGetLastError();
}
