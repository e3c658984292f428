// Kernel K4 for Hopper: the streaming KKT backward of the converged
// box-constrained LQR fixed point, one example per thread, any horizon,
// with batch-shared cost and batch-shared dynamics.
//
// Replaces the TPU kernel mpc_tpu/ops/fused_bwd.py:_make_bwd_kernel_long
// (lines 413-785), which runs K2's three passes as fori_loops with the
// gains in VMEM scratch, streams the per-t vectors in and the per-example
// gradients out through 2-slot DMA buffers, and accumulates the gradients
// of batch-shared operands in SMEM blocks resident across its sequential
// grid.  Per example the passes are K2's (fused_kkt_bwd.cu), in the same
// arithmetic order:
//   1. reverse: the differential Riccati recursion on (C, -r) with the
//      active controls pinned, storing K[t], k[t];
//   2. forward: the differential rollout from dx_0 = 0, storing dx[t],
//      du[t] over the K[t], k[t] just consumed (as the TPU kernel aliases
//      them), and dC = -1/2 (dtau (x) tau + tau (x) dtau), dc = -dtau;
//   3. reverse: the costate and differential-costate recursions, which
//      emit dF[t] = -(dlam[t+1] (x) tau[t] + lam[t+1] (x) dtau[t]) and
//      df[t] = -dlam[t+1] on the fly, and dx_init = -dlam[0].
// What makes it a kernel of its own on this card:
//
// - K2 keeps 8*T floats per thread in local memory (T <= 512).  Here the
//   four rows K (3), k, later dx (3), du, live in a WORKSPACE IN GLOBAL
//   MEMORY that the wrapper allocates, [t, row, b] with the batch padded
//   to whole blocks, so a warp reads and writes one 128-byte line per
//   row.  T is a run-time argument: one build per layout serves every
//   horizon.
// - batch-shared dynamics (MPC_DYN_SHARED): F [T-1, 3, 4] is read with
//   batch stride 0, and dF [T-1, 3, 4], df [T-1, 3] are summed over the
//   batch in pass 3 by the method K2 uses for dC, dc (MPC_COST_SHARED),
//   which runs in pass 2: blocks run in parallel and in no order, so for
//   every t each block sums its threads in a fixed order (a shuffle-down
//   tree; a block is one warp) into one row of a [n_blocks, T, 20] or
//   [n_blocks, T-1, 15] scratch, and a second kernel sums those rows in
//   block order.  No atomics: two launches on the same inputs give the
//   same bits.  A thread past the batch computes on example 0's data in
//   its own workspace column, writes no per-example output, and adds
//   exactly 0 to every sum.  The sums take nothing from a thread but its
//   finished per-example value, so the per-example order of pass 3 is
//   K2's.
// - an absent f (has_f = 0, df == nullptr): no df is computed or written.
//
// Shared operands are read through the read-only cache, one broadcast a
// warp (see fused_ilqr_long.cu).  The plain PyTorch version is
// mpc_tpu_torch/ops/fused_bwd.py:fused_kkt_backward_long_plain, in the
// same order apart from the order of the batch sums.
//
// Bound on the card: bytes (k4_flops, k4_bytes): per example and step the
// kernel must read r, x*, u* and the mask (36 B) against ~400 operations.
// This first version is latency-bound: one thread walks its three passes
// sequentially through global memory, one warp a block.

#include <cuda_runtime.h>

#ifndef MPC_COST_SHARED
#error "compile with -DMPC_COST_SHARED=0 or 1"
#endif
#ifndef MPC_DYN_SHARED
#error "compile with -DMPC_DYN_SHARED=0 or 1"
#endif

namespace mpc_bwd_long {

constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kCostShared = MPC_COST_SHARED != 0;
constexpr bool kDynShared = MPC_DYN_SHARED != 0;
constexpr int kThreads = 32;  // one warp: a block sum is a shuffle tree
constexpr int kRows = 4;      // workspace rows per step: K (3), k
constexpr int kRedCost = NTAU * NTAU + NTAU;  // dC and dc entries of a step
constexpr int kRedDyn = NS * NTAU + NS;       // dF and df entries of a step
constexpr int kReduceThreads = 128;
static_assert(kThreads == 32, "the block sums assume one warp a block");

struct Operands {
  int B, T;
  const float* C;  // [T, 1 or B, 4, 4]
  long long sCt, sCb;
  const float* c;  // [T, 1 or B, 4]
  long long sct, scb;
  const float* F;  // [T-1, 1 or B, 3, 4]
  long long sFt, sFb;
  const float* rx;  // [T, B, 3]
  const float* ru;  // [T, B]
  const float* x;   // [T, B, 3]
  const float* u;   // [T, B]
  const float* I;   // [T, B], 1.0 = pinned; nullptr without an active set
  float* ws;        // [T, 4, n_blocks * 32]
  float* dxi;       // [B, 3]
  float* dC;        // [T, B, 4, 4]; unused when the cost is shared
  float* dc;        // [T, B, 4]; unused when the cost is shared
  float* dF;        // [T-1, B, 3, 4]; unused when the dynamics are shared
  float* df;        // [T-1, B, 3] or nullptr (no f); unused when shared
  float* part_cost;  // [n_blocks, T, 20] when the cost is shared
  float* part_dyn;   // [n_blocks, T-1, 15] when the dynamics are shared
};

// ((a0 b0 + a1 b1) + a2 b2)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// The block's sum of ``s`` in a fixed order; lane 0 holds it.
__device__ __forceinline__ float block_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(kThreads)
    kkt_bwd_long_kernel(const Operands op) {
  const int gb = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = gb < op.B;
  // ragged tail: masked, not padded.  With a shared operand a thread past
  // the batch still takes part in the block sums: it reads example 0 and
  // contributes 0
  if (!kCostShared && !kDynShared && !valid) return;
  const int b = valid ? gb : 0;
  const int B = op.B;
  const int T = op.T;
  const long long wsB = (long long)gridDim.x * kThreads;
  const float* Cb = op.C + b * op.sCb;
  const float* cb = op.c + b * op.scb;
  const float* Fb = op.F + b * op.sFb;
  const bool has_I = op.I != nullptr;
  const int lane = threadIdx.x;
#define WS(t, row) op.ws[((long long)(t) * kRows + (row)) * wsB + gb]

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
        for (int j = 0; j < NTAU; ++j) Qt[a][j] = __ldg(Ct + 4 * a + j);
        qt[a] = -r[a];
      }
    } else {
      const float* Fp = Fb + t * op.sFt;
      float F[NS][NTAU];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j) F[i][j] = __ldg(Fp + 4 * i + j);
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
          Qt[a][j] = __ldg(Ct + 4 * a + j) +
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
    const bool free_u = has_I ? op.I[o] < 0.5f : true;
    const float kt = free_u ? -qu * inv : 0.f;
    float Kt[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) Kt[j] = free_u ? -Qt[3][j] * inv : 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) WS(t, j) = Kt[j];
    WS(t, 3) = kt;
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
  float dxc[NS] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const long long o = (long long)t * B + b;
    float dut = dot3(WS(t, 0), WS(t, 1), WS(t, 2), dxc[0], dxc[1], dxc[2]) +
                WS(t, 3);
    if (has_I && op.I[o] > 0.5f) dut = 0.f;
    // dx[t], du[t] take the place of K[t], k[t], which are dead now
#pragma unroll
    for (int i = 0; i < NS; ++i) WS(t, i) = dxc[i];
    WS(t, 3) = dut;
    const float d[NTAU] = {dxc[0], dxc[1], dxc[2], dut};
    const float tau[NTAU] = {op.x[o * NS], op.x[o * NS + 1], op.x[o * NS + 2],
                             op.u[o]};
    float g[kRedCost];
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
      float* row = op.part_cost + ((long long)blockIdx.x * T + t) * kRedCost;
#pragma unroll
      for (int e = 0; e < kRedCost; ++e) {
        const float s = block_sum(valid ? g[e] : 0.f);
        if (lane == 0) row[e] = s;
      }
    } else if (valid) {
#pragma unroll
      for (int e = 0; e < 16; ++e) op.dC[o * 16 + e] = g[e];
#pragma unroll
      for (int i = 0; i < NTAU; ++i) op.dc[o * NTAU + i] = g[16 + i];
    }
    if (t < T - 1) {
      const float* Fp = Fb + t * op.sFt;
      float nx[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        nx[i] = dot3(__ldg(Fp + 4 * i), __ldg(Fp + 4 * i + 1),
                     __ldg(Fp + 4 * i + 2), d[0], d[1], d[2]) +
                __ldg(Fp + 4 * i + 3) * d[3];
#pragma unroll
      for (int i = 0; i < NS; ++i) dxc[i] = nx[i];
    }
  }
  if (!kDynShared && !valid) return;  // no block sum is left to share

  // ---- 3. costate recursions, dF and df on the fly --------------------
  float lam_n[NS], dlam_n[NS];
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const float* Ct = Cb + t * op.sCt;
    const float* ct = cb + t * op.sct;
    const long long o = (long long)t * B + b;
    const float tau[NTAU] = {op.x[o * NS], op.x[o * NS + 1], op.x[o * NS + 2],
                             op.u[o]};
    const float d[NTAU] = {WS(t, 0), WS(t, 1), WS(t, 2), WS(t, 3)};
    float lam[NS], dlam[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float Ci[NTAU] = {__ldg(Ct + 4 * i), __ldg(Ct + 4 * i + 1),
                              __ldg(Ct + 4 * i + 2), __ldg(Ct + 4 * i + 3)};
      lam[i] = (dot3(Ci[0], Ci[1], Ci[2], tau[0], tau[1], tau[2]) +
                Ci[3] * tau[3]) + __ldg(ct + i);
      dlam[i] = (dot3(Ci[0], Ci[1], Ci[2], d[0], d[1], d[2]) + Ci[3] * d[3]) -
                op.rx[o * NS + i];
    }
    if (t < T - 1) {
      const float* Fp = Fb + t * op.sFt;
      float g[kRedDyn];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j)
          g[4 * i + j] = -(dlam_n[i] * tau[j] + lam_n[i] * d[j]);
        g[12 + i] = -dlam_n[i];
      }
      if (kDynShared) {
        float* row =
            op.part_dyn + ((long long)blockIdx.x * (T - 1) + t) * kRedDyn;
#pragma unroll
        for (int e = 0; e < kRedDyn; ++e) {
          const float s = block_sum(valid ? g[e] : 0.f);
          if (lane == 0) row[e] = s;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 12; ++e) op.dF[o * 12 + e] = g[e];
        if (op.df != nullptr) {
#pragma unroll
          for (int i = 0; i < NS; ++i) op.df[o * NS + i] = g[12 + i];
        }
      }
      float nl[NS], ndl[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float F0 = __ldg(Fp + i), F1 = __ldg(Fp + 4 + i),
                    F2 = __ldg(Fp + 8 + i);
        nl[i] = lam[i] + dot3(F0, F1, F2, lam_n[0], lam_n[1], lam_n[2]);
        ndl[i] = dlam[i] + dot3(F0, F1, F2, dlam_n[0], dlam_n[1], dlam_n[2]);
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
  if (!valid) return;
#pragma unroll
  for (int i = 0; i < NS; ++i) op.dxi[(long long)b * NS + i] = -dlam_n[i];
#undef WS
}

// The second pass of a reduction: entry e of [n_t, kPer] is the sum of
// the blocks' partials in block order; its first kFirst values go to
// ``a`` [n_t, kFirst] and the rest to ``rest`` [n_t, kPer - kFirst]
// (skipped when nullptr: an absent f has no df).
template <int kPer, int kFirst>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* partial, int n_blocks, int n_t,
                           float* a, float* rest) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_t * kPer) return;
  float s = partial[e];
  for (int blk = 1; blk < n_blocks; ++blk)
    s += partial[(long long)blk * n_t * kPer + e];
  const int t = e / kPer;
  const int i = e % kPer;
  if (i < kFirst)
    a[t * kFirst + i] = s;
  else if (rest != nullptr)
    rest[t * (kPer - kFirst) + i - kFirst] = s;
}

}  // namespace mpc_bwd_long

extern "C" int mpc_fused_kkt_bwd_long_threads() {
  return mpc_bwd_long::kThreads;
}

// Launches K4 on ``stream`` (and the block-order sums of its shared
// gradients); returns the cudaError_t of the launches.  ``ws`` is the
// [T, 4, n_blocks * threads] workspace; dC, dc are [T, 4, 4], [T, 4] when
// the cost is shared and dF, df [T-1, 3, 4], [T-1, 3] when the dynamics
// are; df is nullptr for an absent f.
extern "C" int mpc_fused_kkt_bwd_long(
    int B, int T, const float* C, long long sCt, long long sCb, const float* c,
    long long sct, long long scb, const float* F, long long sFt, long long sFb,
    const float* rx, const float* ru, const float* x, const float* u,
    const float* I, float* ws, float* dxi, float* dC, float* dc, float* dF,
    float* df, float* part_cost, float* part_dyn, void* stream) {
  using namespace mpc_bwd_long;
  if (B <= 0 || T <= 0 || ws == nullptr || (kCostShared && part_cost == nullptr) ||
      (kDynShared && T > 1 && part_dyn == nullptr))
    return (int)cudaErrorInvalidValue;
  const Operands op{B,  T,  C, sCt, sCb, c,   sct, scb, F,  sFt, sFb,
                    rx, ru, x, u,   I,   ws,  dxi, dC,  dc, dF,  df,
                    part_cost, part_dyn};
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  kkt_bwd_long_kernel<<<blocks, kThreads, 0, s>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (kCostShared) {
    const int n = T * kRedCost;
    reduce_partials_kernel<kRedCost, NTAU * NTAU>
        <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
            part_cost, blocks, T, dC, dc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kDynShared && T > 1) {
    const int n = (T - 1) * kRedDyn;
    reduce_partials_kernel<kRedDyn, NS * NTAU>
        <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
            part_dyn, blocks, T - 1, dF, df);
    err = cudaGetLastError();
  }
  return (int)err;
}
