// Kernel K1 for Hopper: the whole box-constrained iLQR solve of the
// pendulum, one example per thread.
//
// Replaces the TPU kernel mpc_tpu/ops/fused.py:_make_kernel (lines
// 617-1119), which lays a tile of 1024 examples on the vector lanes and
// unrolls every scalar of the small matrices into (8, 128) registers.
// Here each thread owns one example: T (MPC_T), n_state = 3 and
// n_ctrl = 1 are compile-time constants so the small loops unroll, and
// the per-example trajectory, best trajectory, gains and trial rollout
// (16*T floats) sit in registers and local memory.  Batch-shared and
// batched operands differ only in their batch stride, which is 0 for
// shared ones.  The plain PyTorch version is
// mpc_tpu_torch/ops/fused.py:fused_solve_plain, in the same order.
//
// Bound on the card: operations.  Per example the solve runs the
// Riccati recursion with in-kernel Jacobians and the line-search
// rollouts, ~8 kFLOP per outer iteration at T = 20, against ~440 B of
// device memory per example in and out (k1_flops, k1_bytes).  This
// first version is latency-bound: one thread walks its solve
// sequentially, and B = 4096 fills 64 blocks of 64 threads, about half
// the SMs with two warps each.  Spreading an example over a warp (the
// line-search step sizes run in parallel on the TPU) is later work.
//
// Outputs: x [T, B, 3], u [T, B, 1], stats [6, B] = best cost, best
// full-step norm, n_iter, n_qp_iter, alpha and the number of line-search
// trial rollouts (for the operation count).

#include <cuda_runtime.h>

#include "pendulum.cuh"

#ifndef MPC_T
#error "compile with -DMPC_T=<horizon>"
#endif
#ifndef MPC_HAS_BOUNDS
#error "compile with -DMPC_HAS_BOUNDS=0 or 1"
#endif

namespace mpc {

constexpr int T = MPC_T;
constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kHasBounds = MPC_HAS_BOUNDS != 0;
constexpr int kMaxAlpha = 32;  // ops/fused.py:MAX_ALPHA
constexpr int kThreads = 64;
constexpr float kBig = 3.0e38f;

struct Schedule {
  float a[kMaxAlpha];
  int n;
};

struct Operands {
  int B;
  const float* params;
  const float* C;  // [T, 1 or B, 4, 4]
  long long sCt, sCb;
  const float* c;  // [T, 1 or B, 4]
  long long sct, scb;
  const float* x0;  // [B, 3]
  const float* u0;  // [T, B]
  const float* lb;  // [T, 1 or B]
  const float* ub;
  long long sbt, sbb;
  int lqr_iter;
  float eps, best_cost_eps, not_improved_lim;
  float* x_out;  // [T, B, 3]
  float* u_out;  // [T, B]
  float* stats;  // [6, B]
};

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

// 0.5 tau^T C tau + c^T tau in _quad_lin_cost's order
// (mpc_tpu/ops/fused.py:468-476).
__device__ __forceinline__ float stage_cost(const float* Ct, const float* ct,
                                            const float* xt, float ut) {
  const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NTAU; ++i) {
    const float term = (0.5f * dot4(Ct + 4 * i, tau) + ct[i]) * tau[i];
    acc = i == 0 ? term : acc + term;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    fused_ilqr_kernel(const Operands op, const Schedule sched) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= op.B) return;  // ragged tail: no padding, just masking
  const int B = op.B;
  const PendulumParams p{op.params[0], op.params[1], op.params[2]};
  const float* Cb = op.C + b * op.sCb;
  const float* cb = op.c + b * op.scb;

  float x[T][NS], u[T], bx[T][NS], bu[T];
  float K[T][NS], k[T];
  float nx[T][NS], nu[T];
  float lbv[kHasBounds ? T : 1], ubv[kHasBounds ? T : 1];

  for (int t = 0; t < T; ++t) {
    u[t] = op.u0[(long long)t * B + b];
    if (kHasBounds) {
      lbv[t] = op.lb[t * op.sbt + b * op.sbb];
      ubv[t] = op.ub[t * op.sbt + b * op.sbb];
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) x[0][i] = op.x0[(long long)b * NS + i];
  for (int t = 0; t < T - 1; ++t) pendulum_step(p, x[t], u[t], x[t + 1]);
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NS; ++i) bx[t][i] = x[t][i];
    bu[t] = u[t];
  }

  float best_cost = kBig, best_du = kBig, cur_du = kBig;
  float nni = 0.f, n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;

  for (int it = 0; it < op.lqr_iter; ++it) {
    // ---- Riccati backward recursion with the 1-D box QP --------------
    float V[NS][NS], v[NS];
    float qp_cnt = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const float* Ct = Cb + t * op.sCt;
      const float* ct = cb + t * op.sct;
      const float tau[NTAU] = {x[t][0], x[t][1], x[t][2], u[t]};
      float cbv[NTAU];
#pragma unroll
      for (int i = 0; i < NTAU; ++i) cbv[i] = dot4(Ct + 4 * i, tau) + ct[i];
      float Qt[NTAU][NTAU], qt[NTAU];
      if (t == T - 1) {
#pragma unroll
        for (int i = 0; i < NTAU; ++i) {
#pragma unroll
          for (int j = 0; j < NTAU; ++j) Qt[i][j] = Ct[4 * i + j];
          qt[i] = cbv[i];
        }
      } else {
        float F[NS][NTAU];
        pendulum_jacobian(p, x[t], u[t], F);
        float W[NS][NTAU];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int j = 0; j < NTAU; ++j)
            W[i][j] = V[i][0] * F[0][j] + V[i][1] * F[1][j] + V[i][2] * F[2][j];
#pragma unroll
        for (int a = 0; a < NTAU; ++a) {
#pragma unroll
          for (int bb = a; bb < NTAU; ++bb) {
            Qt[a][bb] = Ct[4 * a + bb] + (F[0][a] * W[0][bb] + F[1][a] * W[1][bb] +
                                          F[2][a] * W[2][bb]);
            Qt[bb][a] = Qt[a][bb];
          }
          qt[a] = cbv[a] + (F[0][a] * v[0] + F[1][a] * v[1] + F[2][a] * v[2]);
        }
      }
      const float Quu = Qt[3][3];
      const float qu = qt[3];
      const float inv = 1.f / Quu;
      float Kt[NS], kt;
      if (kHasBounds) {
        // closed-form 1-D box QP (mpc_tpu/ops/fused.py:929-942); the
        // clamped test compares exactly against the clipped value
        const float lo = lbv[t] - u[t];
        const float hi = ubv[t] - u[t];
        const float kv = clampf(-qu * inv, lo, hi);
        const float g = Quu * kv + qu;
        const bool clamped = (kv == lo && g > 0.f) || (kv == hi && g < 0.f);
#pragma unroll
        for (int j = 0; j < NS; ++j) Kt[j] = clamped ? 0.f : -Qt[3][j] * inv;
        kt = kv;
        qp_cnt += 1.f;
      } else {
        kt = -qu * inv;
#pragma unroll
        for (int j = 0; j < NS; ++j) Kt[j] = -Qt[3][j] * inv;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) K[t][j] = Kt[j];
      k[t] = kt;
      // cost-to-go: V = Qxx + Qxu K + K^T Qux + K^T Quu K; likewise v
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
          V[i][j] = (Qt[i][j] + QK[i][j]) + (QK[j][i] + Kt[i] * KQuu[j]);
          V[j][i] = V[i][j];
        }
      const float quk = qu + Quu * kt;
#pragma unroll
      for (int i = 0; i < NS; ++i) v[i] = (qt[i] + Qt[i][3] * kt) + Kt[i] * quk;
    }

    // ---- line search: the first step size whose cost does not exceed
    // the current one, else the last; the alpha = 1 trial always runs
    // and gives the full-step norm (mpc_tpu/ops/fused.py:998-1057) ----
    float old_cost = 0.f;
    for (int t = 0; t < T; ++t) {
      const float sc = stage_cost(Cb + t * op.sCt, cb + t * op.sct, x[t], u[t]);
      old_cost = t == 0 ? sc : old_cost + sc;
    }
    float sel_cost = 0.f, sel_alpha = 1.f, full_du = 0.f;
    for (int ki = 0; ki < sched.n; ++ki) {
      const float a = sched.a[ki];
#pragma unroll
      for (int i = 0; i < NS; ++i) nx[0][i] = x[0][i];
      float cost_a = 0.f;
      for (int t = 0; t < T; ++t) {
        const float d0 = nx[t][0] - x[t][0];
        const float d1 = nx[t][1] - x[t][1];
        const float d2 = nx[t][2] - x[t][2];
        float ut = (K[t][0] * d0 + K[t][1] * d1 + K[t][2] * d2) + (u[t] + a * k[t]);
        if (kHasBounds) ut = clampf(ut, lbv[t], ubv[t]);
        nu[t] = ut;
        const float sc = stage_cost(Cb + t * op.sCt, cb + t * op.sct, nx[t], ut);
        cost_a = t == 0 ? sc : cost_a + sc;
        if (t < T - 1) pendulum_step(p, nx[t], ut, nx[t + 1]);
      }
      n_trials += 1.f;
      if (ki == 0) {
        float du2 = 0.f;
        for (int t = 0; t < T; ++t) {
          const float d = u[t] - nu[t];
          du2 = t == 0 ? d * d : du2 + d * d;
        }
        full_du = sqrtf(du2);
      }
      sel_cost = cost_a;
      sel_alpha = a;
      if (cost_a <= old_cost) break;
    }

    // ---- best tracking and per-example stopping -----------------------
    const bool first = it == 0;
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    nni = (improved && !first) ? 0.f : nni + 1.f;
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NS; ++i) x[t][i] = nx[t][i];
      u[t] = nu[t];
    }
    if (first || improved) {
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < NS; ++i) bx[t][i] = nx[t][i];
        bu[t] = nu[t];
      }
      best_cost = sel_cost;
      best_du = full_du;
    }
    cur_du = full_du;
    n_qp += qp_cnt;
    alpha_sel = sel_alpha;
    n_it += 1.f;
    if (!(cur_du >= op.eps && nni <= op.not_improved_lim)) break;
  }

  for (int t = 0; t < T; ++t) {
    const long long o = (long long)t * B + b;
#pragma unroll
    for (int i = 0; i < NS; ++i) op.x_out[o * NS + i] = bx[t][i];
    op.u_out[o] = bu[t];
  }
  op.stats[0 * B + b] = best_cost;
  op.stats[1 * B + b] = best_du;
  op.stats[2 * B + b] = n_it;
  op.stats[3 * B + b] = n_qp;
  op.stats[4 * B + b] = alpha_sel;
  op.stats[5 * B + b] = n_trials;
}

}  // namespace mpc

extern "C" int mpc_fused_ilqr_horizon() { return mpc::T; }

// Launches K1 on ``stream``; returns the cudaError_t of the launch.
extern "C" int mpc_fused_ilqr(
    int B, const float* params, const float* C, long long sCt, long long sCb,
    const float* c, long long sct, long long scb, const float* x0,
    const float* u0, const float* lb, const float* ub, long long sbt,
    long long sbb, const float* alphas, int n_alpha, int lqr_iter, float eps,
    float best_cost_eps, float not_improved_lim, float* x_out, float* u_out,
    float* stats, void* stream) {
  if (B <= 0 || n_alpha <= 0 || n_alpha > mpc::kMaxAlpha)
    return (int)cudaErrorInvalidValue;
  mpc::Schedule sched;
  for (int i = 0; i < n_alpha; ++i) sched.a[i] = alphas[i];
  sched.n = n_alpha;
  const mpc::Operands op{B,   params, C,        sCt,           sCb,
                         c,   sct,    scb,      x0,            u0,
                         lb,  ub,     sbt,      sbb,           lqr_iter,
                         eps, best_cost_eps, not_improved_lim, x_out,
                         u_out, stats};
  const int blocks = (B + mpc::kThreads - 1) / mpc::kThreads;
  mpc::fused_ilqr_kernel<<<blocks, mpc::kThreads, 0, (cudaStream_t)stream>>>(
      op, sched);
  return (int)cudaGetLastError();
}
