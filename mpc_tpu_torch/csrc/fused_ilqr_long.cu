// Kernel K3 for Hopper: the streaming box-constrained iLQR solve, one
// example per thread, any horizon.
//
// Replaces the TPU kernel mpc_tpu/ops/fused.py:_make_kernel_long (lines
// 1126-1932), which runs the horizon as fori_loops with x, u, K, k per t
// in VMEM scratch and streams batched operands through a 2-slot DMA
// buffer.  It is the same solve as K1 (fused_ilqr.cu) with two
// differences that make it a kernel of its own on this card:
//
// - K1 keeps 16*T floats per thread in local memory, which CUDA reserves
//   for every resident thread slot and which stops K1 at T = 256.  Here
//   the current trajectory x, u and the gains K, k live in a WORKSPACE IN
//   GLOBAL MEMORY that the wrapper allocates, laid out [t, row, b] (8
//   rows), so the 32 examples of a warp read and write one 128-byte line
//   per row.  The best trajectory lives in the outputs themselves, as in
//   the TPU kernel.  T is a run-time argument: one build serves every
//   horizon, and T is bounded by memory the caller can see (32*T bytes
//   per example).
// - the line search is K3's own (mpc_tpu/ops/fused.py:1144-1150): trial
//   rollouts that keep only their cost, over the step-size schedule, the
//   first whose cost does not exceed the current one, else the last; then
//   ONE commit rollout with the selected step size writes the new
//   trajectory (and the best one where it improved).  The current cost
//   is carried from the last accepted trial, not recomputed.  A thread
//   stops trying step sizes at its first passing one, which selects what
//   the TPU's evaluate-all-then-select does.
//
// Dynamics (MPC_DYN): 0 = LinDx (lindx.cuh; F shared or per example, f
// optional), 1 = the simple pendulum (pendulum.cuh).  Cost, dynamics and
// bound operands are read straight from global memory at [t, b] through
// the read-only cache; a batch-shared operand has batch stride 0, so a
// warp's load is one broadcast, and at T = 160 the shared C, c, F and
// bounds (24 KB) stay resident in L1.  Staging them in shared memory
// would add a second code path and a limit on T (227 KB a block) for
// loads that already hit; so there is no gate on T for shared layouts.
//
// The arithmetic follows the TPU kernel's order (vv_update sums left to
// right, the control is (K dx + u) + alpha k), and the plain PyTorch
// version mpc_tpu_torch/ops/fused.py:fused_solve_long_plain follows this
// file.  Built without --use_fast_math; nvcc's FMA contraction is the
// only arithmetic difference from the plain version.
//
// Bound on the card: operations (k3_flops against k3_bytes: ~2.5e5
// operations and ~3 KB in and out per example at T = 160).  This first
// version is latency-bound: one thread walks its solve sequentially
// through global memory, one warp a block so that B = 4096 spreads over
// 128 of the 132 SMs.
//
// Outputs: x [T, B, 3], u [T, B, 1], stats [6, B] = best cost, best
// full-step norm, n_iter, n_qp_iter, alpha and the number of trial
// rollouts (for the operation count).

#include <cuda_runtime.h>

#include "lindx.cuh"
#include "pendulum.cuh"

#ifndef MPC_DYN
#error "compile with -DMPC_DYN=0 (LinDx) or 1 (pendulum)"
#endif
#ifndef MPC_HAS_BOUNDS
#error "compile with -DMPC_HAS_BOUNDS=0 or 1"
#endif

namespace mpc {

constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kLinDx = MPC_DYN == 0;
constexpr bool kHasBounds = MPC_HAS_BOUNDS != 0;
constexpr int kMaxAlpha = 32;  // ops/fused.py:MAX_ALPHA
constexpr int kThreads = 32;
constexpr int kRows = 8;  // workspace rows per step: x (3), u, K (3), k
constexpr float kBig = 3.0e38f;

struct Schedule {
  float a[kMaxAlpha];
  int n;
};

struct Operands {
  int B, T;
  const float* params;  // pendulum (g, m, l); unused for LinDx
  LinDxOperand lin;     // unused for the pendulum
  const float* C;       // [T, 1 or B, 4, 4]
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
  float* ws;     // [T, 8, B]
  float* x_out;  // [T, B, 3]: the best trajectory throughout
  float* u_out;  // [T, B]
  float* stats;  // [6, B]
};

struct Thread {
  const Operands& op;
  int b;
  PendulumParams p;
  const float* Cb;
  const float* cb;

  __device__ __forceinline__ float& ws(int t, int row) const {
    return op.ws[((long long)t * kRows + row) * op.B + b];
  }
  __device__ __forceinline__ void load_x(int t, float* x) const {
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = ws(t, i);
  }
  __device__ __forceinline__ void load_cost(int t, float Ct[NTAU][NTAU],
                                            float* ct) const {
    const float* Cp = Cb + t * op.sCt;
    const float* cp = cb + t * op.sct;
#pragma unroll
    for (int i = 0; i < NTAU; ++i) {
#pragma unroll
      for (int j = 0; j < NTAU; ++j) Ct[i][j] = __ldg(Cp + 4 * i + j);
      ct[i] = __ldg(cp + i);
    }
  }
  __device__ __forceinline__ float lower(int t) const {
    return __ldg(op.lb + t * op.sbt + b * op.sbb);
  }
  __device__ __forceinline__ float upper(int t) const {
    return __ldg(op.ub + t * op.sbt + b * op.sbb);
  }
  // x_{t+1} from (x_t, u_t); ``out`` must not alias ``x``
  __device__ __forceinline__ void step(int t, const float* x, float u,
                                       float* out) const {
    if (kLinDx)
      lindx_step(op.lin, t, b, x, u, out);
    else
      pendulum_step(p, x, u, out);
  }
  __device__ __forceinline__ void jacobian(int t, const float* x, float u,
                                           float F[NS][NTAU]) const {
    if (kLinDx)
      lindx_load(op.lin, t, b, F);
    else
      pendulum_jacobian(p, x, u, F);
  }
  // the new control at step t from the stored gains
  // (_ctrl_from, mpc_tpu/ops/fused.py:1681-1695)
  __device__ __forceinline__ float control(int t, const float* xt,
                                           const float* x_old, float u_old,
                                           float alpha) const {
    const float d0 = xt[0] - x_old[0];
    const float d1 = xt[1] - x_old[1];
    const float d2 = xt[2] - x_old[2];
    float ut = ((ws(t, 4) * d0 + ws(t, 5) * d1) + ws(t, 6) * d2 + u_old) +
               alpha * ws(t, 7);
    if (kHasBounds) ut = clampf(ut, lower(t), upper(t));
    return ut;
  }
};

// 0.5 tau^T C tau + c^T tau in _quad_lin_cost's order
// (mpc_tpu/ops/fused.py:468-476).
__device__ __forceinline__ float stage_cost(const float Ct[NTAU][NTAU],
                                            const float* ct, const float* xt,
                                            float ut) {
  const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NTAU; ++i) {
    const float dot = ((Ct[i][0] * tau[0] + Ct[i][1] * tau[1]) +
                       Ct[i][2] * tau[2]) + Ct[i][3] * tau[3];
    const float term = (0.5f * dot + ct[i]) * tau[i];
    acc = i == 0 ? term : acc + term;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    fused_ilqr_long_kernel(const Operands op, const Schedule sched) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= op.B) return;  // ragged tail: no padding, just masking
  const int B = op.B;
  const int T = op.T;
  PendulumParams p{0.f, 0.f, 0.f};
  if (!kLinDx) p = PendulumParams{op.params[0], op.params[1], op.params[2]};
  const Thread th{op, b, p, op.C + b * op.sCb, op.c + b * op.scb};

  float Ct[NTAU][NTAU], ct[NTAU];
  float x0[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x0[i] = op.x0[(long long)b * NS + i];

  // ---- init: u <- u0, x <- rollout(u0), best <- the same, its cost -----
  float cost_cur = 0.f;
  {
    float xt[NS] = {x0[0], x0[1], x0[2]};
    for (int t = 0; t < T; ++t) {
      const long long o = (long long)t * B + b;
      const float ut = op.u0[o];
      th.ws(t, 3) = ut;
      op.u_out[o] = ut;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        th.ws(t, i) = xt[i];
        op.x_out[o * NS + i] = xt[i];
      }
      th.load_cost(t, Ct, ct);
      const float sc = stage_cost(Ct, ct, xt, ut);
      cost_cur = t == 0 ? sc : cost_cur + sc;
      if (t < T - 1) {
        float xn[NS];
        th.step(t, xt, ut, xn);
#pragma unroll
        for (int i = 0; i < NS; ++i) xt[i] = xn[i];
      }
    }
  }

  float best_cost = kBig, best_du = kBig;
  float nni = 0.f, n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;

  for (int it = 0; it < op.lqr_iter; ++it) {
    // ---- Riccati backward recursion with the 1-D box QP --------------
    float V[NS][NS], v[NS];
    float qp_cnt = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      float xt[NS];
      th.load_x(t, xt);
      const float ut = th.ws(t, 3);
      th.load_cost(t, Ct, ct);
      const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
      float cbv[NTAU];
#pragma unroll
      for (int i = 0; i < NTAU; ++i)
        cbv[i] = (((Ct[i][0] * tau[0] + Ct[i][1] * tau[1]) + Ct[i][2] * tau[2]) +
                  Ct[i][3] * tau[3]) + ct[i];
      float Qt[NTAU][NTAU], qt[NTAU];
      if (t == T - 1) {
#pragma unroll
        for (int i = 0; i < NTAU; ++i) {
#pragma unroll
          for (int j = 0; j < NTAU; ++j) Qt[i][j] = Ct[i][j];
          qt[i] = cbv[i];
        }
      } else {
        float F[NS][NTAU];
        th.jacobian(t, xt, ut, F);
        float W[NS][NTAU];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int j = 0; j < NTAU; ++j)
            W[i][j] = (V[i][0] * F[0][j] + V[i][1] * F[1][j]) + V[i][2] * F[2][j];
#pragma unroll
        for (int a = 0; a < NTAU; ++a) {
#pragma unroll
          for (int bb = a; bb < NTAU; ++bb) {
            Qt[a][bb] = Ct[a][bb] + ((F[0][a] * W[0][bb] + F[1][a] * W[1][bb]) +
                                     F[2][a] * W[2][bb]);
            Qt[bb][a] = Qt[a][bb];
          }
          qt[a] = cbv[a] + ((F[0][a] * v[0] + F[1][a] * v[1]) + F[2][a] * v[2]);
        }
      }
      const float Quu = Qt[3][3];
      const float qu = qt[3];
      const float inv = 1.f / Quu;
      float Kt[NS], kt;
      if (kHasBounds) {
        // closed-form 1-D box QP (mpc_tpu/ops/fused.py:1516-1527); the
        // clamped test compares exactly against the clipped value
        const float lo = th.lower(t) - ut;
        const float hi = th.upper(t) - ut;
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
      for (int j = 0; j < NS; ++j) th.ws(t, 4 + j) = Kt[j];
      th.ws(t, 7) = kt;
      // cost-to-go, summed left to right (vv_update,
      // mpc_tpu/ops/fused.py:1546-1573)
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

    // ---- line search: trial rollouts that keep only their cost; the
    // first step size whose cost does not exceed the current one, else
    // the last.  The alpha = 1 trial always runs and gives the
    // full-step norm. ----------------------------------------------------
    const float old_cost = cost_cur;
    float sel_cost = 0.f, sel_alpha = 1.f, full_du = 0.f;
    for (int ki = 0; ki < sched.n; ++ki) {
      const float a = sched.a[ki];
      float xt[NS] = {x0[0], x0[1], x0[2]};
      float cost_a = 0.f, du2 = 0.f;
      for (int t = 0; t < T; ++t) {
        float x_old[NS];
        th.load_x(t, x_old);
        const float u_old = th.ws(t, 3);
        const float ut = th.control(t, xt, x_old, u_old, a);
        th.load_cost(t, Ct, ct);
        const float sc = stage_cost(Ct, ct, xt, ut);
        cost_a = t == 0 ? sc : cost_a + sc;
        if (ki == 0) {
          const float d = u_old - ut;
          du2 = t == 0 ? d * d : du2 + d * d;
        }
        if (t < T - 1) {
          float xn[NS];
          th.step(t, xt, ut, xn);
#pragma unroll
          for (int i = 0; i < NS; ++i) xt[i] = xn[i];
        }
      }
      n_trials += 1.f;
      if (ki == 0) full_du = sqrtf(du2);
      sel_cost = cost_a;
      sel_alpha = a;
      if (cost_a <= old_cost) break;
    }

    // ---- commit: re-roll with the selected step size into the current
    // trajectory, and into the best one where it improved
    // (rollout_commit, mpc_tpu/ops/fused.py:1828-1857) ------------------
    const bool first = it == 0;
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    const bool take_best = first || improved;
    {
      float xt[NS] = {x0[0], x0[1], x0[2]};
      for (int t = 0; t < T; ++t) {
        float x_old[NS];
        th.load_x(t, x_old);
        const float u_old = th.ws(t, 3);
        const float ut = th.control(t, xt, x_old, u_old, sel_alpha);
        const long long o = (long long)t * B + b;
#pragma unroll
        for (int i = 0; i < NS; ++i) th.ws(t, i) = xt[i];
        th.ws(t, 3) = ut;
        if (take_best) {
#pragma unroll
          for (int i = 0; i < NS; ++i) op.x_out[o * NS + i] = xt[i];
          op.u_out[o] = ut;
        }
        if (t < T - 1) {
          float xn[NS];
          th.step(t, xt, ut, xn);
#pragma unroll
          for (int i = 0; i < NS; ++i) xt[i] = xn[i];
        }
      }
    }

    // ---- best tracking and per-example stopping -----------------------
    nni = (improved && !first) ? 0.f : nni + 1.f;
    if (take_best) {
      best_cost = sel_cost;
      best_du = full_du;
    }
    cost_cur = sel_cost;
    n_qp += qp_cnt;
    alpha_sel = sel_alpha;
    n_it += 1.f;
    if (!(full_du >= op.eps && nni <= op.not_improved_lim)) break;
  }

  op.stats[0 * B + b] = best_cost;
  op.stats[1 * B + b] = best_du;
  op.stats[2 * B + b] = n_it;
  op.stats[3 * B + b] = n_qp;
  op.stats[4 * B + b] = alpha_sel;
  op.stats[5 * B + b] = n_trials;
}

}  // namespace mpc

extern "C" int mpc_fused_ilqr_long_rows() { return mpc::kRows; }

// Launches K3 on ``stream``; returns the cudaError_t of the launch.
// ``ws`` is the [T, 8, B] workspace.
extern "C" int mpc_fused_ilqr_long(
    int B, int T, const float* params, const float* F, long long sFt,
    long long sFb, const float* f, long long sft, long long sfb,
    const float* C, long long sCt, long long sCb, const float* c,
    long long sct, long long scb, const float* x0, const float* u0,
    const float* lb, const float* ub, long long sbt, long long sbb,
    const float* alphas, int n_alpha, int lqr_iter, float eps,
    float best_cost_eps, float not_improved_lim, float* ws, float* x_out,
    float* u_out, float* stats, void* stream) {
  if (B <= 0 || T <= 0 || n_alpha <= 0 || n_alpha > mpc::kMaxAlpha ||
      ws == nullptr || (mpc::kLinDx ? F == nullptr : params == nullptr) ||
      (mpc::kHasBounds && (lb == nullptr || ub == nullptr)))
    return (int)cudaErrorInvalidValue;
  mpc::Schedule sched;
  for (int i = 0; i < n_alpha; ++i) sched.a[i] = alphas[i];
  sched.n = n_alpha;
  mpc::Operands op;
  op.B = B;
  op.T = T;
  op.params = params;
  op.lin = mpc::LinDxOperand{F, sFt, sFb, f, sft, sfb};
  op.C = C;
  op.sCt = sCt;
  op.sCb = sCb;
  op.c = c;
  op.sct = sct;
  op.scb = scb;
  op.x0 = x0;
  op.u0 = u0;
  op.lb = lb;
  op.ub = ub;
  op.sbt = sbt;
  op.sbb = sbb;
  op.lqr_iter = lqr_iter;
  op.eps = eps;
  op.best_cost_eps = best_cost_eps;
  op.not_improved_lim = not_improved_lim;
  op.ws = ws;
  op.x_out = x_out;
  op.u_out = u_out;
  op.stats = stats;
  const int blocks = (B + mpc::kThreads - 1) / mpc::kThreads;
  mpc::fused_ilqr_long_kernel<<<blocks, mpc::kThreads, 0,
                                (cudaStream_t)stream>>>(op, sched);
  return (int)cudaGetLastError();
}
