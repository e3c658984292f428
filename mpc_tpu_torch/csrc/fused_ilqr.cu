// Kernel K1 for Hopper: the whole box-constrained iLQR solve of the
// pendulum (the simple one, or with MPC_DAMPED the damped, biased one), a
// team of lanes per example, the horizon in shared memory.
//
// Replaces the TPU kernel mpc_tpu/ops/fused.py:_make_kernel (lines
// 617-1119), which lays a tile of 1024 examples on the vector lanes,
// unrolls every scalar of the small matrices into (8, 128) registers and
// evaluates every line-search step size at once.
//
// What bounds it on this card.  Operations set the bound (~8 kFLOP per
// outer iteration at T = 20 against ~440 B of device memory per example
// in and out; k1_flops, k1_bytes), but the batch is small for the card
// (B = 4096 is 31 examples an SM), so what takes the time is the chain
// of dependent horizon steps one example walks.  One example per thread
// put the pendulum's Jacobian (cosf, sinf, sqrtf, two IEEE divisions) on
// the Riccati chain, kept 16*T floats a thread in local memory, tried
// the step sizes one after the other and recomputed the current cost
// every iteration.  Only two recurrences are truly serial: the
// cost-to-go V, v backwards and the rollout forwards.
//
// What the design does about it (the same as K3's, fused_ilqr_long.cu,
// with the horizon resident in shared memory instead of streamed).
//
// - A TEAM of kTeam neighbouring lanes of a warp owns one example; a
//   block is one warp of 32 / kTeam examples, so B = 4096 fills 512
//   warps, one on every scheduler of the card.
// - The Jacobians leave the chain.  Per iteration a pass parallel over t
//   (lane g takes steps g, g + kTeam, ...) computes F_t and C_t tau_t +
//   c_t into shared memory; the V recursion then reads them, and its
//   chain per step is W = V F, Q, one division, K and the V update.  It
//   runs redundantly in every lane (same arithmetic, same bits, no
//   shuffles); lane 0 stores the gains.
// - The line search runs ACROSS the lanes: lane g rolls out step size
//   alphas[g] into a trajectory slot of its own, and a ballot picks the
//   first lane whose cost does not exceed the current one, else the last
//   step size; more step sizes than lanes run in rounds of kTeam, a
//   later round only if no lane of the earlier one passed.  stats[5]
//   stays the selected index plus one.  The winner's slot becomes the
//   current trajectory (the team's variable ``cur``): nothing is copied
//   but the best trajectory into the outputs, parallel over t.
// - The current cost is carried from the accepted trial (it is the same
//   sum of the same terms); the initial cost is computed once.
// - Shared memory is [t, slot, example] of float4, slots = 6 +
//   min(n_alpha, kTeam): (K, k), the three rows of F, C tau + c, and the
//   1 + min(n_alpha, kTeam) trajectories (x, u).  The 8 examples of a
//   warp read one 128-byte line per slot.  Its size bounds the horizon:
//   ops/fused.py:T_MAX.  C, c and the bounds are read from global memory
//   through the read-only cache, one step ahead of their use; a
//   batch-shared one has batch stride 0.
//
// Teams of one warp stop at different iterations: every collective is
// the tile's and there is no __syncthreads().
//
// T (MPC_T), n_state = 3 and n_ctrl = 1 are compile-time constants.  The
// arithmetic of every scalar is the one-example-per-thread version's, in
// its order, and the plain PyTorch version
// mpc_tpu_torch/ops/fused.py:fused_solve_plain follows it.  Built without
// --use_fast_math; nvcc's FMA contraction is the only arithmetic
// difference from the plain version.
//
// THE COST BUILD (MPC_COST = 1) takes the pseudo-Huber cost (cost.cuh)
// where the TPU kernel takes a structure-of-arrays cost (cost_mode 'soa',
// mpc_tpu/ops/fused.py:721-765, 819-826): no C or c operand (no pointer
// of one is formed), the 9 parameters [w, goal, delta] in every lane's
// registers.  The pass parallel over t quadratises the cost at the
// current trajectory beside the Jacobians, off the Riccati chain: g (the
// recentred C_t tau + c_t) into the C tau + c slot and the diagonal of H
// into a trajectory slot that is not the current one (the trials write
// the non-current slots only after the sweep), so the slot count, and
// T_MAX, are the QuadCost build's; the Riccati step takes C_t = diag(H).
// The initial rollout and the trials score the true cost
// (mpc_tpu/ops/fused.py:731-735; reference mpc/lqr_step.py:230-236).
//
// CONTROLS PINNED TO ZERO (MPC_HAS_UZ = 1) and THE TRUST REGION delta_u,
// as the TPU kernel applies them (mpc_tpu/ops/fused.py:668-675, 872-928,
// 1019-1032): the mask [T, 1 or B] (1 pinned) is an operand of that build
// alone, so no other build forms a pointer into it, and rides in the rows
// loaded one step ahead beside the bounds (no shared-memory slot, so
// T_MAX stays); delta_u is a run-time argument, +inf where there is none,
// where max and min with +-inf are exact, so the other builds keep their
// bits.  Without bounds the Newton step's k and K are zero where the
// control is pinned; with bounds the mask never enters the QP, whose box
// delta_u narrows to [-delta_u, delta_u].  A trial zeroes a pinned
// control before its clamp, and under delta_u clamps to the box
// intersected with [u - delta_u, u + delta_u] around the current
// iterate's control u.  The initial rollout applies neither.
//
// Outputs: x [T, B, 3], u [T, B, 1], stats [6, B] = best cost, best
// full-step norm, n_iter, n_qp_iter, alpha and the summed index plus one
// of the selected step sizes (the trial rollouts a serial search would
// run, for the operation count).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

#include "cost.cuh"
#include "pendulum.cuh"

#ifndef MPC_T
#error "compile with -DMPC_T=<horizon>"
#endif
#ifndef MPC_HAS_BOUNDS
#error "compile with -DMPC_HAS_BOUNDS=0 or 1"
#endif
#if !defined(MPC_TEAM) || !defined(MPC_WARPS)
#error "compile with -DMPC_TEAM=<lanes an example> -DMPC_WARPS=<warps a block>"
#endif
// the damped, biased pendulum (pendulum.cuh) instead of the simple one
#ifndef MPC_DAMPED
#define MPC_DAMPED 0
#endif
// 0: a QuadCost (C, c); 1: the pseudo-Huber cost (cost.cuh)
#ifndef MPC_COST
#define MPC_COST 0
#endif
// 1: the u_zero_I mask operand
#ifndef MPC_HAS_UZ
#define MPC_HAS_UZ 0
#endif

namespace cg = cooperative_groups;

namespace mpc {

constexpr int T = MPC_T;
constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kHasBounds = MPC_HAS_BOUNDS != 0;
constexpr bool kDamped = MPC_DAMPED != 0;
constexpr bool kHuber = MPC_COST == 1;
constexpr bool kHasUz = MPC_HAS_UZ != 0;
constexpr int kMaxAlpha = 32;  // ops/fused.py:MAX_ALPHA
constexpr int kTeam = MPC_TEAM;
constexpr int kThreads = 32 * MPC_WARPS;
constexpr int kExamples = kThreads / kTeam;
constexpr float kBig = 3.0e38f;
// shared-memory slots of one step and example (float4 each)
constexpr int kSlotGain = 0;  // (K, k)
constexpr int kSlotF = 1;     // rows of F_t: 1, 2, 3
constexpr int kSlotCb = 4;    // C_t tau_t + c_t (the cost build: g)
constexpr int kSlotTraj = 5;  // (x, u): 1 + min(n_alpha, kTeam) of them

static_assert(kTeam == 2 || kTeam == 4 || kTeam == 8 || kTeam == 16,
              "a team is a power-of-two part of a warp");

struct Schedule {
  float a[kMaxAlpha];
  int n;
};

// Every operand and output has fewer than 2^31 elements (the launcher
// checks), so indices are 32-bit: a 64-bit multiply costs three
// instruction slots on this card.
struct Operands {
  int B;
  const float* params;
  const float* cost;  // the cost build's [w, goal, delta] (9)
  const float* C;     // [T, 1 or B, 4, 4], or nullptr in the cost build
  int sCt, sCb;
  const float* c;  // [T, 1 or B, 4]
  int sct, scb;
  const float* x0;  // [B, 3]
  const float* u0;  // [T, B]
  const float* lb;  // [T, 1 or B]
  const float* ub;
  int sbt, sbb;
  const float* uz;  // [T, 1 or B], 1 pinned: the MPC_HAS_UZ build only
  int sut, sub;
  float delta;      // the trust region, +inf for none
  int lqr_iter;
  float eps, best_cost_eps, not_improved_lim;
  int slots;     // 6 + min(n_alpha, kTeam)
  float* x_out;  // [T, B, 3]: the best trajectory throughout
  float* u_out;  // [T, B]
  float* stats;  // [6, B]
};

extern __shared__ float4 smem[];

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void unpack(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// 0.5 tau^T C tau + c^T tau in _quad_lin_cost's order
// (mpc_tpu/ops/fused.py:468-476).
__device__ __forceinline__ float stage_cost(const float Ct[NTAU][NTAU],
                                            const float* ct, const float* xt,
                                            float ut) {
  const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NTAU; ++i) {
    const float term = (0.5f * dot4(Ct[i], tau) + ct[i]) * tau[i];
    acc = i == 0 ? term : acc + term;
  }
  return acc;
}

// The global operands of one horizon step, as one register set of the
// prefetch.
struct Rows {
  float C[NTAU][NTAU], c[NTAU];  // the QuadCost build only
  float lb, ub;                  // with bounds only
  float uz;                      // the MPC_HAS_UZ build only
};

// What the Riccati step reads from shared memory.
struct Lin {
  float4 F[NS], cb, xu;
  float4 H;  // the cost build's diagonal of C_t
};

struct Team {
  const Operands& op;
  int b;  // the team's example
  int e;  // its place in the block
  PendulumParams p;
  Huber<NTAU> hc;  // the cost build's parameters
  const float* Cb;
  const float* cb;

  __device__ __forceinline__ float4& sm(int t, int slot) const {
    return smem[(t * op.slots + slot) * kExamples + e];
  }

  __device__ __forceinline__ void load_rows(int t, Rows& r) const {
    if (!kHuber) {
      const float* Cp = Cb + t * op.sCt;
#pragma unroll
      for (int i = 0; i < NTAU; ++i) load4(Cp + 4 * i, r.C[i]);
      load4(cb + t * op.sct, r.c);
    }
    if (kHasBounds) {
      r.lb = __ldg(op.lb + t * op.sbt + b * op.sbb);
      r.ub = __ldg(op.ub + t * op.sbt + b * op.sbb);
    }
    if constexpr (kHasUz) r.uz = __ldg(op.uz + t * op.sut + b * op.sub);
  }

  // the trajectory slot that holds the cost build's H while the current
  // trajectory is ``cur``: the first of the others
  __device__ __forceinline__ static int h_slot(int cur) {
    return cur == kSlotTraj ? kSlotTraj + 1 : kSlotTraj;
  }

  __device__ __forceinline__ void load_lin(int t, int cur, Lin& l) const {
#pragma unroll
    for (int i = 0; i < NS; ++i) l.F[i] = sm(t, kSlotF + i);
    l.cb = sm(t, kSlotCb);
    l.xu = sm(t, cur);
    if (kHuber) l.H = sm(t, h_slot(cur));
  }

  // The true stage cost at (x_t, u_t) of the build's cost.
  __device__ __forceinline__ float cost_at(const Rows& r, const float* xt,
                                           float ut) const {
    if (kHuber) {
      const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
      return hc.stage(tau);
    }
    return stage_cost(r.C, r.c, xt, ut);
  }

  // The part of the Riccati step that does not depend on V: F_t (for
  // t < T - 1) and C_t tau_t + c_t of the current trajectory; in the cost
  // build g and the diagonal of H at tau_t.
  __device__ __forceinline__ void linearize(int t, int cur,
                                            const Rows& r) const {
    float tau[NTAU];
    unpack(sm(t, cur), tau);
    float cbv[NTAU];
    if (kHuber) {
      float C[NTAU][NTAU];
      hc.quad(tau, C, cbv);
      sm(t, h_slot(cur)) = make_float4(C[0][0], C[1][1], C[2][2], C[3][3]);
    } else {
#pragma unroll
      for (int i = 0; i < NTAU; ++i) cbv[i] = dot4(r.C[i], tau) + r.c[i];
    }
    sm(t, kSlotCb) = make_float4(cbv[0], cbv[1], cbv[2], cbv[3]);
    if (t < T - 1) {
      float F[NS][NTAU];
      pendulum_jacobian<kDamped>(p, tau, tau[3], F);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sm(t, kSlotF + i) = make_float4(F[i][0], F[i][1], F[i][2], F[i][3]);
    }
  }

  // One step of the Riccati backward recursion with the 1-D box QP.  V, v
  // are those of step t + 1 on entry and of step t on return.
  __device__ __forceinline__ void riccati_step(int t, const Rows& r,
                                               const Lin& l, float V[NS][NS],
                                               float* v, float& qp_cnt,
                                               bool store) const {
    const float ut = l.xu.w;
    // C_t and C_t tau_t + c_t; in the cost build diag(H) (exact zeros
    // elsewhere) and g at tau_t, from the pass parallel over t
    float Ct[NTAU][NTAU], cbv[NTAU];
    unpack(l.cb, cbv);
    if (kHuber) {
      float h[NTAU];
      unpack(l.H, h);
#pragma unroll
      for (int i = 0; i < NTAU; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Ct[i][j] = i == j ? h[i] : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < NTAU; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Ct[i][j] = r.C[i][j];
    }
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
#pragma unroll
      for (int i = 0; i < NS; ++i) unpack(l.F[i], F[i]);
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
          Qt[a][bb] = Ct[a][bb] + (F[0][a] * W[0][bb] + F[1][a] * W[1][bb] +
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
      // closed-form 1-D box QP (mpc_tpu/ops/fused.py:929-942) on the box
      // narrowed by the trust region (:924-928); the clamped test
      // compares exactly against the clipped value
      const float lo = fmaxf(r.lb - ut, -op.delta);
      const float hi = fminf(r.ub - ut, op.delta);
      const float kv = clamp_box(-qu * inv, lo, hi);
      const float g = Quu * kv + qu;
      const bool clamped = (kv == lo && g > 0.f) || (kv == hi && g < 0.f);
#pragma unroll
      for (int j = 0; j < NS; ++j) Kt[j] = clamped ? 0.f : -Qt[3][j] * inv;
      kt = kv;
      qp_cnt += 1.f;
    } else {
      // a pinned control's k and K are zero (:872-884)
      const bool free = !kHasUz || r.uz < 0.5f;
      kt = free ? -qu * inv : 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) Kt[j] = free ? -Qt[3][j] * inv : 0.f;
    }
    if (store) sm(t, kSlotGain) = make_float4(Kt[0], Kt[1], Kt[2], kt);
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

  // One step of a trial rollout with step size alpha: the new control
  // from the stored gains, the lane's slot, the cost, the step norm, and
  // x <- x_{t+1}.
  __device__ __forceinline__ void trial_step(int t, const Rows& r,
                                             const float4 old, const float4 Kk,
                                             float alpha, int slot, float* xt,
                                             float& cost, float& du2) const {
    const float d0 = xt[0] - old.x;
    const float d1 = xt[1] - old.y;
    const float d2 = xt[2] - old.z;
    float ut = (Kk.x * d0 + Kk.y * d1 + Kk.z * d2) + (old.w + alpha * Kk.w);
    // zeroed where pinned, before the clamp (:1019-1024)
    if (kHasUz && r.uz > 0.5f) ut = 0.f;
    if (kHasBounds)
      ut = clamp_box(ut, fmaxf(old.w - op.delta, r.lb),
                     fminf(old.w + op.delta, r.ub));
    sm(t, slot) = make_float4(xt[0], xt[1], xt[2], ut);
    const float sc = cost_at(r, xt, ut);
    cost = t == 0 ? sc : cost + sc;
    const float d = old.w - ut;
    du2 = t == 0 ? d * d : du2 + d * d;
    if (t < T - 1) {
      float xn[NS];
      pendulum_step<kDamped>(p, xt, ut, xn);
#pragma unroll
      for (int i = 0; i < NS; ++i) xt[i] = xn[i];
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    fused_ilqr_kernel(const Operands op, const Schedule sched) {
  const cg::thread_block_tile<kTeam> tile =
      cg::tiled_partition<kTeam>(cg::this_thread_block());
  const int g = tile.thread_rank();
  const int e = threadIdx.x / kTeam;
  const int b = blockIdx.x * kExamples + e;
  if (b >= op.B) return;  // ragged tail: a whole team leaves together
  const int B = op.B;
  // the cost build forms no pointer into the absent C and c
  Huber<NTAU> hc{};
  if (kHuber) hc = Huber<NTAU>::load(op.cost);
  const Team tm{op,
                b,
                e,
                load_pendulum<kDamped>(op.params),
                hc,
                kHuber ? nullptr : op.C + b * op.sCb,
                kHuber ? nullptr : op.c + b * op.scb};
  // the lanes that roll out a trial, and the team's lanes within its
  // warp for the ballot of the line search
  const int n_lanes = sched.n < kTeam ? sched.n : kTeam;
  const unsigned team_shift = (threadIdx.x & 31u) & ~(unsigned)(kTeam - 1);
  const unsigned team_mask = ((1u << kTeam) - 1u) << team_shift;

  float x0[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x0[i] = op.x0[b * NS + i];

  // ---- init: u <- u0, x <- rollout(u0) into the first trajectory slot
  // and, as the best trajectory, into the outputs; its cost, computed
  // this once.  Every lane walks the chain, lane 0 stores. -------------
  int cur = kSlotTraj;
  float cost_cur = 0.f;
  // u0 comes from device memory, a round trip far longer than a rollout
  // step: the team fetches it in a pass parallel over t, not on the chain
#pragma unroll 4
  for (int t = g; t < T; t += kTeam) tm.sm(t, cur).w = op.u0[t * B + b];
  tile.sync();
  {
    float xt[NS] = {x0[0], x0[1], x0[2]};
    Rows r, rn;
    tm.load_rows(0, r);
    float ut = tm.sm(0, cur).w;
    for (int t = 0; t < T; ++t) {
      const int tn = t < T - 1 ? t + 1 : t;
      tm.load_rows(tn, rn);
      const float un = tm.sm(tn, cur).w;
      if (g == 0) {
        const int o = t * B + b;
        tm.sm(t, cur) = make_float4(xt[0], xt[1], xt[2], ut);
        op.u_out[o] = ut;
#pragma unroll
        for (int i = 0; i < NS; ++i) op.x_out[o * NS + i] = xt[i];
      }
      const float sc = tm.cost_at(r, xt, ut);
      cost_cur = t == 0 ? sc : cost_cur + sc;
      if (t < T - 1) {
        float xn[NS];
        pendulum_step<kDamped>(tm.p, xt, ut, xn);
#pragma unroll
        for (int i = 0; i < NS; ++i) xt[i] = xn[i];
      }
      r = rn;
      ut = un;
    }
  }
  tile.sync();

  float best_cost = kBig, best_du = kBig;
  float nni = 0.f, n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;

  for (int it = 0; it < op.lqr_iter; ++it) {
    // ---- the Jacobians and C tau + c of the current trajectory,
    // parallel over t across the lanes ---------------------------------
    for (int t = g; t < T; t += kTeam) {
      Rows r;
      tm.load_rows(t, r);
      tm.linearize(t, cur, r);
    }
    tile.sync();

    // ---- Riccati backward recursion, rows of step t - 1 in flight
    // while step t computes; two register sets in turns ----------------
    float qp_cnt = 0.f;
    {
      float V[NS][NS], v[NS];
      Rows ra, rb;
      Lin la, lnb;
      tm.load_rows(T - 1, ra);
      tm.load_lin(T - 1, cur, la);
      int t = T - 1;
      for (; t >= 1; t -= 2) {
        tm.load_rows(t - 1, rb);
        tm.load_lin(t - 1, cur, lnb);
        tm.riccati_step(t, ra, la, V, v, qp_cnt, g == 0);
        const int t2 = t >= 2 ? t - 2 : 0;
        tm.load_rows(t2, ra);
        tm.load_lin(t2, cur, la);
        tm.riccati_step(t - 1, rb, lnb, V, v, qp_cnt, g == 0);
      }
      if (t == 0) tm.riccati_step(0, ra, la, V, v, qp_cnt, g == 0);
    }
    tile.sync();  // the gains are lane 0's stores

    // ---- line search across the lanes: lane g rolls out step size
    // base + g into its own slot; the first lane whose cost does not
    // exceed the current one is taken, else the next round, else the
    // last step size (mpc_tpu/ops/fused.py:998-1057).  Round 0's lane 0
    // is alpha = 1 and gives the full-step norm. -----------------------
    const float old_cost = cost_cur;
    const int slot = kSlotTraj + g + (kSlotTraj + g >= cur ? 1 : 0);
    float sel_cost = 0.f, sel_alpha = 1.f, full_du = 0.f;
    int sel_slot = cur, sel_index = 0;
    for (int base = 0; base < sched.n; base += kTeam) {
      const int ki = base + g;
      const bool runs = g < n_lanes && ki < sched.n;
      float cost_a = 0.f, du2 = 0.f;
      if (runs) {
        const float a = sched.a[ki];
        float xt[NS] = {x0[0], x0[1], x0[2]};
        Rows ra, rb;
        float4 oa, ob, ka, kb;
        tm.load_rows(0, ra);
        oa = tm.sm(0, cur);
        ka = tm.sm(0, kSlotGain);
        int t = 0;
        for (; t + 1 < T; t += 2) {
          tm.load_rows(t + 1, rb);
          ob = tm.sm(t + 1, cur);
          kb = tm.sm(t + 1, kSlotGain);
          tm.trial_step(t, ra, oa, ka, a, slot, xt, cost_a, du2);
          const int t2 = t + 2 < T ? t + 2 : T - 1;
          tm.load_rows(t2, ra);
          oa = tm.sm(t2, cur);
          ka = tm.sm(t2, kSlotGain);
          tm.trial_step(t + 1, rb, ob, kb, a, slot, xt, cost_a, du2);
        }
        if (t < T) tm.trial_step(t, ra, oa, ka, a, slot, xt, cost_a, du2);
      }
      if (base == 0) full_du = sqrtf(tile.shfl(du2, 0));
      const unsigned passed =
          (__ballot_sync(team_mask, runs && cost_a <= old_cost) >> team_shift) &
          ((1u << kTeam) - 1u);
      const bool last = base + kTeam >= sched.n;
      if (passed != 0u || last) {
        const int w = passed != 0u ? __ffs(passed) - 1 : sched.n - 1 - base;
        sel_cost = tile.shfl(cost_a, w);
        sel_index = base + w;
        sel_alpha = sched.a[sel_index];
        sel_slot = kSlotTraj + w + (kSlotTraj + w >= cur ? 1 : 0);
        break;
      }
    }
    n_trials += (float)(sel_index + 1);
    tile.sync();  // the winner's slot is another lane's stores

    // ---- the winner's slot becomes the current trajectory; where it
    // improved, the team copies it into the outputs (the best one),
    // lane g taking steps g, g + kTeam, ... ----------------------------
    const bool first = it == 0;
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    const bool take_best = first || improved;
    cur = sel_slot;
    if (take_best) {
      for (int t = g; t < T; t += kTeam) {
        const float4 row = tm.sm(t, cur);
        const int o = t * B + b;
        op.x_out[o * NS + 0] = row.x;
        op.x_out[o * NS + 1] = row.y;
        op.x_out[o * NS + 2] = row.z;
        op.u_out[o] = row.w;
      }
    }

    // ---- best tracking and per-example stopping (the same in every
    // lane of the team) ------------------------------------------------
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

  if (g == 0) {
    op.stats[0 * B + b] = best_cost;
    op.stats[1 * B + b] = best_du;
    op.stats[2 * B + b] = n_it;
    op.stats[3 * B + b] = n_qp;
    op.stats[4 * B + b] = alpha_sel;
    op.stats[5 * B + b] = n_trials;
  }
}

}  // namespace mpc

// Launches K1 on ``stream`` with the geometry of ops/fused.py:k1_launch
// (``slots`` float4 a step and example, ``smem_bytes`` of dynamic shared
// memory), which is built with the same MPC_TEAM and MPC_WARPS; returns
// the cudaError_t of the launch, or of raising the kernel's shared-memory
// limit where that is needed.
extern "C" int mpc_fused_ilqr(
    int B, const float* params, const float* cost, const float* C,
    long long sCt, long long sCb,
    const float* c, long long sct, long long scb, const float* x0,
    const float* u0, const float* lb, const float* ub, long long sbt,
    long long sbb, const float* uz, long long sut, long long sub,
    float delta, const float* alphas, int n_alpha, int lqr_iter, float eps,
    float best_cost_eps, float not_improved_lim, int slots, int smem_bytes,
    float* x_out, float* u_out, float* stats, void* stream) {
  if (B <= 0 || n_alpha <= 0 || n_alpha > mpc::kMaxAlpha ||
      (mpc::kHasBounds && (lb == nullptr || ub == nullptr)) ||
      (mpc::kHasUz != (uz != nullptr)) || !(delta > 0.f) ||
      (!mpc::kHasBounds && delta != INFINITY) ||
      (mpc::kHuber ? (cost == nullptr || C != nullptr || c != nullptr)
                   : (C == nullptr || c == nullptr)))
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory has to be asked for; the
  // library remembers the most it has asked for
  static int smem_allowed = 48 * 1024;
  if (smem_bytes > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        mpc::fused_ilqr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem_bytes;
  }
  // 32-bit indices: the largest offset of each array
  const long long last = mpc::T - 1, lastb = B - 1, big = 1LL << 31;
  if (last * sCt + lastb * sCb + 16 >= big ||
      last * sct + lastb * scb + 4 >= big ||
      last * sbt + lastb * sbb + 1 >= big ||
      last * sut + lastb * sub + 1 >= big || 3LL * mpc::T * B >= big)
    return (int)cudaErrorInvalidValue;
  mpc::Schedule sched;
  for (int i = 0; i < n_alpha; ++i) sched.a[i] = alphas[i];
  sched.n = n_alpha;
  mpc::Operands op;
  op.B = B;
  op.params = params;
  op.cost = cost;
  op.C = C;
  op.sCt = (int)sCt;
  op.sCb = (int)sCb;
  op.c = c;
  op.sct = (int)sct;
  op.scb = (int)scb;
  op.x0 = x0;
  op.u0 = u0;
  op.lb = lb;
  op.ub = ub;
  op.sbt = (int)sbt;
  op.sbb = (int)sbb;
  op.uz = uz;
  op.sut = (int)sut;
  op.sub = (int)sub;
  op.delta = delta;
  op.lqr_iter = lqr_iter;
  op.eps = eps;
  op.best_cost_eps = best_cost_eps;
  op.not_improved_lim = not_improved_lim;
  op.slots = slots;
  op.x_out = x_out;
  op.u_out = u_out;
  op.stats = stats;
  const int blocks = (B + mpc::kExamples - 1) / mpc::kExamples;
  mpc::fused_ilqr_kernel<<<blocks, mpc::kThreads, smem_bytes,
                           (cudaStream_t)stream>>>(op, sched);
  return (int)cudaGetLastError();
}
