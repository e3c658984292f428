// K3's dense configuration for Hopper: the box-constrained iLQR solve of a
// LinDx problem of any n_state and n_ctrl with n_state + n_ctrl <= 32, a
// warp an example.
//
// Replaces the TPU kernels' general-size configurations:
// mpc_tpu/ops/fused.py:_make_kernel_long (lines 1126-1932) at these
// sizes, and _make_kernel (617-1119), where the JAX package's config 1
// (TVLQR, 3 states and 4 controls) runs.  Both unroll every scalar of the
// small matrices over lane vectors; the control solve of a step is the
// closed-form 1-D box QP for one control, the projected-Newton box QP
// (_pnqp_kernel) on the masked unrolled Cholesky for several bounded
// controls, or the Cholesky with a 1e-11 jitter for several unbounded
// ones (ctrl_solve, :1464-1544; here box_qp.cuh).
//
// What bounds it on this card.  An iteration's work per example is the
// Riccati sweep's products, W = V F and Q = C + F^T W, ~3 n_state^2
// (n_state + n_ctrl) operations a step (~51,000 at 24 states and 4
// controls), the box QP's trips and the trial rollouts; at the JAX
// package's medium-state row (24 states, 4 controls, T=20, B=2048, 10
// iterations) that is ~2.6e10 operations against ~5.6 MB in and out, so
// the bound is the card's float32 rate, not its memory
// (fused_dense.k3d_flops, k3d_bytes).  The sweep is a chain over t per
// example, so the card needs many examples in flight, and what a step
// costs is the latency of its phases on that chain: the phase account
// (MPC_PHASE_CLOCKS, phase_clock.cuh; PERF.md section 6) put the
// products at 40% of a warp's cycles at 24 states, staging the step's
// operands at 12%, and past 8 controls the control block's factor at
// 43% (a column at a time, one lane a solve).
//
// What the design does about it.
//
// - ONE WARP AN EXAMPLE, B = 2048 is 2048 warps, ~16 an SM: up to 4
//   controls a build keeps to 128 registers a lane (__launch_bounds__
//   with 4 blocks an SM), so that they are resident at once.  The lanes
//   meet through the warp's tiles in shared memory (__syncwarp between
//   the phases of a step), shuffles, and the xor-butterfly that sums a
//   stage cost over the lanes.
// - THE RICCATI STEP (riccati_dense.cuh, shared with the dense
//   backward): W = V F and Q's upper triangle as register tiles, each
//   lane an outer product over k of its block, every load a broadcast
//   from one row of a tile; C_t staged into Q's tile of odd stride and
//   updated in place, mirrored below.  Where a second set of tiles keeps
//   the blocks an SM (fused_dense.dense_prefetch, MPC_PREFETCH) the next
//   step's C, c and F are in flight by cp.async while this step's control
//   solve and cost-to-go run, and the rows of F, W and V are float4
//   loads.  A batch-shared operand is read by every warp from the same
//   addresses (L1 and L2 hits), a batched one with its batch stride.
// - The CONTROL SOLVE of a step runs in every lane on registers up to
//   kRegCtrlMax = 8 controls (box_qp.cuh: the n_ctrl x n_ctrl block is
//   small); past that across the lanes (box_qp_smem.cuh: Quu read in
//   place from Q's tile, lane i row i of the factor, right-looking with
//   shuffles, of the triangular solves for all the gains' columns at
//   once, and of the box QP's ten trial objectives).  Either way the
//   projected-Newton trip's Armijo search judges step size 0.1^g on lane
//   g with a ballot.  A warp stops its QP's trips, its line search and
//   its iterations on its own, so stopped examples cost nothing: the TPU
//   kernel runs every trip for every lane of its tile.
// - The line search runs its step sizes one after the other: a rollout
//   takes the whole warp (a lane a state), so the trial writes its
//   trajectory to the second slot of the example's workspace and, if it
//   passes (or is the last), the two slots swap roles: there is no
//   commit rollout.  The gains and the two trajectory slots live in the
//   workspace in global memory ([B][...] of float32, the example's
//   region contiguous), written and read by the same warp.
//
// The arithmetic of every scalar is the TPU kernel's, in its order (dot
// products from the first term on, vv_update's sums left to right, the
// control (K dx + u) + alpha k, sums over t left to right), with the sums
// over lanes in the butterfly's order; the plain PyTorch version
// mpc_tpu_torch/ops/fused_dense.py:fused_solve_dense_plain follows it.
// Built without --use_fast_math; nvcc's FMA contraction is the only
// arithmetic difference from the plain version.  float32, on the CUDA
// cores: no tensor cores, so no TF32.
//
// THE MODEL-STEP BUILD (MPC_MODEL 1, 2, 3: the simple pendulum, the damped
// one, the cartpole; MPC_SLEW its slew passthrough, soa_model.cuh) runs a
// nonlinear model where the TPU kernels take its structure-of-arrays step
// (dyn_mode 'soa', mpc_tpu/ops/fused.py:676-700) and linearise it in the
// kernel (jax.linearize, :788-815 in K1, :1307-1340 in K3).  There is no
// F or f operand: no pointer of one is formed.  The model's parameters (3
// to 5 floats) sit in every lane's registers.
//
// - THE ROLLOUT STEP ON EVERY LANE'S REGISTERS: every lane holds the
//   whole of tau = (x_t, u_t), forms the control (K_t dx + u)
//   + alpha k_t and its clamp from the step's operands, runs the model's
//   whole step and keeps the whole next state.  Every lane does the same
//   arithmetic on the same values, so every lane has the same bits, and
//   no lane waits on another: the step needs no __syncwarp and no
//   round trip through shared memory.  The step's operands (the current
//   trajectory's row, K_t and k_t, the bounds, the mask) do not depend on
//   the chain, so the next step's are loaded while this step's model
//   runs.  The stage cost keeps lane i's row term and the butterfly,
//   which are off the state's chain: the butterfly runs at the top of
//   the next step, beside its control; the full step's squares are
//   summed in registers in the butterfly's order (lane_tree), so neither
//   sum changes a bit.  Only the trial row's store leaves the warp.  The
//   initial rollout takes the same path.
// - THE EXAMPLE'S WORKSPACE IN THE WARP'S SHARED MEMORY where it fits
//   (MPC_WS_SHARED; the host decides, fused_dense.dense_ws_shared: where
//   the block stays within 227 KB and the launch's waves do not grow):
//   the two trajectory slots, the gains and the Jacobians above the
//   warp's tiles, so the rollouts, the sweep and the Jacobian pass read
//   them at shared memory's latency, and the sweep reads F_t in place
//   (no staging copy).  Elsewhere (the cartpole at T=200 with more than
//   132 blocks) they stay in global memory.  Outputs stay in global
//   memory.
// - Before each Riccati sweep a pass parallel over t (lane t takes steps
//   t, t + 32, ...) computes the step Jacobians F_t = d x_{t+1} / d tau_t
//   at the current trajectory into the workspace, [T-1][n_state][n_tau],
//   and the sweep reads them there as it reads a batched LinDx's F: the
//   Jacobian stays off the Riccati chain (the MLP's lesson in K3).
// - 64 registers a lane up to n_tau = 5 (__launch_bounds__ with
//   kStepMinBlocks = 8 blocks an SM), so that the headline under slew,
//   B = 4096, 1,024 blocks, runs in one wave on 132 SMs.
//
// What bounds it: operations (k3d_flops with the model's counts, ~2.4e5
// an example at config 3), but config 3's 512 examples and the cartpole
// at T=200 are one block an SM, so the time is one warp's chain: a
// rollout step (~940 cycles at config 3) is mostly the model's own step,
// whose IEEE divisions, sqrtf, cosf and sinf each end in a branch that
// closes the scheduler's block, so their chains do not overlap; a sweep
// step is the Riccati tiles at n_tau = 6 (W, Q and the cost-to-go, half
// of config 3's cycles) and staging C_t.  The slew headline, eight
// blocks an SM, is bound by the schedulers its warps share (PERF.md
// section 6).
//
// THE MLP BUILD (MPC_MODEL 4, MPC_NN_DEPTH hidden layers, MPC_ACT; with
// MPC_SLEW its slew passthrough, any n_ctrl) runs an NNDynamics of any
// admitted size and depth where the TPU kernels take its stream form
// (one hidden layer, mpc_tpu/ops/fused.py:1252-1306) or its tuple path
// (deeper, :1307-1340): nn_dense.cuh.  The block copies the weights into
// shared memory above the warps' tiles once a launch; each warp has a
// scratch beside its tiles.  In the rollouts the step is the whole
// warp's, a unit a lane (ceil(width / 32) slots a lane, none empty in
// every lane), the activations in the scratch, each output's dot product
// split over the lanes and summed by a butterfly of shuffles (its plain
// version fused_dense.mlp_step_lanes; ROADMAP section 3).  Before each
// sweep the Jacobian pass takes a chunk of consecutive steps (the host
// sizes it from the shared memory left, fused_dense.mlp_chunk: 4 steps
// at mlp-slew and mlp-multictrl, 2 at mlp-deep, 1 where the weights fill
// the block), in a function of its own (its tiles' registers): each
// hidden layer's forward pass and each reverse product
// is a register tile over the chunk's steps, the scratch holding the
// chunk's inputs, activations, derivatives and reverse rows.  The sweep
// reads the Jacobians from the workspace as for the other models.  What
// bounds it: operations, the MLP's step in every trial rollout and its
// Jacobian T - 1 times an iteration (k3d_flops with mlp_op_counts); on
// the card, the shared-memory wavefronts the MLP's multiply-adds read
// (one a clock an SM): the tiles read a broadcast row of a chunk's steps
// for C multiply-adds, and the rollout's layers are a chain of dependent
// dot products on the rollout's chain.  Where a launch lasts as long as
// its slowest warps (mlp-deep stops on eps: 3 iterations on average, 20
// at most), each chunk's fixed cost (its inputs' load, the activations,
// the loops' start) sets the time, so the chunk is as large as the
// shared memory left allows (PERF.md section 6).
//
// THE COST BUILD (MPC_COST = 1), for the LinDx and the model-step builds,
// takes the pseudo-Huber cost (cost.cuh) where the TPU kernels take a
// structure-of-arrays cost (mpc_tpu/ops/fused.py:721-765, 1406-1461): no C
// or c operand (no pointer of one is formed).  Lane i < n_tau owns
// component i of tau and keeps w_i, goal_i and delta in registers: in the
// sweep it writes H_ii into Q's diagonal (the rest of the tile zeros) and
// takes g_i as its C tau + c, from the tau_i it stages; a stage cost is
// lane i's term summed by the butterfly.  No workspace and no extra pass.
//
// CONTROLS PINNED TO ZERO (MPC_HAS_UZ = 1) and THE TRUST REGION delta_u,
// for the LinDx, model-step and cost builds alike, as the TPU kernels
// apply them (ctrl_solve and _ctrl_from, mpc_tpu/ops/fused.py:1475-1515,
// 1681-1692): the mask [T, 1 or B, n_ctrl] (1 pinned) is an operand of
// that build alone, read at the clamped control index; delta_u is a
// run-time argument, +inf where there is none (max and min with +-inf
// are exact, so the other builds keep their bits).  Without bounds a
// pinned control's row of k and K is zero: at one control by a select,
// at several from masked_free_chol (box_qp.cuh: unit diagonal on the
// pinned entries, no jitter) with qu and the lane's column of Qux masked;
// with bounds the mask never enters the QP, whose box delta_u narrows to
// [-delta_u, delta_u] (the PNQP's start is clipped into it).  A trial
// zeroes a pinned control before its clamp, and under delta_u clamps to
// the box intersected with [u - delta_u, u + delta_u] around the current
// iterate's control u.  The initial rollout applies neither.
//
// Outputs: x [T, B, n_state], u [T, B, n_ctrl], stats [6, B] = best cost,
// best full-step norm, n_iter, n_qp_iter, alpha and the summed index plus
// one of the selected step sizes.

#include <cuda_runtime.h>

#include <cmath>

#include "box_qp.cuh"
#include "box_qp_smem.cuh"
#include "cost.cuh"
#include "nn_dense.cuh"
#include "phase_clock.cuh"
#include "riccati_dense.cuh"
#include "soa_model.cuh"

#if !defined(MPC_NS) || !defined(MPC_NC) || !defined(MPC_HAS_BOUNDS) || \
    !defined(MPC_HAS_F) || !defined(MPC_WARPS)
#error "compile with -DMPC_NS, -DMPC_NC, -DMPC_HAS_BOUNDS, -DMPC_HAS_F, -DMPC_WARPS"
#endif
// the model-step build: MPC_MODEL 1 (pendulum), 2 (damped pendulum), 3
// (cartpole), 4 (an MLP of MPC_NN_DEPTH hidden layers, activation
// MPC_ACT: 0 sigmoid, 1 relu, 2 elu), MPC_SLEW 0 or 1; a LinDx build
// leaves them out
#ifndef MPC_MODEL
#define MPC_MODEL 0
#endif
#ifndef MPC_SLEW
#define MPC_SLEW 0
#endif
#ifndef MPC_NN_DEPTH
#define MPC_NN_DEPTH 1
#endif
#ifndef MPC_ACT
#define MPC_ACT 0
#endif
// 0: a QuadCost (C, c); 1: the pseudo-Huber cost (cost.cuh)
#ifndef MPC_COST
#define MPC_COST 0
#endif
// 1: the u_zero_I mask operand
#ifndef MPC_HAS_UZ
#define MPC_HAS_UZ 0
#endif
// 1: the model-step build's workspace in the warp's shared memory
// (fused_dense.dense_ws_shared); 0: in global memory
#ifndef MPC_WS_SHARED
#define MPC_WS_SHARED 0
#endif

namespace mpc {

constexpr int kNS = MPC_NS;
constexpr int kNC = MPC_NC;
constexpr int kNT = kNS + kNC;
constexpr bool kHasBounds = MPC_HAS_BOUNDS != 0;
constexpr bool kHasF = MPC_HAS_F != 0;
constexpr bool kHuber = MPC_COST == 1;
constexpr bool kHasUz = MPC_HAS_UZ != 0;
constexpr int kWarps = MPC_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxAlpha = 32;
constexpr float kBig = 3.0e38f;
static_assert(kNS >= 1 && kNC >= 1 && kNT <= 32,
              "a warp an example: n_state + n_ctrl <= 32");

constexpr bool kModel = MPC_MODEL != 0;
constexpr bool kMLP = MPC_MODEL == 4;
constexpr bool kSlew = kModel && MPC_SLEW != 0;
constexpr int kDepth = MPC_NN_DEPTH;
// the MLP's own states (the augmented state less u_{t-1} under slew)
constexpr int kNSI = kSlew ? kNS - kNC : kNS;
static_assert(!kMLP || (kDepth >= 1 && kDepth <= kNNMaxDepth && kNSI >= 1),
              "the MLP build: 1 to kNNMaxDepth hidden layers");
// a LinDx build's stand-in, and the MLP build's (its step is the warp's,
// mlp_model_step), never called
struct NoModel {
  static constexpr int NS = kNS;
  static constexpr int NC = kNC;
  static constexpr int NP = 1;
  __device__ static void step(const float*, const float*, float*) {}
  __device__ static void jacobian(const float*, const float*,
                                  float (*)[kNT]) {}
};
template <int Id>
struct ModelOf {
  using type = NoModel;
};
template <>
struct ModelOf<1> {
  using type = PendulumModel<false>;
};
template <>
struct ModelOf<2> {
  using type = PendulumModel<true>;
};
template <>
struct ModelOf<3> {
  using type = CartpoleModel;
};
template <class M, bool S>
struct SlewOf {
  using type = M;
};
template <class M>
struct SlewOf<M, true> {
  using type = Slew<M>;
};
using Model = typename SlewOf<typename ModelOf<MPC_MODEL>::type,
                              kSlew && !kMLP>::type;
static_assert(!kModel ||
                  (Model::NS == kNS && Model::NC == kNC && !kHasF),
              "the model-step build: the model's states and controls, no f");
constexpr int kNP = Model::NP;
// the Jacobians of the current trajectory in the workspace, a step's
constexpr int kJac = kModel ? kNS * kNT : 0;
// the model-step build: a model's step in every lane (not the MLP's)
constexpr bool kStep = kModel && !kMLP;
constexpr bool kWsShared = MPC_WS_SHARED != 0;

// 1: the prefetching layout (a second set of C, c and F tiles, the rows
// of F, W and V 16-byte aligned); 0: one set, the lane-a-row design's
// strides.  The host sets it (fused_dense.dense_kernel_defines): 1
// wherever the second set fits a block's 227 KB, which is every build but
// an MLP's whose weights fill the block
#ifndef MPC_PREFETCH
#define MPC_PREFETCH 0
#endif
constexpr bool kPrefetch = MPC_PREFETCH != 0;
constexpr int kBufs = kPrefetch ? 2 : 1;
static_assert(!kWsShared || (kStep && !kPrefetch),
              "the shared workspace: the model-step build, one set of tiles");
// a warp's tiles (floats), riccati_dense.cuh's strides: the aligned tiles
// first, so that their rows start 16-byte aligned
using Strides = RiccatiStrides<kNS, kNT, kPrefetch>;
constexpr int kSQ = Strides::kSQ;
constexpr int kSW = Strides::kSW;
constexpr int kSF = Strides::kSF;
constexpr int kSV = Strides::kSV;
constexpr int kQT = kNT * kSQ;              // a Q tile
constexpr int kFT = kNS * kSF;              // an F tile
constexpr int oF = 0;                       // F_t             [kBufs][kNS][kSF]
constexpr int oW = oF + kBufs * kFT;        // W = V F         [kNS][kSW]
constexpr int oV = oW + kNS * kSW;          // V               [kNS][kSV]
constexpr int oQ = oV + kNS * kSV;          // C_t, then Q_t   [kBufs][kNT][kSQ]
constexpr int oTau = oQ + kBufs * kQT;      // tau_t           [kNT]
constexpr int oQv = oTau + kNT;             // q               [kNT]
constexpr int oCv = oQv + kNT;              // c_t             [kBufs][kNT]
constexpr int oVv = oCv + kBufs * kNT;      // v               [kNS]
constexpr int oDx = oVv + kNS;              // x_new - x       [kNS]
constexpr int oK = oDx + kNS;               // K_t             [kNC][kNS]
constexpr int oKQ = oK + kNC * kNS;         // Quu K_t         [kNC][kNS]
constexpr int oKk = oKQ + kNC * kNS;        // k_t             [kNC]
// past kRegCtrlMax controls the control solve's tiles (box_qp_smem.cuh):
// the factor L [kNC][odd] and its diagonal's reciprocals, the QP's x
// (kept from step to step: the next step's start, prev_k), dx, lo and hi
// [kNC]
constexpr bool kSmemCtrl = kNC > kRegCtrlMax;
constexpr int kSL = odd_stride(kNC);
constexpr int oL = oKk + kNC;               // L               [kNC][kSL]
constexpr int oLi = oL + kNC * kSL;         // 1 / L_kk        [kNC]
constexpr int oQx = oLi + kNC;              // x, prev_k       [kNC]
constexpr int oQd = oQx + kNC;              // dx              [kNC]
constexpr int oQlo = oQd + kNC;             // lo              [kNC]
constexpr int oQhi = oQlo + kNC;            // hi              [kNC]
constexpr int kCtrlFloats = kSmemCtrl ? kNC * kSL + 5 * kNC : 0;
// the phase account's counters (phase_clock.cuh; none but in its build)
constexpr int oClk = (oKk + kNC + kCtrlFloats + 3) / 4 * 4;
constexpr int kWarpFloats = oClk + kClockFloats;
// the gains of a step in the workspace: K (kNC x kNS), then k
constexpr int kGain = kNC * (kNS + 1);

struct Schedule {
  float a[kMaxAlpha];          // the line search's step sizes
  float qp_steps[kPnqpSteps];  // the box QP's 0.1^k
  int n;
};

struct Operands {
  int B, T;
  const float* params;  // the model-step build's (an MLP's flat weights)
  MLPLayout nn;         // the MLP build's widths and shared memory
  int warp_floats;      // a warp's tiles, and in the MLP build its scratch
  const float* cost;    // the cost build's [w, goal, delta] (2 n_tau + 1)
  const float* F;
  int sFt, sFb;
  const float* f;
  int sft, sfb;
  const float* C;
  int sCt, sCb;
  const float* c;
  int sct, scb;
  const float* x0;
  const float* u0;
  const float* lb;
  const float* ub;
  int sbt, sbb;
  const float* uz;  // [T, 1 or B, n_ctrl], 1 pinned: MPC_HAS_UZ only
  int sut, sub;
  float delta;      // the trust region, +inf for none
  int lqr_iter, pnqp_iter;
  float eps, best_cost_eps, not_improved_lim;
  float* ws;
  int ws_example;
  float* x_out;
  float* u_out;
  float* stats;
  long long* clocks;  // [B][kPhases]: MPC_PHASE_CLOCKS only
};

// the sum over the warp's lanes, every lane ending with the same bits
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every address below is computed from a lane index clamped into its
// array (lt, lx, lu in the kernel), also where a guard keeps the lane
// away: the compiler may hoist a load above its guard, and one through a
// pointer of an absent operand was seen to fault.  f is a compile-time
// flag (MPC_HAS_F) for the same reason.

// 0.5 tau^T C_t tau + c_t^T tau: lane i's term from its row of C_t, the
// terms summed over the lanes; lt is the lane clamped below kNT
__device__ __forceinline__ float stage_cost(const float* Ct, const float* ct,
                                            const float* tau, int lane,
                                            int lt) {
  float term = 0.f;
  if (lane < kNT) {
    const float* row = Ct + lt * kNT;
    float s = __ldg(row) * tau[0];
#pragma unroll
    for (int j = 1; j < kNT; ++j) s = s + __ldg(row + j) * tau[j];
    term = (0.5f * s + __ldg(ct + lt)) * tau[lt];
  }
  return lane_sum(term);
}

// The cost build's parameters of a lane's component (lane lt < kNT).
struct LaneCost {
  float w, goal, delta;
};

// The stage cost at step t of the build's cost: the pseudo-Huber term of
// the lane's component, or the QuadCost's row, summed over the lanes.
// The cost build forms no pointer into the absent C and c.
__device__ __forceinline__ float stage_at(const float* Cb, const float* cb,
                                          int sCt, int sct, int t,
                                          const LaneCost& hl, const float* tau,
                                          int lane, int lt) {
  if constexpr (kHuber) {
    const float term =
        lane < kNT ? huber_term(hl.w, hl.goal, hl.delta, tau[lt]) : 0.f;
    return lane_sum(term);
  } else {
    return stage_cost(Cb + t * sCt, cb + t * sct, tau, lane, lt);
  }
}

// lane_sum's sum of values v[i] held on lanes Off + i (0.0 on the other
// lanes), computed in every lane's registers in the butterfly's order
// (level o adds lane k + o to lane k): the same bits, no shuffle
template <int Off, int N>
__device__ __forceinline__ float lane_tree(const float (&v)[N]) {
  static_assert(Off >= 0 && Off + N <= 32, "values on the warp's lanes");
  float a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) a[Off + i] = v[i];
  // o = 16, 8, 4, 2, 1; loops of fixed counts, so that both unroll and
  // a stays in registers
#pragma unroll
  for (int level = 0; level < 5; ++level)
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < (16 >> level)) a[k] = a[k] + a[k + (16 >> level)];
  return a[0];
}

// v[i] of a register array at a run-time index (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? v[k] : r;
  return r;
}

// Lane lt's term of the stage cost at step t of tau in every lane's
// registers (stage_at's: the pseudo-Huber term of its component, or the
// QuadCost's row), 0 on the lanes past n_tau; lane_sum sums the terms.
// No branch: every lane reads row lt, which is in range.
__device__ __forceinline__ float stage_term(const float* Cb, const float* cb,
                                           int sCt, int sct, int t,
                                           const LaneCost& hl,
                                           const float (&tau)[kNT], int lane,
                                           int lt) {
  float term;
  if constexpr (kHuber) {
    term = huber_term(hl.w, hl.goal, hl.delta, pick(tau, lt));
  } else {
    const float* row = Cb + t * sCt + lt * kNT;
    float s = __ldg(row) * tau[0];
#pragma unroll
    for (int j = 1; j < kNT; ++j) s = s + __ldg(row + j) * tau[j];
    term = (0.5f * s + __ldg(cb + t * sct + lt)) * pick(tau, lt);
  }
  return lane < kNT ? term : 0.f;
}

// A trial step's operands, which do not depend on the rollout's chain:
// the current trajectory's x_t and u_t, K_t and k_t, and the control's
// box (the bounds narrowed by the trust region around u_t) and mask.
struct TrialOps {
  float xo[kNS], uo[kNC], K[kNC][kNS], k[kNC], lo[kNC], hi[kNC];
  bool pin[kNC];
};

__device__ __forceinline__ void load_trial(const Operands& op,
                                           const float* trajc,
                                           const float* gains,
                                           const float* lbb, const float* ubb,
                                           const float* uzb, int t,
                                           TrialOps& s) {
  const float* tr = trajc + t * kNT;
  const float* g = gains + t * kGain;
#pragma unroll
  for (int j = 0; j < kNS; ++j) s.xo[j] = tr[j];
#pragma unroll
  for (int m = 0; m < kNC; ++m) {
    s.uo[m] = tr[kNS + m];
#pragma unroll
    for (int j = 0; j < kNS; ++j) s.K[m][j] = g[m * kNS + j];
    s.k[m] = g[kNC * kNS + m];
    s.pin[m] = false;
    if constexpr (kHasUz) s.pin[m] = __ldg(uzb + t * op.sut + m) > 0.5f;
    if constexpr (kHasBounds) {
      s.lo[m] = fmaxf(s.uo[m] - op.delta, __ldg(lbb + t * op.sbt + m));
      s.hi[m] = fminf(s.uo[m] + op.delta, __ldg(ubb + t * op.sbt + m));
    }
  }
}

// The MLP build's pointers into shared memory: the block's weights and
// this warp's scratch (nn_dense.cuh): the rollout step's two activation
// buffers, or the Jacobian pass's chunk.
struct MLPShared {
  const float* w;
  float *hA, *hB;
  int wo, so;  // w and the scratch as offsets into the shared memory
};

// state row lx of the MLP's step from tau in shared memory, every lane of
// the warp calling it: the MLP on (x_t, u_t) (under slew past the
// u_{t-1} entries), and under slew rows below n_ctrl passing u_t through
__device__ __forceinline__ float mlp_model_step(const MLPShared& m,
                                               const MLPLayout& L,
                                               const float* tau, int lane,
                                               int lx) {
  const float o = mlp_step<kDepth, MPC_ACT, kNSI>(
      m.w, L, kSlew ? tau + kNC : tau, m.hA, m.hB, lane);
  if constexpr (kSlew) {
    const float r = __shfl_sync(0xffffffffu, o, lx >= kNC ? lx - kNC : 0);
    return lx < kNC ? tau[kNS + lx] : r;
  }
  return o;
}

// F_t = d x_{t+1} / d tau_t of the MLP at the T - 1 steps of the
// trajectory traj [T][kNT] into J [T-1][kNS][kNT] (the workspace), every
// lane of the warp calling it; under slew the first n_ctrl rows pick u_t
// and the MLP's rows start past the u_{t-1} columns
// (fused.SlewSoA.soa_jacobian)
__device__ __forceinline__ void mlp_model_jacobians(const MLPShared& m,
                                                    const MLPLayout& L,
                                                    const float* traj, int T,
                                                    int lane, float* J,
                                                    PhaseClock& clk) {
  if constexpr (kSlew) {
    for (int e = lane; e < (T - 1) * kNC * kNT; e += 32) {
      const int t = e / (kNC * kNT), f = e - t * (kNC * kNT), r = f / kNT;
      J[t * kJac + f] = f - r * kNT == kNS + r ? 1.f : 0.f;
    }
    for (int e = lane; e < (T - 1) * kNSI * kNC; e += 32) {
      const int t = e / (kNSI * kNC), f = e - t * (kNSI * kNC), r = f / kNC;
      J[t * kJac + (kNC + r) * kNT + f - r * kNC] = 0.f;
    }
  }
  constexpr int off = kSlew ? kNC : 0;
  mlp_jacobians<kDepth, MPC_ACT, kNSI>(
      m.wo, L, m.so, traj + off, kNT, T - 1, lane,
      J + off * kNT + off, kNT, kJac, clk);
}

// state row lx (a lane clamped below kNS) of F_t tau + f_t
__device__ __forceinline__ float dyn_step(const float* Ft, const float* ft,
                                          const float* tau, int lx) {
  const float* row = Ft + lx * kNT;
  float s = __ldg(row) * tau[0];
#pragma unroll
  for (int j = 1; j < kNT; ++j) s = s + __ldg(row + j) * tau[j];
  if constexpr (kHasF) s = s + __ldg(ft + lx);
  return s;
}

// Step t's operands into its set of tiles (t % kBufs): C_t and c_t (a
// QuadCost; the cost build has none) and, for t < T - 1, F_t (a LinDx's,
// or the model's Jacobian from the workspace this warp wrote, not by the
// read-only path); in flight with Async (cp.async), else read now.
template <bool Async>
__device__ __forceinline__ void stage_step(const Operands& op,
                                           const float* Cb, const float* cb,
                                           const float* Fb, const float* jac,
                                           float* sh, int t, int T, int lane,
                                           int lt) {
  const int buf = kPrefetch ? (t & 1) : 0;
  if constexpr (!kHuber) {
    stage_tile<kNT, kNT, kSQ, Async, true>(sh + oQ + buf * kQT,
                                           Cb + t * op.sCt, lane);
    if (lane < kNT)
      stage_entry<Async, true>(sh + oCv + buf * kNT + lt, cb + t * op.sct + lt);
  }
  // (the shared workspace's F_t is read in place)
  if (t < T - 1 && !kWsShared) {
    if constexpr (kModel)
      stage_tile<kNS, kNT, kSF, Async, false>(sh + oF + buf * kFT,
                                              jac + t * kJac, lane);
    else
      stage_tile<kNS, kNT, kSF, Async, true>(sh + oF + buf * kFT,
                                             Fb + t * op.sFt, lane);
  }
}

// Up to 16 controls a warp's work is held to 128 registers a lane, so
// that four blocks of 128 threads share an SM (B = 2048, 512 blocks, then
// runs in one wave on 132 SMs; at three blocks an SM a second wave of 116
// blocks costs more than the few spilled registers); the corners past it
// take what their solve needs.
// The model-step build up to n_tau = 5 (the slew-augmented pendulums) is
// held to 64 registers a lane: eight blocks of 128 threads an SM, so that
// the headline under slew, B = 4096 (1,024 blocks), runs in one wave (at
// 80 registers, 6 blocks an SM, it took two); above (the cartpole) 64
// registers spill its step and Jacobian, and its rows run one block an
// SM either way, so it keeps 4 (fused_dense.step_min_blocks).
constexpr int kStepMinBlocks = kNT <= 5 ? 8 : 4;
constexpr int kMinBlocks = kStep ? kStepMinBlocks : (kNC <= 16 ? 4 : 1);

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_ilqr_dense_kernel(const Operands op, const Schedule sched) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  // the lane clamped into a tau row, a state row and a control
  const int lt = lane < kNT ? lane : kNT - 1;
  const int lx = lane < kNS ? lane : kNS - 1;
  const int lu = lane < kNS ? 0 : lt - kNS;
  // the lane clamped into a control (the control solve's rows)
  const int lc = lane < kNC ? lane : kNC - 1;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // a warp's tiles, and its scratch in the MLP build (then the weights)
  // or its example's workspace in the shared layout
  const int wf = (kMLP || kWsShared) ? op.warp_floats : kWarpFloats;
  MLPShared mlp{};
  if constexpr (kMLP) {
    float* const w = smem + kWarps * wf;
    stage_mlp<kThreads, kDepth>(op.params, op.nn, w);
    __syncthreads();
    float* const scr = smem + (threadIdx.x >> 5) * wf + kWarpFloats;
    const int so = (threadIdx.x >> 5) * wf + kWarpFloats;
    mlp = MLPShared{w, scr, scr + op.nn.wmax, kWarps * wf, so};
  }
  if (b >= op.B) return;  // the whole warp: nothing below syncs the block
  const int T = op.T, B = op.B;
  float* sh = smem + (threadIdx.x >> 5) * wf;
  PhaseClock clk;
  clk.start(sh + oClk);
  float* const Ws = sh + oW;
  float* const Vs = sh + oV;
  float* tau = sh + oTau;
  float* qv = sh + oQv;
  float* vv = sh + oVv;
  float* dxs = sh + oDx;
  float* Ks = sh + oK;
  float* KQs = sh + oKQ;
  float* ks = sh + oKk;
  // the two trajectory slots [T][kNT] (current and trial, by ``cur``)
  // and the gains; slot s at ws0 + s * T * kNT; above the warp's tiles
  // in the shared layout
  float* const ws0 = kWsShared ? sh + kWarpFloats : op.ws + b * op.ws_example;
  float* const gains = ws0 + 2 * T * kNT;
  // the model-step build's Jacobians [T-1][kNS][kNT]
  float* const jac = gains + T * kGain;
  const float* Cb = kHuber ? nullptr : op.C + b * op.sCb;
  const float* cb = kHuber ? nullptr : op.c + b * op.scb;
  LaneCost hl{0.f, 0.f, 1.f};
  if constexpr (kHuber) {
    hl.w = __ldg(op.cost + lt);
    hl.goal = __ldg(op.cost + kNT + lt);
    hl.delta = __ldg(op.cost + 2 * kNT);
  }
  const float* Fb = nullptr;
  if constexpr (!kModel) Fb = op.F + b * op.sFb;
  const float* fb = kHasF ? op.f + b * op.sfb : nullptr;
  float prm[kNP] = {};
  if constexpr (kModel && !kMLP) {
#pragma unroll
    for (int i = 0; i < kNP; ++i) prm[i] = __ldg(op.params + i);
  }
  const float* lbb = kHasBounds ? op.lb + b * op.sbb : nullptr;
  const float* ubb = kHasBounds ? op.ub + b * op.sbb : nullptr;
  const float* uzb = kHasUz ? op.uz + b * op.sub : nullptr;
  const float x0r = lane < kNS ? __ldg(op.x0 + b * kNS + lx) : 0.f;

  // ---- init: the rollout of u0 into slot 0 and the outputs, its cost --
  float cost_cur = 0.f;
  if constexpr (kStep) {
    // every lane on its registers (the model-step build's rollout step):
    // x_t, the next step's u0 loaded while this step's model runs
    float x[kNS], un[kNC];
#pragma unroll
    for (int i = 0; i < kNS; ++i) x[i] = __ldg(op.x0 + b * kNS + i);
#pragma unroll
    for (int m = 0; m < kNC; ++m) un[m] = __ldg(op.u0 + b * kNC + m);
    // the last step's stage term, summed over the lanes at the top of the
    // next step (its shuffles beside that step's work)
    float term = 0.f;
    for (int t = 0; t < T; ++t) {
      const float sc = lane_sum(term);
      cost_cur = t < 2 ? sc : cost_cur + sc;
      float tv[kNT];
#pragma unroll
      for (int i = 0; i < kNS; ++i) tv[i] = x[i];
#pragma unroll
      for (int m = 0; m < kNC; ++m) tv[kNS + m] = un[m];
      const int tn = t + 1 < T ? t + 1 : t;
#pragma unroll
      for (int m = 0; m < kNC; ++m)
        un[m] = __ldg(op.u0 + (tn * B + b) * kNC + m);
      term = stage_term(Cb, cb, op.sCt, op.sct, t, hl, tv, lane, lt);
      if (lane < kNT) {
        const float v = pick(tv, lt);
        ws0[t * kNT + lane] = v;
        if (lane < kNS)
          op.x_out[(t * B + b) * kNS + lane] = v;
        else
          op.u_out[(t * B + b) * kNC + lane - kNS] = v;
      }
      Model::step(prm, tv, x);  // past the last step unused
    }
    const float sc = lane_sum(term);
    cost_cur = T < 2 ? sc : cost_cur + sc;
    __syncwarp();
  } else {
    float xr = x0r;
    for (int t = 0; t < T; ++t) {
      if (lane < kNS)
        tau[lane] = xr;
      else if (lane < kNT)
        tau[lane] = __ldg(op.u0 + (t * B + b) * kNC + lu);
      __syncwarp();
      const float sc =
          stage_at(Cb, cb, op.sCt, op.sct, t, hl, tau, lane, lt);
      cost_cur = t == 0 ? sc : cost_cur + sc;
      if (lane < kNT) {
        const float v = tau[lt];
        ws0[t * kNT + lane] = v;
        if (lane < kNS)
          op.x_out[(t * B + b) * kNS + lane] = v;
        else
          op.u_out[(t * B + b) * kNC + lane - kNS] = v;
      }
      if (t < T - 1) {
        if constexpr (kMLP) {
          const float r = mlp_model_step(mlp, op.nn, tau, lane, lx);
          if (lane < kNS) xr = r;
        } else if (lane < kNS) {
          xr = dyn_step(Fb + t * op.sFt, kHasF ? fb + t * op.sft : nullptr,
                        tau, lx);
        }
      }
      __syncwarp();
    }
  }
  clk.mark(kPhOther);

  int cur = 0;
  float best_cost = kBig, best_du = kBig, cur_du = kBig, nni = 0.f,
        n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;
  for (int it = 0; it < op.lqr_iter; ++it) {
    const float* trajc = ws0 + cur * T * kNT;
    // ---- the model's Jacobians at the current trajectory, lane t taking
    // steps t, t + 32, ... (the MLP's: the warp, a chunk of steps at
    // once): off the sweep's chain -------------------------------------
    if constexpr (kMLP) {
      mlp_model_jacobians(mlp, op.nn, trajc, T, lane, jac, clk);
    } else if constexpr (kModel) {
      for (int t = lane; t < T - 1; t += 32) {
        float tl[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j) tl[j] = trajc[t * kNT + j];
        float J[kNS][kNT];
        Model::jacobian(prm, tl, J);
        float* dst = jac + t * kJac;
#pragma unroll
        for (int i = 0; i < kNS; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) dst[i * kNT + j] = J[i][j];
      }
      __syncwarp();
    }
    clk.mark(kPhJac);
    // ---- the Riccati sweep, t = T-1 .. 0 ------------------------------
    float qp_cnt = 0.f;
    float prev_k[kNC];
#pragma unroll
    for (int m = 0; m < kNC; ++m) prev_k[m] = 0.f;
    // the last step's operands in flight (the next ones are started at
    // the top of each step, after it has waited on its own)
    if constexpr (kPrefetch) {
      stage_step<true>(op, Cb, cb, Fb, jac, sh, T - 1, T, lane, lt);
      cp_async_commit();
    }
    for (int t = T - 1; t >= 0; --t) {
      const int buf = kPrefetch ? (t & 1) : 0;
      float* const Qs = sh + oQ + buf * kQT;
      const float* const Fs =
          kWsShared ? jac + (t < T - 1 ? t : 0) * kJac : sh + oF + buf * kFT;
      const float* const cv = sh + oCv + buf * kNT;
      if constexpr (kPrefetch)
        cp_async_wait_all();
      else
        stage_step<false>(op, Cb, cb, Fb, jac, sh, t, T, lane, lt);
      // tau_t; in the cost build lane i writes H_ii on Q's diagonal (the
      // rest zeros) and keeps g_i as its C tau + c
      float cbv = 0.f;
      if (lane < kNT) {
        const float v = trajc[t * kNT + lt];
        tau[lane] = v;
        if constexpr (kHuber) {
          float h;
          huber_quad(hl.w, hl.goal, hl.delta, v, h, cbv);
          Qs[lane * kSQ + lane] = h;
        }
      }
      if constexpr (kHuber) {
        for (int e = lane; e < kNT * kNT; e += 32) {
          const int i = e / kNT, j = e - i * kNT;
          if (i != j) Qs[i * kSQ + j] = 0.f;
        }
      }
      __syncwarp();
      if constexpr (kPrefetch) {
        if (t > 0) stage_step<true>(op, Cb, cb, Fb, jac, sh, t - 1, T, lane, lt);
        cp_async_commit();
      }
      // cb = C_t tau + c_t, from the staged C_t before Q replaces it
      if constexpr (!kHuber) {
        if (lane < kNT) {
          const float* row = Qs + lt * kSQ;
          float s = row[0] * tau[0];
#pragma unroll
          for (int j = 1; j < kNT; ++j) s = s + row[j] * tau[j];
          cbv = s + cv[lt];
        }
        __syncwarp();
      }
      clk.mark(kPhStage);
      const bool last = t == T - 1;
      if (last) {
        if (lane < kNT) qv[lane] = cbv;
      } else {
        products_W<kNS, kNT, kSV, kSF, kSW, kPrefetch>(Vs, Fs, Ws, lane);
        clk.mark(kPhW);
        // Q = C_t + F_t^T W; q = cb + F_t^T v
        products_Q<kNS, kNT, kSF, kSW, kSQ, kPrefetch>(Fs, Ws, Qs, lane);
        if (lane < kNT) qv[lane] = q_entry<kNS, kSF>(Fs, vv, cbv, lt);
      }
      __syncwarp();
      clk.mark(kPhQ);

      if constexpr (kSmemCtrl) {
        // ---- the control solve across the lanes (box_qp_smem.cuh): Quu
        // read in place from Q's tile; lane i row i of the gains ---------
        float* Ls = sh + oL;
        float* Li = sh + oLi;
        float* xq = sh + oQx;
        const float* Quu = Qs + kNS * kSQ + kNS;
        const float* qu = qv + kNS;
        unsigned fr = (1u << kNC) - 1u;
        if constexpr (!kHasBounds) {
          // a pinned control's row of k and K is zero (:1475-1503): the
          // free block's factor (no jitter), qu and Qux masked
          if constexpr (kHasUz)
            fr = __ballot_sync(0xffffffffu,
                               lane < kNC &&
                                   __ldg(uzb + t * op.sut + lc) < 0.5f);
          factor_lanes<kNC>(Quu, kSQ, kHasUz, fr, kHasUz ? 0.f : 1e-11f, Ls,
                            kSL, Li, lane);
          clk.mark(kPhFactor);
        } else {
          // the box narrowed by the trust region (:1513-1515)
          if (lane < kNC) {
            sh[oQlo + lane] = fmaxf(
                __ldg(lbb + t * op.sbt + lc) - tau[kNS + lc], -op.delta);
            sh[oQhi + lane] = fminf(
                __ldg(ubb + t * op.sbt + lc) - tau[kNS + lc], op.delta);
          }
          if (last) {
            // the unclamped solve that starts the search; later steps
            // start from the previous step's solution, left in x
            factor_lanes<kNC>(Quu, kSQ, false, fr, 1e-11f, Ls, kSL, Li,
                              lane);
            float v[1] = {qu[lc]};
            solve_lanes<kNC, 1>(Ls, kSL, Li, v, lane);
            if (lane < kNC) xq[lane] = -v[0];
          }
          __syncwarp();
          clk.mark(kPhFactor);
          float trips;
          pnqp_lanes<kNC>(Quu, kSQ, qu, sh + oQlo, sh + oQhi, xq, sh + oQd,
                          op.pnqp_iter, sched.qp_steps, lane, Ls, kSL, Li,
                          fr, trips, clk);
          clk.mark(kPhQP);
          qp_cnt += trips;
          if (lane < kNC) {
            ks[lane] = xq[lane];
            gains[t * kGain + kNC * kNS + lane] = xq[lane];
          }
        }
        // the gains: lane i row i of K (Qux's row i, masked) and, without
        // bounds, of k (qu_i masked)
        constexpr int R = kNS + (kHasBounds ? 0 : 1);
        const bool fi = (fr >> lc) & 1u;
        float rhs[R];
#pragma unroll
        for (int r = 0; r < kNS; ++r)
          rhs[r] = fi ? Qs[(kNS + lc) * kSQ + r] : 0.f;
        if constexpr (!kHasBounds) rhs[R - 1] = fi ? qu[lc] : 0.f;
        solve_lanes<kNC, R>(Ls, kSL, Li, rhs, lane);
        if (lane < kNC) {
          float* gK = gains + t * kGain;
#pragma unroll
          for (int r = 0; r < kNS; ++r) {
            Ks[lane * kNS + r] = -rhs[r];
            gK[lane * kNS + r] = -rhs[r];
          }
          if constexpr (!kHasBounds) {
            ks[lane] = -rhs[R - 1];
            gK[kNC * kNS + lane] = -rhs[R - 1];
          }
        }
        __syncwarp();
        clk.mark(kPhGains);
        const float none2[1][1] = {{0.f}}, none1[1] = {0.f};
        cost_to_go<kNS, kNC, kSQ, kSV, false>(Qs, qv, Ks, KQs, ks, none2,
                                              none1, none1, Vs, vv, lane);
        clk.mark(kPhCostToGo);
      } else {
        // ---- the control solve (every lane on the same registers) ------
        float Quu[kNC][kNC], qu[kNC], kt[kNC];
  #pragma unroll
        for (int i = 0; i < kNC; ++i) {
          qu[i] = qv[kNS + i];
  #pragma unroll
          for (int j = 0; j < kNC; ++j) Quu[i][j] = Qs[(kNS + i) * kSQ + kNS + j];
        }
        // lane j's column of Qux
        float qx[kNC];
  #pragma unroll
        for (int i = 0; i < kNC; ++i)
          qx[i] = lane < kNS ? Qs[(kNS + i) * kSQ + lx] : 0.f;
        float Kcol[kNC];
        if constexpr (!kHasBounds) {
          // a pinned control's row of k and K is zero (:1475-1503)
          bool fr[kNC];
  #pragma unroll
          for (int i = 0; i < kNC; ++i) fr[i] = true;
          if constexpr (kHasUz) {
  #pragma unroll
            for (int i = 0; i < kNC; ++i)
              fr[i] = __ldg(uzb + t * op.sut + i) < 0.5f;
          }
          if constexpr (kNC == 1) {
            const float inv = 1.f / Quu[0][0];
            kt[0] = fr[0] ? -qu[0] * inv : 0.f;
            Kcol[0] = fr[0] ? -qx[0] * inv : 0.f;
          } else {
            // qu stays whole for the cost-to-go; the solves take it masked
            float L[kNC][kNC], sol[kNC], qm[kNC];
  #pragma unroll
            for (int i = 0; i < kNC; ++i) qm[i] = qu[i];
            if constexpr (kHasUz) {
              // the free block's factor, qu and Qux masked (no jitter)
              masked_free_chol<kNC>(Quu, fr, L);
  #pragma unroll
              for (int i = 0; i < kNC; ++i) {
                qm[i] = fr[i] ? qu[i] : 0.f;
                qx[i] = fr[i] ? qx[i] : 0.f;
              }
            } else {
              cholesky<kNC>(Quu, 1e-11f, L);
            }
            clk.mark(kPhFactor);
            chol_solve<kNC>(L, qm, sol);
  #pragma unroll
            for (int i = 0; i < kNC; ++i) kt[i] = -sol[i];
            chol_solve<kNC>(L, qx, sol);
  #pragma unroll
            for (int i = 0; i < kNC; ++i) Kcol[i] = -sol[i];
          }
        } else {
          // the box narrowed by the trust region (:1513-1515)
          float lo[kNC], hi[kNC];
  #pragma unroll
          for (int m = 0; m < kNC; ++m) {
            lo[m] = fmaxf(__ldg(lbb + t * op.sbt + m) - tau[kNS + m], -op.delta);
            hi[m] = fminf(__ldg(ubb + t * op.sbt + m) - tau[kNS + m], op.delta);
          }
          if constexpr (kNC == 1) {
            const float inv = 1.f / Quu[0][0];
            const float kv = fminf(fmaxf(-qu[0] * inv, lo[0]), hi[0]);
            const float g = Quu[0][0] * kv + qu[0];
            const bool clamped =
                (kv == lo[0] && g > 0.f) || (kv == hi[0] && g < 0.f);
            kt[0] = kv;
            Kcol[0] = clamped ? 0.f : -qx[0] * inv;
            qp_cnt += 1.f;
          } else {
            float L[kNC][kNC], sol[kNC], trips;
            bool fr[kNC];
            if (last) {
              cholesky<kNC>(Quu, 1e-11f, L);
              chol_solve<kNC>(L, qu, sol);
  #pragma unroll
              for (int i = 0; i < kNC; ++i) kt[i] = -sol[i];
            } else {
  #pragma unroll
              for (int i = 0; i < kNC; ++i) kt[i] = prev_k[i];
            }
            clk.mark(kPhFactor);
            pnqp<kNC>(Quu, qu, lo, hi, kt, op.pnqp_iter, sched.qp_steps, lane,
                      L, fr, trips, clk);
            clk.mark(kPhQP);
            qp_cnt += trips;
  #pragma unroll
            for (int i = 0; i < kNC; ++i) qx[i] = fr[i] ? qx[i] : 0.f;
            chol_solve<kNC>(L, qx, sol);
  #pragma unroll
            for (int i = 0; i < kNC; ++i) Kcol[i] = -sol[i];
          }
        }
  #pragma unroll
        for (int i = 0; i < kNC; ++i) prev_k[i] = kt[i];
        float* gK = gains + t * kGain;
        if (lane < kNS) {
  #pragma unroll
          for (int i = 0; i < kNC; ++i) {
            Ks[i * kNS + lane] = Kcol[i];
            gK[i * kNS + lane] = Kcol[i];
          }
        }
        if (lane == 0) {
  #pragma unroll
          for (int i = 0; i < kNC; ++i) {
            ks[i] = kt[i];
            gK[kNC * kNS + i] = kt[i];
          }
        }
        __syncwarp();
        clk.mark(kPhGains);

        cost_to_go<kNS, kNC, kSQ, kSV, true>(Qs, qv, Ks, KQs, ks, Quu, qu,
                                             kt, Vs, vv, lane);
        clk.mark(kPhCostToGo);
      }
    }


    // ---- the line search: trial rollouts into the other slot; the first
    // passing step size, else the last, becomes the trajectory ----------
    const float old_cost = cost_cur;
    float* trial = ws0 + (1 - cur) * T * kNT;
    float sel_cost = 0.f, sel_alpha = 0.f, full_du = 0.f;
    // the gains and the current slot as the sweep left them
    if constexpr (kStep) __syncwarp();
    for (int ai = 0; ai < sched.n; ++ai) {
      const float a = sched.a[ai];
      float xr = x0r, cost_a = 0.f, du2 = 0.f;
      if constexpr (kStep) {
        // every lane on its registers: x_t, u_t and the step's operands
        // (the next step's loaded while this step's model runs); no
        // barrier on the chain
        float x[kNS];
#pragma unroll
        for (int i = 0; i < kNS; ++i) x[i] = __ldg(op.x0 + b * kNS + i);
        TrialOps s;
        load_trial(op, trajc, gains, lbb, ubb, uzb, 0, s);
        float term = 0.f;  // the last step's stage term, as in the init
        for (int t = 0; t < T; ++t) {
          const float sc = lane_sum(term);
          cost_a = t < 2 ? sc : cost_a + sc;
          float tv[kNT], u[kNC];
#pragma unroll
          for (int i = 0; i < kNS; ++i) tv[i] = x[i];
#pragma unroll
          for (int m = 0; m < kNC; ++m) {
            float dx[kNS];
#pragma unroll
            for (int j = 0; j < kNS; ++j) dx[j] = x[j] - s.xo[j];
            float sk = s.K[m][0] * dx[0];
#pragma unroll
            for (int j = 1; j < kNS; ++j) sk = sk + s.K[m][j] * dx[j];
            float ut = (sk + s.uo[m]) + a * s.k[m];
            // zeroed where pinned, before the clamp (:1686-1692)
            if constexpr (kHasUz) ut = s.pin[m] ? 0.f : ut;
            if constexpr (kHasBounds) ut = fminf(fmaxf(ut, s.lo[m]), s.hi[m]);
            u[m] = ut;
            tv[kNS + m] = ut;
          }
          // the full step's squares, control m's on lane n_state + m
          float d2[kNC];
#pragma unroll
          for (int m = 0; m < kNC; ++m) {
            const float d = s.uo[m] - u[m];
            d2[m] = d * d;
          }
          load_trial(op, trajc, gains, lbb, ubb, uzb, t + 1 < T ? t + 1 : t,
                     s);
          term = stage_term(Cb, cb, op.sCt, op.sct, t, hl, tv, lane, lt);
          const float d2s = lane_tree<kNS, kNC>(d2);
          du2 = t == 0 ? d2s : du2 + d2s;
          if (lane < kNT) trial[t * kNT + lane] = pick(tv, lt);
          Model::step(prm, tv, x);  // past the last step unused
        }
        const float sc = lane_sum(term);
        cost_a = T < 2 ? sc : cost_a + sc;
      } else {
        for (int t = 0; t < T; ++t) {
          if (lane < kNS) {
            tau[lane] = xr;
            dxs[lane] = xr - trajc[t * kNT + lx];
          }
          __syncwarp();
          float d2 = 0.f;
          if (lane >= kNS && lane < kNT) {
            const int m = lu;
            const float* Kr = gains + t * kGain + m * kNS;
            float s = Kr[0] * dxs[0];
#pragma unroll
            for (int j = 1; j < kNS; ++j) s = s + Kr[j] * dxs[j];
            const float uo = trajc[t * kNT + kNS + m];
            float ut = (s + uo) + a * gains[t * kGain + kNC * kNS + m];
            // zeroed where pinned, before the clamp (:1686-1692)
            if constexpr (kHasUz)
              ut = __ldg(uzb + t * op.sut + m) > 0.5f ? 0.f : ut;
            if constexpr (kHasBounds)
              ut = fminf(fmaxf(ut, fmaxf(uo - op.delta,
                                         __ldg(lbb + t * op.sbt + m))),
                         fminf(uo + op.delta, __ldg(ubb + t * op.sbt + m)));
            tau[lane] = ut;
            const float d = uo - ut;
            d2 = d * d;
          }
          __syncwarp();
          const float sc =
              stage_at(Cb, cb, op.sCt, op.sct, t, hl, tau, lane, lt);
          cost_a = t == 0 ? sc : cost_a + sc;
          if (ai == 0) {
            const float d2s = lane_sum(d2);
            du2 = t == 0 ? d2s : du2 + d2s;
          }
          if (lane < kNT) trial[t * kNT + lane] = tau[lt];
          if (t < T - 1) {
            if constexpr (kMLP) {
              const float r = mlp_model_step(mlp, op.nn, tau, lane, lx);
              if (lane < kNS) xr = r;
            } else if (lane < kNS) {
              xr = dyn_step(Fb + t * op.sFt, kHasF ? fb + t * op.sft : nullptr,
                            tau, lx);
            }
          }
          __syncwarp();
        }
      }
      n_trials += 1.f;
      if (ai == 0) full_du = sqrtf(du2);
      if (cost_a <= old_cost || ai == sched.n - 1) {
        sel_cost = cost_a;
        sel_alpha = a;
        break;
      }
    }
    // the trial slot complete before another lane reads it (the next
    // Jacobian pass, the next sweep)
    if constexpr (kStep) __syncwarp();
    clk.mark(kPhRollout);

    // ---- best tracking and stopping ----------------------------------
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    const bool take_best = improved || it == 0;
    nni = (improved && it != 0) ? 0.f : nni + 1.f;
    cur = 1 - cur;
    if (take_best) {
      for (int t = 0; t < T; ++t) {
        const float v = trial[t * kNT + lt];
        if (lane < kNS)
          op.x_out[(t * B + b) * kNS + lane] = v;
        else if (lane < kNT)
          op.u_out[(t * B + b) * kNC + lane - kNS] = v;
      }
      best_cost = sel_cost;
      best_du = full_du;
    }
    cur_du = full_du;
    n_qp += qp_cnt;
    alpha_sel = sel_alpha;
    n_it += 1.f;
    cost_cur = sel_cost;
    clk.mark(kPhOther);
    if (!(cur_du >= op.eps && nni <= op.not_improved_lim)) break;
  }

  if (lane == 0) {
    op.stats[0 * B + b] = best_cost;
    op.stats[1 * B + b] = best_du;
    op.stats[2 * B + b] = n_it;
    op.stats[3 * B + b] = n_qp;
    op.stats[4 * B + b] = alpha_sel;
    op.stats[5 * B + b] = n_trials;
  }
  clk.mark(kPhOther);
  clk.write(op.clocks, b);
}

}  // namespace mpc

extern "C" int mpc_fused_ilqr_dense(
    int B, int T, const float* params, const int* nn_sizes, int n_sizes,
    int nn_pass, const float* cost, const float* F,
    long long sFt,
    long long sFb,
    const float* f, long long sft, long long sfb, const float* C,
    long long sCt, long long sCb, const float* c, long long sct,
    long long scb, const float* x0, const float* u0, const float* lb,
    const float* ub, long long sbt, long long sbb, const float* uz,
    long long sut, long long sub, float delta, const float* alphas,
    int n_alpha, int lqr_iter, int pnqp_iter, float eps, float best_cost_eps,
    float not_improved_lim, float* ws, int smem_bytes, float* x_out,
    float* u_out, float* stats, long long* clocks, void* stream) {
  using namespace mpc;
  if (B <= 0 || T <= 0 || n_alpha <= 0 || n_alpha > kMaxAlpha ||
      lqr_iter < 0 || pnqp_iter < 0 || (ws == nullptr) != kWsShared ||
      (kModel ? (params == nullptr || F != nullptr || f != nullptr)
              : (F == nullptr && T > 1)) ||
      ((f != nullptr) != kHasF && T > 1) ||
      (kHasBounds && (lb == nullptr || ub == nullptr)) ||
      (kHasUz != (uz != nullptr)) || !(delta > 0.f) ||
      (!kHasBounds && delta != INFINITY) ||
      (kHuber ? (cost == nullptr || C != nullptr || c != nullptr)
              : (C == nullptr || c == nullptr)) ||
      (kMLP ? n_sizes != kDepth + 2 || nn_sizes == nullptr
            : n_sizes != 0) ||
      (clocks != nullptr) != kPhaseClocks)
    return (int)cudaErrorInvalidValue;
  // the MLP build: its widths (the model's n_in and n_out are the build's),
  // the weights' copy above the warps' tiles and scratch; the Jacobian
  // pass's chunk is the largest whose scratch gives the host's shared
  // memory (fused_dense.mlp_chunk), a warp's region 16-byte aligned where
  // its rows are vector loads or the layout prefetches
  MLPLayout nn{};
  const long long ws_example =
      (long long)T * (2 * kNT + kGain) + (T - 1LL) * kJac;
  int warp_floats = kWarpFloats, smem_floats = kWarps * kWarpFloats;
  // the shared layout: each warp's workspace above its tiles, a multiple
  // of 4 floats
  if (kWsShared) {
    warp_floats = kWarpFloats + (int)((ws_example + 3) / 4 * 4);
    smem_floats = kWarps * warp_floats;
  }
  if (kMLP) {
    if (!mlp_layout(nn_sizes, kDepth, nn_pass != 0, nn) ||
        nn.size[0] != kNSI + kNC || nn.size[kDepth + 1] != kNSI)
      return (int)cudaErrorInvalidValue;
    for (int ch = kMaxChunk; ch >= 1; --ch) {
      const int scratch = mlp_scratch_floats(nn.base, nn.slot, ch, kPrefetch);
      const int wf = kWarpFloats + scratch;
      if (smem_bytes == (kWarps * wf + nn.floats) * (int)sizeof(float)) {
        nn.chunk = ch;
        warp_floats = wf;
        smem_floats = kWarps * wf + nn.floats;
        break;
      }
    }
  }
  if (smem_bytes != smem_floats * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  // 32-bit indices: the largest offset of each array
  const long long last = T - 1, lastb = B - 1, big = 1LL << 31;
  if (last * sCt + lastb * sCb + kNT * kNT >= big ||
      last * sct + lastb * scb + kNT >= big ||
      last * sFt + lastb * sFb + kNS * kNT >= big ||
      last * sft + lastb * sfb + kNS >= big ||
      last * sbt + lastb * sbb + kNC >= big ||
      last * sut + lastb * sub + kNC >= big ||
      (long long)T * B * kNT >= big ||
      (!kWsShared && ws_example * B >= big))
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory has to be asked for; the
  // library remembers the most it has asked for
  static int smem_allowed = 48 * 1024;
  if (smem_bytes > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_ilqr_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem_bytes;
  }
  Schedule sched;
  for (int i = 0; i < n_alpha; ++i) sched.a[i] = alphas[i];
  for (int i = n_alpha; i < kMaxAlpha; ++i) sched.a[i] = 0.f;
  // the box QP's step sizes: the float32 values of 0.1^k, as the JAX
  // kernel bakes in the Python floats
  for (int k = 0; k < kPnqpSteps; ++k)
    sched.qp_steps[k] = (float)std::pow(0.1, (double)k);
  sched.n = n_alpha;
  Operands op;
  op.B = B;
  op.T = T;
  op.params = params;
  op.nn = nn;
  op.warp_floats = warp_floats;
  op.cost = cost;
  op.F = F;
  op.sFt = (int)sFt;
  op.sFb = (int)sFb;
  op.f = f;
  op.sft = (int)sft;
  op.sfb = (int)sfb;
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
  op.pnqp_iter = pnqp_iter;
  op.eps = eps;
  op.best_cost_eps = best_cost_eps;
  op.not_improved_lim = not_improved_lim;
  op.ws = ws;
  op.ws_example = (int)ws_example;
  op.x_out = x_out;
  op.u_out = u_out;
  op.stats = stats;
  op.clocks = clocks;
  const int blocks = (B + kWarps - 1) / kWarps;
  fused_ilqr_dense_kernel<<<blocks, kThreads, smem_bytes,
                            (cudaStream_t)stream>>>(op, sched);
  return (int)cudaGetLastError();
}
