// Kernel K3 for Hopper: the streaming box-constrained iLQR solve, a team
// of lanes per example, any horizon.
//
// Replaces the TPU kernel mpc_tpu/ops/fused.py:_make_kernel_long (lines
// 1126-1932), which runs the horizon as fori_loops with x, u, K, k per t
// in VMEM scratch, evaluates every line-search step size at once and
// streams batched operands through a 2-slot DMA buffer.
//
// What bounds it on this card.  The work is small (~2.5e5 operations and
// ~3 KB in and out per example at T = 160; k3_flops, k3_bytes: the bound
// is set by operations) and the batch is small for the card: B = 4096 is
// 31 examples an SM.  What takes the time is the length of the chain of
// dependent horizon steps one example walks, times the latency of a
// step: the loads a step starts with, then its dependent arithmetic,
// with no other warp on the scheduler to fill the gaps.  An iLQR
// iteration has two recurrences that cannot be cut, the cost-to-go V, v
// backwards and the rollout forwards; everything else is parallel.
//
// What the design does about it.
//
// - A TEAM of kTeam neighbouring lanes of a warp owns one example
//   (cooperative_groups::tiled_partition<kTeam>), so B = 4096 fills 512
//   warps: one on every scheduler of the card.
// - The line search runs ACROSS the lanes: lane g rolls out step size
//   alphas[g] and writes its trajectory to a slot of its own in the
//   workspace; a ballot picks the first lane whose cost does not exceed
//   the current one, else the last step size.  More step sizes than
//   lanes run in rounds of kTeam, a later round only if no lane of the
//   earlier one passed.  That selects what a serial search that stops at
//   its first passing step size selects, and stats[5] stays the selected
//   index plus one.  A launch lasts as long as its slowest example, and a
//   second round is a whole rollout more for the examples that need it,
//   so the pendulum's team is as wide as its line search (8 lanes in 8
//   warps for 5 to 8 step sizes, ops/fused.py:_k3_team; 32 examples a
//   block either way).
// - There is NO COMMIT ROLLOUT.  The team copies the winner's slot into
//   the current trajectory and, where it improved on the best cost, into
//   the outputs, lane g taking steps g, g + kTeam, ... with the loads of
//   kCopy steps in flight together: a copy, not a chain.  Per iteration
//   the chain is one Riccati sweep and one rollout.
// - What the chains read lives in SHARED MEMORY where it fits.  The
//   state a chain reads at every step is the current trajectory (x, u)
//   and the gains (K, k): two float4 a step and example.  A round trip
//   to the L2 for them costs more than a step's arithmetic (measured:
//   600-800 cycles a step with the state in global memory, whether or
//   not it was loaded a step ahead).  A block of kWarps warps holds
//   kExamples = 32 kWarps / kTeam = 32 examples, so the state takes
//   T * 2 * 16 * kExamples = 1024 T bytes and the shared operands 4
//   kOpRow T (160 T for LinDx with a QuadCost, 96 T for the pendulum, 16 T
//   for its cost build).  The state is resident where it fits 232,448
//   bytes a block beside the pendulum's linearisation buffers (LinDx's
//   only with its operands, whose rows its sweep would otherwise read
//   from global memory: up to T = 196; the damped pendulum's to 202), the
//   operands where they fit beside it too, one block an SM, which at
//   T = 160 leaves the card's 132 SMs room for 4224 examples.  Past that
//   the same source (the kernel's Ring instantiation) keeps the state in
//   the workspace in global memory, and each lane reads it through A RING
//   of the next kRing steps of its walk in shared memory: the rows of the
//   position kAhead on are copied in by cp.async while a step computes,
//   one commit group a position, waited for when the chain reaches it
//   (Feed), so a step's state is a shared-memory load whatever T (the
//   L2's round trip, 600-800 cycles, hidden behind kAhead steps).  Each
//   lane fills its own ring: no barrier on the chain.  ops/fused.py:k3_launch
//   computes the layout, and nothing else limits T.  The trial slots are
//   always in global memory: the chains only write them.
// - Rows arrive before the step that needs them, which is this card's
//   form of the TPU kernel's make_async_copy double buffer: in both
//   horizon loops the operands and the state of step t -+ 1 are loaded
//   into registers while step t computes (two register sets used in
//   turns, so nothing is moved).  The initial controls come from device
//   memory: the team fetches them in a pass parallel over t.
// - A batch-shared operand (batch stride 0) is ONE COPY FOR THE BLOCK:
//   where it fits beside the state or the rings the block first copies
//   the shared ones the build reads of C, c, F, f, the bounds and the
//   mask into shared memory (kOpRow floats a step), all threads together,
//   and the loops read them there; the initial rollout, the first to
//   touch them, otherwise waits for device memory at every step of its
//   chain (measured: ~1000 cycles a step), and the later loops find them
//   in the L1.  A batched operand is read from global memory with its
//   batch stride.
// - THE PENDULUM'S JACOBIANS (and the cost build's quadratisation) are
//   OFF THE SWEEP'S CHAIN: its damped step's Jacobian is an atan2f, a
//   sincos, a cosf and an IEEE division deep, which every lane would pay
//   at every step were the Riccati step to take it inline.  The sweep
//   walks the horizon in rounds of kTeam steps; while the chain walks one
//   round, lane g forms the Jacobian (and H's diagonal and g) of step
//   t0 - kTeam - g of the next round, from (x, u) it loaded a round
//   before, into the team's buffer of two rounds in shared memory, and a
//   tile.sync() ends the round: one Jacobian's latency and issue a round
//   instead of kTeam.  The chain reads the rows as it reads a LinDx F (load_lin).
//   The transcendentals' fast-path checks are branches, so the formed
//   rows do not interleave with the chain's arithmetic: the gain is the
//   kTeam steps a Jacobian's latency is shared by (PERF.md section 6).
//   The rollout's step stays on its chain: it is the recurrence.
// - The workspace is [t, slot, b] of float4: one 16-byte access for
//   (x, u) or (K, k) of a step, the examples of a warp (8, in teams of 8
//   lanes 4) on one 128-byte line; C, c and F are read as float4 too.
// - The Riccati sweep runs redundantly in every lane of a team (same
//   arithmetic, same bits, no shuffles on the chain); lane 0 stores the
//   gains.  A lane reads rows another lane of its team wrote only after
//   a tile.sync(), and never through the read-only path.
//
// Teams of one warp stop at different iterations: the whole team leaves
// its loop together and every collective there is the tile's.  The one
// __syncthreads() follows the block's copy of the shared operands, before
// any team has left.
//
// Dynamics (MPC_DYN): 0 = LinDx (x' = F (x, u) + f; F shared or per
// example, f optional), 1 = a pendulum (pendulum.cuh; MPC_DAMPED the
// damped, biased one), 2 = a one-hidden-layer MLP (nn.cuh; MPC_ACT its
// activation, H and the passthrough run-time arguments), the TPU kernel's
// streamed-weights NN mode (mpc_tpu/ops/fused.py:1252-1306), which runs
// in a kernel of its own below.
//
// THE MLP CONFIGURATION (fused_ilqr_nn_kernel).  An MLP's step is ~1,800
// operations at H = 100 and its Jacobian ~4,100 (ops/fused.py:
// nn_op_counts), ~80x the pendulum's, so one lane's chain of them is what
// a team of lanes would wait on (PERF.md section 6: a rollout step ~5.4k
// cycles on one lane, one warp a scheduler).  So an example gets a WARP
// (the team is the warp, 4 warps a block, 16 warps an SM at the
// __launch_bounds__ of 128 registers a lane, ops/fused.py:k3_nn_launch):
// - the rollout step is split over the lanes (nn_step_warp): lane l keeps
//   units l, l + 32, ... in registers, loaded from the block's shared
//   copy of the weights at the start of each rollout (kept live across
//   the sweep they would take its registers), forms partial sums of the
//   three outputs, and a butterfly of shuffles leaves x_{t+1} in every
//   lane with the same bits: no shared-memory scratch and no __syncwarp
//   on the chain.  The control, its clamp and the stage cost run in every
//   lane, lane 0 stores;
// - the line search rolls out its step sizes one after another and stops
//   at the first that passes (bench_nn_dynamics needs 1.107 trials an
//   iteration; two or three side by side, as the TPU kernel's
//   dyn_step_multi shares one weight sweep, :1705-1720, ran slower:
//   PERF.md section 6);
// - the Jacobian pass before each sweep runs a step a lane (lane t step
//   t, looping past 33 steps), each nn_jacobian over every unit with the
//   weights read as broadcasts, into three float4 rows a step;
// - the Riccati sweep runs redundantly in every lane (SIMT: no more issue
//   slots than one lane), lane 0 stores the gains;
// - the example's slots ((K, k), (x, u), the Jacobian rows, the trial
//   trajectory) are the warp's rows of shared memory where they cost an
//   SM no block, else the workspace [t, slot, B]; the selected trial is
//   copied into (x, u) and the outputs, lane t step t.
// The step's output sums are lane partials and a butterfly, another order
// than the stream form's, which the plain version follows
// (ops/fused_dense.py:mlp_step_lanes); the Jacobian keeps the stream
// form's order.
//
// The arithmetic of every scalar is the TPU kernel's, in its order
// (vv_update sums left to right, the control is (K dx + u) + alpha k,
// sums over t run left to right in one lane), and the plain PyTorch
// version mpc_tpu_torch/ops/fused.py:fused_solve_long_plain follows it.
// Built without --use_fast_math; nvcc's FMA contraction is the only
// arithmetic difference from the plain version.
//
// THE COST BUILD (MPC_COST = 1), for every MPC_DYN, takes the pseudo-Huber
// cost (cost.cuh) where the TPU kernel takes a structure-of-arrays cost
// (mpc_tpu/ops/fused.py:1406-1461, 1584-1590): no C or c operand (no
// pointer of one is formed, and the block's copy of the shared operands
// holds none), the 9 parameters [w, goal, delta] in every lane's
// registers.  The Riccati step quadratises the cost at the current (x, u)
// it already reads, C_t = diag(H) and g in place of C_t tau + c_t: work
// on tau_t alone, off the V chain's dependencies, and no memory.  The
// initial rollout and the trials score the true cost.
//
// CONTROLS PINNED TO ZERO (MPC_HAS_UZ = 1) and THE TRUST REGION delta_u,
// for every MPC_DYN, as the TPU kernel applies them (read_uz, ctrl_solve
// and _ctrl_from, mpc_tpu/ops/fused.py:1233-1236, 1475-1515, 1681-1692):
// the mask [T, 1 or B] (1 pinned) is an operand of that build alone and
// rides in each step's rows beside the bounds, a batch-shared one in the
// block's copy of the shared operands; delta_u is a run-time argument,
// +inf where there is none (max and min with +-inf are exact, so the
// other builds keep their bits).  Without bounds a pinned control's k
// and K are zero; with bounds the mask never enters the QP, whose box
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
#include "nn.cuh"
#include "pendulum.cuh"
#include "phase_clock.cuh"

#ifndef MPC_DYN
#error "compile with -DMPC_DYN=0 (LinDx), 1 (pendulum) or 2 (MLP)"
#endif
#if MPC_DYN == 2 && !defined(MPC_ACT)
#error "compile the MLP with -DMPC_ACT=0 (sigmoid), 1 (relu) or 2 (elu)"
#endif
#if MPC_DYN == 2 && !defined(MPC_MIN_BLOCKS)
#error "compile the MLP with -DMPC_MIN_BLOCKS=<blocks an SM>"
#endif
#ifndef MPC_ACT
#define MPC_ACT 0
#endif
// MPC_DYN = 1: the damped, biased pendulum (pendulum.cuh) instead of the
// simple one
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
#ifndef MPC_HAS_BOUNDS
#error "compile with -DMPC_HAS_BOUNDS=0 or 1"
#endif
#if !defined(MPC_TEAM) || !defined(MPC_WARPS) || !defined(MPC_OP_ROW)
#error "compile with -DMPC_TEAM=<lanes an example> -DMPC_WARPS=<warps a block> -DMPC_OP_ROW=<floats a step of the shared operands' copy>"
#endif
#if MPC_DYN != 2 && !defined(MPC_RING)
#error "compile the team kernel with -DMPC_RING=<steps of a lane's ring>"
#endif
#ifndef MPC_RING
#define MPC_RING 4
#endif

namespace cg = cooperative_groups;

namespace mpc {

constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr bool kLinDx = MPC_DYN == 0;
constexpr bool kPendulum = MPC_DYN == 1;
constexpr bool kNN = MPC_DYN == 2;
constexpr bool kHasBounds = MPC_HAS_BOUNDS != 0;
constexpr bool kDamped = MPC_DAMPED != 0;
constexpr bool kHuber = MPC_COST == 1;
constexpr bool kHasUz = MPC_HAS_UZ != 0;
constexpr int kMaxAlpha = 32;  // ops/fused.py:MAX_ALPHA
constexpr int kTeam = MPC_TEAM;
constexpr int kWarps = MPC_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kExamples = kThreads / kTeam;  // per block
constexpr int kCopy = 8;  // steps a lane keeps in flight in the copy
constexpr float kBig = 3.0e38f;
// the state's two slots of one step and example
constexpr int kGain = 0;  // (K, k)
constexpr int kTraj = 1;  // the current (x, u)
// a step of the block's copy of the batch-shared operands, in floats: the
// operands the build reads (C and c but in the cost build, F and f for
// LinDx, the bounds, the mask), padded to float4 (ops/fused.py:_k3_op_row;
// the MLP's row keeps 40)
constexpr int kOffC = 0;
constexpr int kOffc = kOffC + (kHuber ? 0 : 16);
constexpr int kOffF = kOffc + (kHuber ? 0 : 4);
constexpr int kOfff = kOffF + (kLinDx ? 12 : 0);
constexpr int kOffLb = kOfff + (kLinDx ? 4 : 0);
constexpr int kOffUb = kOffLb + (kHasBounds ? 1 : 0);
constexpr int kOffUz = kOffUb + (kHasBounds ? 1 : 0);
constexpr int kOpRowUsed = (kOffUz + (kHasUz ? 1 : 0) + 3) / 4 * 4;
constexpr int kOpRow = MPC_OP_ROW;
static_assert(kNN ? kOpRow >= kOpRowUsed : kOpRow == kOpRowUsed,
              "a row holds the build's operands and keeps float4 alignment");
// THE PENDULUM'S LINEARISATION, off the Riccati sweep's chain: the team's
// lanes form the Jacobians of the next kTeam steps (and the cost build's
// quadratisation) together, lane g step t0 - kTeam - g, into a buffer of
// two rounds of kTeam steps, kLinRows float4 a step (F's three rows; H's
// diagonal and g), one float4 more a team so that a warp's 8 teams read
// other banks
constexpr bool kLinOff = kPendulum;
constexpr int kLinRows = kLinOff ? NS + (kHuber ? 2 : 0) : 0;
constexpr int kLinTeam = kLinOff ? 2 * kTeam * kLinRows + 1 : 0;
// THE RING past residency: a lane's rows of the next kRing steps of its
// walk in shared memory, [kRing, 2, kThreads] of float4, those kAhead
// positions on in flight (cp.async) while a step computes
constexpr int kRing = MPC_RING;
constexpr int kAhead = kRing - 2;
static_assert(kRing >= 3 && (kRing & (kRing - 1)) == 0,
              "a ring of a power of two steps");

static_assert(kNN ? kTeam == 32
                  : kTeam == 2 || kTeam == 4 || kTeam == 8 || kTeam == 16,
              "a team is a power-of-two part of a warp; the MLP's a warp");

// The phase account (MPC_PHASE_CLOCKS, phase_clock.cuh; the host reads
// the columns as fused.K3_PHASES): the initial rollout (with the block's
// staging), the Jacobian pass, the Riccati sweep, the trial rollouts, the
// copy of the selected trial (with best tracking and the outputs).
enum K3Phase { kK3Init = 0, kK3Jac, kK3Sweep, kK3Trials, kK3Copy, kK3Phases };
// a warp's counters at the start of the block's shared memory
constexpr int kK3ClockFloats = kPhaseClocks ? 8 : 0;
static_assert(kK3ClockFloats == 0 || kK3ClockFloats >= kK3Phases, "");

struct Schedule {
  float a[kMaxAlpha];
  int n;
};

// Every operand, the outputs and the workspace have fewer than 2^31
// elements (the launcher checks), so indices are 32-bit: a 64-bit
// multiply costs three instruction slots on this card, and a step
// computes a dozen addresses.
struct Operands {
  int B, T;
  const float* params;  // pendulum (g, m, l), or an MLP's flat weights;
                        // unused for LinDx
  int nn_h, nn_pass;    // MLP: hidden units, passthrough
  const float* cost;    // the cost build's [w, goal, delta] (9)
  const float* F;       // LinDx: [T-1, 1 or B, 3, 4]
  int sFt, sFb;
  const float* f;  // LinDx: [T-1, 1 or B, 3], or nullptr
  int sft, sfb;
  const float* C;  // [T, 1 or B, 4, 4], or nullptr in the cost build
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
  float4* ws;    // [T, slots, B]: the trial slots, then the state's two
  int slots;     // min(n_alpha, kTeam), + 2 where the state is not resident
  int resident;  // the state (K, k), (x, u), the batch-shared operands
                 // and an MLP's Jacobian rows are in shared memory
  int staged;    // the team kernel: the block's copy of the batch-shared
                 // operands is in shared memory (beside the rings too,
                 // where it fits)
  float* x_out;  // [T, B, 3]: the best trajectory throughout
  float* u_out;  // [T, B]
  float* stats;  // [6, B]
  long long* clocks;  // [blocks * kExamples][kK3Phases]: MPC_PHASE_CLOCKS only
};

// ``p`` points into global or shared memory
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// The operands of one horizon step, as one register set of the prefetch.
struct Rows {
  float C[NTAU][NTAU], c[NTAU];  // the QuadCost build only
  float F[NS][NTAU], f[NS];      // LinDx only
  float lb, ub;              // with bounds only
  float uz;                  // the MPC_HAS_UZ build only
  float hq[NTAU], gq[NTAU];  // the pendulum's cost build: H's diagonal, g
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

extern __shared__ float4 smem[];

// Copies a batch-shared operand of ``N`` floats a step into the block's
// shared memory, all threads of the block together.
template <int N>
__device__ __forceinline__ void stage(const float* src, int stride, int steps,
                                      float* dst) {
  for (int i = threadIdx.x; i < steps * N; i += kThreads) {
    const int t = i / N;
    const int j = i - t * N;
    dst[t * kOpRow + j] = src[t * stride + j];
  }
}

// An operand as the horizon loops read it: the example's rows in global
// memory, or the block's copy in shared memory.
struct Operand {
  const float* p;
  int step;  // floats between steps

  __device__ __forceinline__ const float* at(int t) const {
    return p + t * step;
  }
};

// ``staged`` is the block's copy of the batch-shared operands (nullptr
// where it has none) and ``offset`` this operand's place in its rows; it
// is used where the operand is batch-shared (batch stride 0).
__device__ __forceinline__ Operand operand(const float* src, int step,
                                           int batch, int b,
                                           const float* staged, int offset) {
  if (staged != nullptr && batch == 0) return Operand{staged + offset, kOpRow};
  return Operand{src + b * batch, step};
}

struct Team {
  const Operands& op;
  int b;  // the team's example
  PendulumParams p;
  Huber<NTAU> hc;  // the cost build's parameters
  Operand C, c, F, f, lb, ub, uz;
  bool has_f;
  float4* st;  // the example's state at step 0, slot kGain: shared
               // memory [t, 2, kExamples] where resident, else two
               // slots of the workspace [t, slots, B] after the trials';
               // the MLP's kNNSlots slots, the warp's rows [t, kNNSlots]
               // or the workspace [t, kNNSlots, B]
  int st_step, st_slot;  // its strides
  const float4* w;  // MLP: the block's weights in shared memory
  int H;
  bool pass;
  float4* jb;  // MLP: the example's Jacobian rows at step 0 (its slots
               // kJac, kJac + 1, kJac + 2)
  int jb_step, jb_row;  // their strides
  float4* lin;   // the pendulum: the team's linearisation buffer
  float4* ring;  // past residency: the lane's ring (its row of slot 0)

  // slot ``slot`` (kGain or kTraj) of the state at step t
  __device__ __forceinline__ float4& state(int t, int slot) const {
    return st[t * st_step + slot * st_slot];
  }
  // row i of an MLP's Jacobian at step t
  __device__ __forceinline__ float4& jac(int t, int i) const {
    return jb[t * jb_step + i * jb_row];
  }
  // trial slot ``lane`` of the workspace at step t
  __device__ __forceinline__ float4& trial(int t, int lane) const {
    return op.ws[(t * op.slots + lane) * op.B + b];
  }
  // row k of step j of the linearisation buffer's round ``half``
  __device__ __forceinline__ float4& lin_row(int half, int j, int k) const {
    return lin[(half * kTeam + j) * kLinRows + k];
  }
  // the lane's ring entry of walk position n, slot ``slot``
  __device__ __forceinline__ float4& ring_row(int n, int slot) const {
    return ring[((n & (kRing - 1)) * 2 + slot) * kThreads];
  }

  // The pendulum's Jacobian at (x_t, u_t) = xu and, in the cost build,
  // the cost's quadratisation there (H's diagonal, g), into step j of the
  // linearisation buffer's round ``half``: the operations of
  // pendulum_jacobian and huber_quad (the plain K3's order).
  __device__ __forceinline__ void form_lin(const float4 xu, int half,
                                           int j) const {
    if constexpr (kLinOff) {
      const float xt[NS] = {xu.x, xu.y, xu.z};
      float F[NS][NTAU];
      pendulum_jacobian<kDamped>(p, xt, xu.w, F);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        lin_row(half, j, i) = make_float4(F[i][0], F[i][1], F[i][2], F[i][3]);
      if constexpr (kHuber) {
        const float tau[NTAU] = {xu.x, xu.y, xu.z, xu.w};
        float h[NTAU], gq[NTAU];
#pragma unroll
        for (int i = 0; i < NTAU; ++i)
          huber_quad(hc.w[i], hc.goal[i], hc.delta, tau[i], h[i], gq[i]);
        lin_row(half, j, NS) = make_float4(h[0], h[1], h[2], h[3]);
        lin_row(half, j, NS + 1) = make_float4(gq[0], gq[1], gq[2], gq[3]);
      }
    }
  }

  // step j of round ``half`` of the linearisation buffer into r.F (and
  // r.hq, r.gq), which the Riccati step reads as it reads a LinDx F
  __device__ __forceinline__ void load_lin(int half, int j, Rows& r) const {
    if constexpr (kLinOff) {
#pragma unroll
      for (int i = 0; i < NS; ++i) load4(&lin_row(half, j, i).x, r.F[i]);
      if constexpr (kHuber) {
        load4(&lin_row(half, j, NS).x, r.hq);
        load4(&lin_row(half, j, NS + 1).x, r.gq);
      }
    }
  }

  // the operands of step t; F and f are those of min(t, T - 2), the last
  // step having no successor
  __device__ __forceinline__ void load_rows(int t, Rows& r) const {
    if (!kHuber) {
      const float* Cp = C.at(t);
#pragma unroll
      for (int i = 0; i < NTAU; ++i) load4(Cp + 4 * i, r.C[i]);
      load4(c.at(t), r.c);
    }
    if (kLinDx && op.T > 1) {
      const int tf = t < op.T - 1 ? t : op.T - 2;
      const float* Fp = F.at(tf);
#pragma unroll
      for (int i = 0; i < NS; ++i) load4(Fp + 4 * i, r.F[i]);
      if (has_f) {
        const float* fp = f.at(tf);
#pragma unroll
        for (int i = 0; i < NS; ++i) r.f[i] = fp[i];
      }
    }
    if (kHasBounds) {
      r.lb = *lb.at(t);
      r.ub = *ub.at(t);
    }
    if constexpr (kHasUz) r.uz = *uz.at(t);
  }

  // an MLP's Jacobian of step t (t < T - 1) into r.F, which the Riccati
  // sweep reads as it reads a LinDx F; nothing for the other dynamics
  __device__ __forceinline__ void load_jac(int t, Rows& r) const {
    if (kNN && t < op.T - 1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 v = jac(t, i);
        r.F[i][0] = v.x;
        r.F[i][1] = v.y;
        r.F[i][2] = v.z;
        r.F[i][3] = v.w;
      }
    }
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

  // x_{t+1} from (x_t, u_t) in place
  __device__ __forceinline__ void step(const Rows& r, float* x, float u) const {
    float out[NS];
    if (kLinDx) {
      // the TPU kernel's LinDx branch (mpc_tpu/ops/fused.py:1369-1405):
      // F[i][j] tau[j] from j = 0 upwards, f[i] last
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float s = ((r.F[i][0] * x[0] + r.F[i][1] * x[1]) + r.F[i][2] * x[2]) +
                  r.F[i][3] * u;
        if (has_f) s += r.f[i];
        out[i] = s;
      }
    } else {
      pendulum_step<kDamped>(p, x, u, out);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = out[i];
  }

  // One step of the Riccati backward recursion with the 1-D box QP.  V, v
  // are those of step t + 1 on entry and of step t on return.
  __device__ __forceinline__ void riccati_step(int t, const Rows& r,
                                               const float4 xu,
                                               float V[NS][NS], float* v,
                                               float& qp_cnt,
                                               bool store) const {
    const float xt[NS] = {xu.x, xu.y, xu.z};
    const float ut = xu.w;
    const float tau[NTAU] = {xt[0], xt[1], xt[2], ut};
    // C_t and C_t tau_t + c_t; in the cost build diag(H) and g at tau_t
    // (the pendulum's from its linearisation rows)
    float Ct[NTAU][NTAU], cbv[NTAU];
    if constexpr (kHuber && kLinOff) {
#pragma unroll
      for (int i = 0; i < NTAU; ++i) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Ct[i][j] = 0.f;
        Ct[i][i] = r.hq[i];
        cbv[i] = r.gq[i];
      }
    } else if (kHuber) {
      hc.quad(tau, Ct, cbv);
    } else {
#pragma unroll
      for (int i = 0; i < NTAU; ++i) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Ct[i][j] = r.C[i][j];
        cbv[i] = (((r.C[i][0] * tau[0] + r.C[i][1] * tau[1]) +
                   r.C[i][2] * tau[2]) + r.C[i][3] * tau[3]) + r.c[i];
      }
    }
    float Qt[NTAU][NTAU], qt[NTAU];
    if (t == op.T - 1) {
#pragma unroll
      for (int i = 0; i < NTAU; ++i) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) Qt[i][j] = Ct[i][j];
        qt[i] = cbv[i];
      }
    } else {
      // LinDx's F, an MLP's or the pendulum's Jacobian rows
      float F[NS][NTAU];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NTAU; ++j) F[i][j] = r.F[i][j];
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
      // closed-form 1-D box QP (mpc_tpu/ops/fused.py:1516-1527) on the box
      // narrowed by the trust region (:1513-1515); the clamped test
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
      // a pinned control's k and K are zero (:1476-1481)
      const bool free = !kHasUz || r.uz < 0.5f;
      kt = free ? -qu * inv : 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) Kt[j] = free ? -Qt[3][j] * inv : 0.f;
    }
    if (store) state(t, kGain) = make_float4(Kt[0], Kt[1], Kt[2], kt);
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

  // A trial rollout's control at step t with step size alpha, from the
  // stored gains (_ctrl_from, mpc_tpu/ops/fused.py:1681-1695), with its
  // stage cost and step norm added to ``cost`` and ``du2``; both kernels'
  // trials take it.
  __device__ __forceinline__ float trial_control(int t, const Rows& r,
                                                 const float4 old,
                                                 const float4 Kk, float alpha,
                                                 const float* xt, float& cost,
                                                 float& du2) const {
    const float d0 = xt[0] - old.x;
    const float d1 = xt[1] - old.y;
    const float d2 = xt[2] - old.z;
    float ut = ((Kk.x * d0 + Kk.y * d1) + Kk.z * d2 + old.w) + alpha * Kk.w;
    // zeroed where pinned, before the clamp (_ctrl_from, :1686-1692)
    if (kHasUz && r.uz > 0.5f) ut = 0.f;
    if (kHasBounds)
      ut = clamp_box(ut, fmaxf(old.w - op.delta, r.lb),
                     fminf(old.w + op.delta, r.ub));
    const float sc = cost_at(r, xt, ut);
    cost = t == 0 ? sc : cost + sc;
    const float d = old.w - ut;
    du2 = t == 0 ? d * d : du2 + d * d;
    return ut;
  }

  // One step of a trial rollout: the control, the lane's slot, and
  // x <- x_{t+1}.
  __device__ __forceinline__ void trial_step(int t, const Rows& r,
                                             const float4 old, const float4 Kk,
                                             float alpha, int lane, float* xt,
                                             float& cost, float& du2) const {
    const float ut = trial_control(t, r, old, Kk, alpha, xt, cost, du2);
    trial(t, lane) = make_float4(xt[0], xt[1], xt[2], ut);
    if (t < op.T - 1) step(r, xt, ut);
  }
};

#if MPC_DYN != 2
// a 16-byte copy from global into shared memory, in flight until waited for
__device__ __forceinline__ void ring_copy(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most N of the thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The state rows a chain reads at every step, (x, u) and where Gain
// (K, k), at walk position n (step t): where the state is resident, read
// in place; past that, from the lane's ring, whose copies of position
// n + kAhead - 1 start when the chain first asks for position n (one
// commit group a position, the first kAhead at construction) and whose
// position n is then waited for.  A chain asks for positions in order,
// each at most one past the last (a repeat reads the same rows again).
template <bool Ring, bool Gain>
struct Feed {
  const Team& tm;
  int t0, dir;  // position n is step t0 + dir * n
  int pos;      // the last position waited for
  __device__ __forceinline__ Feed(const Team& team, int first, int step)
      : tm(team), t0(first), dir(step), pos(0) {
    if constexpr (Ring) {
#pragma unroll
      for (int n = 0; n < kAhead; ++n) issue(n);
      ring_wait<kAhead - 1>();
    }
  }
  __device__ __forceinline__ void issue(int n) const {
    if (n < tm.op.T) {
      const int t = t0 + dir * n;
      ring_copy(&tm.ring_row(n, kTraj), &tm.state(t, kTraj));
      if (Gain) ring_copy(&tm.ring_row(n, kGain), &tm.state(t, kGain));
    }
    ring_commit();
  }
  __device__ __forceinline__ void at(int n, int t, float4& xu, float4& kk) {
    if constexpr (Ring) {
      if (n > pos) {
        issue(n - 1 + kAhead);
        ring_wait<kAhead - 1>();
        pos = n;
      }
      xu = tm.ring_row(n, kTraj);
      if constexpr (Gain) kk = tm.ring_row(n, kGain);
    } else {
      xu = tm.state(t, kTraj);
      if constexpr (Gain) kk = tm.state(t, kGain);
    }
  }
};

// The team kernel, for LinDx and the pendulums; Ring: the state in the
// workspace, read through the lanes' rings (past residency).
template <bool Ring>
__global__ void __launch_bounds__(kThreads)
    fused_ilqr_long_kernel(const Operands op, const Schedule sched) {
  const cg::thread_block_tile<kTeam> tile =
      cg::tiled_partition<kTeam>(cg::this_thread_block());
  const int g = tile.thread_rank();
  const int b = blockIdx.x * kExamples + threadIdx.x / kTeam;
  const int B = op.B;
  const int T = op.T;
  // shared memory: the pendulum's linearisation buffers [kExamples,
  // kLinTeam], then where resident the state [T, 2, kExamples], else the
  // lanes' rings [kRing, 2, kThreads], then where it fits the block's copy
  // of the batch-shared operands [T, kOpRow], which the whole block fills
  // before any team leaves
  float4* const state_base = smem + kExamples * kLinTeam;
  float* const staged =
      op.staged ? reinterpret_cast<float*>(
                      state_base + (Ring ? 2 * kRing * kThreads
                                         : 2 * T * kExamples))
                : nullptr;
  if (staged != nullptr) {
    if (!kHuber && op.sCb == 0) stage<16>(op.C, op.sCt, T, staged + kOffC);
    if (!kHuber && op.scb == 0) stage<4>(op.c, op.sct, T, staged + kOffc);
    if (kLinDx && op.sFb == 0) stage<12>(op.F, op.sFt, T - 1, staged + kOffF);
    if (kLinDx && op.f != nullptr && op.sfb == 0)
      stage<3>(op.f, op.sft, T - 1, staged + kOfff);
    if (kHasBounds && op.sbb == 0) {
      stage<1>(op.lb, op.sbt, T, staged + kOffLb);
      stage<1>(op.ub, op.sbt, T, staged + kOffUb);
    }
    if (kHasUz && op.sub == 0) stage<1>(op.uz, op.sut, T, staged + kOffUz);
  }
  if (staged != nullptr) __syncthreads();
  if (b >= B) return;  // ragged tail: a whole team leaves together
  TeamClockOf<kK3Phases> clk;
  clk.start(op.clocks, b, g == 0);
  PendulumParams p{0.f, 0.f, 0.f, 0.f, 0.f};
  if (kPendulum) p = load_pendulum<kDamped>(op.params);
  Huber<NTAU> hc{};
  if (kHuber) hc = Huber<NTAU>::load(op.cost);
  // the lanes that roll out a trial, each into its slot of the workspace
  const int n_lanes = sched.n < kTeam ? sched.n : kTeam;
  const int e = threadIdx.x / kTeam;
  // the cost build forms no pointer into the absent C and c
  const Team tm{op,
                b,
                p,
                hc,
                kHuber ? Operand{nullptr, 0}
                       : operand(op.C, op.sCt, op.sCb, b, staged, kOffC),
                kHuber ? Operand{nullptr, 0}
                       : operand(op.c, op.sct, op.scb, b, staged, kOffc),
                operand(op.F, op.sFt, op.sFb, b, staged, kOffF),
                operand(op.f, op.sft, op.sfb, b, staged, kOfff),
                operand(op.lb, op.sbt, op.sbb, b, staged, kOffLb),
                operand(op.ub, op.sbt, op.sbb, b, staged, kOffUb),
                kHasUz ? operand(op.uz, op.sut, op.sub, b, staged, kOffUz)
                       : Operand{nullptr, 0},
                kLinDx && op.f != nullptr,
                Ring ? op.ws + n_lanes * B + b : state_base + e,
                Ring ? op.slots * B : 2 * kExamples,
                Ring ? B : kExamples,
                nullptr,
                0,
                false,
                nullptr,
                0,
                0,
                smem + e * kLinTeam,
                state_base + threadIdx.x};
  // the team's lanes within its warp, for the ballot of the line search
  const unsigned team_shift = (threadIdx.x & 31u) & ~(unsigned)(kTeam - 1);
  const unsigned team_mask = ((1u << kTeam) - 1u) << team_shift;

  float x0[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x0[i] = op.x0[b * NS + i];

  // ---- init: u <- u0, x <- rollout(u0) into the state and, as the best
  // trajectory, into the outputs; its cost.  u0 comes from device
  // memory, a round trip far longer than a rollout step: the team
  // fetches it in a pass parallel over t, kCopy steps of a lane in
  // flight together, not on the chain.  Then every lane walks the chain
  // (the cost is then in every lane), lane 0 stores. ------------------
  for (int t0 = g; t0 < T; t0 += kCopy * kTeam) {
    float u[kCopy];
#pragma unroll
    for (int k = 0; k < kCopy; ++k) {
      const int t = t0 + k * kTeam;
      if (t < T) u[k] = op.u0[t * B + b];
    }
#pragma unroll
    for (int k = 0; k < kCopy; ++k) {
      const int t = t0 + k * kTeam;
      if (t < T) tm.state(t, kTraj).w = u[k];
    }
  }
  tile.sync();
  float cost_cur = 0.f;
  {
    float xt[NS] = {x0[0], x0[1], x0[2]};
    Rows r, rn;
    tm.load_rows(0, r);
    float ut = tm.state(0, kTraj).w;
    for (int t = 0; t < T; ++t) {
      const int tn = t < T - 1 ? t + 1 : t;
      tm.load_rows(tn, rn);
      const float un = tm.state(tn, kTraj).w;
      if (g == 0) {
        const int o = t * B + b;
        tm.state(t, kTraj) = make_float4(xt[0], xt[1], xt[2], ut);
        op.u_out[o] = ut;
#pragma unroll
        for (int i = 0; i < NS; ++i) op.x_out[o * NS + i] = xt[i];
      }
      const float sc = tm.cost_at(r, xt, ut);
      cost_cur = t == 0 ? sc : cost_cur + sc;
      if (t < T - 1) tm.step(r, xt, ut);
      r = rn;
      ut = un;
    }
  }
  tile.sync();
  clk.mark(kK3Init);

  float best_cost = kBig, best_du = kBig;
  float nni = 0.f, n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;

  for (int it = 0; it < op.lqr_iter; ++it) {
    // ---- Riccati backward recursion, rows of step t - 1 in flight
    // while step t computes; two register sets in turns ----------------
    float qp_cnt = 0.f;
    {
      float V[NS][NS], v[NS];
      Rows ra, rb;
      float4 xa, xb, unused;
      Feed<Ring, false> feed(tm, T - 1, -1);
      if constexpr (kLinOff) {
        // the pendulum in rounds of kTeam steps: while the chain walks a
        // round's steps t0 .. t0 - kTeam + 1, lane g forms the next
        // round's step t0 - kTeam - g (clamped at 0, a row never read)
        // from (x, u) it loaded a round before; round 0's rows first
        tm.form_lin(tm.state(max(T - 1 - g, 0), kTraj), 0, g);
        // loaded after each use, into the same registers: no move waits
        // for the load
        float4 xl = tm.state(max(T - 1 - kTeam - g, 0), kTraj);
        tile.sync();
        clk.mark(kK3Jac);
        tm.load_rows(T - 1, ra);
        feed.at(0, T - 1, xa, unused);
        int half = 0;
        for (int t0 = T - 1; t0 >= 0; t0 -= kTeam, half ^= 1) {
          tm.form_lin(xl, half ^ 1, g);
          xl = tm.state(max(t0 - 2 * kTeam - g, 0), kTraj);
          tm.load_lin(half, 0, ra);
#pragma unroll
          for (int j = 0; j < kTeam; ++j) {
            const int t = t0 - j;
            if (t < 0) break;
            const int tn = t > 0 ? t - 1 : 0;
            tm.load_rows(tn, rb);
            feed.at(T - 1 - tn, tn, xb, unused);
            if (j + 1 < kTeam) tm.load_lin(half, j + 1, rb);
            tm.riccati_step(t, ra, xa, V, v, qp_cnt, g == 0);
            ra = rb;
            xa = xb;
          }
          tile.sync();  // the next round's rows are every lane's stores
        }
      } else {
        tm.load_rows(T - 1, ra);
        feed.at(0, T - 1, xa, unused);
        int t = T - 1;
        for (; t >= 1; t -= 2) {
          tm.load_rows(t - 1, rb);
          tm.load_jac(t - 1, rb);
          feed.at(T - t, t - 1, xb, unused);
          tm.riccati_step(t, ra, xa, V, v, qp_cnt, g == 0);
          const int t2 = t >= 2 ? t - 2 : 0;
          tm.load_rows(t2, ra);
          tm.load_jac(t2, ra);
          feed.at(T - 1 - t2, t2, xa, unused);
          tm.riccati_step(t - 1, rb, xb, V, v, qp_cnt, g == 0);
        }
        if (t == 0) tm.riccati_step(0, ra, xa, V, v, qp_cnt, g == 0);
      }
    }
    tile.sync();  // the gains are lane 0's stores
    clk.mark(kK3Sweep);

    // ---- line search across the lanes: lane g rolls out step size
    // base + g into its own slot; the first lane whose cost does not
    // exceed the current one is taken, else the next round, else the
    // last step size.  Round 0's lane 0 is alpha = 1 and gives the
    // full-step norm. --------------------------------------------------
    const float old_cost = cost_cur;
    float sel_cost = 0.f, sel_alpha = 1.f, full_du = 0.f;
    int sel_lane = 0, sel_index = 0;
    for (int base = 0; base < sched.n; base += kTeam) {
      const int ki = base + g;
      const bool runs = g < n_lanes && ki < sched.n;
      float cost_a = 0.f, du2 = 0.f;
      if (runs) {
        const float a = sched.a[ki];
        float xt[NS] = {x0[0], x0[1], x0[2]};
        Rows ra, rb;
        float4 oa, ob, ka, kb;
        Feed<Ring, true> feed(tm, 0, 1);
        tm.load_rows(0, ra);
        feed.at(0, 0, oa, ka);
        int t = 0;
        for (; t + 1 < T; t += 2) {
          tm.load_rows(t + 1, rb);
          feed.at(t + 1, t + 1, ob, kb);
          tm.trial_step(t, ra, oa, ka, a, g, xt, cost_a, du2);
          const int t2 = t + 2 < T ? t + 2 : T - 1;
          tm.load_rows(t2, ra);
          feed.at(t2, t2, oa, ka);
          tm.trial_step(t + 1, rb, ob, kb, a, g, xt, cost_a, du2);
        }
        if (t < T) tm.trial_step(t, ra, oa, ka, a, g, xt, cost_a, du2);
      }
      if (base == 0) full_du = sqrtf(tile.shfl(du2, 0));
      const unsigned passed =
          (__ballot_sync(team_mask, runs && cost_a <= old_cost) >> team_shift) &
          ((1u << kTeam) - 1u);
      const bool last = base + kTeam >= sched.n;
      if (passed != 0u || last) {
        sel_lane = passed != 0u ? __ffs(passed) - 1 : sched.n - 1 - base;
        sel_cost = tile.shfl(cost_a, sel_lane);
        sel_index = base + sel_lane;
        sel_alpha = sched.a[sel_index];
        break;
      }
    }
    n_trials += (float)(sel_index + 1);
    tile.sync();  // the winner's slot is another lane's stores
    clk.mark(kK3Trials);

    // ---- the team copies the winner's slot into the current trajectory
    // and, where it improved, into the outputs (the best one): lane g
    // takes steps g, g + kTeam, ..., kCopy of them in flight ------------
    const bool first = it == 0;
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    const bool take_best = first || improved;
    for (int t0 = g; t0 < T; t0 += kCopy * kTeam) {
      float4 rows[kCopy];
#pragma unroll
      for (int k = 0; k < kCopy; ++k) {
        const int t = t0 + k * kTeam;
        if (t < T) rows[k] = tm.trial(t, sel_lane);
      }
#pragma unroll
      for (int k = 0; k < kCopy; ++k) {
        const int t = t0 + k * kTeam;
        if (t < T) {
          tm.state(t, kTraj) = rows[k];
          if (take_best) {
            const int o = t * B + b;
            op.x_out[o * NS + 0] = rows[k].x;
            op.x_out[o * NS + 1] = rows[k].y;
            op.x_out[o * NS + 2] = rows[k].z;
            op.u_out[o] = rows[k].w;
          }
        }
      }
    }
    tile.sync();  // the current trajectory is every lane's stores

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
    clk.mark(kK3Copy);
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
  clk.mark(kK3Copy);
}

#endif  // MPC_DYN != 2

#if MPC_DYN == 2
// ---------------------------------------------------------------------------
// The MLP configuration: a warp an example
// ---------------------------------------------------------------------------

// an example's float4 slots a step: (K, k), the current (x, u), the
// Jacobian's three rows, the trial trajectory (ops/fused.py:NN_SLOTS)
constexpr int kJac = 2;
constexpr int kTrial = 5;
constexpr int kNNSlots = 6;
// blocks an SM at least (ops/fused.py:K3_NN_MIN_BLOCKS): 16 warps, so at
// most 128 registers a lane
constexpr int kMinBlocks = MPC_MIN_BLOCKS;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_ilqr_nn_kernel(const Operands op, const Schedule sched) {
  const int lane = threadIdx.x & 31;
  const int e = threadIdx.x >> 5;  // the warp's example within the block
  const int b = blockIdx.x * kWarps + e;
  const int B = op.B;
  const int T = op.T;
  // shared memory: the clocked build's counters (kK3ClockFloats a warp),
  // the MLP's weights (2 H + 1 float4), then where resident each warp's
  // example [T, kNNSlots] and the block's copy of the batch-shared
  // operands [T, kOpRow]; the whole block fills the weights and the copy
  // before any warp leaves
  PhaseClockOf<kK3Phases> clk;
  clk.start(reinterpret_cast<float*>(smem) + e * kK3ClockFloats);
  float4* const wts = smem + kWarps * kK3ClockFloats / 4;
  float4* const state_base = wts + 2 * op.nn_h + 1;
  float* const staged =
      op.resident
          ? reinterpret_cast<float*>(state_base + kWarps * T * kNNSlots)
          : nullptr;
  stage_nn_weights<kThreads>(op.params, op.nn_h, wts);
  if (staged != nullptr) {
    if (!kHuber && op.sCb == 0) stage<16>(op.C, op.sCt, T, staged + kOffC);
    if (!kHuber && op.scb == 0) stage<4>(op.c, op.sct, T, staged + kOffc);
    if (kHasBounds && op.sbb == 0) {
      stage<1>(op.lb, op.sbt, T, staged + kOffLb);
      stage<1>(op.ub, op.sbt, T, staged + kOffUb);
    }
    if (kHasUz && op.sub == 0) stage<1>(op.uz, op.sut, T, staged + kOffUz);
  }
  __syncthreads();
  if (b >= B) return;  // ragged tail: a whole warp leaves
  Huber<NTAU> hc{};
  if (kHuber) hc = Huber<NTAU>::load(op.cost);
  // the example's slots: the warp's rows of shared memory where resident,
  // else the workspace [T, kNNSlots, B]
  float4* const st = op.resident ? state_base + e * T * kNNSlots : op.ws + b;
  const int st_step = op.resident ? kNNSlots : op.slots * B;
  const int st_slot = op.resident ? 1 : B;
  // the cost build forms no pointer into the absent C and c
  const Team tm{op,
                b,
                PendulumParams{0.f, 0.f, 0.f, 0.f, 0.f},
                hc,
                kHuber ? Operand{nullptr, 0}
                       : operand(op.C, op.sCt, op.sCb, b, staged, kOffC),
                kHuber ? Operand{nullptr, 0}
                       : operand(op.c, op.sct, op.scb, b, staged, kOffc),
                Operand{nullptr, 0},
                Operand{nullptr, 0},
                operand(op.lb, op.sbt, op.sbb, b, staged, kOffLb),
                operand(op.ub, op.sbt, op.sbb, b, staged, kOffUb),
                kHasUz ? operand(op.uz, op.sut, op.sub, b, staged, kOffUz)
                       : Operand{nullptr, 0},
                false,
                st,
                st_step,
                st_slot,
                wts,
                op.nn_h,
                op.nn_pass != 0,
                st + kJac * st_slot,
                st_step,
                st_slot};

  float x0[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x0[i] = op.x0[b * NS + i];

  // ---- init: u <- u0 (fetched in a pass parallel over t, off the
  // chain), x <- rollout(u0) into the state and, as the best trajectory,
  // into the outputs; its cost in every lane, lane 0 stores -------------
  for (int t = lane; t < T; t += 32) tm.state(t, kTraj).w = op.u0[t * B + b];
  __syncwarp();
  float cost_cur = 0.f;
  {
    const Units un = load_units(wts, op.nn_h, lane);
    float xt[NS] = {x0[0], x0[1], x0[2]};
    for (int t = 0; t < T; ++t) {
      Rows r;
      tm.load_rows(t, r);
      const float ut = tm.state(t, kTraj).w;
      if (lane == 0) {
        const int o = t * B + b;
        tm.state(t, kTraj) = make_float4(xt[0], xt[1], xt[2], ut);
        op.u_out[o] = ut;
#pragma unroll
        for (int i = 0; i < NS; ++i) op.x_out[o * NS + i] = xt[i];
      }
      const float sc = tm.cost_at(r, xt, ut);
      cost_cur = t == 0 ? sc : cost_cur + sc;
      if (t < T - 1)
        nn_step_warp<MPC_ACT>(un, wts, op.nn_h, tm.pass, lane, xt, ut);
    }
  }
  __syncwarp();
  clk.mark(kK3Init);

  float best_cost = kBig, best_du = kBig;
  float nni = 0.f, n_qp = 0.f, alpha_sel = 1.f, n_it = 0.f, n_trials = 0.f;

  for (int it = 0; it < op.lqr_iter; ++it) {
    // ---- the Jacobians at the current trajectory, off the chains: lane
    // t takes step t (t, t + 32, ... past 33 steps), each a loop over
    // every unit with the weights read as broadcasts ----------------------
    for (int t = lane; t < T - 1; t += 32) {
      const float4 xu = tm.state(t, kTraj);
      const float xt[NS] = {xu.x, xu.y, xu.z};
      float J[NS][NTAU];
      nn_jacobian<MPC_ACT>(wts, op.nn_h, tm.pass, xt, xu.w, J);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        tm.jac(t, i) = make_float4(J[i][0], J[i][1], J[i][2], J[i][3]);
    }
    __syncwarp();  // the sweep reads every lane's rows
    clk.mark(kK3Jac);

    // ---- Riccati backward recursion in every lane, lane 0 stores -------
    float qp_cnt = 0.f;
    {
      float V[NS][NS], v[NS];
      for (int t = T - 1; t >= 0; --t) {
        Rows r;
        tm.load_rows(t, r);
        tm.load_jac(t, r);
        tm.riccati_step(t, r, tm.state(t, kTraj), V, v, qp_cnt, lane == 0);
      }
    }
    __syncwarp();  // the gains are lane 0's stores
    clk.mark(kK3Sweep);

    // ---- line search: the step sizes one after another; the first
    // whose cost does not exceed the current one is taken, else the last.
    // The first is alpha = 1 and gives the full-step norm.  Every lane
    // holds the trial's cost with the same bits. -------------------------
    const float old_cost = cost_cur;
    float sel_cost = 0.f, full_du = 0.f;
    int sel_index = 0;
    {
      const Units un = load_units(wts, op.nn_h, lane);
      for (int a = 0; a < sched.n; ++a) {
        const float alpha = sched.a[a];
        float xt[NS] = {x0[0], x0[1], x0[2]};
        float cost_a = 0.f, du2 = 0.f;
        for (int t = 0; t < T; ++t) {
          Rows r;
          tm.load_rows(t, r);
          const float ut = tm.trial_control(t, r, tm.state(t, kTraj),
                                            tm.state(t, kGain), alpha, xt,
                                            cost_a, du2);
          if (lane == 0)
            tm.state(t, kTrial) = make_float4(xt[0], xt[1], xt[2], ut);
          if (t < T - 1)
            nn_step_warp<MPC_ACT>(un, wts, op.nn_h, tm.pass, lane, xt, ut);
        }
        if (a == 0) full_du = sqrtf(du2);
        sel_cost = cost_a;
        sel_index = a;
        if (cost_a <= old_cost) break;
      }
    }
    const float sel_alpha = sched.a[sel_index];
    n_trials += (float)(sel_index + 1);
    __syncwarp();  // the trial slots are lane 0's stores
    clk.mark(kK3Trials);

    // ---- the selected trial becomes the current trajectory and, where
    // it improved, the outputs (the best one): lane t copies step t ------
    const bool first = it == 0;
    const bool improved = sel_cost <= best_cost + op.best_cost_eps;
    const bool take_best = first || improved;
    for (int t = lane; t < T; t += 32) {
      const float4 row = tm.state(t, kTrial);
      tm.state(t, kTraj) = row;
      if (take_best) {
        const int o = t * B + b;
        op.x_out[o * NS + 0] = row.x;
        op.x_out[o * NS + 1] = row.y;
        op.x_out[o * NS + 2] = row.z;
        op.u_out[o] = row.w;
      }
    }
    __syncwarp();  // the current trajectory is every lane's stores

    // ---- best tracking and per-example stopping (the same in every
    // lane) --------------------------------------------------------------
    nni = (improved && !first) ? 0.f : nni + 1.f;
    if (take_best) {
      best_cost = sel_cost;
      best_du = full_du;
    }
    cost_cur = sel_cost;
    n_qp += qp_cnt;
    alpha_sel = sel_alpha;
    n_it += 1.f;
    clk.mark(kK3Copy);
    if (!(full_du >= op.eps && nni <= op.not_improved_lim)) break;
  }

  if (lane == 0) {
    op.stats[0 * B + b] = best_cost;
    op.stats[1 * B + b] = best_du;
    op.stats[2 * B + b] = n_it;
    op.stats[3 * B + b] = n_qp;
    op.stats[4 * B + b] = alpha_sel;
    op.stats[5 * B + b] = n_trials;
  }
  clk.mark(kK3Copy);
  clk.write(op.clocks, b);
}
#endif  // MPC_DYN == 2

}  // namespace mpc

// Launches K3 on ``stream`` with the geometry of ops/fused.py:k3_launch,
// which is built with the same MPC_TEAM, MPC_WARPS, MPC_OP_ROW and
// MPC_RING; returns the cudaError_t of the launch, or of raising the
// kernel's shared-memory limit where that is needed.  ``ws`` is the
// [T, slots, B] float4 workspace.  Where ``resident``, the state is
// resident in shared memory (the MLP's with the block's copy of the
// batch-shared operands, the team kernel's with it where ``staged``):
// the team kernel's slots are then the trial slots, else the
// state lives in the two workspace slots after the trials' and is read
// through the lanes' rings; the MLP's slots are all resident (``ws`` may
// be null), else all in the workspace.  ``smem_bytes`` must be the
// layout's: the team kernel's linearisation buffers (the pendulum) and
// the state or the rings; the MLP's clocked build's counters
// (MPC_PHASE_CLOCKS, 4 MPC_WARPS kK3ClockFloats bytes) and its weights
// (16 (2 nn_h + 1)) first.  The clocked team kernel adds into ``clocks``
// [blocks * examples][kK3Phases] (zeroed), a row an example.
extern "C" int mpc_fused_ilqr_long(
    int B, int T, const float* params, int nn_h, int nn_pass,
    const float* cost, const float* F, long long sFt,
    long long sFb, const float* f, long long sft, long long sfb,
    const float* C, long long sCt, long long sCb, const float* c,
    long long sct, long long scb, const float* x0, const float* u0,
    const float* lb, const float* ub, long long sbt, long long sbb,
    const float* uz, long long sut, long long sub, float delta,
    const float* alphas, int n_alpha, int lqr_iter, float eps,
    float best_cost_eps, float not_improved_lim, float* ws, int slots,
    int smem_bytes, int resident, int staged, float* x_out, float* u_out,
    float* stats, long long* clocks, void* stream) {
  const int weight_bytes = mpc::kNN ? 16 * (2 * nn_h + 1) +
                                          4 * mpc::kWarps * mpc::kK3ClockFloats
                                    : 0;
  // the team kernel's layout, in bytes
  const long long team_bytes =
      16LL * (mpc::kExamples * mpc::kLinTeam +
              (resident ? 2LL * T * mpc::kExamples
                        : 2LL * mpc::kRing * mpc::kThreads)) +
      (staged ? 4LL * T * mpc::kOpRow : 0LL);
  if (B <= 0 || T <= 0 || n_alpha <= 0 || n_alpha > mpc::kMaxAlpha ||
      (clocks != nullptr) != mpc::kPhaseClocks ||
      (ws == nullptr && !(mpc::kNN && resident)) ||
      (mpc::kNN ? (nn_h <= 0 || smem_bytes < weight_bytes ||
                   (resident != 0) != (smem_bytes > weight_bytes))
                : smem_bytes != team_bytes) ||
      (mpc::kLinDx ? (F == nullptr && T > 1) : params == nullptr) ||
      (mpc::kHasBounds && (lb == nullptr || ub == nullptr)) ||
      (mpc::kHasUz != (uz != nullptr)) || !(delta > 0.f) ||
      (!mpc::kHasBounds && delta != INFINITY) ||
      (mpc::kHuber ? (cost == nullptr || C != nullptr || c != nullptr)
                   : (C == nullptr || c == nullptr)))
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory has to be asked for; the
  // library remembers the most it has asked for
#if MPC_DYN == 2
  const auto kernel = mpc::fused_ilqr_nn_kernel;
#else
  const auto kernel = resident ? mpc::fused_ilqr_long_kernel<false>
                               : mpc::fused_ilqr_long_kernel<true>;
#endif
  static int smem_allowed[2] = {48 * 1024, 48 * 1024};
  int& allowed = smem_allowed[resident ? 0 : 1];
  if (smem_bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = smem_bytes;
  }
  mpc::Schedule sched;
  for (int i = 0; i < n_alpha; ++i) sched.a[i] = alphas[i];
  sched.n = n_alpha;
  // 32-bit indices: the largest offset of each array
  const long long last = T - 1, lastb = B - 1, big = 1LL << 31;
  if (last * sCt + lastb * sCb + 16 >= big ||
      last * sct + lastb * scb + 4 >= big ||
      last * sFt + lastb * sFb + 12 >= big ||
      last * sft + lastb * sfb + 3 >= big ||
      last * sbt + lastb * sbb + 1 >= big ||
      last * sut + lastb * sub + 1 >= big ||
      4LL * T * (slots + 2) * B >= big)
    return (int)cudaErrorInvalidValue;
  mpc::Operands op;
  op.B = B;
  op.T = T;
  op.params = params;
  op.nn_h = nn_h;
  op.nn_pass = nn_pass;
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
  op.eps = eps;
  op.best_cost_eps = best_cost_eps;
  op.not_improved_lim = not_improved_lim;
  op.ws = reinterpret_cast<float4*>(ws);
  op.slots = slots;
  op.resident = resident != 0 ? 1 : 0;
  op.staged = staged != 0 ? 1 : 0;
  op.x_out = x_out;
  op.u_out = u_out;
  op.stats = stats;
  op.clocks = clocks;
  const int blocks = (B + mpc::kExamples - 1) / mpc::kExamples;
  kernel<<<blocks, mpc::kThreads, smem_bytes, (cudaStream_t)stream>>>(op,
                                                                      sched);
  return (int)cudaGetLastError();
}
