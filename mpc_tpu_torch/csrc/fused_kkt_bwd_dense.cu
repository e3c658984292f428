// The dense configuration of K2 and K4 for Hopper: the KKT backward of the
// converged box-constrained LQR of a problem of any n_state and n_ctrl
// with n_state + n_ctrl <= 32, a warp an example.
//
// Replaces the TPU kernels' general-size configurations:
// mpc_tpu/ops/fused_bwd.py:_make_bwd_kernel (lines 251-410, T unrolled)
// and _make_bwd_kernel_long (413-785, the passes as loops), with their
// helpers _bwd_ctrl_solve (162-198) and _bwd_vv_update (201-226).  The
// JAX package splits the two by an unroll volume and VMEM
// (_bwd_route_long, 130-136), limits of the TPU; here T is a run-time
// argument and one kernel takes every horizon.  Per example it computes
// the function of the eager fixed point (mpc_tpu_torch/ops/diff.py):
// the differential Riccati recursion on (C, -r) with the active controls
// pinned, the differential rollout from dx_0 = 0, the costate lam and
// the differential costate dlam, and the gradients
//   dC = -1/2 (dtau tau^T + tau dtau^T), dc = -dtau,
//   dF_t = -(dlam_{t+1} tau_t^T + lam_{t+1} dtau_t^T), df_t = -dlam_{t+1},
//   dx_init = -dlam_0.
//
// What bounds it on this card.  An example's work is the Riccati
// recursion's products, W = V F and Q = C + F^T W, ~3 n_state^2
// (n_state + n_ctrl) operations a step, and the gradients' outer
// products; at the medium imitation row (20 states, 4 controls, T=20,
// B=1024) ~0.9 M operations an example against ~4 MB in and out, so the
// bound is the card's float32 rate (fused_bwd_dense.k4d_flops,
// k4d_bytes).  The recursions are chains over t per example, so the
// card needs many examples in flight, only the three true recurrences
// belong on a chain, and a step costs the latency of its phases: the
// phase account (MPC_PHASE_CLOCKS; PERF.md section 6) put the
// products at 38% of the chains' cycles at 20s4c and the control
// block's factor at 42% at 4s12c.
//
// What the design does about it.
//
// - THE CHAINS, ONE WARP AN EXAMPLE (kkt_bwd_dense_chains), the dense
//   forward's Riccati step (riccati_dense.cuh, the same code): W = V F
//   and Q's upper triangle as register tiles, the next step's C and F in
//   flight by cp.async where a second set of tiles pays
//   (fused_bwd_dense.bwd_dense_prefetch), the cost-to-go a row a lane.
//   The control solve of a step runs in every lane on registers with the
//   same bits (box_qp.cuh's cholesky, chol_solve and masked_free_chol) up
//   to kRegCtrlMax = 8 controls (lane j column j of the gains), past that
//   across the lanes (box_qp_smem.cuh: Quu read in place from Q's tile,
//   lane i row i of the right-looking factor and of the gains' solves,
//   all n_state + 1 right-hand sides at once).  Up to 4 controls a build
//   keeps to 128 registers a lane (4 blocks an SM).  Then the
//   differential rollout (lane i state i, the controls on lanes
//   n_state..) and the costates lam and dlam (lane i row i), the second
//   beside the first.  The gains, dtau, lam and dlam of each step go to a
//   workspace in global memory (written and read by the same warp; a
//   warp's tiles hold one step, and T steps of a 24-state example would
//   not fit).
// - THE GRADIENTS, A PASS PARALLEL OVER t (kkt_bwd_dense_grads): a block
//   for each step and chunk of K4D_CHUNK examples copies the chunk's
//   tau, dtau, lam' and dlam' to shared memory and writes every
//   per-example gradient of a batched leaf, a thread an entry, neighbours
//   on neighbouring addresses.  For a batch-shared leaf a thread sums its
//   entry over the chunk's examples in order into a partial sum, and
//   kkt_bwd_dense_sums sums the chunks in order: a fixed order, no
//   atomics, so two launches give the same bits, and no [T, B, ntau,
//   ntau] tensor is written.
//
// The arithmetic of every scalar is the TPU kernel's, in its order (dot
// products from the first term on, _bwd_vv_update's sums left to right,
// lam = (C_xx x + C_xu u) + c), which the plain PyTorch version
// mpc_tpu_torch/ops/fused_bwd_dense.py:fused_kkt_backward_dense_plain
// follows; only the batch sums take another order.  Built without
// --use_fast_math; nvcc's FMA contraction is the only other arithmetic
// difference.  float32, on the CUDA cores: no tensor cores, so no TF32.
//
// n_state, n_ctrl, the active set and f are compile-time (MPC_NS, MPC_NC,
// MPC_HAS_I, MPC_HAS_F), so the small loops unroll and no load goes
// through the pointer of an absent operand; every lane-indexed address
// is computed from a lane clamped into its array (lt, lx, lu), since the
// compiler may hoist a load above its guard.  T and the layouts (C, c, F
// shared or per example: batch stride 0 or not; f shared or not) are
// run-time arguments.

#include <cuda_runtime.h>

#include "box_qp.cuh"
#include "box_qp_smem.cuh"
#include "phase_clock.cuh"
#include "riccati_dense.cuh"

#if !defined(MPC_NS) || !defined(MPC_NC) || !defined(MPC_HAS_I) || \
    !defined(MPC_HAS_F) || !defined(MPC_WARPS) || !defined(MPC_CHUNK) || \
    !defined(MPC_GRAD_THREADS)
#error "compile with -DMPC_NS, -DMPC_NC, -DMPC_HAS_I, -DMPC_HAS_F, -DMPC_WARPS, -DMPC_CHUNK, -DMPC_GRAD_THREADS"
#endif

namespace mpc {

constexpr int kNS = MPC_NS;
constexpr int kNC = MPC_NC;
constexpr int kNT = kNS + kNC;
constexpr bool kHasI = MPC_HAS_I != 0;
constexpr bool kHasF = MPC_HAS_F != 0;
constexpr int kWarps = MPC_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = MPC_CHUNK;
constexpr int kGradThreads = MPC_GRAD_THREADS;
static_assert(kNS >= 1 && kNC >= 1 && kNT <= 32,
              "a warp an example: n_state + n_ctrl <= 32");

// 1: the prefetching layout (a second set of C and F tiles, the rows of
// F, W and V 16-byte aligned); 0: one set, the lane-a-row design's
// strides (fused_bwd_dense.bwd_dense_kernel_defines decides, as the
// forward's host does)
#ifndef MPC_PREFETCH
#define MPC_PREFETCH 0
#endif
constexpr bool kPrefetch = MPC_PREFETCH != 0;
constexpr int kBufs = kPrefetch ? 2 : 1;
// a warp's tiles (floats), riccati_dense.cuh's strides, the aligned tiles
// first
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
constexpr int oQv = oQ + kBufs * kQT;       // q               [kNT]
constexpr int oTau = oQv + kNT;             // tau_t           [kNT]
constexpr int oDt = oTau + kNT;             // dtau_t          [kNT]
constexpr int oVv = oDt + kNT;              // v               [kNS]
constexpr int oLam = oVv + kNS;             // lam_{t+1}       [kNS]
constexpr int oDl = oLam + kNS;             // dlam_{t+1}      [kNS]
constexpr int oK = oDl + kNS;               // K_t             [kNC][kNS]
constexpr int oKQ = oK + kNC * kNS;         // Quu K_t         [kNC][kNS]
constexpr int oKk = oKQ + kNC * kNS;        // k_t             [kNC]
// past kRegCtrlMax controls the factor of the control block in the
// warp's tiles (box_qp_smem.cuh)
constexpr bool kSmemCtrl = kNC > kRegCtrlMax;
constexpr int kSL = odd_stride(kNC);
constexpr int oL = oKk + kNC;               // L               [kNC][kSL]
constexpr int oLi = oL + kNC * kSL;         // 1 / L_kk        [kNC]
constexpr int kCtrlFloats = kSmemCtrl ? kNC * kSL + kNC : 0;
// the phase account's counters (phase_clock.cuh; none but in its build)
constexpr int oClk = (oKk + kNC + kCtrlFloats + 3) / 4 * 4;
constexpr int kWarpFloats = oClk + kClockFloats;
// the gains of a step in the workspace: K (kNC x kNS), then k
constexpr int kGain = kNC * (kNS + 1);
// a gradient block's copy of its chunk: tau, dtau [kChunk][kNT], then
// lam', dlam' [kChunk][kNS]
constexpr int kGradFloats = kChunk * (2 * kNT + 2 * kNS);
// the entries of a step's partial sums: dC then dc; dF then df
constexpr int kCC = kNT * kNT;
constexpr int kCostRow = kCC + kNT;
constexpr int kDynRow = kNS * kNT + kNS;

struct Operands {
  int B, T;
  const float* C;
  int sCt, sCb;
  const float* c;
  int sct, scb;
  const float* F;
  int sFt, sFb;
  const float* xs;   // [T][B][kNS]
  const float* us;   // [T][B][kNC]
  const float* gx;   // dl_dx [T][B][kNS]
  const float* gu;   // dl_du [T][B][kNC]
  const float* I;    // [T][B][kNC], 1.0 = pinned (MPC_HAS_I)
  int f_shared;
  float* gains;      // [B][T][kGain]
  float* dtau;       // [T][B][kNT]
  float* lam;        // [T][B][kNS]
  float* dlam;       // [T][B][kNS]
  float* dxi;        // [B][kNS]
  float* dC;
  float* dc;
  float* dF;
  float* df;
  float* part_cost;  // [chunks][T][kCostRow] where C or c is shared
  float* part_dyn;   // [chunks][T-1][kDynRow] where F or f is shared
  int chunks;
  long long* clocks; // [B][kPhases]: MPC_PHASE_CLOCKS only
};

// Up to 16 controls a warp's work is held to 128 registers a lane, so
// that four blocks of 128 threads share an SM (B = 2048, 512 blocks, then
// runs in one wave on 132 SMs; at three blocks an SM a second wave of 116
// blocks costs more than the few spilled registers); the corners past it
// take what their solve needs.
constexpr int kMinBlocks = kNC <= 16 ? 4 : 1;

// Step t's C_t and F_t (t < T - 1) into its set of tiles (t % kBufs): in
// flight with Async (the next step's while this one runs), else read now.
template <bool Async>
__device__ __forceinline__ void stage_step(const Operands& op,
                                           const float* Cb, const float* Fb,
                                           float* sh, int t, int T, int lane) {
  const int buf = kPrefetch ? (t & 1) : 0;
  stage_tile<kNT, kNT, kSQ, Async, true>(sh + oQ + buf * kQT,
                                         Cb + t * op.sCt, lane);
  if (t < T - 1)
    stage_tile<kNS, kNT, kSF, Async, true>(sh + oF + buf * kFT,
                                           Fb + t * op.sFt, lane);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    kkt_bwd_dense_chains(const Operands op) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  // the lane clamped into a tau row, a state row and a control
  const int lt = lane < kNT ? lane : kNT - 1;
  const int lx = lane < kNS ? lane : kNS - 1;
  const int lu = lane < kNS ? 0 : lt - kNS;
  // the lane clamped into a control (the control solve's mask)
  const int lc = lane < kNC ? lane : kNC - 1;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= op.B) return;  // the whole warp: nothing below syncs the block
  const int T = op.T, B = op.B;
  float* sh = smem + (threadIdx.x >> 5) * kWarpFloats;
  PhaseClock clk;
  clk.start(sh + oClk);
  float* const Ws = sh + oW;
  float* const Vs = sh + oV;
  float* qv = sh + oQv;
  float* taus = sh + oTau;
  float* dts = sh + oDt;
  float* vv = sh + oVv;
  float* lams = sh + oLam;
  float* dls = sh + oDl;
  float* Ks = sh + oK;
  float* KQs = sh + oKQ;
  float* ks = sh + oKk;
  float* const gains = op.gains + b * T * kGain;
  const float* Cb = op.C + b * op.sCb;
  const float* cb = op.c + b * op.scb;
  const float* Fb = op.F + b * op.sFb;

  // ---- the differential Riccati recursion on (C, -r), t = T-1 .. 0 -----
  if constexpr (kPrefetch) {
    stage_step<true>(op, Cb, Fb, sh, T - 1, T, lane);
    cp_async_commit();
  }
  for (int t = T - 1; t >= 0; --t) {
    const int buf = kPrefetch ? (t & 1) : 0;
    float* const Qs = sh + oQ + buf * kQT;
    const float* const Fs = sh + oF + buf * kFT;
    if constexpr (kPrefetch)
      cp_async_wait_all();
    else
      stage_step<false>(op, Cb, Fb, sh, t, T, lane);
    const bool last = t == T - 1;
    // -r_t, this lane's row
    const int tb = t * B + b;
    const float mr = lane < kNS ? -__ldg(op.gx + tb * kNS + lx)
                                : -__ldg(op.gu + tb * kNC + lu);
    __syncwarp();
    if constexpr (kPrefetch) {
      if (t > 0) stage_step<true>(op, Cb, Fb, sh, t - 1, T, lane);
      cp_async_commit();
    }
    clk.mark(kPhStage);
    if (last) {
      if (lane < kNT) qv[lane] = mr;
    } else {
      products_W<kNS, kNT, kSV, kSF, kSW, kPrefetch>(Vs, Fs, Ws, lane);
      clk.mark(kPhW);
      // Q = C_t + F_t^T W; q = -r_t + F_t^T v
      products_Q<kNS, kNT, kSF, kSW, kSQ, kPrefetch>(Fs, Ws, Qs, lane);
      if (lane < kNT) qv[lane] = q_entry<kNS, kSF>(Fs, vv, mr, lt);
    }
    __syncwarp();
    clk.mark(kPhQ);

    if constexpr (kSmemCtrl) {
      // ---- the control solve across the lanes (box_qp_smem.cuh): Quu
      // read in place from Q's tile, the pinned controls' rows and
      // columns masked out of the factor (no jitter), else a 1e-11
      // jitter; lane i row i of K and k
      float* Ls = sh + oL;
      float* Li = sh + oLi;
      const float* Quu = Qs + kNS * kSQ + kNS;
      const float* qu = qv + kNS;
      unsigned fr = (1u << kNC) - 1u;
      if constexpr (kHasI)
        fr = __ballot_sync(0xffffffffu,
                           lane < kNC && __ldg(op.I + tb * kNC + lc) < 0.5f);
      factor_lanes<kNC>(Quu, kSQ, kHasI, fr, kHasI ? 0.f : 1e-11f, Ls, kSL,
                        Li, lane);
      clk.mark(kPhFactor);
      const bool fi = (fr >> lc) & 1u;
      float rhs[kNS + 1];
#pragma unroll
      for (int r = 0; r < kNS; ++r)
        rhs[r] = fi ? Qs[(kNS + lc) * kSQ + r] : 0.f;
      rhs[kNS] = fi ? qu[lc] : 0.f;
      solve_lanes<kNC, kNS + 1>(Ls, kSL, Li, rhs, lane);
      if (lane < kNC) {
        float* gK = gains + t * kGain;
#pragma unroll
        for (int r = 0; r < kNS; ++r) {
          Ks[lane * kNS + r] = -rhs[r];
          gK[lane * kNS + r] = -rhs[r];
        }
        ks[lane] = -rhs[kNS];
        gK[kNC * kNS + lane] = -rhs[kNS];
      }
      __syncwarp();
      clk.mark(kPhGains);
      const float none2[1][1] = {{0.f}}, none1[1] = {0.f};
      cost_to_go<kNS, kNC, kSQ, kSV, false>(Qs, qv, Ks, KQs, ks, none2, none1,
                                            none1, Vs, vv, lane);
      clk.mark(kPhCostToGo);
    } else {
      // ---- the control solve (every lane on the same registers) --------
      float Quu[kNC][kNC], qu[kNC], kt[kNC], qx[kNC], Kcol[kNC];
  #pragma unroll
      for (int i = 0; i < kNC; ++i) {
        qu[i] = qv[kNS + i];
  #pragma unroll
        for (int j = 0; j < kNC; ++j) Quu[i][j] = Qs[(kNS + i) * kSQ + kNS + j];
        // lane j's column of Qux
        qx[i] = lane < kNS ? Qs[(kNS + i) * kSQ + lx] : 0.f;
      }
      if constexpr (kHasI) {
        bool fr[kNC];
  #pragma unroll
        for (int i = 0; i < kNC; ++i) fr[i] = __ldg(op.I + tb * kNC + i) < 0.5f;
        if constexpr (kNC == 1) {
          const float inv = 1.f / Quu[0][0];
          kt[0] = fr[0] ? -qu[0] * inv : 0.f;
          Kcol[0] = fr[0] ? -qx[0] * inv : 0.f;
        } else {
          float L[kNC][kNC], rhs[kNC], sol[kNC];
          masked_free_chol<kNC>(Quu, fr, L);
          clk.mark(kPhFactor);
  #pragma unroll
          for (int i = 0; i < kNC; ++i) rhs[i] = fr[i] ? qu[i] : 0.f;
          chol_solve<kNC>(L, rhs, sol);
  #pragma unroll
          for (int i = 0; i < kNC; ++i) {
            kt[i] = -sol[i];
            rhs[i] = fr[i] ? qx[i] : 0.f;
          }
          chol_solve<kNC>(L, rhs, sol);
  #pragma unroll
          for (int i = 0; i < kNC; ++i) Kcol[i] = -sol[i];
        }
      } else if constexpr (kNC == 1) {
        const float inv = 1.f / Quu[0][0];
        kt[0] = -qu[0] * inv;
        Kcol[0] = -qx[0] * inv;
      } else {
        float L[kNC][kNC], sol[kNC];
        cholesky<kNC>(Quu, 1e-11f, L);
        clk.mark(kPhFactor);
        chol_solve<kNC>(L, qu, sol);
  #pragma unroll
        for (int i = 0; i < kNC; ++i) kt[i] = -sol[i];
        chol_solve<kNC>(L, qx, sol);
  #pragma unroll
        for (int i = 0; i < kNC; ++i) Kcol[i] = -sol[i];
      }
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

      cost_to_go<kNS, kNC, kSQ, kSV, true>(Qs, qv, Ks, KQs, ks, Quu, qu, kt,
                                           Vs, vv, lane);
      clk.mark(kPhCostToGo);
    }
  }

  // ---- the differential rollout from dx_0 = 0 -------------------------
  {
    float dxr = 0.f;  // lane i < kNS: dx_t[i]
    for (int t = 0; t < T; ++t) {
      if (lane < kNS) dts[lane] = dxr;
      __syncwarp();
      if (lane >= kNS && lane < kNT) {
        const float* Kr = gains + t * kGain + lu * kNS;
        float s = Kr[0] * dts[0];
#pragma unroll
        for (int j = 1; j < kNS; ++j) s = s + Kr[j] * dts[j];
        float du = s + gains[t * kGain + kNC * kNS + lu];
        if constexpr (kHasI)
          du = __ldg(op.I + (t * B + b) * kNC + lu) > 0.5f ? 0.f : du;
        dts[lane] = du;
      }
      __syncwarp();
      if (lane < kNT) op.dtau[(t * B + b) * kNT + lane] = dts[lt];
      if (t < T - 1 && lane < kNS) {
        const float* row = Fb + t * op.sFt + lx * kNT;
        float s = __ldg(row) * dts[0];
#pragma unroll
        for (int j = 1; j < kNT; ++j) s = s + __ldg(row + j) * dts[j];
        dxr = s;
      }
      __syncwarp();
    }
  }

  // ---- the costates lam and dlam, t = T-1 .. 0 -------------------------
  float dlam = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const int tb = t * B + b;
    if (lane < kNT) {
      taus[lane] = lane < kNS ? __ldg(op.xs + tb * kNS + lx)
                              : __ldg(op.us + tb * kNC + lu);
      // this lane's own entry of dtau_t, written in the rollout
      dts[lane] = op.dtau[tb * kNT + lt];
    }
    __syncwarp();
    float lam = 0.f;
    if (lane < kNS) {
      const float* row = Cb + t * op.sCt + lx * kNT;
      float sx = __ldg(row) * taus[0];
      float sd = __ldg(row) * dts[0];
#pragma unroll
      for (int j = 1; j < kNS; ++j) {
        sx = sx + __ldg(row + j) * taus[j];
        sd = sd + __ldg(row + j) * dts[j];
      }
      float ux = __ldg(row + kNS) * taus[kNS];
      float ud = __ldg(row + kNS) * dts[kNS];
#pragma unroll
      for (int m = 1; m < kNC; ++m) {
        ux = ux + __ldg(row + kNS + m) * taus[kNS + m];
        ud = ud + __ldg(row + kNS + m) * dts[kNS + m];
      }
      lam = (sx + ux) + __ldg(cb + t * op.sct + lx);
      dlam = (sd + ud) - __ldg(op.gx + tb * kNS + lx);
      if (t < T - 1) {
        const float* Ft = Fb + t * op.sFt;
        float s1 = __ldg(Ft + lx) * lams[0];
        float s2 = __ldg(Ft + lx) * dls[0];
#pragma unroll
        for (int k = 1; k < kNS; ++k) {
          s1 = s1 + __ldg(Ft + k * kNT + lx) * lams[k];
          s2 = s2 + __ldg(Ft + k * kNT + lx) * dls[k];
        }
        lam = lam + s1;
        dlam = dlam + s2;
      }
    }
    __syncwarp();
    if (lane < kNS) {
      lams[lane] = lam;
      dls[lane] = dlam;
      op.lam[tb * kNS + lane] = lam;
      op.dlam[tb * kNS + lane] = dlam;
    }
    __syncwarp();
  }
  if (lane < kNS) op.dxi[b * kNS + lane] = -dlam;
  clk.mark(kPhRollout);
  clk.write(op.clocks, b);
}

// the gradients of step t (blockIdx.x) for the chunk blockIdx.y
__global__ void __launch_bounds__(kGradThreads)
    kkt_bwd_dense_grads(const Operands op) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, chunk = blockIdx.y;
  const int T = op.T, B = op.B;
  const int b0 = chunk * kChunk;
  const int nb = B - b0 < kChunk ? B - b0 : kChunk;
  const bool link = t < T - 1;
  float* tau_s = smem;                     // [kChunk][kNT]
  float* dt_s = tau_s + kChunk * kNT;      // [kChunk][kNT]
  float* ln_s = dt_s + kChunk * kNT;       // lam_{t+1} [kChunk][kNS]
  float* dn_s = ln_s + kChunk * kNS;       // dlam_{t+1} [kChunk][kNS]
  for (int e = threadIdx.x; e < nb * kNT; e += kGradThreads) {
    const int bb = e / kNT, a = e % kNT;
    const int tb = t * B + b0 + bb;
    tau_s[e] = a < kNS ? op.xs[tb * kNS + a] : op.us[tb * kNC + a - kNS];
    dt_s[e] = op.dtau[(t * B + b0) * kNT + e];
  }
  if (link) {
    for (int e = threadIdx.x; e < nb * kNS; e += kGradThreads) {
      ln_s[e] = op.lam[((t + 1) * B + b0) * kNS + e];
      dn_s[e] = op.dlam[((t + 1) * B + b0) * kNS + e];
    }
  }
  __syncthreads();

  // dC_t and dc_t: a thread an entry; a shared leaf's sums over the
  // chunk go to its partial sums, pc (allocated where C or c is shared)
  const int pcost = (chunk * T + t) * kCostRow;
  if (op.sCb == 0) {
    float* pc = op.part_cost + pcost;
    for (int e = threadIdx.x; e < kCC; e += kGradThreads) {
      const int i = e / kNT, j = e % kNT;
      float acc = 0.f;
      for (int bb = 0; bb < nb; ++bb) {
        const float* tv = tau_s + bb * kNT;
        const float* dv = dt_s + bb * kNT;
        const float g = -0.5f * (dv[i] * tv[j] + tv[i] * dv[j]);
        acc = bb == 0 ? g : acc + g;
      }
      pc[e] = acc;
    }
  } else {
    float* out = op.dC + (t * B + b0) * kCC;
    for (int e = threadIdx.x; e < nb * kCC; e += kGradThreads) {
      const int bb = e / kCC, ij = e % kCC, i = ij / kNT, j = ij % kNT;
      const float* tv = tau_s + bb * kNT;
      const float* dv = dt_s + bb * kNT;
      out[e] = -0.5f * (dv[i] * tv[j] + tv[i] * dv[j]);
    }
  }
  if (op.scb == 0) {
    float* pc = op.part_cost + pcost;
    for (int i = threadIdx.x; i < kNT; i += kGradThreads) {
      float acc = 0.f;
      for (int bb = 0; bb < nb; ++bb) {
        const float g = -dt_s[bb * kNT + i];
        acc = bb == 0 ? g : acc + g;
      }
      pc[kCC + i] = acc;
    }
  } else {
    float* out = op.dc + (t * B + b0) * kNT;
    for (int e = threadIdx.x; e < nb * kNT; e += kGradThreads)
      out[e] = -dt_s[e];
  }
  if (!link) return;

  // dF_t and df_t from lam_{t+1}, dlam_{t+1}
  constexpr int kFF = kNS * kNT;
  const int pdyn = (chunk * (T - 1) + t) * kDynRow;
  if (op.sFb == 0) {
    float* pd = op.part_dyn + pdyn;
    for (int e = threadIdx.x; e < kFF; e += kGradThreads) {
      const int i = e / kNT, j = e % kNT;
      float acc = 0.f;
      for (int bb = 0; bb < nb; ++bb) {
        const float g = -(dn_s[bb * kNS + i] * tau_s[bb * kNT + j] +
                          ln_s[bb * kNS + i] * dt_s[bb * kNT + j]);
        acc = bb == 0 ? g : acc + g;
      }
      pd[e] = acc;
    }
  } else {
    float* out = op.dF + (t * B + b0) * kFF;
    for (int e = threadIdx.x; e < nb * kFF; e += kGradThreads) {
      const int bb = e / kFF, ij = e % kFF, i = ij / kNT, j = ij % kNT;
      out[e] = -(dn_s[bb * kNS + i] * tau_s[bb * kNT + j] +
                 ln_s[bb * kNS + i] * dt_s[bb * kNT + j]);
    }
  }
  if constexpr (kHasF) {
    if (op.f_shared) {
      float* pd = op.part_dyn + pdyn;
      for (int i = threadIdx.x; i < kNS; i += kGradThreads) {
        float acc = 0.f;
        for (int bb = 0; bb < nb; ++bb) {
          const float g = -dn_s[bb * kNS + i];
          acc = bb == 0 ? g : acc + g;
        }
        pd[kFF + i] = acc;
      }
    } else {
      float* out = op.df + (t * B + b0) * kNS;
      for (int e = threadIdx.x; e < nb * kNS; e += kGradThreads)
        out[e] = -dn_s[e];
    }
  }
}

// the shared leaves' gradients: the chunks' partial sums in chunk order
__global__ void kkt_bwd_dense_sums(const Operands op) {
  const int T = op.T;
  const int n_cost = T * kCostRow, n_dyn = (T - 1) * kDynRow;
  const bool cost = op.part_cost != nullptr, dyn = op.part_dyn != nullptr;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_cost + n_dyn;
       e += gridDim.x * blockDim.x) {
    if (e < n_cost) {
      if (!cost) continue;
      const int t = e / kCostRow, k = e % kCostRow;
      if (k < kCC ? op.sCb != 0 : op.scb != 0) continue;
      float acc = op.part_cost[e];
      for (int ch = 1; ch < op.chunks; ++ch)
        acc = acc + op.part_cost[ch * n_cost + e];
      if (k < kCC)
        op.dC[t * kCC + k] = acc;
      else
        op.dc[t * kNT + k - kCC] = acc;
    } else {
      if (!dyn) continue;
      const int d = e - n_cost;
      const int t = d / kDynRow, k = d % kDynRow;
      const bool is_f = k >= kNS * kNT;
      if (is_f ? !(kHasF && op.f_shared) : op.sFb != 0) continue;
      float acc = op.part_dyn[d];
      for (int ch = 1; ch < op.chunks; ++ch)
        acc = acc + op.part_dyn[ch * n_dyn + d];
      if (is_f)
        op.df[t * kNS + k - kNS * kNT] = acc;
      else
        op.dF[t * kNS * kNT + k] = acc;
    }
  }
}

}  // namespace mpc

extern "C" int mpc_fused_kkt_bwd_dense(
    int B, int T, const float* C, long long sCt, long long sCb,
    const float* c, long long sct, long long scb, const float* F,
    long long sFt, long long sFb, const float* xs, const float* us,
    const float* gx, const float* gu, const float* I, int f_shared,
    float* ws, int smem_bytes, int grad_smem_bytes, float* dxi, float* dC,
    float* dc, float* dF, float* df, float* part_cost, float* part_dyn,
    long long* clocks, int parts, void* stream) {
  using namespace mpc;
  const int chunks = B > 0 ? (B + kChunk - 1) / kChunk : 0;
  const bool cost_red = sCb == 0 || scb == 0;
  const bool dyn_red = T > 1 && (sFb == 0 || (kHasF && f_shared));
  if (B <= 0 || T <= 0 || ws == nullptr || C == nullptr || c == nullptr ||
      xs == nullptr || us == nullptr || gx == nullptr || gu == nullptr ||
      dxi == nullptr || dC == nullptr || dc == nullptr ||
      (T > 1 && (F == nullptr || dF == nullptr)) ||
      (kHasF && T > 1 && df == nullptr) || (I != nullptr) != kHasI ||
      (cost_red && part_cost == nullptr) ||
      (dyn_red && part_dyn == nullptr) ||
      smem_bytes != kWarps * kWarpFloats * (int)sizeof(float) ||
      grad_smem_bytes != kGradFloats * (int)sizeof(float) ||
      grad_smem_bytes > 48 * 1024 || chunks > 65535 ||
      (clocks != nullptr) != kPhaseClocks || parts < 1 || parts > 7 ||
      (!kPhaseClocks && parts != 7))
    return (int)cudaErrorInvalidValue;
  // 32-bit indices: the largest offset of each array
  const long long last = T - 1, lastb = B - 1, big = 1LL << 31;
  const long long TB = (long long)T * B;
  if (last * sCt + lastb * sCb + kCC >= big ||
      last * sct + lastb * scb + kNT >= big ||
      last * sFt + lastb * sFb + kNS * kNT >= big ||
      TB * kCC >= big || TB * (kGain + kNT + 2 * kNS) >= big ||
      (long long)chunks * T * (kCostRow + kDynRow) >= big)
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory has to be asked for; the
  // library remembers the most it has asked for
  static int smem_allowed = 48 * 1024;
  if (smem_bytes > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kkt_bwd_dense_chains, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem_bytes;
  }
  Operands op;
  op.B = B;
  op.T = T;
  op.C = C;
  op.sCt = (int)sCt;
  op.sCb = (int)sCb;
  op.c = c;
  op.sct = (int)sct;
  op.scb = (int)scb;
  op.F = F;
  op.sFt = (int)sFt;
  op.sFb = (int)sFb;
  op.xs = xs;
  op.us = us;
  op.gx = gx;
  op.gu = gu;
  op.I = I;
  op.f_shared = f_shared;
  // the workspace: gains [B][T][kGain], dtau [T][B][kNT], lam and dlam
  // [T][B][kNS]
  op.gains = ws;
  op.dtau = op.gains + TB * kGain;
  op.lam = op.dtau + TB * kNT;
  op.dlam = op.lam + TB * kNS;
  op.dxi = dxi;
  op.dC = dC;
  op.dc = dc;
  op.dF = dF;
  op.df = df;
  op.part_cost = cost_red ? part_cost : nullptr;
  op.part_dyn = dyn_red ? part_dyn : nullptr;
  op.chunks = chunks;
  op.clocks = clocks;
  // ``parts`` (bits: 1 the chains, 2 the gradient pass, 4 the chunk-order
  // sums) is 7 but in the clocked build, whose account times the three
  // launches apart
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    kkt_bwd_dense_chains<<<(B + kWarps - 1) / kWarps, kThreads, smem_bytes,
                           s>>>(op);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    kkt_bwd_dense_grads<<<dim3(T, chunks), kGradThreads, grad_smem_bytes,
                          s>>>(op);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 4) && (cost_red || dyn_red)) {
    const int n = T * kCostRow + (T - 1) * kDynRow;
    int blocks = (n + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    kkt_bwd_dense_sums<<<blocks, 256, 0, s>>>(op);
    err = cudaGetLastError();
  }
  return (int)err;
}
