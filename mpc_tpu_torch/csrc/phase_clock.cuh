// The phase account of the dense kernels (fused_ilqr_dense.cu,
// fused_kkt_bwd_dense.cu and the control solves they include) and of K3
// (fused_ilqr_long.cu, its own phases: fused.K3_PHASES; TeamClockOf for
// its team kernel).
//
// THE PHASE ACCOUNT (MPC_PHASE_CLOCKS = 1, a build of its own that only
// mpc_tpu_torch/utils/phase_account.py launches): every lane reads
// clock() at the phase boundaries of its example and lane 0 adds each
// phase's cycles into kPhases counters in its warp's shared memory (32
// bits: a phase of a launch takes far fewer than 2^32 cycles), written at
// the end into clocks [B][kPhases] (int64).  The counters live in shared
// memory and not in registers, so that the clocked build keeps the
// registers (and the blocks an SM) of the build it measures.  Without the
// define PhaseClock is empty, kClockFloats is 0 and every mark()
// vanishes, so the builds the ops launch carry none of it.

#pragma once

#include <cuda_runtime.h>

#ifndef MPC_PHASE_CLOCKS
#define MPC_PHASE_CLOCKS 0
#endif

namespace mpc {

// The phases, in the order of the buffer's columns (the host reads them
// as fused_dense.PHASES): the Jacobian pass before a sweep (the MLP
// build's forward pass; its reverse product apart); staging the
// step's operands (C_t, c_t, F_t, tau_t, C_t tau + c_t); W = V F_t; Q =
// C_t + F_t^T W with q; the control solve's factor (an unbounded solve's,
// the unclamped start's and, past kRegCtrlMax controls, each QP trip's),
// its QP trips apart from their factors, and its gains' solves; the
// cost-to-go; the line search's trial rollouts (the backward: the
// differential rollout with the costates); the rest (the initial
// rollout, best tracking, the outputs).
enum Phase {
  kPhJac = 0,
  kPhJacRev,
  kPhStage,
  kPhW,
  kPhQ,
  kPhFactor,
  kPhQP,
  kPhGains,
  kPhCostToGo,
  kPhRollout,
  kPhOther,
  kPhases
};

constexpr bool kPhaseClocks = MPC_PHASE_CLOCKS != 0;
// the counters' floats at the end of a warp's tiles (a multiple of 4)
constexpr int kClockFloats = kPhaseClocks ? (kPhases + 3) / 4 * 4 : 0;

// mark(p) charges the cycles since the last mark to phase p, one of N.
template <int N>
struct PhaseClockOf {
  unsigned last;
  unsigned* acc;  // the warp's counters (lane 0 adds)
  __device__ __forceinline__ void start(float* counters) {
    if constexpr (kPhaseClocks) {
      acc = reinterpret_cast<unsigned*>(counters);
      if ((threadIdx.x & 31) == 0)
        for (int p = 0; p < N; ++p) acc[p] = 0u;
      last = static_cast<unsigned>(clock());
    }
  }
  __device__ __forceinline__ void mark(int p) {
    if constexpr (kPhaseClocks) {
      const unsigned now = static_cast<unsigned>(clock());
      if ((threadIdx.x & 31) == 0) acc[p] += now - last;
      last = now;
    }
  }
  // row ``b`` of clocks [rows][N]
  __device__ __forceinline__ void write(long long* clocks, int b) const {
    if constexpr (kPhaseClocks) {
      if ((threadIdx.x & 31) == 0 && clocks != nullptr)
        for (int p = 0; p < N; ++p)
          clocks[b * N + p] = static_cast<long long>(acc[p]);
    }
  }
};

using PhaseClock = PhaseClockOf<kPhases>;

// The account of K3's team kernel (fused_ilqr_long.cu, a team of lanes an
// example): the teams of a warp leave their loops apart, so each team's
// lane 0 adds each phase's cycles straight into its example's row of
// clocks [rows][N] in global memory (zeroed by the host), by a reduction
// it does not wait on.  No shared memory: the clocked build keeps the
// layout of the build it measures.
template <int N>
struct TeamClockOf {
  unsigned last;
  unsigned long long* row;  // lane 0's row of clocks, else null
  __device__ __forceinline__ void start(long long* clocks, int b, bool lead) {
    if constexpr (kPhaseClocks) {
      row = lead && clocks != nullptr
                ? reinterpret_cast<unsigned long long*>(clocks + b * N)
                : nullptr;
      last = static_cast<unsigned>(clock());
    }
  }
  __device__ __forceinline__ void mark(int p) {
    if constexpr (kPhaseClocks) {
      const unsigned now = static_cast<unsigned>(clock());
      if (row != nullptr)
        atomicAdd(row + p, static_cast<unsigned long long>(now - last));
      last = now;
    }
  }
};

}  // namespace mpc
