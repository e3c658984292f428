// Kernel K2 for Hopper: the KKT backward of the converged box-constrained
// LQR fixed point, with per-example dynamics and T known at compile time.
//
// Replaces the TPU kernel mpc_tpu/ops/fused_bwd.py:_make_bwd_kernel
// (lines 251-410, with _bwd_ctrl_solve's n_ctrl = 1 branches and
// _bwd_vv_update), which lays a tile of 1024 examples on the vector
// lanes and, for a batch-shared cost, accumulates the batch-reduced
// gradient in an SMEM block that stays resident across its sequential
// grid.  The kernel itself is kkt_bwd.cuh, shared with K4, here with
// T = MPC_T, the active set present or not (MPC_HAS_I) and dF, df per
// example (df zeros for an absent f).
//
// What bounds it on this card.  Per example and step the function must
// read F, r, x*, u* and the mask (~80 B) and write dF and df (~60 B)
// against ~440 operations (k2_flops, k2_bytes): the bound is set by bytes,
// 0.4 us at config 4's T = 10, B = 1024.  What takes the time is latency:
// 3 T dependent steps an example, each as long as the round trip of the
// loads it starts with unless they were issued earlier, and a batch of
// 1024 that fills few of the card's 132 SMs.
//
// What the design does about it (kkt_bwd.cuh): a team of four threads an
// example, one in each of four warps, 32 examples a block; only the three
// recurrences are serial, the costate lam runs beside the first, and the
// gradients and the block sums (a fixed tree of warp shuffles) come after
// the chains in a pass parallel over t; the chains' state and the
// examples' rows r and the mask, copied in with cp.async, are in shared
// memory (T <= T_MAX_BWD, 181: what a block of 32 examples holds in
// 232,448 bytes), so no step of a chain waits for device memory.  Smaller
// blocks would fill more of the card at B = 1024 but gain little there,
// since the chains' latency does not depend on the batch, and lose at
// B = 8192 (PERF.md).
//
// The plain PyTorch version is mpc_tpu_torch/ops/fused_bwd.py:
// fused_kkt_backward_plain, in the same order apart from the order of the
// batch sum.

#if !defined(MPC_T) || !defined(MPC_HAS_I) || !defined(MPC_COST_SHARED) || \
    !defined(MPC_TEAM) || !defined(MPC_EXAMPLES)
#error "compile with -DMPC_T=<horizon> -DMPC_HAS_I=0|1 -DMPC_COST_SHARED=0|1 -DMPC_TEAM=<threads an example> -DMPC_EXAMPLES=<examples a block>"
#endif
#define MPC_DYN_SHARED 0  // dF and df per example

#include "kkt_bwd.cuh"

// Launches K2 (and, for a shared cost, its block-order sum) on
// ``stream``; returns the cudaError_t of the launches.  T must be MPC_T,
// F is [T-1, B, 3, 4], the state resident (``smem_bytes`` of k2_launch)
// and ``ws`` the costates' workspace; ``part_dyn`` is unused.
extern "C" int mpc_fused_kkt_bwd(
    int B, int T, const float* C, long long sCt, long long sCb, const float* c,
    long long sct, long long scb, const float* F, long long sFt, long long sFb,
    const float* rx, const float* ru, const float* x, const float* u,
    const float* I, int has_f, float* ws, int resident, int smem_bytes,
    float* dxi, float* dC, float* dc, float* dF, float* df, float* part_cost,
    float* part_dyn, void* stream) {
  return mpc_bwd::launch(B, T, C, sCt, sCb, c, sct, scb, F, sFt, sFb, rx, ru,
                         x, u, I, has_f, ws, resident, smem_bytes, dxi, dC, dc,
                         dF, df, part_cost, part_dyn, stream);
}
