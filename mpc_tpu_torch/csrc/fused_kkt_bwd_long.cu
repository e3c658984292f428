// Kernel K4 for Hopper: the streaming KKT backward of the converged
// box-constrained LQR fixed point, any horizon, with the cost and the
// dynamics each batch-shared or per example.
//
// Replaces the TPU kernel mpc_tpu/ops/fused_bwd.py:_make_bwd_kernel_long
// (lines 413-785), which runs K2's three passes as fori_loops with the
// gains in VMEM scratch, streams the per-t vectors in and the per-example
// gradients out through 2-slot DMA buffers, and accumulates the gradients
// of batch-shared operands in SMEM blocks resident across its sequential
// grid.  The kernel itself is kkt_bwd.cuh, shared with K2, here with T a
// run-time argument (one build per layout serves every horizon) and the
// active set present where I is not null.
//
// What bounds it on this card.  The function must read r, x*, u* and the
// mask (36 B a step and example) against ~400 operations (k4_flops,
// k4_bytes): the bound is set by bytes, 7 us at T = 160, B = 4096.  What
// takes the time is the chain of dependent horizon steps an example walks:
// three recurrences of T steps each, where each step's own arithmetic is
// 20 to 200 cycles and a round trip to device memory 600 or more, so a
// step must find its operands on the chip, loaded before it starts.  The
// batch sums of the shared gradients (35 entries a step) must stay off
// that chain.
//
// What the design does about it (kkt_bwd.cuh): a team of four threads an
// example, one in each of four warps, 32 examples a block, so B = 4096 is
// 128 blocks of 4 warps; only the three recurrences are serial, the costate
// lam runs beside the first in its own warp, and every gradient and every
// batch sum (a fixed tree of warp shuffles) is computed after the chains in
// a pass parallel over t.  The chains' state, the examples' rows r and the
// mask (copied in with cp.async before the chains) and one copy a block of
// the batch-shared operands are in shared memory up to T = K4_T_RESIDENT
// (181), so no step of the three recurrences waits for device memory;
// past it the state is a workspace in global memory, so any T runs.
//
// The plain PyTorch version is mpc_tpu_torch/ops/fused_bwd.py:
// fused_kkt_backward_long_plain, in the same order apart from the order
// of the batch sums.

#if !defined(MPC_COST_SHARED) || !defined(MPC_DYN_SHARED) || \
    !defined(MPC_TEAM) || !defined(MPC_EXAMPLES)
#error "compile with -DMPC_COST_SHARED=0|1 -DMPC_DYN_SHARED=0|1 -DMPC_TEAM=<threads an example> -DMPC_EXAMPLES=<examples a block>"
#endif
#define MPC_T 0       // a run-time horizon
#define MPC_HAS_I -1  // an active set where I is not null

#include "kkt_bwd.cuh"

// Launches K4 and the block-order sums of its shared gradients on
// ``stream``; returns the cudaError_t of the launches.  dC, dc are
// [T, 4, 4], [T, 4] when the cost is shared and dF, df [T-1, 3, 4],
// [T-1, 3] when the dynamics are; df is nullptr for an absent f.
extern "C" int mpc_fused_kkt_bwd_long(
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
