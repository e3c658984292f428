// The control solves of the dense kernels (fused_ilqr_dense.cu,
// fused_kkt_bwd_dense.cu) past kRegCtrlMax controls, on a warp's tiles in
// shared memory: the Cholesky of the control block, its triangular solves
// and the projected-Newton box QP.
//
// Replaces, as box_qp.cuh does at up to kRegCtrlMax controls, the TPU
// kernel's helpers mpc_tpu/ops/fused.py:_cholesky, _chol_solve,
// _masked_free_chol (lines 479-533) and _pnqp_kernel (534-616).  The
// register versions keep the n_ctrl x n_ctrl block, its factor and the
// QP's vectors in every lane's registers, nc^2 + nc (nc + 1) / 2 + 7 nc
// floats (504 at 16 controls): past 8 controls that no longer fits a
// thread's 255 registers.  Here nothing of nc^2 floats is held in
// registers:
//
// - the matrix (Quu) is read in place from the warp's Q tile, its factor
//   L is a tile [N][ldl] of odd stride, and the QP's x, g, dx, lo and hi
//   are rows of the warp's tiles; the free set is a bit mask from a
//   ballot, the same in every lane;
// - the Cholesky runs column by column, lane i owning row i of L: lane j
//   writes the diagonal L[j][j], then (after a __syncwarp) lanes i > j
//   compute L[i][j], each sum from k = 0 ascending as _cholesky sums it;
// - a triangular solve runs on one lane, its right-hand side and solution
//   one vector of N floats in that lane's registers (chol_solve_reg); the
//   gains' columns are solved side by side, lane j column j;
// - the box QP's gradient is a row a lane; its Armijo search keeps "lane g
//   tries step size 0.1^g" with the ballot of box_qp.cuh, each lane
//   evaluating its trial objective from the rows in shared memory with
//   the trial point recomputed entry by entry (no array).
//
// Every sum runs in the plain version's order (mpc_tpu_torch/ops/
// fused_dense.py:_cholesky, _chol_solve, _masked_free_chol, _pnqp), from
// its first term on; the trial point x + a dx is rounded as the plain
// version rounds it (a product, then a sum, no FMA), so that every lane
// that forms it gets the same bits.  Elsewhere nvcc's FMA contraction is
// the only arithmetic difference from the plain version.

#pragma once

#include <cuda_runtime.h>

#include "box_qp.cuh"

namespace mpc {

// The most controls whose solve runs on register arrays (box_qp.cuh);
// past it the solve runs on the warp's tiles (this file).  The host's
// count of a warp's tiles reads it as fused_dense.REG_CTRL_MAX.
constexpr int kRegCtrlMax = 8;

// An odd row stride of at least n: the lanes reading a column of their
// rows hit distinct banks.
__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

// L L^T = A (+ jitter on the diagonal) for the N x N matrix A (row stride
// lda) into L (row stride ldl; the lower triangle and the diagonal are
// written, nothing above).  With ``masked`` the matrix is A with the rows
// and columns outside the free set ``fr`` (bit i: entry i free) zeroed and
// a unit diagonal on them (_masked_free_chol; pass jitter 0).  Every lane
// of the warp calls it; lane i < N owns row i.  Ends with a __syncwarp.
template <int N>
__device__ __forceinline__ void cholesky_rows(const float* A, int lda,
                                              bool masked, unsigned fr,
                                              float jitter, float* L,
                                              int ldl, int lane) {
  const bool fl = lane < N && ((fr >> (lane < N ? lane : 0)) & 1u);
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    const bool fj = (fr >> j) & 1u;
    if (lane == j) {
      const float ajj = masked ? (fj ? A[j * lda + j] : 1.f) : A[j * lda + j];
      float s = ajj + jitter;
      const float* Lj = L + j * ldl;
      for (int k = 0; k < j; ++k) s = s - Lj[k] * Lj[k];
      L[j * ldl + j] = sqrtf(fmaxf(s, 1e-30f));
    }
    __syncwarp();
    if (lane > j && lane < N) {
      const float* Lj = L + j * ldl;
      const float* Li = L + lane * ldl;
      const float inv = 1.f / Lj[j];
      const float aij = A[lane * lda + j];
      float s2 = masked ? ((fl && fj) ? aij : 0.f) : aij;
      for (int k = 0; k < j; ++k) s2 = s2 - Li[k] * Lj[k];
      L[lane * ldl + j] = s2 * inv;
    }
  }
  __syncwarp();
}

// (L L^T) x = b on one lane: x holds b on entry and the solution on exit,
// in registers (every index known at compile time); L from shared memory
// (row stride ldl).  The forward and back substitutions of _chol_solve,
// each sum from its first term on.
template <int N>
__device__ __forceinline__ void chol_solve_reg(const float* L, int ldl,
                                               float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i * ldl + k] * x[k];
    x[i] = s / L[i * ldl + i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k * ldl + i] * x[k];
    x[i] = s / L[i * ldl + i];
  }
}

// Entry i of the trial point clamp(x + a dx, lo, hi): the product and the
// sum rounded apart, as the plain version forms them.
__device__ __forceinline__ float trial_entry(const float* x, const float* dx,
                                             const float* lo, const float* hi,
                                             float a, int i) {
  return fminf(fmaxf(__fadd_rn(x[i], __fmul_rn(a, dx[i])), lo[i]), hi[i]);
}

// 0.5 z^T H z + q^T z, summed over i from the first term on, at z = x or,
// with ``trial``, at the trial point of step size a (qp_objective's order)
template <int N>
__device__ __forceinline__ float qp_objective_rows(
    const float* H, int ldh, const float* q, const float* x, const float* dx,
    const float* lo, const float* hi, float a, bool trial) {
  float acc = 0.f;
  for (int i = 0; i < N; ++i) {
    const float* row = H + i * ldh;
    float s = row[0] * (trial ? trial_entry(x, dx, lo, hi, a, 0) : x[0]);
    for (int j = 1; j < N; ++j)
      s = s + row[j] * (trial ? trial_entry(x, dx, lo, hi, a, j) : x[j]);
    const float zi = trial ? trial_entry(x, dx, lo, hi, a, i) : x[i];
    const float term = (0.5f * s + q[i]) * zi;
    acc = i == 0 ? term : acc + term;
  }
  return acc;
}

// The projected-Newton box QP min 0.5 x^T H x + q^T x, lo <= x <= hi, as
// box_qp.cuh's pnqp, on rows in shared memory: H (row stride ldh), q, lo,
// hi and the start x (clamped first; the solution on exit), g and dx
// scratch rows, L the factor's tile.  Returns in L and fr the factor and
// free set of the last trip (the identity and every entry free if none
// ran), in trips the trips run.  Every lane of the warp calls it; ``steps``
// are the ten step sizes.
template <int N>
__device__ __forceinline__ void pnqp_rows(const float* H, int ldh,
                                          const float* q, const float* lo,
                                          const float* hi, float* x, float* g,
                                          float* dx, int n_iter,
                                          const float* steps, int lane,
                                          float* L, int ldl, unsigned& fr,
                                          float& trips) {
  const int li = lane < N ? lane : N - 1;
  if (lane < N) x[lane] = fminf(fmaxf(x[lane], lo[lane]), hi[lane]);
  for (int e = lane; e < N * N; e += 32) {
    const int i = e / N, j = e - i * N;
    L[i * ldl + j] = i == j ? 1.f : 0.f;
  }
  fr = (1u << N) - 1u;
  trips = 0.f;
  const float a = steps[lane < kPnqpSteps ? lane : kPnqpSteps - 1];
  __syncwarp();
  for (int it = 0; it < n_iter; ++it) {
    // the gradient, a row a lane; the clamped entries' gradient zeroed
    // into dx, which the solve below overwrites with the step
    bool clamped = false;
    if (lane < N) {
      const float* row = H + li * ldh;
      float s = row[0] * x[0];
      for (int j = 1; j < N; ++j) s = s + row[j] * x[j];
      const float gi = s + q[li];
      const float xi = x[li];
      clamped = (xi == lo[li] && gi > 0.f) || (xi == hi[li] && gi < 0.f);
      g[li] = gi;
      dx[li] = clamped ? 0.f : gi;
    }
    fr = __ballot_sync(0xffffffffu, lane < N && !clamped);
    __syncwarp();
    cholesky_rows<N>(H, ldh, true, fr, 0.f, L, ldl, lane);
    if (lane == 0) {
      float v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = dx[i];
      chol_solve_reg<N>(L, ldl, v);
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = -v[i];
    }
    __syncwarp();
    float dx2 = 0.f;
    for (int i = 0; i < N; ++i) {
      const float d = dx[i];
      dx2 = i == 0 ? d * d : dx2 + d * d;
    }
    trips += 1.f;
    if (sqrtf(dx2) < kPnqpConvTol) break;
    // the Armijo search across the lanes: this lane's step size
    const float ox = qp_objective_rows<N>(H, ldh, q, x, dx, lo, hi, 0.f,
                                          false);
    const float num = ox - qp_objective_rows<N>(H, ldh, q, x, dx, lo, hi, a,
                                                true);
    float den = 0.f;
    for (int i = 0; i < N; ++i) {
      const float d = g[i] * (x[i] - trial_entry(x, dx, lo, hi, a, i));
      den = i == 0 ? d : den + d;
    }
    const float ratio = fabsf(den) < 1e-30f ? kPnqpTie : num / den;
    const unsigned pass =
        __ballot_sync(0xffffffffu, lane < kPnqpSteps && ratio > kPnqpGamma);
    const int sel = pass ? __ffs(pass) - 1 : kPnqpSteps - 1;
    const float xn = trial_entry(x, dx, lo, hi, steps[sel], li);
    __syncwarp();
    if (lane < N) x[lane] = xn;
    __syncwarp();
  }
}

}  // namespace mpc
