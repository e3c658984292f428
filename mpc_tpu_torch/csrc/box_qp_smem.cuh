// The control solves of the dense kernels (fused_ilqr_dense.cu,
// fused_kkt_bwd_dense.cu) past kRegCtrlMax controls, across the warp's
// lanes: the Cholesky of the control block, its triangular solves and the
// projected-Newton box QP.
//
// Replaces, as box_qp.cuh does at up to kRegCtrlMax controls, the TPU
// kernel's helpers mpc_tpu/ops/fused.py:_cholesky, _chol_solve,
// _masked_free_chol (lines 479-533) and _pnqp_kernel (534-616).  The
// register versions keep the n_ctrl x n_ctrl block, its factor and the
// QP's vectors in every lane's registers, nc^2 + nc (nc + 1) / 2 + 7 nc
// floats (504 at 16 controls): past 8 controls that no longer fits a
// thread's 255 registers.
//
// What bounds it on this card.  A step's control solve is a chain: the
// factor's nc columns, two triangular solves of nc steps each, and per
// box-QP trip a factor, a solve and the Armijo search.  A lane that
// walks a whole solve alone (nc^2 dependent multiply-adds, each reading
// the factor from shared memory) or an objective of nc^2 terms puts that
// chain on one lane while 31 idle.
//
// What the design does about it.  Lane i owns row i, and each chain is
// cut to nc steps of a few operations, the lanes meeting by shuffles:
//
// - THE FACTOR, right-looking (factor_lanes): lane i holds its row of the
//   matrix (masked, with the jitter) in registers; at step k lane k's
//   diagonal becomes L_kk, every lane forms L_ik = s_ik (1 / L_kk), and
//   lane i subtracts L_ik L_jk from its s_ij, L_jk handed on by a shuffle
//   from lane j.  So s_ij = A_ij (+ jitter) - L_i0 L_j0 - L_i1 L_j1 - ...,
//   _cholesky's order: the bits of the column-by-column form, with no
//   __syncwarp or shared-memory round trip a column.  Each row is written
//   to the factor's tile L [N][odd] once, for the back substitutions.
// - THE TRIANGULAR SOLVES (solve_lanes): lane i holds row i of every
//   right-hand side at once (the n_state + 1 gains' columns in a sweep,
//   one vector in a QP trip).  Forward: at step k lane k's y_k = s_k
//   (1 / L_kk) goes to every lane by a shuffle, and lanes i > k subtract
//   L_ik y_k: s = b_i - L_i0 y_0 - L_i1 y_1 - ..., _chol_solve's order.
//   Back substitution runs k descending (x_{N-1} is ready first): s = y_i
//   - L_{N-1,i} x_{N-1} - L_{N-2,i} x_{N-2} - ...; lane i reads column i
//   of L from the tile (row k, so no bank conflict).  A step's division
//   is a product with the reciprocal the factor formed (the IEEE division
//   would be a long dependent sequence on every step of the chain, for
//   every right-hand side).  Both are the plain version's own helper past
//   REG_CTRL_MAX (mpc_tpu_torch/ops/fused_dense.py:_chol_solve_lanes).
// - THE BOX QP's trial objectives (pnqp_lanes): lane i forms (H z)_i for
//   all ten step sizes' trial points z from its row of H, and its terms
//   (0.5 (H z)_i + q_i) z_i and g_i (x_i - z_i); the sums over i are
//   taken by shuffles in ascending i, as qp_objective sums them, and
//   lane g keeps step size 0.1^g's with the ballot of box_qp.cuh.  Each
//   lane computes nc rows of 10 step sizes, not two objectives of nc^2.
//
// Every sum runs in the plain version's order (mpc_tpu_torch/ops/
// fused_dense.py:_cholesky, _chol_solve_lanes, _masked_free_chol,
// _pnqp), from its first term on; the trial point x + a dx is rounded as
// the plain version rounds it (a product, then a sum, no FMA), and a sum
// of shuffled terms has no FMA to contract.  Elsewhere nvcc's FMA
// contraction is the only arithmetic difference from the plain version.
// Nothing of N floats is indexed at run time in registers: every array
// here is indexed by unrolled loops, so no build spills for it.

#pragma once

#include <cuda_runtime.h>

#include "box_qp.cuh"
#include "phase_clock.cuh"

namespace mpc {

// The most controls whose solve runs on register arrays (box_qp.cuh);
// past it the solve runs across the lanes (this file).  The host's
// count of a warp's tiles reads it as fused_dense.REG_CTRL_MAX.
constexpr int kRegCtrlMax = 8;

// An odd row stride of at least n: the lanes reading a column of their
// rows hit distinct banks.
__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

// L L^T = A (+ jitter on the diagonal) for the N x N matrix A (row stride
// lda) into L (row stride ldl; the lower triangle and the diagonal are
// written, nothing above) and the reciprocals 1 / L_kk of its diagonal
// into Linv [N].  With ``masked`` the matrix is A with the rows and
// columns outside the free set ``fr`` (bit i: entry i free) zeroed and a
// unit diagonal on them (_masked_free_chol; pass jitter 0).  Every lane
// of the warp calls it; lane i < N owns row i.  Ends with a __syncwarp.
template <int N>
__device__ __forceinline__ void factor_lanes(const float* A, int lda,
                                             bool masked, unsigned fr,
                                             float jitter, float* L, int ldl,
                                             float* Linv, int lane) {
  const int li = lane < N ? lane : N - 1;
  const bool fl = (fr >> li) & 1u;
  float a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float aij = A[li * lda + j];
    const bool fj = (fr >> j) & 1u;
    float v = masked ? (j == li ? (fl ? aij : 1.f) : (fl && fj ? aij : 0.f))
                     : aij;
    a[j] = j == li ? v + jitter : v;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float lkk = sqrtf(fmaxf(__shfl_sync(0xffffffffu, a[k], k), 1e-30f));
    const float inv = 1.f / lkk;
    if (lane == k) Linv[k] = inv;
    a[k] = lane == k ? lkk : (lane > k ? a[k] * inv : a[k]);
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const float ljk = __shfl_sync(0xffffffffu, a[k], j);
      a[j] = a[j] - a[k] * ljk;
    }
  }
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j <= lane) L[lane * ldl + j] = a[j];
  }
  __syncwarp();
}

// (L L^T) x = b for R right-hand sides across the lanes: lane i < N holds
// row i of each (b on entry, x on exit) in s; L from the tile (row stride
// ldl) and Linv its diagonal's reciprocals (factor_lanes).  Forward
// substitution from row 0, back substitution from row N - 1, each step's
// division a product with the reciprocal.  Every lane of the warp calls
// it.
template <int N, int R>
__device__ __forceinline__ void solve_lanes(const float* L, int ldl,
                                            const float* Linv, float (&s)[R],
                                            int lane) {
  const int li = lane < N ? lane : N - 1;
  const float* Li = L + li * ldl;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float ikk = Linv[k];
    const float lik = Li[k < li ? k : li];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float yk = __shfl_sync(0xffffffffu, s[r], k) * ikk;
      s[r] = lane == k ? yk : (lane > k ? s[r] - lik * yk : s[r]);
    }
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    const float ikk = Linv[k];
    const float lki = L[k * ldl + (li < k ? li : k)];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xk = __shfl_sync(0xffffffffu, s[r], k) * ikk;
      s[r] = lane == k ? xk : (lane < k ? s[r] - lki * xk : s[r]);
    }
  }
}

// Entry i of the trial point clamp(x + a dx, lo, hi): the product and the
// sum rounded apart, as the plain version forms them.
__device__ __forceinline__ float trial_point(float x, float dx, float lo,
                                             float hi, float a) {
  return fminf(fmaxf(__fadd_rn(x, __fmul_rn(a, dx)), lo), hi);
}

// The sum over lanes 0..N-1 of each lane's v, in ascending lane order
// from the first term on, in every lane.
template <int N>
__device__ __forceinline__ float ordered_sum(float v) {
  float acc = __shfl_sync(0xffffffffu, v, 0);
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + __shfl_sync(0xffffffffu, v, i);
  return acc;
}

// The projected-Newton box QP min 0.5 x^T H x + q^T x, lo <= x <= hi, as
// box_qp.cuh's pnqp, across the lanes: H (row stride ldh), q, lo, hi and
// the start x (clamped first; the solution on exit) rows in shared
// memory, dx a scratch row, L the factor's tile and Linv its diagonal's
// reciprocals.  Returns in L, Linv and fr the factor and free set of the
// last trip (the identity and every entry free if none ran), in trips the
// trips run.  Every lane of the warp calls
// it; ``steps`` are the ten step sizes; ``clk`` takes the trips' factors
// and the rest apart (the phase account).
template <int N>
__device__ __forceinline__ void pnqp_lanes(const float* H, int ldh,
                                           const float* q, const float* lo,
                                           const float* hi, float* x,
                                           float* dx, int n_iter,
                                           const float* steps, int lane,
                                           float* L, int ldl, float* Linv,
                                           unsigned& fr, float& trips,
                                           PhaseClock& clk) {
  const int li = lane < N ? lane : N - 1;
  const float qi = q[li], loi = lo[li], hii = hi[li];
  const float* row = H + li * ldh;
  if (lane < N) x[lane] = fminf(fmaxf(x[lane], loi), hii);
  for (int e = lane; e < N * N; e += 32) {
    const int i = e / N, j = e - i * N;
    L[i * ldl + j] = i == j ? 1.f : 0.f;
  }
  if (lane < N) Linv[lane] = 1.f;
  fr = (1u << N) - 1u;
  trips = 0.f;
  __syncwarp();
  for (int it = 0; it < n_iter; ++it) {
    // the gradient, a row a lane; a clamped entry's gradient zeroed in
    // the Newton step's right-hand side
    const float xi = x[li];
    float s = row[0] * x[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = s + row[j] * x[j];
    const float gi = s + qi;
    const bool clamped = (xi == loi && gi > 0.f) || (xi == hii && gi < 0.f);
    fr = __ballot_sync(0xffffffffu, lane < N && !clamped);
    clk.mark(kPhQP);
    factor_lanes<N>(H, ldh, true, fr, 0.f, L, ldl, Linv, lane);
    clk.mark(kPhFactor);
    float v[1] = {clamped ? 0.f : gi};
    solve_lanes<N, 1>(L, ldl, Linv, v, lane);
    if (lane < N) dx[lane] = -v[0];
    __syncwarp();
    float dx2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = dx[i];
      dx2 = i == 0 ? d * d : dx2 + d * d;
    }
    trips += 1.f;
    if (sqrtf(dx2) < kPnqpConvTol) break;
    // the Armijo search: this lane's row at the ten trial points, the
    // sums over the rows by shuffles, lane g judging step size 0.1^g
    float hz[kPnqpSteps];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xj = x[j], dj = dx[j], lj = lo[j], hj = hi[j];
      const float hij = row[j];
#pragma unroll
      for (int m = 0; m < kPnqpSteps; ++m) {
        const float z = trial_point(xj, dj, lj, hj, steps[m]);
        hz[m] = j == 0 ? hij * z : hz[m] + hij * z;
      }
    }
    const float dxi = dx[li];
    const float ox = ordered_sum<N>((0.5f * s + qi) * xi);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int m = 0; m < kPnqpSteps; ++m) {
      const float zi = trial_point(xi, dxi, loi, hii, steps[m]);
      const float oz = ordered_sum<N>((0.5f * hz[m] + qi) * zi);
      const float dm = ordered_sum<N>(gi * (xi - zi));
      if (lane == m) {
        num = ox - oz;
        den = dm;
      }
    }
    const float ratio = fabsf(den) < 1e-30f ? kPnqpTie : num / den;
    const unsigned pass =
        __ballot_sync(0xffffffffu, lane < kPnqpSteps && ratio > kPnqpGamma);
    const int sel = pass ? __ffs(pass) - 1 : kPnqpSteps - 1;
    const float xn = trial_point(xi, dxi, loi, hii, steps[sel]);
    __syncwarp();
    if (lane < N) x[lane] = xn;
    __syncwarp();
  }
}

}  // namespace mpc
