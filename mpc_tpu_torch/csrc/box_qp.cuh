// The control solves of the dense configuration of K3
// (fused_ilqr_dense.cu) as device functions on register arrays: the
// unrolled Cholesky, its triangular solves, the factor of the
// free-subspace-masked Hessian and the projected-Newton box QP.
//
// Replaces the TPU kernel's helpers mpc_tpu/ops/fused.py:_cholesky,
// _chol_solve, _masked_free_chol (lines 479-533) and _pnqp_kernel
// (534-616), which unroll the same loops over lane vectors.  Here N (the
// number of controls) is a compile-time constant, so every loop unrolls
// and the matrices stay in registers.  Every lane of the warp that owns
// an example runs these on the same values and gets the same bits; only
// the Armijo search of a projected-Newton trip is split across the
// lanes: lane g < 10 tries step size 0.1^g, and a ballot takes the first
// that passes, else the last, as the TPU kernel's parallel search does.
//
// The arithmetic is the TPU kernel's, in its order; the plain PyTorch
// versions are mpc_tpu_torch/ops/fused_dense.py:_cholesky, _chol_solve,
// _masked_free_chol and _pnqp.

#pragma once

#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace mpc {

// mpc_tpu/ops/fused.py:70-73
constexpr float kPnqpGamma = 0.1f;
constexpr float kPnqpTie = (float)(0.1 + 1e-6);   // ratio of a zero step
constexpr int kPnqpSteps = 10;
constexpr float kPnqpConvTol = 1e-4f;

// L L^T = A (+ jitter on the diagonal); L lower, zeros above
template <int N>
__device__ __forceinline__ void cholesky(const float (&A)[N][N], float jitter,
                                         float (&L)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) L[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = A[j][j] + jitter;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-30f));
    const float inv = 1.f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s2 = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - L[i][k] * L[j][k];
      L[i][j] = s2 * inv;
    }
  }
}

// (L L^T) x = b
template <int N>
__device__ __forceinline__ void chol_solve(const float (&L)[N][N],
                                           const float (&b)[N],
                                           float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// the factor of H with the clamped rows and columns zeroed and a unit
// diagonal on them (no jitter)
template <int N>
__device__ __forceinline__ void masked_free_chol(const float (&H)[N][N],
                                                 const bool (&fr)[N],
                                                 float (&L)[N][N]) {
  float Hm[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Hm[i][j] = (fr[i] && fr[j]) ? H[i][j] : 0.f;
    Hm[i][i] = fr[i] ? H[i][i] : 1.f;
  }
  cholesky<N>(Hm, 0.f, L);
}

// 0.5 z^T H z + q^T z, summed over i from the first term on
template <int N>
__device__ __forceinline__ float qp_objective(const float (&H)[N][N],
                                              const float (&q)[N],
                                              const float (&z)[N]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = H[i][0] * z[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = s + H[i][j] * z[j];
    const float term = (0.5f * s + q[i]) * z[i];
    acc = i == 0 ? term : acc + term;
  }
  return acc;
}

// The projected-Newton box QP min 0.5 x^T H x + q^T x, lo <= x <= hi,
// from the start x (clamped first), at most n_iter trips.  A trip takes
// the Newton direction on the free set (a clamped entry sits on a bound
// with the gradient pushing out), stops where the step's norm is below
// kPnqpConvTol (x stays; the trip counts), else moves to the first of
// the step sizes 0.1^k whose Armijo ratio exceeds kPnqpGamma, else to
// the last.  Returns in L and fr the factor and free set of the last
// trip, in trips the trips run.  The stop is the same in every lane, so
// the warp leaves the loop together; ``steps`` are the ten step sizes
// and ``lane`` the caller's lane of the warp.
template <int N>
__device__ __forceinline__ void pnqp(const float (&H)[N][N],
                                     const float (&q)[N],
                                     const float (&lo)[N],
                                     const float (&hi)[N], float (&x)[N],
                                     int n_iter, const float* steps,
                                     int lane, float (&L)[N][N],
                                     bool (&fr)[N], float& trips,
                                     PhaseClock& clk) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = fminf(fmaxf(x[i], lo[i]), hi[i]);
    fr[i] = true;
#pragma unroll
    for (int j = 0; j < N; ++j) L[i][j] = i == j ? 1.f : 0.f;
  }
  trips = 0.f;
  const float a = steps[lane < kPnqpSteps ? lane : kPnqpSteps - 1];
  for (int it = 0; it < n_iter; ++it) {
    float g[N], gm[N], dx[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = H[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s = s + H[i][j] * x[j];
      g[i] = s + q[i];
      const bool clamped =
          (x[i] == lo[i] && g[i] > 0.f) || (x[i] == hi[i] && g[i] < 0.f);
      fr[i] = !clamped;
      gm[i] = clamped ? 0.f : g[i];
    }
    clk.mark(kPhQP);
    masked_free_chol<N>(H, fr, L);
    clk.mark(kPhFactor);
    chol_solve<N>(L, gm, dx);
    float dx2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      dx[i] = -dx[i];
      dx2 = i == 0 ? dx[i] * dx[i] : dx2 + dx[i] * dx[i];
    }
    trips += 1.f;
    if (sqrtf(dx2) < kPnqpConvTol) break;
    // the Armijo search across the lanes: this lane's step size
    const float ox = qp_objective<N>(H, q, x);
    float xt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i] = fminf(fmaxf(x[i] + a * dx[i], lo[i]),
                                              hi[i]);
    const float num = ox - qp_objective<N>(H, q, xt);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = g[i] * (x[i] - xt[i]);
      den = i == 0 ? d : den + d;
    }
    const float ratio = fabsf(den) < 1e-30f ? kPnqpTie : num / den;
    const unsigned pass =
        __ballot_sync(0xffffffffu, lane < kPnqpSteps && ratio > kPnqpGamma);
    const int sel = pass ? __ffs(pass) - 1 : kPnqpSteps - 1;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __shfl_sync(0xffffffffu, xt[i], sel);
  }
}

}  // namespace mpc
