// The pseudo-Huber cost's device code, shared by K1 (fused_ilqr.cu), K3
// (fused_ilqr_long.cu) and K3's dense configuration (fused_ilqr_dense.cu)
// in their cost build (MPC_COST = 1).
//
// The cost on tau = (x, u) is sum_i w_i delta^2 (sqrt(1 + r_i^2) - 1),
// r_i = (tau_i - goal_i) / delta (mpc_tpu_torch/models/cost.py,
// mpc_tpu/models/cost.py:29-77).  The TPU kernels quadratise it at every
// outer iteration by nested jax.jvp (mpc_tpu/ops/fused.py:737-765); it is
// separable, so its Hessian is diagonal and both are written out here:
// with s = sqrt(1 + r^2), g_i = w_i delta r / s and H_ii = w_i / s^3.  In
// delta space the recentred linear term C tau + c is g itself (c = g -
// H tau), so a kernel takes g where it takes C tau + c, and diag(H) with
// exact zeros elsewhere as C.
//
// The 2 n_tau + 1 parameters [w, goal, delta] are one operand shared by
// the batch (the TPU kernel's SMEM scalars); a kernel keeps the ones it
// uses in registers.  IEEE division and sqrtf (no --use_fast_math), in the
// order of the plain versions (models/cost.py:huber_terms, huber_quad).

#pragma once

namespace mpc {

// component i's term of the stage cost
__device__ __forceinline__ float huber_term(float w, float goal, float delta,
                                            float tau) {
  const float r = (tau - goal) / delta;
  return w * delta * delta * (sqrtf(1.f + r * r) - 1.f);
}

// component i's Hessian diagonal h and gradient g
__device__ __forceinline__ void huber_quad(float w, float goal, float delta,
                                           float tau, float& h, float& g) {
  const float r = (tau - goal) / delta;
  const float s = sqrtf(1.f + r * r);
  g = w * delta * r / s;
  h = w / (s * s * s);
}

// The parameters of a cost on N components, in registers.
template <int N>
struct Huber {
  float w[N], goal[N], delta;

  __device__ __forceinline__ static Huber load(const float* p) {
    Huber h;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      h.w[i] = __ldg(p + i);
      h.goal[i] = __ldg(p + N + i);
    }
    h.delta = __ldg(p + 2 * N);
    return h;
  }

  // the stage cost, summed over i = 0 .. N - 1 in sequence (soa_cost)
  __device__ __forceinline__ float stage(const float* tau) const {
    float acc = huber_term(w[0], goal[0], delta, tau[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) acc = acc + huber_term(w[i], goal[i], delta, tau[i]);
    return acc;
  }

  // C = diag(H) (exact zeros elsewhere) and g at tau
  __device__ __forceinline__ void quad(const float* tau, float C[N][N],
                                       float* g) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) C[i][j] = 0.f;
      huber_quad(w[i], goal[i], delta, tau[i], C[i][i], g[i]);
    }
  }
};

}  // namespace mpc
