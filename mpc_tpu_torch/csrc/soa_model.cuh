// The models of the dense kernel's model-step build
// (fused_ilqr_dense.cu, MPC_MODEL 1-3, MPC_SLEW): each device model of
// pendulum.cuh and cartpole.cuh behind one interface on the kernel's tau
// layout, and the slew passthrough step over any of them.
//
// The simple pendulum's step takes pendulum_newdth_rn: its gravity term
// rounded as the plain version rounds it, whatever ptxas fuses.
//
// A model M has NS states, NC controls and NP parameters (the vector the
// wrapper passes, in the model's soa_params order), and two functions of
// tau = (x_t, u_t), NS + NC floats:
//   M::step(p, tau, out)     out[NS] = x_{t+1}
//   M::jacobian(p, tau, F)   F[NS][NS + NC] = d x_{t+1} / d tau
// (the pendulums and the cartpole have one control).  Slew<M> is
// mpc_tpu/ops/fused.py:_SlewSoA (lines 2441-2508;
// mpc_tpu_torch/ops/fused.py:SlewSoA): on the augmented state
// (u_{t-1}, x_t) its step is (u_t, f(x_t, u_t)), the controls passed
// through unclipped; its Jacobian's first NC rows pick u_t and the inner
// Jacobian's rows follow, shifted right past the u_{t-1} columns.  The
// MLP's warp-wide step and Jacobian (nn_dense.cuh) do not fit this
// per-lane interface; fused_ilqr_dense.cu runs them and their slew rows
// itself.
#pragma once

#include "cartpole.cuh"
#include "pendulum.cuh"

namespace mpc {

template <bool Damped>
struct PendulumModel {
  static constexpr int NS = 3;
  static constexpr int NC = 1;
  static constexpr int NP = Damped ? 5 : 3;
  __device__ static __forceinline__ void step(const float* p,
                                              const float* tau, float* out) {
    pendulum_step<Damped, true>(load_pendulum<Damped>(p), tau, tau[NS], out);
  }
  __device__ static __forceinline__ void jacobian(const float* p,
                                                  const float* tau,
                                                  float F[NS][NS + 1]) {
    pendulum_jacobian<Damped>(load_pendulum<Damped>(p), tau, tau[NS], F);
  }
};

struct CartpoleModel {
  static constexpr int NS = 5;
  static constexpr int NC = 1;
  static constexpr int NP = 4;
  __device__ static __forceinline__ void step(const float* p,
                                              const float* tau, float* out) {
    cartpole_step(load_cartpole(p), tau, tau[NS], out);
  }
  __device__ static __forceinline__ void jacobian(const float* p,
                                                  const float* tau,
                                                  float F[NS][NS + 1]) {
    cartpole_jacobian(load_cartpole(p), tau, tau[NS], F);
  }
};

template <class M>
struct Slew {
  static constexpr int NC = M::NC;
  static constexpr int NS = M::NS + NC;
  static constexpr int NP = M::NP;
  __device__ static __forceinline__ void step(const float* p,
                                              const float* tau, float* out) {
#pragma unroll
    for (int m = 0; m < NC; ++m) out[m] = tau[NS + m];
    M::step(p, tau + NC, out + NC);
  }
  __device__ static __forceinline__ void jacobian(const float* p,
                                                  const float* tau,
                                                  float F[NS][NS + NC]) {
    float Fi[M::NS][M::NS + NC];
    M::jacobian(p, tau + NC, Fi);
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int j = 0; j < NS + NC; ++j) F[m][j] = j == NS + m ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < M::NS; ++i) {
#pragma unroll
      for (int m = 0; m < NC; ++m) F[i + NC][m] = 0.f;
#pragma unroll
      for (int j = 0; j < M::NS + NC; ++j) F[i + NC][j + NC] = Fi[i][j];
    }
  }
};

}  // namespace mpc
