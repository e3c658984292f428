// Cartpole step and its Jacobian for the dense kernel's model-step build,
// each call one example's in one thread.
//
// Device counterpart of mpc_tpu_torch/models/cartpole.py:soa_step and
// soa_jacobian (the JAX package's mpc_tpu/models/cartpole.py:76-103),
// with the same operations in the same order; the Jacobian takes the
// place of the TPU kernels' in-kernel jax.linearize
// (mpc_tpu/ops/fused.py:788-815, 1307-1340).  State (x, dx, cos th,
// sin th, dth), one control clipped to +-100 inside the step, parameters
// (gravity, masscart, masspole, length); the angle advances by angle
// addition with atan2's renormalisation and with the OLD dth, as the
// reference's Euler step does.  Built without --use_fast_math.
#pragma once

#include "pendulum.cuh"

namespace mpc {

constexpr float kCartDt = 0.05f;
constexpr float kForceMag = 100.f;

struct CartpoleParams {
  float g, mc, mp, l;
};

__device__ __forceinline__ CartpoleParams load_cartpole(const float* p) {
  return CartpoleParams{p[0], p[1], p[2], p[3]};
}

// x_{t+1} = f(x_t, u_t)
__device__ __forceinline__ void cartpole_step(const CartpoleParams& p,
                                              const float* x, float u,
                                              float* out) {
  const float total_mass = p.mp + p.mc;
  const float pml = p.mp * p.l;
  const float uc = clampf(u, -kForceMag, kForceMag);
  const float cos_th = x[2], sin_th = x[3], dth = x[4];
  const float cart_in = (uc + pml * (dth * dth) * sin_th) / total_mass;
  const float th_acc =
      (p.g * sin_th - cos_th * cart_in) /
      (p.l * (4.f / 3.f - p.mp * (cos_th * cos_th) / total_mass));
  const float xacc = cart_in - pml * th_acc * cos_th / total_mass;
  const float delta = dth * kCartDt;
  const float cd = cosf(delta), sd = sinf(delta);
  const float r2 = cos_th * cos_th + sin_th * sin_th;
  const bool deg = r2 < 1e-30f;
  const float c = deg ? 1.f : cos_th;
  const float s = deg ? 0.f : sin_th;
  const float inv_r = 1.f / sqrtf(deg ? 1.f : r2);
  out[0] = x[0] + kCartDt * x[1];
  out[1] = x[1] + kCartDt * xacc;
  out[2] = (c * cd - s * sd) * inv_r;
  out[3] = (s * cd + c * sd) * inv_r;
  out[4] = dth + kCartDt * th_acc;
}

// F[i][j] = d x_{t+1}[i] / d (x_t, u_t)[j].  The control column is the
// full derivative for -100 <= u <= 100, ENDPOINTS INCLUDED, and 0
// strictly outside; at (cos, sin) = (0, 0) the rotation's inputs are
// constants, so its derivative there is the path through dth alone.
__device__ __forceinline__ void cartpole_jacobian(const CartpoleParams& p,
                                                  const float* x, float u,
                                                  float F[5][6]) {
  const bool inside = (u >= -kForceMag) & (u <= kForceMag);
  const float uc = clampf(u, -kForceMag, kForceMag);
  const float total_mass = p.mp + p.mc;
  const float pml = p.mp * p.l;
  const float cos_th = x[2], sin_th = x[3], dth = x[4];
  const float cart_in = (uc + pml * (dth * dth) * sin_th) / total_mass;
  const float den =
      p.l * (4.f / 3.f - p.mp * (cos_th * cos_th) / total_mass);
  const float th_acc = (p.g * sin_th - cos_th * cart_in) / den;
  const float inv_den = 1.f / den;
  // d cart_in / d (sin, dth, u)
  const float ci_s = pml * (dth * dth) / total_mass;
  const float ci_w = 2.f * pml * dth * sin_th / total_mass;
  const float ci_u = inside ? 1.f / total_mass : 0.f;
  // d den / d cos, then d th_acc / d (cos, sin, dth, u)
  const float den_c = -(p.l * (p.mp * (2.f * cos_th) / total_mass));
  const float ta_c = (-cart_in - th_acc * den_c) * inv_den;
  const float ta_s = (p.g - cos_th * ci_s) * inv_den;
  const float ta_w = -(cos_th * ci_w) * inv_den;
  const float ta_u = -(cos_th * ci_u) * inv_den;
  // d xacc / d (cos, sin, dth, u), xacc = cart_in - k th_acc cos
  const float k = pml / total_mass;
  const float xa_c = -(k * (ta_c * cos_th + th_acc));
  const float xa_s = ci_s - k * ta_s * cos_th;
  const float xa_w = ci_w - k * ta_w * cos_th;
  const float xa_u = ci_u - k * ta_u * cos_th;
  // the rotation by delta = dth dt, renormalised (pendulum.cuh's a00..a11)
  const float delta = dth * kCartDt;
  const float cd = cosf(delta), sd = sinf(delta);
  const float r2 = cos_th * cos_th + sin_th * sin_th;
  const bool deg = r2 < 1e-30f;
  const float c = deg ? 1.f : cos_th;
  const float s = deg ? 0.f : sin_th;
  const float inv_r = 1.f / sqrtf(deg ? 1.f : r2);
  const float pc = c * cd - s * sd;
  const float qs = s * cd + c * sd;
  const float new_cos = pc * inv_r;
  const float new_sin = qs * inv_r;
  const float ir3 = inv_r * inv_r * inv_r;
  const float a00 = deg ? 0.f : cd * inv_r - pc * c * ir3;
  const float a01 = deg ? 0.f : -sd * inv_r - pc * s * ir3;
  const float a10 = deg ? 0.f : sd * inv_r - qs * c * ir3;
  const float a11 = deg ? 0.f : cd * inv_r - qs * s * ir3;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) F[i][j] = 0.f;
  F[0][0] = 1.f;
  F[0][1] = kCartDt;
  F[1][1] = 1.f;
  F[1][2] = kCartDt * xa_c;
  F[1][3] = kCartDt * xa_s;
  F[1][4] = kCartDt * xa_w;
  F[1][5] = kCartDt * xa_u;
  F[2][2] = a00;
  F[2][3] = a01;
  F[2][4] = -new_sin * kCartDt;
  F[3][2] = a10;
  F[3][3] = a11;
  F[3][4] = new_cos * kCartDt;
  F[4][2] = kCartDt * ta_c;
  F[4][3] = kCartDt * ta_s;
  F[4][4] = 1.f + kCartDt * ta_w;
  F[4][5] = kCartDt * ta_u;
}

}  // namespace mpc
