// Pendulum step and its Jacobian for kernels K1 and K3, each call one
// example's in one thread.
//
// Device counterpart of mpc_tpu_torch/models/pendulum.py:soa_step and
// soa_jacobian, with the same operations in the same order; the
// Jacobian takes the place of the TPU kernel's in-kernel
// jax.linearize (mpc_tpu/ops/fused.py:788-815).  Built without
// --use_fast_math: cosf/sinf, IEEE division and sqrtf, so the only
// difference from the PyTorch version is nvcc's FMA contraction.
#pragma once

namespace mpc {

constexpr float kDt = 0.05f;
constexpr float kMaxTorque = 2.0f;

struct PendulumParams {
  float g, m, l;
};

// torch.clamp: NaN passes through, the bound value itself is kept.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float pendulum_newdth(const PendulumParams& p,
                                                 float sin_th, float dth,
                                                 float uc) {
  return dth + kDt * ((-3.f * p.g) / (2.f * p.l) * (-sin_th) +
                      (3.f * uc) / (p.m * (p.l * p.l)));
}

// x_{t+1} = f(x_t, u_t) by angle addition with atan2's renormalisation
// (mpc_tpu/ops/math.py:rotate_unit), (0, 0) taken as angle 0.
__device__ __forceinline__ void pendulum_step(const PendulumParams& p,
                                              const float* x, float u,
                                              float* out) {
  const float cos_th = x[0], sin_th = x[1];
  const float uc = clampf(u, -kMaxTorque, kMaxTorque);
  const float newdth = pendulum_newdth(p, sin_th, x[2], uc);
  const float delta = newdth * kDt;
  const float cd = cosf(delta), sd = sinf(delta);
  const float r2 = cos_th * cos_th + sin_th * sin_th;
  const bool deg = r2 < 1e-30f;
  const float c = deg ? 1.f : cos_th;
  const float s = deg ? 0.f : sin_th;
  const float inv_r = 1.f / sqrtf(deg ? 1.f : r2);
  out[0] = (c * cd - s * sd) * inv_r;
  out[1] = (s * cd + c * sd) * inv_r;
  out[2] = newdth;
}

// F[i][j] = d x_{t+1}[i] / d (x_t, u_t)[j].  The control column is the
// full derivative for -2 <= u <= 2, ENDPOINTS INCLUDED (hard_clip's
// convention: bang-bang controls sit exactly on the bound), and 0
// strictly outside.
__device__ __forceinline__ void pendulum_jacobian(const PendulumParams& p,
                                                  const float* x, float u,
                                                  float F[3][4]) {
  const float cos_th = x[0], sin_th = x[1];
  const bool inside = (u >= -kMaxTorque) & (u <= kMaxTorque);
  const float uc = clampf(u, -kMaxTorque, kMaxTorque);
  const float newdth = pendulum_newdth(p, sin_th, x[2], uc);
  const float delta = newdth * kDt;
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
  const float dn_ds = kDt * ((3.f * p.g) / (2.f * p.l));
  const float dn_du = inside ? kDt * (3.f / (p.m * (p.l * p.l))) : 0.f;
  const float dd_ds = kDt * dn_ds;
  const float dd_du = kDt * dn_du;
  const float a00 = deg ? 0.f : cd * inv_r - pc * c * ir3;
  const float a01 = deg ? 0.f : -sd * inv_r - pc * s * ir3;
  const float a10 = deg ? 0.f : sd * inv_r - qs * c * ir3;
  const float a11 = deg ? 0.f : cd * inv_r - qs * s * ir3;
  F[0][0] = a00;
  F[0][1] = a01 - new_sin * dd_ds;
  F[0][2] = -new_sin * kDt;
  F[0][3] = -new_sin * dd_du;
  F[1][0] = a10;
  F[1][1] = a11 + new_cos * dd_ds;
  F[1][2] = new_cos * kDt;
  F[1][3] = new_cos * dd_du;
  F[2][0] = 0.f;
  F[2][1] = dn_ds;
  F[2][2] = 1.f;
  F[2][3] = dn_du;
}

}  // namespace mpc
