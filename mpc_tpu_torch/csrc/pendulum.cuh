// Pendulum steps and their Jacobians for kernels K1 and K3 and the dense
// kernel's model-step build, each call one example's in one thread: the
// simple pendulum (Damped = false, parameters g, m, l) and the damped,
// biased one (Damped = true, also d and b; the builds' MPC_DAMPED).
//
// Device counterpart of mpc_tpu_torch/models/pendulum.py:soa_step and
// soa_jacobian, with the same operations in the same order; the
// Jacobian takes the place of the TPU kernel's in-kernel
// jax.linearize (mpc_tpu/ops/fused.py:788-815).  Built without
// --use_fast_math: cosf/sinf, atan2f, IEEE division and sqrtf, so the
// only difference from the PyTorch version is nvcc's FMA contraction and
// the last bits of the two libraries' transcendentals.  The damped step
// takes the true atan2f where the TPU kernel evaluates a degree-9
// polynomial of it (mpc_tpu/ops/math.py:atan2, ~1e-7 off in float32),
// which the TPU needed only because Mosaic cannot lower the arctan
// family.
#pragma once

namespace mpc {

constexpr float kDt = 0.05f;
constexpr float kMaxTorque = 2.0f;

struct PendulumParams {
  float g, m, l, d, b;  // d, b: the damped pendulum's only
};

template <bool Damped>
__device__ __forceinline__ PendulumParams load_pendulum(const float* p) {
  if constexpr (Damped)
    return PendulumParams{p[0], p[1], p[2], p[3], p[4]};
  else
    return PendulumParams{p[0], p[1], p[2], 0.f, 0.f};
}

// torch.clamp: NaN passes through, the bound value itself is kept.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.clamp's value also where a trust region leaves lo > hi (the
// control outside the box by more than delta_u): hi, as min(max(v, lo),
// hi) gives it; where lo <= hi it is clampf's.
__device__ __forceinline__ float clamp_box(float v, float lo, float hi) {
  return clampf(v, fminf(lo, hi), hi);
}

__device__ __forceinline__ float pendulum_newdth(const PendulumParams& p,
                                                 float sin_th, float dth,
                                                 float uc) {
  return dth + kDt * ((-3.f * p.g) / (2.f * p.l) * (-sin_th) +
                      (3.f * uc) / (p.m * (p.l * p.l)));
}

// pendulum_newdth with the gravity term rounded before the control's is
// added (no FFMA), as the plain version rounds it: the dense kernel's
// model-step build takes it (soa_model.cuh), whose rollout step ptxas
// would otherwise fuse or not by where it schedules the product
__device__ __forceinline__ float pendulum_newdth_rn(const PendulumParams& p,
                                                    float sin_th, float dth,
                                                    float uc) {
  return dth + kDt * (__fmul_rn((-3.f * p.g) / (2.f * p.l), -sin_th) +
                      (3.f * uc) / (p.m * (p.l * p.l)));
}

// the damped step's new angular velocity from the angle th
__device__ __forceinline__ float damped_newdth(const PendulumParams& p,
                                               float th, float dth,
                                               float uc) {
  return dth + kDt * (((-3.f * p.g) / (2.f * p.l) * (-sinf(th + p.b)) +
                       (3.f * uc) / (p.m * (p.l * p.l))) -
                      p.d * th);
}

// x_{t+1} = f(x_t, u_t).  The simple pendulum by angle addition with
// atan2's renormalisation (mpc_tpu/ops/math.py:rotate_unit), (0, 0)
// taken as angle 0; the damped one through th = atan2f(sin, cos), which
// is 0 at (0, 0).  Rn: the simple pendulum's dth by pendulum_newdth_rn.
template <bool Damped, bool Rn = false>
__device__ __forceinline__ void pendulum_step(const PendulumParams& p,
                                              const float* x, float u,
                                              float* out) {
  const float cos_th = x[0], sin_th = x[1];
  const float uc = clampf(u, -kMaxTorque, kMaxTorque);
  if constexpr (Damped) {
    const float th = atan2f(sin_th, cos_th);
    const float newdth = damped_newdth(p, th, x[2], uc);
    const float newth = th + newdth * kDt;
    out[0] = cosf(newth);
    out[1] = sinf(newth);
    out[2] = newdth;
  } else {
    const float newdth = Rn ? pendulum_newdth_rn(p, sin_th, x[2], uc)
                            : pendulum_newdth(p, sin_th, x[2], uc);
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
}

// F[i][j] = d x_{t+1}[i] / d (x_t, u_t)[j].  The control column is the
// full derivative for -2 <= u <= 2, ENDPOINTS INCLUDED (hard_clip's
// convention: bang-bang controls sit exactly on the bound), and 0
// strictly outside.  At (0, 0) the derivatives through the angle are 0:
// the rotation's inputs are constants there (simple), atan2's angle is 0
// whatever the pair's direction (damped).
template <bool Damped>
__device__ __forceinline__ void pendulum_jacobian(const PendulumParams& p,
                                                  const float* x, float u,
                                                  float F[3][4]) {
  const float cos_th = x[0], sin_th = x[1];
  const bool inside = (u >= -kMaxTorque) & (u <= kMaxTorque);
  const float uc = clampf(u, -kMaxTorque, kMaxTorque);
  const float r2 = cos_th * cos_th + sin_th * sin_th;
  const bool deg = r2 < 1e-30f;
  if constexpr (Damped) {
    const float th = atan2f(sin_th, cos_th);
    const float newdth = damped_newdth(p, th, x[2], uc);
    const float newth = th + newdth * kDt;
    const float nc = cosf(newth), ns = sinf(newth);
    const float inv_r2 = deg ? 0.f : 1.f / r2;
    const float th_c = -sin_th * inv_r2;
    const float th_s = cos_th * inv_r2;
    const float dn_dth =
        kDt * ((3.f * p.g) / (2.f * p.l) * cosf(th + p.b) - p.d);
    const float dn_du = inside ? kDt * (3.f / (p.m * (p.l * p.l))) : 0.f;
    const float dnt_dth = 1.f + kDt * dn_dth;
    const float dn_c = dn_dth * th_c, dn_s = dn_dth * th_s;
    const float dt_c = dnt_dth * th_c, dt_s = dnt_dth * th_s;
    const float dt_du = kDt * dn_du;
    F[0][0] = -ns * dt_c;
    F[0][1] = -ns * dt_s;
    F[0][2] = -ns * kDt;
    F[0][3] = -ns * dt_du;
    F[1][0] = nc * dt_c;
    F[1][1] = nc * dt_s;
    F[1][2] = nc * kDt;
    F[1][3] = nc * dt_du;
    F[2][0] = dn_c;
    F[2][1] = dn_s;
    F[2][2] = 1.f;
    F[2][3] = dn_du;
  } else {
    const float newdth = pendulum_newdth(p, sin_th, x[2], uc);
    const float delta = newdth * kDt;
    const float cd = cosf(delta), sd = sinf(delta);
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
}

}  // namespace mpc
