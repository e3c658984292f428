// A one-hidden-layer MLP's step and its Jacobian for kernel K3's MLP
// configuration (fused_ilqr_long.cu, MPC_DYN = 2): a warp an example, the
// weights in the block's shared memory and, for the step, a lane's share
// of them in registers.
//
// Replaces the TPU kernel's param-streaming NN mode
// (mpc_tpu/ops/fused.py:1252-1306, which calls the model's _stream_core,
// mpc_tpu/models/dynamics.py:176-235): there the weights sit in SMEM and
// a fori_loop over the hidden units reads each with a scalar load.  Here
// the block copies the flat weight vector into shared memory once
// (stage_nn_weights), two float4 a hidden unit.  H is a run-time
// argument, so one build serves every width.
//
// The step (nn_step_warp) is on the rollout's chain, so it is split over
// the warp's lanes: a lane keeps its units' weights in registers
// (load_units; kUnitsReg of them, the rest read from shared memory), forms
// partial sums of the three outputs over its units, and a butterfly of
// shuffles sums the partials, another order of the output sums than the
// stream form's, which the plain version follows
// (ops/fused_dense.py:mlp_step_lanes).  The Jacobian (nn_jacobian, off
// the chains: a lane a step) is one lane's loop over every unit, the
// weights read as broadcasts (every lane on the same unit), in the
// stream form's order.
//
// The arithmetic is the stream form's: the pre-activation
// w1[k, 0] z_0 + ... + w1[k, 3] z_3 + b1[k], the activation in the form
// that stays finite when saturated (sigmoid as 0.5 (tanh(0.5 v) + 1));
// the Jacobian accumulates (w2[j, k] act'(v)) w1[k, i] over k from exact
// zero and adds 1 on the diagonal with the passthrough.  The plain
// PyTorch version of the Jacobian is
// mpc_tpu_torch/models/dynamics.py:soa_stream_jac.  Built without
// --use_fast_math: tanhf and expf are the accurate ones, and nvcc's FMA
// contraction in the Jacobian is its only arithmetic difference from the
// plain version (the step rounds as the plain version does).
#pragma once

namespace mpc {

// MPC_ACT: 0 sigmoid, 1 relu, 2 elu (ops/fused.py:NN_ACTIVATIONS)
template <int Act>
__device__ __forceinline__ float nn_act(float v) {
  if (Act == 0) return 0.5f * (tanhf(0.5f * v) + 1.f);
  if (Act == 1) return v < 0.f ? 0.f : v;
  return v > 0.f ? v : expf(v) - 1.f;
}

// the activation's derivative from the pre-activation
template <int Act>
__device__ __forceinline__ float nn_dact(float v) {
  if (Act == 0) {
    const float s = 0.5f * (tanhf(0.5f * v) + 1.f);
    return s * (1.f - s);
  }
  if (Act == 1) return v > 0.f ? 1.f : 0.f;
  return v > 0.f ? 1.f : expf(v);
}

// Copies the flat weights (mpc_tpu's soa_params_flat order: W1 [H, 4]
// row-major, b1 [H], W2 [3, H] row-major, b2 [3]) into ``w``, all threads
// of the block together: w[2k] = w1[k, :], w[2k + 1] = (b1[k], w2[:, k]),
// w[2H] = (b2, 0).
template <int Threads>
__device__ __forceinline__ void stage_nn_weights(const float* p, int H,
                                                 float4* w) {
  for (int k = threadIdx.x; k < H; k += Threads) {
    w[2 * k] = make_float4(p[4 * k], p[4 * k + 1], p[4 * k + 2],
                           p[4 * k + 3]);
    w[2 * k + 1] = make_float4(p[4 * H + k], p[5 * H + k], p[6 * H + k],
                               p[7 * H + k]);
  }
  if (threadIdx.x == 0)
    w[2 * H] = make_float4(p[8 * H], p[8 * H + 1], p[8 * H + 2], 0.f);
}

__device__ __forceinline__ float nn_pre(const float4 a, const float4 b,
                                        const float* x, float u) {
  return (((a.x * x[0] + a.y * x[1]) + a.z * x[2]) + a.w * u) + b.x;
}

// nn_pre with every product and sum rounded on its own, as the plain
// version's tensor operations round them: no multiply-add is contracted,
// so the rollout step has the plain version's bits
// (ops/fused_dense.py:mlp_step_lanes; the activations are the same
// functions).
__device__ __forceinline__ float nn_pre_rn(const float4 a, const float4 b,
                                           const float* x, float u) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, x[0]),
                                                 __fmul_rn(a.y, x[1])),
                                       __fmul_rn(a.z, x[2])),
                             __fmul_rn(a.w, u)),
                   b.x);
}

// p + w h, rounded as the plain version rounds it
__device__ __forceinline__ float nn_madd_rn(float p, float w, float h) {
  return __fadd_rn(p, __fmul_rn(w, h));
}

// Hidden units a lane keeps in registers (units lane, lane + 32, ...):
// 8 floats each, 32 registers at 4, which covers 128 units.
constexpr int kUnitsReg = 4;

// One lane's hidden units in registers, for the warp's step: unit
// k = lane + 32 s is (a[s], b[s]) = (w1[k, :], (b1[k], w2[:, k])), zero
// past the width (its partials then add 0).
struct Units {
  float4 a[kUnitsReg], b[kUnitsReg];
  float4 b2;  // (b2, 0)
  int n;      // slots a lane runs: min(kUnitsReg, ceil(H / 32)), the
              // same in every lane
};

__device__ __forceinline__ Units load_units(const float4* w, int H,
                                            int lane) {
  Units un;
#pragma unroll
  for (int s = 0; s < kUnitsReg; ++s) {
    const int k = lane + 32 * s;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    un.a[s] = k < H ? w[2 * k] : z;
    un.b[s] = k < H ? w[2 * k + 1] : z;
  }
  un.b2 = w[2 * H];
  const int slots = (H + 31) / 32;
  un.n = slots < kUnitsReg ? slots : kUnitsReg;
  return un;
}

// x_{t+1} = MLP(x_t, u_t) (+ x_t with the passthrough), in place, split
// over a warp's lanes: lane l forms the partial sums of the three outputs
// over its units l, l + 32, ... in that order from the first term on
// (those past kUnitsReg slots read from the block's copy ``w``), then an
// xor butterfly of shuffles (lane i adds lane i ^ o for o = 16, 8, 4, 2,
// 1) leaves the full sums, with the same bits, in every lane; then b2 and
// the passthrough.  Every lane of the warp calls it with the same x and
// u.  The plain version is ops/fused_dense.py:mlp_step_lanes, whose
// roundings it keeps (nn_pre_rn, nn_madd_rn).
template <int Act>
__device__ __forceinline__ void nn_step_warp(const Units& un,
                                             const float4* w, int H,
                                             bool pass, int lane, float* x,
                                             float u) {
  float p[3];
#pragma unroll
  for (int s = 0; s < kUnitsReg; ++s) {
    if (s < un.n) {
      const float h = nn_act<Act>(nn_pre_rn(un.a[s], un.b[s], x, u));
      if (s == 0) {
        p[0] = __fmul_rn(un.b[s].y, h);
        p[1] = __fmul_rn(un.b[s].z, h);
        p[2] = __fmul_rn(un.b[s].w, h);
      } else {
        p[0] = nn_madd_rn(p[0], un.b[s].y, h);
        p[1] = nn_madd_rn(p[1], un.b[s].z, h);
        p[2] = nn_madd_rn(p[2], un.b[s].w, h);
      }
    }
  }
  for (int k = lane + 32 * kUnitsReg; k < H; k += 32) {
    const float4 a = w[2 * k];
    const float4 b = w[2 * k + 1];
    const float h = nn_act<Act>(nn_pre_rn(a, b, x, u));
    p[0] = nn_madd_rn(p[0], b.y, h);
    p[1] = nn_madd_rn(p[1], b.z, h);
    p[2] = nn_madd_rn(p[2], b.w, h);
  }
  // a fixed count: a register array indexed in a loop whose count nvcc
  // cannot compute goes to local memory
#pragma unroll
  for (int level = 0; level < 5; ++level)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[j] = p[j] + __shfl_xor_sync(0xffffffffu, p[j], 16 >> level);
  const float o0 = p[0] + un.b2.x;
  const float o1 = p[1] + un.b2.y;
  const float o2 = p[2] + un.b2.z;
  x[0] = pass ? o0 + x[0] : o0;
  x[1] = pass ? o1 + x[1] : o1;
  x[2] = pass ? o2 + x[2] : o2;
}

// F[j][i] = d x_{t+1}[j] / d (x_t, u_t)[i]
template <int Act>
__device__ __forceinline__ void nn_jacobian(const float4* w, int H, bool pass,
                                            const float* x, float u,
                                            float F[3][4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) F[j][i] = 0.f;
#pragma unroll 2
  for (int k = 0; k < H; ++k) {
    const float4 a = w[2 * k];
    const float4 b = w[2 * k + 1];
    const float d = nn_dact<Act>(nn_pre(a, b, x, u));
    const float wd[3] = {b.y * d, b.z * d, b.w * d};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      F[j][0] = F[j][0] + wd[j] * a.x;
      F[j][1] = F[j][1] + wd[j] * a.y;
      F[j][2] = F[j][2] + wd[j] * a.z;
      F[j][3] = F[j][3] + wd[j] * a.w;
    }
  }
  if (pass) {
    F[0][0] = F[0][0] + 1.f;
    F[1][1] = F[1][1] + 1.f;
    F[2][2] = F[2][2] + 1.f;
  }
}

}  // namespace mpc
