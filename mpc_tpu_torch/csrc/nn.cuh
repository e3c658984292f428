// A one-hidden-layer MLP's step and its Jacobian for kernel K3, each call
// one example's in one thread, with the weights in the block's shared
// memory.
//
// Replaces the TPU kernel's param-streaming NN mode
// (mpc_tpu/ops/fused.py:1252-1306, which calls the model's _stream_core,
// mpc_tpu/models/dynamics.py:176-235): there the weights sit in SMEM and
// a fori_loop over the hidden units reads each with a scalar load.  Here
// the block copies the flat weight vector into shared memory once
// (stage_nn_weights), two float4 a hidden unit, and every lane of a warp
// reads the same unit at the same time: a broadcast.  H is a run-time
// argument, so one build serves every width, and registers do not grow
// with it.
//
// The arithmetic is the stream form's, in its order: the pre-activation
// w1[k, 0] z_0 + ... + w1[k, 3] z_3 + b1[k], the activation in the form
// that stays finite when saturated (sigmoid as 0.5 (tanh(0.5 v) + 1)),
// each output accumulated over k from exact zero, then b2 and the
// passthrough; the Jacobian accumulates (w2[j, k] act'(v)) w1[k, i] the
// same way and adds 1 on the diagonal with the passthrough.  The plain
// PyTorch version is mpc_tpu_torch/models/dynamics.py:soa_stream_step and
// soa_stream_jac.  Built without --use_fast_math: tanhf and expf are the
// accurate ones, and nvcc's FMA contraction is the only arithmetic
// difference from the plain version.
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

// x_{t+1} = MLP(x_t, u_t) (+ x_t with the passthrough)
template <int Act>
__device__ __forceinline__ void nn_step(const float4* w, int H, bool pass,
                                        const float* x, float u,
                                        float* out) {
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float4 a = w[2 * k];
    const float4 b = w[2 * k + 1];
    const float h = nn_act<Act>(nn_pre(a, b, x, u));
    acc0 = acc0 + b.y * h;
    acc1 = acc1 + b.z * h;
    acc2 = acc2 + b.w * h;
  }
  const float4 b2 = w[2 * H];
  out[0] = acc0 + b2.x;
  out[1] = acc1 + b2.y;
  out[2] = acc2 + b2.z;
  if (pass) {
    out[0] = out[0] + x[0];
    out[1] = out[1] + x[1];
    out[2] = out[2] + x[2];
  }
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
