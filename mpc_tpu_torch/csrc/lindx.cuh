// Linear dynamics x' = F (x, u) + f for the streaming kernels, one
// example per thread.
//
// Device counterpart of the LinDx branch of the TPU kernel
// (mpc_tpu/ops/fused.py:1369-1405): the step sums F[i][j] * tau[j] from
// j = 0 upwards and adds f[i] last, and the Jacobian is F itself.  F is
// [T-1, 1 or B, 3, 4] and f [T-1, 1 or B, 3] or absent; a batch-shared
// operand has batch stride 0, so every thread of a warp reads the same
// address and the load is one broadcast through the read-only cache.
#pragma once

namespace mpc {

struct LinDxOperand {
  const float* F;  // [T-1, 1 or B, 3, 4]
  long long sFt, sFb;
  const float* f;  // [T-1, 1 or B, 3], or nullptr
  long long sft, sfb;
};

__device__ __forceinline__ void lindx_load(const LinDxOperand& d, int t, int b,
                                           float F[3][4]) {
  const float* Fp = d.F + t * d.sFt + b * d.sFb;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) F[i][j] = __ldg(Fp + 4 * i + j);
}

__device__ __forceinline__ void lindx_step(const LinDxOperand& d, int t, int b,
                                           const float* x, float u,
                                           float* out) {
  float F[3][4];
  lindx_load(d, t, b, F);
  const float* fp = d.f ? d.f + t * d.sft + b * d.sfb : nullptr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = ((F[i][0] * x[0] + F[i][1] * x[1]) + F[i][2] * x[2]) + F[i][3] * u;
    if (fp) s += __ldg(fp + i);
    out[i] = s;
  }
}

}  // namespace mpc
