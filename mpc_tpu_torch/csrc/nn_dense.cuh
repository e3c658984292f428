// An MLP's step and its Jacobian for the dense kernel's MLP build
// (fused_ilqr_dense.cu, MPC_MODEL 4): a warp an example, the block's
// weights in shared memory.
//
// Replaces the TPU kernels' MLP modes at every size they take: the
// param-streaming mode of _make_kernel_long (mpc_tpu/ops/fused.py:
// 1252-1306; NNDynamics._stream_core, soa_stream_jac and
// soa_stream_step_multi, mpc_tpu/models/dynamics.py:170-283) for one
// hidden layer, and the tuple path (dyn_mode 'soa', :1307-1340 in K3,
// :676-700 and :788-815 in K1; NNDynamics.soa_step,
// mpc_tpu/models/dynamics.py:285-309, linearised in the kernel by
// jax.linearize) for deeper MLPs.  There the weights are SMEM scalars and
// each unit's activation a lane register of the batch tile; here one
// warp computes one example's step.
//
// The layout.  The step is on the rollout's chain (x_{t+1} needs x_t), so
// a layer is split across the warp's lanes: lane k takes units k,
// k + 32, ..., each unit's pre-activation a dot product over the layer's
// inputs in shared memory from the first term on, then its bias and the
// activation (mpc_tpu's soa_step order, so that the plain version is the
// model's own soa_step, models/dynamics.py); the activations go to the
// warp's scratch, and after a __syncwarp the next layer reads them as
// broadcasts.  The output layer is the same rule: lane j computes
// x_{t+1}[j], a dot product over the last hidden layer, which is the
// longest dependent chain of the step (h multiply-adds).  Kept simple
// first: splitting that dot product over the lanes with a butterfly would
// shorten it and change the order of the sums (PERF.md section 7).  A
// lane's units are computed kUnits at a time, so that their independent
// chains overlap.
//
// The Jacobian (off the Riccati chain: the kernel computes the T - 1 of
// the current trajectory in a pass before each sweep, one t after
// another) is the reverse product of the layers with the activations'
// derivatives, written by hand as the reference's grad_input forms it
// (mpc/dynamics.py:81-130): a forward pass keeps act'(v) of every hidden
// layer in the scratch, then G = W_L and, layer by layer down,
// G[j][m] <- sum_k (G[j][k] act'(v_k)) W[k][m], k ascending from the
// first term (the stream form's order at one hidden layer), lane m
// taking columns m, m + 32, ... with the n_state rows in registers; the
// last product goes straight to the Jacobian in the workspace, 1 added on
// the diagonal with the passthrough.  A lane-per-t pass, as the other
// models' Jacobians run, would keep every hidden vector of a step in one
// lane: a register array indexed by a loop, local memory.  The plain
// version is NNDynamics.soa_jacobian.
//
// The weights (a layer's W [n_out][n_in | 1], rows of odd stride, then
// b [n_out]) are copied into shared memory once a launch by all threads
// of the block (stage_mlp, as stage_nn_weights does for K3): a lane a
// unit reads a column of W (stride odd: 32 banks), a lane an input reads
// a row (consecutive).  Widths are run-time values (MLPLayout), the
// number of hidden layers and the activation are defines.  Built without
// --use_fast_math: tanhf and expf are the accurate ones, and nvcc's FMA
// contraction is the only arithmetic difference from the plain version.
#pragma once

#include "nn.cuh"

namespace mpc {

// hidden layers at most (ops/fused_dense.py:MAX_NN_DEPTH)
constexpr int kNNMaxDepth = 4;
// units of a layer a lane computes side by side
constexpr int kUnits = 4;

struct MLPLayout {
  int size[kNNMaxDepth + 2];  // n_in, hidden..., n_out
  int w[kNNMaxDepth + 1];     // a layer's W in the weights' copy
  int b[kNNMaxDepth + 1];     // its b
  int floats;                 // the weights' copy
  int wmax;                   // the widest hidden layer
  int scratch;                // a warp's scratch (mlp_scratch_floats)
  int pass;                   // the passthrough
};

// A warp's scratch in units of wmax: two activation buffers, the
// derivatives of each hidden layer, and one (two hidden layers) or two
// (more) buffers of n_out x wmax for the reverse product's rows
// (ops/fused_dense.py:_mlp_scratch_floats).
__host__ __device__ inline int mlp_scratch_floats(int depth, int wmax,
                                                  int n_out) {
  const int g = depth - 1 < 2 ? depth - 1 : 2;
  return wmax * (2 + depth + n_out * g);
}

// The layout of ``depth`` hidden layers of widths ``size`` (depth + 2
// entries); false if a width is not positive.
inline bool mlp_layout(const int* size, int depth, int pass,
                       MLPLayout& L) {
  if (depth < 1 || depth > kNNMaxDepth) return false;
  int off = 0;
  L.wmax = 0;
  for (int l = 0; l < depth + 2; ++l) {
    if (size[l] < 1) return false;
    L.size[l] = size[l];
  }
  for (int l = 0; l <= depth; ++l) {
    L.w[l] = off;
    off += size[l + 1] * (size[l] | 1);
    L.b[l] = off;
    off += size[l + 1];
    if (l < depth && size[l + 1] > L.wmax) L.wmax = size[l + 1];
  }
  L.floats = off;
  L.scratch = mlp_scratch_floats(depth, L.wmax, size[depth + 1]);
  L.pass = pass;
  return true;
}

// Copies the flat weights (mpc_tpu's soa_params_flat order: each layer's
// W row-major, then its b) into ``w``, all threads of the block together.
template <int Threads, int Depth>
__device__ __forceinline__ void stage_mlp(const float* p, const MLPLayout& L,
                                          float* w) {
  int src = 0;
#pragma unroll
  for (int l = 0; l <= Depth; ++l) {
    const int n_in = L.size[l], n_out = L.size[l + 1], s = n_in | 1;
    for (int e = threadIdx.x; e < n_out * n_in; e += Threads) {
      const int r = e / n_in;
      w[L.w[l] + r * s + (e - r * n_in)] = p[src + e];
    }
    src += n_out * n_in;
    for (int e = threadIdx.x; e < n_out; e += Threads)
      w[L.b[l] + e] = p[src + e];
    src += n_out;
  }
}

// The units of layer l that this lane takes (k = lane, lane + 32, ...):
// v = W[k][0] z[0] + ... + W[k][n_in - 1] z[n_in - 1] + b[k]; h[k] =
// act(v) and, where d is given, d[k] = act'(v).  Every lane of the warp
// calls it; the caller syncs the warp before h is read.
template <int Act>
__device__ __forceinline__ void mlp_hidden(const float* w,
                                           const MLPLayout& L, int l,
                                           const float* z, float* h,
                                           float* d, int lane) {
  const int n_in = L.size[l], n_out = L.size[l + 1], s = n_in | 1;
  const float* W = w + L.w[l];
  const float* b = w + L.b[l];
  for (int k0 = lane; k0 < n_out; k0 += 32 * kUnits) {
    const float* row[kUnits];
    float v[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      // clamped into the layer; a unit past it is computed and dropped
      const int k = k0 + 32 * u < n_out ? k0 + 32 * u : n_out - 1;
      row[u] = W + k * s;
      v[u] = row[u][0] * z[0];
    }
    for (int i = 1; i < n_in; ++i) {
      const float zi = z[i];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) v[u] = v[u] + row[u][i] * zi;
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int k = k0 + 32 * u;
      if (k < n_out) {
        const float vb = v[u] + b[k];
        h[k] = nn_act<Act>(vb);
        if (d != nullptr) d[k] = nn_dact<Act>(vb);
      }
    }
  }
}

// x_{t+1}[j] of lane j (< n_out; the other lanes return lane n_out - 1's)
// from the inputs z0 (x then u, n_in floats in shared memory): the hidden
// layers into the scratch buffers hA, hB in turn, then the output layer's
// unit j and the passthrough.  Every lane of the warp calls it.
template <int Depth, int Act>
__device__ __forceinline__ float mlp_step(const float* w, const MLPLayout& L,
                                          const float* z0, float* hA,
                                          float* hB, int lane) {
  const float* z = z0;
#pragma unroll
  for (int l = 0; l < Depth; ++l) {
    float* h = (l & 1) ? hB : hA;
    mlp_hidden<Act>(w, L, l, z, h, nullptr, lane);
    __syncwarp();
    z = h;
  }
  const int n_in = L.size[Depth], n_out = L.size[Depth + 1];
  const int j = lane < n_out ? lane : n_out - 1;
  const float* row = w + L.w[Depth] + j * (n_in | 1);
  float o = row[0] * z[0];
  for (int i = 1; i < n_in; ++i) o = o + row[i] * z[i];
  o = o + w[L.b[Depth] + j];
  if (L.pass) o = o + z0[j];
  return o;
}

// J[j][m] = d x_{t+1}[j] / d z0[m] for j < NOut, m < n_in, written to
// J[j * ldj + m] (the workspace), at the inputs z0 in shared memory.
// ``D`` holds Depth rows of wmax derivatives, ``GA`` and ``GB`` NOut rows
// of wmax each (GB only past two hidden layers).  Every lane of the warp
// calls it; it ends synced.
template <int Depth, int Act, int NOut>
__device__ __forceinline__ void mlp_jacobian(const float* w,
                                             const MLPLayout& L,
                                             const float* z0, float* hA,
                                             float* hB, float* D, float* GA,
                                             float* GB, int lane, float* J,
                                             int ldj) {
  const float* z = z0;
#pragma unroll
  for (int l = 0; l < Depth; ++l) {
    float* h = (l & 1) ? hB : hA;
    mlp_hidden<Act>(w, L, l, z, h, D + l * L.wmax, lane);
    __syncwarp();
    z = h;
  }
  // G = W_L (its rows of odd stride in the weights' copy)
  const float* G = w + L.w[Depth];
  int ldg = L.size[Depth] | 1;
#pragma unroll
  for (int l = Depth - 1; l >= 0; --l) {
    const int n_k = L.size[l + 1], n_m = L.size[l], s = n_m | 1;
    const float* W = w + L.w[l];
    const float* d = D + l * L.wmax;
    float* out = l == 0 ? J : (((Depth - 1 - l) & 1) ? GB : GA);
    const int ldo = l == 0 ? ldj : L.wmax;
    for (int m = lane; m < n_m; m += 32) {
      float acc[NOut];
      {
        const float dk = d[0], wkm = W[m];
#pragma unroll
        for (int j = 0; j < NOut; ++j) acc[j] = (G[j * ldg] * dk) * wkm;
      }
      for (int k = 1; k < n_k; ++k) {
        const float dk = d[k], wkm = W[k * s + m];
#pragma unroll
        for (int j = 0; j < NOut; ++j)
          acc[j] = acc[j] + (G[j * ldg + k] * dk) * wkm;
      }
      if (l == 0 && L.pass && m < NOut) {
#pragma unroll
        for (int j = 0; j < NOut; ++j)
          if (j == m) acc[j] = acc[j] + 1.f;
      }
#pragma unroll
      for (int j = 0; j < NOut; ++j) out[j * ldo + m] = acc[j];
    }
    __syncwarp();
    G = out;
    ldg = L.wmax;
  }
}

}  // namespace mpc
