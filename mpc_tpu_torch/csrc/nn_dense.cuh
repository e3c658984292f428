// An MLP's step and its Jacobians for the dense kernel's MLP build
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
// What bounds it on this card.  Every multiply-add of the MLP reads its
// operands from shared memory, and an SM serves one shared-memory
// wavefront a clock for its 16 warps: a broadcast (every lane the same
// word) costs a wavefront as a row of 32 words does.  So the design
// counts wavefronts a multiply-add.
//
// The step (the rollouts).  It is on the rollout's chain (x_{t+1} needs
// x_t), so a layer is split across the warp's lanes: lane k takes units
// k, k + 32, ..., each unit's pre-activation a dot product over the
// layer's inputs in shared memory from the first term on, then its bias
// and the activation (mpc_tpu's soa_step order, so that the plain version
// is the model's own soa_step, models/dynamics.py); the activations go to
// the warp's scratch, and after a __syncwarp the next layer reads them as
// broadcasts.  A lane runs ceil(width / 32) units of a layer, up to
// kUnits side by side (independent chains): the warp issues no slot that
// holds no unit in any lane (a lane past the width in the last slot reads
// the layer's last row and writes nothing).  The output layer's dot
// products, one a state, were each one lane's chain of h multiply-adds,
// the longest of the step; each is split over the lanes (a partial a
// lane over every 32nd unit, then the butterfly of shuffles), another
// order of its sum than soa_step's, which the plain version follows
// (fused_dense.mlp_step_lanes).
//
// The Jacobians (off the Riccati chain: the kernel computes the T - 1 of
// the current trajectory in a pass before each sweep) are the reverse
// product of the layers with the activations' derivatives, written by
// hand as the reference's grad_input forms it (mpc/dynamics.py:81-130).
// The steps are independent, so the warp takes a CHUNK of C consecutive
// steps at once (C <= kMaxChunk, sized by the host from the shared memory
// left, fused_dense.mlp_chunk), and every product is a register tile:
//
// - the forward pass, layer l: v[c][k] = sum_i W_l[k][i] a[c][i] + b[k]
//   for the chunk's steps c and the lane's units k (C x kUnits
//   accumulators), a step's inputs [i][C] in the scratch so that the C
//   values of one i are one broadcast (a float4 at C = 4), the lane's
//   weights a row each (odd stride: 32 banks); act(v) (below the last
//   hidden layer) and act'(v) go to the scratch, [k][C];
// - the reverse product, layer l down to the inputs:
//   G_{l-1}[c][j][m] = sum_k (G_l[c][j][k] act'_l(v)[c][k]) W_l[k][m],
//   k ascending from the first term, G_D = W_{D+1} (the block's weights,
//   the same for every step), the lane's columns m (and, where a layer
//   has fewer than 32 inputs, the warp's lanes split into groups over the
//   rows j), its rows (j, c) a tile of accumulators; the row operand G
//   act' is formed as the tile loads it; the last product (the inputs'
//   columns) goes straight to the Jacobian in the workspace, 1 added on
//   the diagonal with the passthrough.
//
// Every entry keeps soa_jacobian's order: the forward's W z from the
// first term, then the bias; the reverse's (G d) W from the first term.
// The products and sums are written as __fmul_rn, __fmaf_rn and
// __fadd_rn, the contraction nvcc makes of a one-step loop over them, so
// that the Jacobians' bits do not depend on the chunk.  The plain version
// is NNDynamics.soa_jacobian.
//
// The weights (a layer's W [n_out][n_in | 1], rows of odd stride, then
// b [n_out]) are copied into shared memory once a launch by all threads
// of the block (stage_mlp, as stage_nn_weights does for K3): a lane a
// unit reads a column of W (stride odd: 32 banks), a lane an input reads
// a row (consecutive).  Widths and the chunk are run-time values
// (MLPLayout), the number of hidden layers and the activation are
// defines.  Built without --use_fast_math: tanhf and expf are the
// accurate ones, and nvcc's FMA contraction is the only arithmetic
// difference from the plain version.
#pragma once

#include "nn.cuh"
#include "phase_clock.cuh"

namespace mpc {

// hidden layers at most (ops/fused_dense.py:MAX_NN_DEPTH)
constexpr int kNNMaxDepth = 4;
// units of a layer a lane computes side by side
constexpr int kUnits = 4;
// steps of the Jacobian pass a warp takes at once, at most
// (ops/fused_dense.py:MLP_MAX_CHUNK)
constexpr int kMaxChunk = 4;
// a reverse tile's accumulators a lane, at most
constexpr int kTileAcc = 16;

// The block's dynamic shared memory (the kernel's own declaration names the
// same bytes): the Jacobian pass, not inlined, forms its pointers from it,
// so that its loads are shared-memory loads and not generic ones.
extern __shared__ float mlp_shared[];

struct MLPLayout {
  int size[kNNMaxDepth + 2];  // n_in, hidden..., n_out
  int w[kNNMaxDepth + 1];     // a layer's W in the weights' copy
  int b[kNNMaxDepth + 1];     // its b
  int dpre[kNNMaxDepth];      // hidden units below layer l (its act' rows)
  int floats;                 // the weights' copy
  int wmax;                   // the widest hidden layer
  int hsum;                   // the hidden units
  int hmid;                   // the widest hidden layer but the last
  int base;                   // the one-step scratch (mlp_base_floats)
  int slot;                   // a chunk step's scratch (mlp_slot_floats)
  int chunk;                  // the Jacobian pass's steps at once
  int pass;                   // the passthrough
};

// The one-step scratch, in units of wmax: two activation buffers, the
// derivatives of each hidden layer, and one (two hidden layers) or two
// (more) buffers of n_out x wmax for the reverse product's rows.  A warp's
// scratch is never less, so that the gate (fused_dense.mlp_gap, at a
// chunk of one step) admits the same MLPs whatever the chunk
// (ops/fused_dense.py:_mlp_base_floats).
__host__ __device__ inline int mlp_base_floats(int depth, int wmax,
                                               int n_out) {
  const int g = depth - 1 < 2 ? depth - 1 : 2;
  return wmax * (2 + depth + n_out * g);
}

// A chunk step's scratch: the derivatives of every hidden layer, then the
// larger of the forward pass's (the inputs and one or two activation
// buffers of hmid) and the reverse product's (one or two buffers of
// n_out x hmid) (ops/fused_dense.py:_mlp_slot_floats).
__host__ __device__ inline int mlp_slot_floats(int depth, int n_in, int hsum,
                                               int hmid, int n_out) {
  const int g = depth - 1 < 2 ? depth - 1 : 2;
  const int fwd = n_in + g * hmid, rev = g * n_out * hmid;
  return hsum + (fwd > rev ? fwd : rev);
}

// A warp's scratch with a chunk of ``chunk`` steps: the larger of the base
// and the chunk's steps, a multiple of 4 floats (16-byte rows) where a
// chunk's rows are vector loads or the layout prefetches
// (ops/fused_dense.py:_mlp_scratch_floats).
__host__ __device__ inline int mlp_scratch_floats(int base, int slot,
                                                  int chunk, bool round) {
  const int s = base > chunk * slot ? base : chunk * slot;
  return round || chunk > 1 ? (s + 3) / 4 * 4 : s;
}

// The layout of ``depth`` hidden layers of widths ``size`` (depth + 2
// entries); false if a width is not positive.  The chunk is the
// launch's (set by the caller).
inline bool mlp_layout(const int* size, int depth, int pass,
                       MLPLayout& L) {
  if (depth < 1 || depth > kNNMaxDepth) return false;
  int off = 0;
  L.wmax = L.hsum = L.hmid = 0;
  for (int l = 0; l < depth + 2; ++l) {
    if (size[l] < 1) return false;
    L.size[l] = size[l];
  }
  for (int l = 0; l <= depth; ++l) {
    L.w[l] = off;
    off += size[l + 1] * (size[l] | 1);
    L.b[l] = off;
    off += size[l + 1];
    if (l < depth) {
      L.dpre[l] = L.hsum;
      L.hsum += size[l + 1];
      if (size[l + 1] > L.wmax) L.wmax = size[l + 1];
      if (l < depth - 1 && size[l + 1] > L.hmid) L.hmid = size[l + 1];
    }
  }
  L.floats = off;
  L.base = mlp_base_floats(depth, L.wmax, size[depth + 1]);
  L.slot = mlp_slot_floats(depth, size[0], L.hsum, L.hmid, size[depth + 1]);
  L.chunk = 1;
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

// A row of C floats at p ([...][C] layouts: a step's entry c at p[c]), the
// same in every lane: one float4 or float2 broadcast where C allows (the
// scratch's rows start 16-byte aligned, mlp_scratch_floats).
template <int C>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

template <int C>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// Units k, k + 32, ..., k + 32 (U - 1) of a layer (W [n_out][s], b) at C
// steps, the inputs A [n_in][C]: v = W[k][0] z[0] + ... + W[k][n_in - 1]
// z[n_in - 1] + b[k]; act(v) into H and act'(v) into Dv ([n_out][C]; a
// null one is not computed).  A unit past n_out reads the last row and
// writes nothing.
template <int Act, int C, int U>
__device__ __forceinline__ void hidden_units(const float* W, int s,
                                             const float* bias, int n_in,
                                             int n_out, const float* A,
                                             float* H, float* Dv, int k) {
  const float* row[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ku = k + 32 * u;
    row[u] = W + (ku < n_out ? ku : n_out - 1) * s;
  }
  float acc[C][U];
  {
    float z[C];
    load_rows<C>(A, z);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float wv = row[u][0];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][u] = __fmul_rn(wv, z[c]);
    }
  }
  // four steps of i in flight (two with more than 8 accumulators, which
  // would spill): the loads of the next inputs hide behind the
  // multiply-adds
#pragma unroll(C * U > 8 ? 2 : 4)
  for (int i = 1; i < n_in; ++i) {
    float z[C];
    load_rows<C>(A + i * C, z);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float wv = row[u][i];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][u] = __fmaf_rn(wv, z[c], acc[c][u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ku = k + 32 * u;
    if (ku < n_out) {
      const float bk = bias[ku];
      float h[C], d[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vb = __fadd_rn(acc[c][u], bk);
        if (H != nullptr) h[c] = nn_act<Act>(vb);
        if (Dv != nullptr) d[c] = nn_dact<Act>(vb);
      }
      if (H != nullptr) store_rows<C>(H + ku * C, h);
      if (Dv != nullptr) store_rows<C>(Dv + ku * C, d);
    }
  }
}

// Layer l of the hidden layers at C steps (hidden_units): lane k takes
// units k, k + 32, ..., up to kUnits at a time, the slots the widest lane
// needs (warp-uniform).  Every lane of the warp calls it; the caller
// syncs the warp before H or Dv is read.
template <int Act, int C>
__device__ __forceinline__ void hidden_layer(const float* w,
                                             const MLPLayout& L, int l,
                                             const float* A, float* H,
                                             float* Dv, int lane) {
  const int n_in = L.size[l], n_out = L.size[l + 1], s = n_in | 1;
  const float* W = w + L.w[l];
  const float* b = w + L.b[l];
  for (int k0 = 0; k0 < n_out; k0 += 32 * kUnits) {
    const int slots = (n_out - k0 + 31) / 32;
    const int k = k0 + lane;
    if (slots >= 4)
      hidden_units<Act, C, 4>(W, s, b, n_in, n_out, A, H, Dv, k);
    else if (slots == 3)
      hidden_units<Act, C, 3>(W, s, b, n_in, n_out, A, H, Dv, k);
    else if (slots == 2)
      hidden_units<Act, C, 2>(W, s, b, n_in, n_out, A, H, Dv, k);
    else
      hidden_units<Act, C, 1>(W, s, b, n_in, n_out, A, H, Dv, k);
  }
}

// The least power of two >= n.
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// x_{t+1}[j] of lane j (< NOut; the other lanes return output NOut - 1)
// from the inputs z0 (x then u, n_in floats in shared memory): the hidden
// layers into the scratch buffers hA, hB in turn, then the output layer
// and the passthrough.  An output's dot product over the last hidden
// layer is split over the lanes: lane l's partial over the units l, l +
// 32, ... from the first term on, the 32 partials summed by the xor
// butterfly's pairs (lane l and l ^ o for o = 16, 8, 4, 2, 1:
// fused_dense._lane_sum), then the bias (fused_dense.mlp_step_lanes, its
// plain version).  The butterfly transposes as it sums: while a lane holds
// several outputs' partials it keeps half of them (the upper half where
// its bit o is set) and sends its partner the other half, so NOut outputs
// take NOut - 1 + 5 - log2(NOut) shuffles, not 5 NOut, and output j ends
// in lane j << (5 - log2 P) (P the outputs rounded up to a power of two).
// A lane's chain is ceil(h / 32) multiply-adds and five adds, not h
// multiply-adds.  Every lane of the warp calls it.
template <int Depth, int Act, int NOut>
__device__ __forceinline__ float mlp_step(const float* w, const MLPLayout& L,
                                          const float* z0, float* hA,
                                          float* hB, int lane) {
  const float* z = z0;
#pragma unroll
  for (int l = 0; l < Depth; ++l) {
    float* h = (l & 1) ? hB : hA;
    hidden_layer<Act, 1>(w, L, l, z, h, nullptr, lane);
    __syncwarp();
    z = h;
  }
  constexpr int P = pow2_at_least(NOut);
  constexpr int kLogP = P >= 32 ? 5 : P >= 16 ? 4 : P >= 8 ? 3 : P >= 4 ? 2
                        : P >= 2 ? 1 : 0;
  const int n_in = L.size[Depth], s = n_in | 1;
  const float* W = w + L.w[Depth];
  float v[P];
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = 0.f;
  if (lane < n_in) {
    const float zl = z[lane];
#pragma unroll
    for (int j = 0; j < NOut; ++j) v[j] = __fmul_rn(W[j * s + lane], zl);
    for (int i = lane + 32; i < n_in; i += 32) {
      const float zi = z[i];
#pragma unroll
      for (int j = 0; j < NOut; ++j) v[j] = __fmaf_rn(W[j * s + i], zi, v[j]);
    }
  }
#pragma unroll
  for (int lev = 0; lev < 5; ++lev) {
    const int o = 16 >> lev;
    const int K = P >> lev;  // outputs a lane holds (known once unrolled)
    const bool up = (lane & o) != 0;
    if (K >= 2) {
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        const float send = up ? v[i] : v[i + K / 2];
        const float keep = up ? v[i + K / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  const int j = lane < NOut ? lane : NOut - 1;
  float out = __shfl_sync(0xffffffffu, v[0], j << (5 - kLogP));
  out = out + w[L.b[Depth] + j];
  if (L.pass) out = out + z0[j];
  return out;
}

// Where a reverse product's rows and columns go: the Jacobian (Last: J at
// step c, row j, column m is J[c * ldt + j * ldj + m]) or the next
// product's row operand G [m][NOut][C].
struct RevOut {
  float* G;
  float* J;
  int ldj, ldt, pass;
};

// The operands of row k of a reverse tile: a[b][c] = G[j_b](c, k)
// Dv[k][c] (the row operand) and the lane's columns of W's row k.
template <int C, int S, int JB, bool Wide, int NOut>
__device__ __forceinline__ void reverse_operands(
    const float* G, int ldg, const float* Dv, const float* const (&col)[S],
    int s, const int (&jr)[JB], int k, float (&a)[JB][C], float (&wv)[S]) {
  float d[C];
  load_rows<C>(Dv + k * C, d);
#pragma unroll
  for (int b = 0; b < JB; ++b) {
    if constexpr (Wide) {
      const float g = G[jr[b] * ldg + k];
#pragma unroll
      for (int c = 0; c < C; ++c) a[b][c] = __fmul_rn(g, d[c]);
    } else {
      float g[C];
      load_rows<C>(G + (k * NOut + jr[b]) * C, g);
#pragma unroll
      for (int c = 0; c < C; ++c) a[b][c] = __fmul_rn(g[c], d[c]);
    }
  }
#pragma unroll
  for (int q = 0; q < S; ++q) wv[q] = col[q][k * s];
}

// One pass of a reverse product at C steps: rows j = j0 + jstep b (b <
// JB; past NOut the last row, not written) and the lane's columns m + 32 s
// (s < S; past M the last, not written):
// out[j][c][m] = sum_k (G[j](c, k) Dv[k][c]) W[k][m], k ascending from the
// first term, G[j](c, k) = Gw[j * ldg + k] (Wide: a row of the next
// layer's weights, every step's) or G[(k NOut + j) C + c].
template <int C, int S, int JB, bool Wide, bool Last, int NOut>
__device__ __forceinline__ void reverse_pass(const float* G, int ldg,
                                             const float* Dv, const float* W,
                                             int s, int n_k, int M, int m,
                                             int j0, int jstep,
                                             const RevOut& o) {
  int jr[JB];
#pragma unroll
  for (int b = 0; b < JB; ++b) {
    const int j = j0 + jstep * b;
    jr[b] = j < NOut ? j : NOut - 1;
  }
  const float* col[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int mq = m + 32 * q;
    col[q] = W + (mq < M ? mq : M - 1);
  }
  float acc[JB][C][S], a[JB][C], wv[S];
  reverse_operands<C, S, JB, Wide, NOut>(G, ldg, Dv, col, s, jr, 0, a, wv);
#pragma unroll
  for (int b = 0; b < JB; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int q = 0; q < S; ++q) acc[b][c][q] = __fmul_rn(a[b][c], wv[q]);
  // four steps of k in flight (two with more than 8 accumulators), the
  // next rows' loads behind the multiply-adds
#pragma unroll(JB * C * S > 8 ? 2 : 4)
  for (int k = 1; k < n_k; ++k) {
    reverse_operands<C, S, JB, Wide, NOut>(G, ldg, Dv, col, s, jr, k, a, wv);
#pragma unroll
    for (int b = 0; b < JB; ++b)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < S; ++q)
          acc[b][c][q] = __fmaf_rn(a[b][c], wv[q], acc[b][c][q]);
  }
#pragma unroll
  for (int b = 0; b < JB; ++b) {
    const int j = j0 + jstep * b;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int mq = m + 32 * q;
      if (j < NOut && mq < M) {
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[c] = acc[b][c][q];
          if constexpr (Last)
            if (o.pass && mq == j) v[c] = __fadd_rn(v[c], 1.f);
        }
        if constexpr (Last) {
#pragma unroll
          for (int c = 0; c < C; ++c) o.J[c * o.ldt + j * o.ldj + mq] = v[c];
        } else {
          store_rows<C>(o.G + (mq * NOut + j) * C, v);
        }
      }
    }
  }
}

// rows j0, j0 + jstep, ... below NOut in passes of JB rows
template <int C, int S, int JB, bool Wide, bool Last, int NOut>
__device__ __forceinline__ void reverse_rows(const float* G, int ldg,
                                             const float* Dv, const float* W,
                                             int s, int n_k, int M, int m,
                                             int j0, int jstep,
                                             const RevOut& o) {
  for (int j = j0; j < NOut; j += jstep * JB)
    reverse_pass<C, S, JB, Wide, Last, NOut>(G, ldg, Dv, W, s, n_k, M, m, j,
                                             jstep, o);
}

__host__ __device__ constexpr int tile_rows(int C, int S, int NOut) {
  return kTileAcc / (C * S) < 1        ? 1
         : kTileAcc / (C * S) > NOut ? NOut
                                      : kTileAcc / (C * S);
}

// The reverse product of one layer (W [n_k][s], s = M | 1; Dv its act'
// [n_k][C]) at C steps, its rows G (Wide: the next layer's weights, row
// stride ldg) into ``o``.  Past 32 columns a lane takes columns m, m + 32,
// ... (up to kUnits a pass) and tile_rows rows a pass; up to 32 columns
// the lanes split into 32 / M groups, group g taking the rows g, g + 32 /
// M, ... (up to 4 a pass).  Every lane of the warp calls it; the caller
// syncs the warp before ``o`` is read.
template <int C, bool Wide, bool Last, int NOut>
__device__ __forceinline__ void reverse_layer(const float* G, int ldg,
                                              const float* Dv,
                                              const float* W, int n_k, int M,
                                              const RevOut& o, int lane) {
  const int s = M | 1;
  if (Last || M <= 32) {
    const int ng = 32 / M, g = lane / M, m = lane - g * M;
    const int j0 = g < ng ? g : NOut;  // lanes past the groups idle
    const int rows = (NOut + ng - 1) / ng;
    if (rows >= 4)
      reverse_rows<C, 1, 4, Wide, Last, NOut>(G, ldg, Dv, W, s, n_k, M, m,
                                              j0, ng, o);
    else if (rows >= 2)
      reverse_rows<C, 1, 2, Wide, Last, NOut>(G, ldg, Dv, W, s, n_k, M, m,
                                              j0, ng, o);
    else
      reverse_rows<C, 1, 1, Wide, Last, NOut>(G, ldg, Dv, W, s, n_k, M, m,
                                              j0, ng, o);
  } else if constexpr (!Last) {
    for (int m0 = 0; m0 < M; m0 += 32 * kUnits) {
      const int slots = (M - m0 + 31) / 32;
      const int m = m0 + lane;
      if (slots >= 4)
        reverse_rows<C, 4, tile_rows(C, 4, NOut), Wide, Last, NOut>(
            G, ldg, Dv, W, s, n_k, M, m, 0, 1, o);
      else if (slots == 3)
        reverse_rows<C, 3, tile_rows(C, 3, NOut), Wide, Last, NOut>(
            G, ldg, Dv, W, s, n_k, M, m, 0, 1, o);
      else if (slots == 2)
        reverse_rows<C, 2, tile_rows(C, 2, NOut), Wide, Last, NOut>(
            G, ldg, Dv, W, s, n_k, M, m, 0, 1, o);
      else
        reverse_rows<C, 1, tile_rows(C, 1, NOut), Wide, Last, NOut>(
            G, ldg, Dv, W, s, n_k, M, m, 0, 1, o);
    }
  }
}

// The Jacobians J_t[j][m] = d x_{t+1}[j] / d z_t[m] (j < NOut, m < n_in)
// of C consecutive steps t0 + c, their inputs z_t at traj + t ldz (the
// current trajectory), into J + c ldt + j ldj + m (the workspace), the
// scratch ``scr`` (mlp_slot_floats a step) laid out as the derivatives
// of every hidden layer [hsum][C], then the inputs [n_in][C] and the
// activation buffers [hmid][C] of the forward pass, where the reverse
// product's buffers [hmid][NOut][C] go after it.  Every lane of the warp
// calls it; it ends synced.  The clock charges the forward pass (and the
// inputs' copy) to the Jacobians, the reverse product to its own phase.
template <int Depth, int Act, int NOut, int C>
__device__ __forceinline__ void mlp_jacobian_chunk(
    const float* w, const MLPLayout& L, float* scr, const float* traj,
    int ldz, int lane, float* J, int ldj, int ldt, PhaseClock& clk) {
  const int n_in = L.size[0];
  float* const Dall = scr;
  float* const X = scr + C * L.hsum;
  float* const Z = X;
  float* const Abuf[2] = {X + C * n_in, X + C * (n_in + L.hmid)};
  float* const Gbuf[2] = {X, X + C * NOut * L.hmid};
  for (int e = lane; e < C * n_in; e += 32) {
    const int c = e / n_in, i = e - c * n_in;
    Z[i * C + c] = traj[c * ldz + i];
  }
  __syncwarp();
#pragma unroll
  for (int l = 0; l < Depth; ++l) {
    hidden_layer<Act, C>(w, L, l, l == 0 ? Z : Abuf[(l - 1) & 1],
                         l < Depth - 1 ? Abuf[l & 1] : nullptr,
                         Dall + C * L.dpre[l], lane);
    __syncwarp();
  }
  clk.mark(kPhJac);
  const float* const Wn = w + L.w[Depth];
  const int ldn = L.size[Depth] | 1;
  const RevOut last{nullptr, J, ldj, ldt, L.pass};
  if constexpr (Depth == 1) {
    reverse_layer<C, true, true, NOut>(Wn, ldn, Dall, w + L.w[0], L.size[1],
                                       n_in, last, lane);
  } else {
    // layer Depth - 1's rows from the output layer's weights, then each
    // layer's from the product above it, in the two buffers in turn
    reverse_layer<C, true, false, NOut>(
        Wn, ldn, Dall + C * L.dpre[Depth - 1], w + L.w[Depth - 1],
        L.size[Depth], L.size[Depth - 1], RevOut{Gbuf[0], nullptr, 0, 0, 0},
        lane);
    __syncwarp();
#pragma unroll
    for (int l = Depth - 2; l >= 1; --l) {
      reverse_layer<C, false, false, NOut>(
          Gbuf[(Depth - 2 - l) & 1], 0, Dall + C * L.dpre[l], w + L.w[l],
          L.size[l + 1], L.size[l],
          RevOut{Gbuf[(Depth - 1 - l) & 1], nullptr, 0, 0, 0}, lane);
      __syncwarp();
    }
    reverse_layer<C, false, true, NOut>(Gbuf[(Depth - 2) & 1], 0, Dall,
                                        w + L.w[0], L.size[1], n_in, last,
                                        lane);
  }
  __syncwarp();
  clk.mark(kPhJacRev);
}

// The Jacobians of the steps 0 .. n - 1 (inputs at traj + t ldz, into
// J + t ldt), L.chunk steps at a time (mlp_jacobian_chunk; the last chunk
// what is left), the weights and the warp's scratch at mlp_shared + wo and
// + so.  Not inlined: the tiles take the registers the caller's
// loops keep live, and a call saves those once a pass; inlined, the
// tiles spilled them for the whole kernel (4 KB of spill stores and the
// rollouts 1.4x slower on the H100).  The layout comes by value: a reference
// to the kernel's parameter would move the parameters to local memory.
template <int Depth, int Act, int NOut>
__device__ __noinline__ void mlp_jacobians(int wo, const MLPLayout L, int so,
                                           const float* traj, int ldz, int n,
                                           int lane, float* J, int ldj,
                                           int ldt, PhaseClock& clk) {
  const float* const w = mlp_shared + wo;
  float* const scr = mlp_shared + so;
  for (int t0 = 0; t0 < n; t0 += L.chunk) {
    const int c = n - t0 < L.chunk ? n - t0 : L.chunk;
    const float* z = traj + t0 * ldz;
    float* Jt = J + t0 * ldt;
    if (c >= 4)
      mlp_jacobian_chunk<Depth, Act, NOut, 4>(w, L, scr, z, ldz, lane, Jt,
                                              ldj, ldt, clk);
    else if (c == 3)
      mlp_jacobian_chunk<Depth, Act, NOut, 3>(w, L, scr, z, ldz, lane, Jt,
                                              ldj, ldt, clk);
    else if (c == 2)
      mlp_jacobian_chunk<Depth, Act, NOut, 2>(w, L, scr, z, ldz, lane, Jt,
                                              ldj, ldt, clk);
    else
      mlp_jacobian_chunk<Depth, Act, NOut, 1>(w, L, scr, z, ldz, lane, Jt,
                                              ldj, ldt, clk);
  }
}

}  // namespace mpc
