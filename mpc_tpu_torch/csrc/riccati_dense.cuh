// The Riccati step of the dense kernels, shared by the forward's sweep
// (fused_ilqr_dense.cu) and the backward's differential recursion
// (fused_kkt_bwd_dense.cu): the tiles' strides, the staging of a step's
// operands (C_t, c_t, F_t), the products W = V F_t and Q = C_t + F_t^T W
// as register tiles, and the cost-to-go.  One warp an example; every
// function is called by all 32 lanes of the warp.
//
// What bounds the step on this card.  Its products are ~3 n_state^2
// (n_state + n_ctrl) multiply-adds; with a lane a row of W or Q each
// multiply-add read one operand from shared memory, and an SM's shared
// memory serves one warp-wide 4-byte load a cycle against four
// warp-wide FMAs, so the products could not pass a quarter of the
// float32 rate, and the lanes past n_state (W) or the short rows near
// Q's corner (its upper triangle a row a lane) idled.
//
// What the design does about it.
//
// - THE PRODUCTS AS REGISTER TILES.  W (n_state x n_tau) is cut into
//   column blocks of kTC <= 4 columns and row groups of kTR rows
//   (WTiles: the shape whose busiest lane runs the fewest instructions,
//   a lane an entry at 5s1c, 6 x 4 at 24s4c): each lane keeps its tile's
//   sums in registers and runs an outer product over k, each loaded entry
//   feeding kTC or kTR multiply-adds.  V is symmetric (the cost-to-go
//   writes both halves with the same bits), so a lane's rows of V at a
//   fixed k are row k of V read at columns i0..i0+kTR: every load of a
//   step reads one row, k, of V, F_t or W, lanes of one block on the same
//   address (a broadcast) and blocks on neighbouring ones, so no load has
//   a bank conflict whatever the stride.  Q's upper triangle is cut into
//   kTB x kTB blocks (QTiles: 4 from n_tau = 16 on, 2 from 8, else 1),
//   a block a lane (36 blocks of 4 at n_tau = 32: four lanes take two),
//   each an outer product of F_t's row k at the block's rows with W's
//   row k at its columns; the entries on and above the diagonal are
//   added to C_t and mirrored.  Every sum keeps its order, from the first
//   term on, k ascending, and its first two terms are contracted as nvcc
//   contracts a fully unrolled sum (first_terms), so the bits are the
//   lane-a-row design's.  The k loop is not unrolled: the loads of one k
//   live at a time, so that up to 16 controls a build keeps to 128
//   registers.
// - 16-BYTE LOADS where the layout allows: in the prefetching layout the
//   rows of F, W and V have strides of a multiple of 4 floats
//   (RiccatiStrides) and start 16-byte aligned, so a block's 4 entries of
//   a row are one float4 load (and V's kTR entries when kTR is a multiple
//   of 4 that divides n_state).  Q keeps its odd stride: the control
//   solve and the cost-to-go read it a row a lane, and an odd stride puts
//   the 32 lanes' rows on 32 banks.  V's stride is even in that layout:
//   the cost-to-go writes V[i][i + s] and V[i + s][i] from lane i, at
//   banks i (stride + 1) + ..., distinct for an odd stride + 1.
// - THE NEXT STEP'S OPERANDS PREFETCHED (MPC_PREFETCH): while step t's
//   control solve and cost-to-go run, cp.async copies C_{t-1}, c_{t-1}
//   and F_{t-1} (or a model's Jacobian from the workspace) into a second
//   set of tiles; the top of step t-1 waits on them (cp.async.wait_all
//   and a __syncwarp).  TMA is not the tool: a warp's tiles are a few
//   hundred bytes to 4 KB, batch-strided, one set a step, and 4-byte
//   copies keep the odd-strided Q tile.  The host takes the second set
//   only where it pays (fused_dense.prefetch_fits: a step's C and F of
//   at least 512 floats, the blocks an SM kept); a build without it
//   keeps one set and the lane-a-row strides, so no size or MLP the
//   gate admits needs more shared memory than before.

#pragma once

#include <cuda_runtime.h>

#include "phase_clock.cuh"

namespace mpc {

// the strides of a warp's tiles: Q odd (a row a lane); W, F and V a
// multiple of 4 in the aligned layout, else the lane-a-row design's
template <int NS, int NT, bool Aligned>
struct RiccatiStrides {
  static constexpr int kSQ = NT | 1;
  static constexpr int kSW = Aligned ? (NT + 3) / 4 * 4 : (NT | 1);
  static constexpr int kSF = Aligned ? (NT + 3) / 4 * 4 : NT;
  static constexpr int kSV = Aligned ? (NS + 3) / 4 * 4 : (NS | 1);
};

// W's tiles: column blocks of kTC columns and row groups of kTR rows, a
// lane a tile, the pair (kTR, kTC <= 4) with at most 32 tiles whose
// busiest lane runs the fewest instructions a k (kTR kTC multiply-adds
// and kTR + kTC loads): a lane an entry at 5s1c, 6 x 4 at 24s4c
__host__ __device__ constexpr int w_tile_cost(int ns, int nt, int tr,
                                               int tc) {
  return ((ns + tr - 1) / tr) * ((nt + tc - 1) / tc) <= 32
             ? tr * tc + tr + tc
             : 1 << 20;
}

// the best (kTR, kTC) as kTR * 8 + kTC
__host__ __device__ constexpr int w_tile_best(int ns, int nt) {
  int b = 0, bc = 1 << 21;
  for (int tc = 1; tc <= 4; tc *= 2)
    for (int tr = 1; tr <= ns; ++tr)
      if (w_tile_cost(ns, nt, tr, tc) < bc) {
        bc = w_tile_cost(ns, nt, tr, tc);
        b = tr * 8 + tc;
      }
  return b;
}

template <int NS, int NT>
struct WTiles {
  static constexpr int kTC = w_tile_best(NS, NT) % 8;
  static constexpr int kTR = w_tile_best(NS, NT) / 8;
  static constexpr int kCB = (NT + kTC - 1) / kTC;
  static constexpr int kLanes = ((NS + kTR - 1) / kTR) * kCB;
};

// Q's tiles: kTB x kTB blocks of the upper triangle, a block a lane (two
// where there are more than 32): 4 x 4 from n_tau = 16 on (the rows of F
// and W then float4 loads), 2 x 2 from 8, a lane an entry below
template <int NT>
struct QTiles {
  static constexpr int kTB = NT >= 16 ? 4 : (NT >= 8 ? 2 : 1);
  static constexpr int kNB = (NT + kTB - 1) / kTB;
  static constexpr int kTiles = kNB * (kNB + 1) / 2;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One entry of a staged operand: copied in flight (Async), or read now,
// by the read-only path for a kernel operand (RO) and plainly for the
// workspace this warp wrote.
template <bool Async, bool RO>
__device__ __forceinline__ void stage_entry(float* dst, const float* src) {
  if constexpr (Async)
    cp_async4(dst, src);
  else if constexpr (RO)
    *dst = __ldg(src);
  else
    *dst = *src;
}

// rows x cols of a row-major source into a tile of row stride ld, the
// warp's lanes on neighbouring entries
template <int Rows, int Cols, int LD, bool Async, bool RO>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                          int lane) {
  for (int e = lane; e < Rows * Cols; e += 32) {
    const int i = e / Cols;
    stage_entry<Async, RO>(dst + i * LD + (e - i * Cols), src + e);
  }
}

// N consecutive floats from shared memory; as float4s where Vec
template <int N, bool Vec>
__device__ __forceinline__ void load_span(const float* p, float (&out)[N]) {
  if constexpr (Vec && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// The first two terms of a dot product a0 b0 + a1 b1 + ..., as nvcc
// contracts the fully unrolled sum s = a0 b0; s = s + a1 b1; ... of the
// lane-a-row design (its bits): the first product fused into the second
// term, fma(a0, b0, a1 b1); the later terms fused one by one
// (__fmaf_rn(ak, bk, s)).  Written out, so that a loop the compiler does
// not unroll takes the same contractions.  ``two`` false: a0 b0 alone.
__device__ __forceinline__ float first_terms(float a0, float b0, float a1,
                                             float b1, bool two) {
  return two ? __fmaf_rn(a0, b0, __fmul_rn(a1, b1)) : __fmul_rn(a0, b0);
}

// W = V F_t (W [NS][SW], V [NS][SV] symmetric, F [NS][SF]): each sum
// from its first term on, k ascending.  Lanes past WTiles::kLanes idle;
// a tile's rows past NS and columns past NT read clamped entries and
// store nothing.  Ends with a __syncwarp.
template <int NS, int NT, int SV, int SF, int SW, bool Vec>
__device__ __forceinline__ void products_W(const float* V, const float* F,
                                           float* W, int lane) {
  using Tl = WTiles<NS, NT>;
  constexpr int TR = Tl::kTR, TC = Tl::kTC;
  constexpr bool kVecV = Vec && TR % 4 == 0 && NS % TR == 0;
  constexpr bool kVecF = Vec && TC == 4;
  if (lane < Tl::kLanes) {
    const int rg = lane / Tl::kCB;
    const int i0 = rg * TR, j0 = (lane - rg * Tl::kCB) * TC;
    float acc[TR][TC];
    // row k of V (the lane's rows i0..) and of F (its columns j0..)
    auto load = [&](int k, float (&v)[TR], float (&f)[TC]) {
      if constexpr (kVecV) {
        load_span<TR, true>(V + k * SV + i0, v);
      } else {
#pragma unroll
        for (int r = 0; r < TR; ++r)
          v[r] = V[k * SV + (i0 + r < NS ? i0 + r : NS - 1)];
      }
      if constexpr (kVecF) {
        load_span<TC, true>(F + k * SF + j0, f);
      } else {
#pragma unroll
        for (int c = 0; c < TC; ++c)
          f[c] = F[k * SF + (j0 + c < NT ? j0 + c : NT - 1)];
      }
    };
    {
      float v[TR], f[TC], v1[TR], f1[TC];
      load(0, v, f);
      if (NS > 1) load(1, v1, f1);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c)
          acc[r][c] = first_terms(v[r], f[c], v1[r], f1[c], NS > 1);
    }
    // not unrolled: the loads of one k live at a time (registers)
#pragma unroll 1
    for (int k = 2; k < NS; ++k) {
      float v[TR], f[TC];
      load(k, v, f);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c)
          acc[r][c] = __fmaf_rn(v[r], f[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = i0 + r;
      if (i < NS) {
        if constexpr (kVecF) {
          // the row's padding past NT takes the tile's spare columns
          reinterpret_cast<float4*>(W + i * SW + j0)[0] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < TC; ++c)
            if (j0 + c < NT) W[i * SW + j0 + c] = acc[r][c];
        }
      }
    }
  }
  __syncwarp();
}

// Q = C_t + F_t^T W on and above the diagonal, mirrored below (Q [NT][SQ]
// holding C_t, F [NS][SF], W [NS][SW]): each sum from its first term on,
// k ascending, then added to C_t's entry.  A block of QTiles a lane.  No
// __syncwarp at the end (q follows in the caller).
template <int NS, int NT, int SF, int SW, int SQ, bool Vec>
__device__ __forceinline__ void products_Q(const float* F, const float* W,
                                           float* Q, int lane) {
  using Tl = QTiles<NT>;
  constexpr int TB = Tl::kTB, NB = Tl::kNB;
  constexpr bool kVec = Vec && TB == 4;
#pragma unroll 1
  for (int tile = lane; tile < Tl::kTiles; tile += 32) {
    int bi = 0, rem = tile;
    while (rem >= NB - bi) {
      rem -= NB - bi;
      ++bi;
    }
    const int i0 = TB * bi, j0 = TB * (bi + rem);
    float acc[TB][TB];
    // row k of F (the block's rows i0..) and of W (its columns j0..)
    auto load = [&](int k, float (&f)[TB], float (&w)[TB]) {
      if constexpr (kVec) {
        load_span<TB, true>(F + k * SF + i0, f);
        load_span<TB, true>(W + k * SW + j0, w);
      } else {
#pragma unroll
        for (int c = 0; c < TB; ++c) {
          f[c] = F[k * SF + (i0 + c < NT ? i0 + c : NT - 1)];
          w[c] = W[k * SW + (j0 + c < NT ? j0 + c : NT - 1)];
        }
      }
    };
    {
      float f[TB], w[TB], f1[TB], w1[TB];
      load(0, f, w);
      if (NS > 1) load(1, f1, w1);
#pragma unroll
      for (int r = 0; r < TB; ++r)
#pragma unroll
        for (int c = 0; c < TB; ++c)
          acc[r][c] = first_terms(f[r], w[c], f1[r], w1[c], NS > 1);
    }
#pragma unroll 1
    for (int k = 2; k < NS; ++k) {
      float f[TB], w[TB];
      load(k, f, w);
#pragma unroll
      for (int r = 0; r < TB; ++r)
#pragma unroll
        for (int c = 0; c < TB; ++c)
          acc[r][c] = __fmaf_rn(f[r], w[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int c = 0; c < TB; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (i <= j && j < NT) {
          const float qij = Q[i * SQ + j] + acc[r][c];
          Q[i * SQ + j] = qij;
          Q[j * SQ + i] = qij;
        }
      }
  }
}

// q = cb + F_t^T v for lane lt < NT (cb this lane's entry of C_t tau +
// c_t, or of -r_t); F [NS][SF], v [NS]
template <int NS, int SF>
__device__ __forceinline__ float q_entry(const float* F, const float* v,
                                         float cb, int lt) {
  float s = F[lt] * v[0];
#pragma unroll
  for (int k = 1; k < NS; ++k) s = s + F[k * SF + lt] * v[k];
  return cb + s;
}

// The cost-to-go V, v of a step (vv_update's sums, left to right) from
// Q [NT][SQ], q, the gains K [NC][NS] and k [NC] on the warp's tiles;
// KQ [NC][NS] scratch.  Lane i < NS owns row i.  With Quu, qu and kt
// given (the control solve in every lane's registers, up to kRegCtrlMax
// controls) those are read from registers, else from the tiles: the
// same values, the same sums.  Ends with a __syncwarp.
template <int NS, int NC, int SQ, int SV, bool Regs>
__device__ __forceinline__ void cost_to_go(
    const float* Qs, const float* qv, const float* Ks, float* KQs,
    const float* ks, const float (&Quu)[Regs ? NC : 1][Regs ? NC : 1],
    const float (&qu)[Regs ? NC : 1], const float (&kt)[Regs ? NC : 1],
    float* Vs, float* vv, int lane) {
  const int lx = lane < NS ? lane : NS - 1;
  const float* Qt = Qs + NS * SQ + NS;  // Quu on the tile
  if (lane < NS) {
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      float s;
      if constexpr (Regs) {
        s = Quu[m][0] * Ks[lx];
#pragma unroll
        for (int mm = 1; mm < NC; ++mm) s = s + Quu[m][mm] * Ks[mm * NS + lx];
      } else {
        const float* qr = Qt + m * SQ;
        s = qr[0] * Ks[lx];
        for (int mm = 1; mm < NC; ++mm) s = s + qr[mm] * Ks[mm * NS + lx];
      }
      KQs[m * NS + lane] = s;
    }
  }
  __syncwarp();
  if (lane < NS) {
    const int i = lx;
    // row i of Qxu and column i of K: in registers with the register
    // solve (a few controls), read from the tiles past it
    constexpr int RN = Regs ? NC : 1;
    const float* qxr = Qs + i * SQ + NS;
    float qxu_r[RN], ki[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      ki[m] = Ks[m * NS + i];
      if constexpr (Regs) qxu_r[Regs ? m : 0] = qxr[m];
    }
    auto qxu = [&](int m) { return Regs ? qxu_r[Regs ? m : 0] : qxr[m]; };
    for (int j = i; j < NS; ++j) {
      const float* qxj = Qs + j * SQ + NS;
      float qk_ij = qxu(0) * Ks[j];
      float qk_ji = qxj[0] * ki[0];
      float kqk = ki[0] * KQs[j];
#pragma unroll
      for (int m = 1; m < NC; ++m) {
        qk_ij = qk_ij + qxu(m) * Ks[m * NS + j];
        qk_ji = qk_ji + qxj[m] * ki[m];
        kqk = kqk + ki[m] * KQs[m * NS + j];
      }
      const float vn = ((Qs[i * SQ + j] + qk_ij) + qk_ji) + kqk;
      Vs[i * SV + j] = vn;
      Vs[j * SV + i] = vn;
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const float km = Regs ? kt[Regs ? m : 0] : ks[m];
      s1 = m == 0 ? qxu(0) * km : s1 + qxu(m) * km;
      float quk;
      if constexpr (Regs) {
        quk = Quu[m][0] * kt[0];
#pragma unroll
        for (int mm = 1; mm < NC; ++mm) quk = quk + Quu[m][mm] * kt[mm];
      } else {
        const float* qr = Qt + m * SQ;
        quk = qr[0] * ks[0];
        for (int mm = 1; mm < NC; ++mm) quk = quk + qr[mm] * ks[mm];
      }
      const float qum = Regs ? qu[Regs ? m : 0] : qv[NS + m];
      const float term = ki[m] * (qum + quk);
      s2 = m == 0 ? term : s2 + term;
    }
    vv[i] = (qv[i] + s1) + s2;
  }
  __syncwarp();
}

}  // namespace mpc
