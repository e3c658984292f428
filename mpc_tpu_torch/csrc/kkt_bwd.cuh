// The KKT backward of the converged box-constrained LQR fixed point, as
// kernels K2 (fused_kkt_bwd.cu: T at compile time, per-example dynamics)
// and K4 (fused_kkt_bwd_long.cu: T at run time, dynamics shared or per
// example) run it on Hopper.  Each of the two sources defines, before it
// includes this file, MPC_T (the horizon, or 0 for a run-time T), MPC_HAS_I
// (1 or 0, or -1: an active set where op.I is not null) and
// MPC_DYN_SHARED; the build gives MPC_COST_SHARED, MPC_TEAM and
// MPC_EXAMPLES (ops/fused_bwd.py: kernel_defines, long_kernel_defines).
//
// Per example the function has three recurrences that no design removes:
//   1. the differential Riccati recursion on (C, -r) with the active
//      controls pinned, backwards, giving the gains K[t], k[t];
//   2. the differential rollout from dx_0 = 0, forwards, giving dx[t],
//      du[t] (which take the place of K[t], k[t]);
//   3. the differential costate dlam, backwards, giving dx_init = -dlam[0];
// and a fourth that needs neither of the first two, the costate
//   lam[t] = C_x tau_t + c_x + F_x^T lam[t+1].
// Everything else is a function of the values at one t: dC = -1/2 (dtau (x)
// tau + tau (x) dtau), dc = -dtau, dF[t] = -(dlam[t+1] (x) tau[t] +
// lam[t+1] (x) dtau[t]), df[t] = -dlam[t+1], and the batch sums of those
// of batch-shared leaves.
//
// The design:
// - A TEAM of kTeam threads owns an example, one thread in each ROLE; a
//   role is one warp, lane e on the block's example e, so the roles never
//   diverge inside a warp.  Role 0 walks recurrences 1, 2 and 3; role 1
//   walks lam beside recurrence 1 (with a team of one, role 0 walks it
//   after recurrence 1).  The chains do no gradient work: no stores but
//   their own per-step values, no shuffles, no barriers.
// - What the three recurrences read and write is in SHARED MEMORY, the
//   STATE [t, field, example] (kFields floats a step and example): K and k,
//   then dx and du in their place, and the example's rows r and the mask,
//   which the block copies there from device memory in a pass parallel
//   over t before the chains start (cp.async: every copy of a thread in
//   flight at once).  Behind it lies one copy a block of the batch-shared
//   C, c and F (kOpRow floats a step).  So no step of those chains waits
//   for device memory: their loads are shared-memory loads, issued
//   kChainAhead steps ahead.  ops/fused_bwd.py computes where it fits
//   (k2_launch, k4_launch); past that (K4 only) the state is a workspace in
//   global memory with the same layout over the padded batch, and the
//   shared operands are read where they are.
// - The costates lam and dlam are written to a workspace in global memory
//   [t, 6, padded batch] (stores wait for nothing) and read back only by
//   the pass parallel over t.  The chain of lam reads x and u from device
//   memory, kCostateAhead steps ahead.
// - After the chains and one __syncthreads(), every thread of the block
//   computes the gradients in a pass parallel over t, neighbouring lanes
//   on neighbouring examples of one step, so that every load is coalesced:
//   per-example ones are stored as they are, and for a batch-shared leaf
//   each warp takes a step at a time (kSumAhead steps' loads in flight)
//   and sums its lanes' 35 values by a fixed tree of shuffles (warp_sums)
//   into a [n_blocks, T, 20] or [n_blocks, T-1, 15] scratch that
//   reduce_partials_kernel sums in block order.  No atomics: two
//   launches on the same inputs give the same bits, and an example's
//   values do not depend on where in the batch it sits.
//
// Per example the arithmetic is that of the plain PyTorch version
// (mpc_tpu_torch/ops/fused_bwd.py:_kkt_passes), in its order; nvcc's FMA
// contraction is the only difference.  n_state = 3, n_ctrl = 1.

#include <cuda_runtime.h>

namespace mpc_bwd {

constexpr int NS = 3;
constexpr int NTAU = 4;
constexpr int kT = MPC_T;          // 0: the horizon is op.T
constexpr int kHasI = MPC_HAS_I;   // -1: an active set where op.I != nullptr
constexpr bool kCostShared = MPC_COST_SHARED != 0;
constexpr bool kDynShared = MPC_DYN_SHARED != 0;
constexpr int kTeam = MPC_TEAM;          // threads an example, one a role
constexpr int kExamples = MPC_EXAMPLES;  // examples a block
constexpr int kThreads = kTeam * 32;    // a role is one warp
constexpr int kWarps = kTeam;
// the state of a step and example: K, k (later dx, du), r, the mask
constexpr int kFields = 9;
constexpr int kD = 0, kR = 4, kPin = 8;
// the costates of a step and example, in global memory: lam, dlam
constexpr int kCostates = 6;
constexpr int kLam = 0, kDlam = 3;
// a step of the block's copy of the batch-shared operands, in floats
constexpr int kOpRow = 32;
constexpr int kOffC = 0, kOffc = 16, kOffF = 20;
static_assert(kOffc == 16 && kOffF == 20 && kOpRow == 32,
              "stage() copies C, c, F as float4 slots 0-3, 4, 5-7 of a step");
constexpr int kRedCost = NTAU * NTAU + NTAU;  // dC and dc entries of a step
constexpr int kRedDyn = NS * NTAU + NS;       // dF and df entries of a step
constexpr int kRedAll = kRedCost + kRedDyn;
// steps the chains' loads run ahead: those of lam come from device memory
constexpr int kChainAhead = 2, kCostateAhead = 2;
// steps whose loads a warp of the block sums has in flight together
constexpr int kSumAhead = 4;
constexpr int kReduceThreads = 128;
static_assert(kTeam >= 1 && kTeam <= 4, "one to four roles");
static_assert(kExamples % 2 == 0 && kExamples <= 32,
              "an even number of examples, at most a warp's lanes");

// Every operand, output and workspace has fewer than 2^31 elements (the
// launcher checks), so indices are 32-bit.
struct Operands {
  int B, T;
  const float* C;  // [T, 1 or B, 4, 4]
  int sCt, sCb;
  const float* c;  // [T, 1 or B, 4]
  int sct, scb;
  const float* F;  // [T-1, 1 or B, 3, 4]
  int sFt, sFb;
  const float* rx;  // [T, B, 3]
  const float* ru;  // [T, B]
  const float* x;   // [T, B, 3]
  const float* u;   // [T, B]
  const float* I;   // [T, B], 1.0 = pinned; nullptr without an active set
  int has_f;        // 0: df is written as zeros (K2)
  float* ws;        // [T, kCostates, n_blocks * kExamples], then the state
                    // [T, kFields, n_blocks * kExamples] where not resident
  float* dxi;       // [B, 3]
  float* dC;        // [T, B, 4, 4]; unused when the cost is shared
  float* dc;        // [T, B, 4]; unused when the cost is shared
  float* dF;        // [T-1, B, 3, 4]; unused when the dynamics are shared
  float* df;        // [T-1, B, 3] or nullptr (no f); unused when shared
  float* part_cost;  // [n_blocks, T, 20] when the cost is shared
  float* part_dyn;   // [n_blocks, T-1, 15] when the dynamics are shared
};

// ((a0 b0 + a1 b1) + a2 b2)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// Copies 4 or 16 bytes from device memory to shared memory without
// passing through registers; the copy is in flight until cp_async_wait().
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ``p`` points into global or shared memory, 16-byte aligned
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

extern __shared__ float smem[];

// Runs load(i, r) and then store(i, r) for the items i = threadIdx.x,
// threadIdx.x + kThreads, ... < n, kChunk items a thread at a time: every
// load of a chunk is issued before its first store, which the compiler
// would not arrange by itself, as it cannot tell that a store to the
// workspace or to an output does not alias the next item's loads.
template <int kChunk, class Regs, class Load, class Store>
__device__ __forceinline__ void in_chunks(int n, const Load& load,
                                          const Store& store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kChunk * kThreads) {
    Regs r[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (i0 + k * kThreads < n) load(i0 + k * kThreads, r[k]);
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (i0 + k * kThreads < n) store(i0 + k * kThreads, r[k]);
  }
}

// Slot i of the block's copy of the batch-shared operands, sixteen bytes:
// step i / 8, float4 slots 0-3 of C, 4 of c, 5-7 of F; nullptr where the
// operand is per example (or past F's last step).
__device__ __forceinline__ const float* staged_source(const Operands& op,
                                                      int T, int i) {
  constexpr int kSlots = kOpRow / 4;
  const int t = i / kSlots;
  const int j = i - t * kSlots;
  if (j < 4) return op.sCb == 0 ? op.C + t * op.sCt + 4 * j : nullptr;
  if (j == 4) return op.scb == 0 ? op.c + t * op.sct : nullptr;
  return op.sFb == 0 && t < T - 1 ? op.F + t * op.sFt + 4 * (j - 5) : nullptr;
}

// Starts copying the batch-shared ones of C, c and F into the block's
// shared memory, kOpRow floats a step, all threads of the block together:
// every chain waits for the copy (cp_async_wait, then a barrier).
__device__ __forceinline__ void stage(const Operands& op, int T, float* dst) {
#pragma unroll 4
  for (int i = threadIdx.x; i < T * (kOpRow / 4); i += kThreads) {
    const float* src = staged_source(op, T, i);
    if (src != nullptr) cp_async16(dst + 4 * i, src);
  }
}

// An operand as the chains read it: the example's rows in global memory,
// or the block's copy in shared memory.
struct Operand {
  const float* p;
  int step;  // floats between steps

  __device__ __forceinline__ const float* at(int t) const {
    return p + t * step;
  }
};

// ``staged`` is the block's copy of the batch-shared operands (nullptr
// where it has none); it is used where the operand is batch-shared, which
// ``shared`` (the build's layout) says at compile time where it can.
__device__ __forceinline__ Operand operand(const float* src, int step,
                                           int batch, int b,
                                           const float* staged, int offset,
                                           bool shared) {
  if (staged != nullptr && (shared || batch == 0))
    return Operand{staged + offset, kOpRow};
  return Operand{src + b * batch, step};
}

// The operands of one step, as one register set.
struct Ops {
  float C[NTAU][NTAU], c[NTAU];
  float F[NS][NTAU];  // those of min(t, T - 2): the last step has none
};

// The block's state: field f of example e at step t is
// p[t * step + f * field + e].
struct State {
  float* p;
  int step, field;

  __device__ __forceinline__ float& at(int t, int f, int e) const {
    return p[t * step + f * field + e];
  }
};

struct Example {
  const Operands& op;
  int T;
  int b;  // the example
  int e;  // its place in the block
  Operand C, c, F;
  State st;
  State cs;  // the costates

  __device__ __forceinline__ float& state(int t, int f) const {
    return st.at(t, f, e);
  }
  __device__ __forceinline__ float& costates(int t, int f) const {
    return cs.at(t, f, e);
  }
  __device__ __forceinline__ void load_ops(int t, Ops& m) const {
    const float* Cp = C.at(t);
#pragma unroll
    for (int i = 0; i < NTAU; ++i) load4(Cp + 4 * i, m.C[i]);
    load4(c.at(t), m.c);
    if (T > 1) {
      const float* Fp = F.at(t < T - 1 ? t : T - 2);
#pragma unroll
      for (int i = 0; i < NS; ++i) load4(Fp + 4 * i, m.F[i]);
    }
  }
};

// Walks ``n`` steps t = first, first + dir, ...: ``step(t, ops, rows)``
// gets the operands of step t (``Example::load_ops``) and the example's
// rows of step t (``load(t, rows)``), both loaded kDepth steps ahead into a
// ring of kDepth slots of registers.  The loop is unrolled kDepth times
// and a slot is refilled right after its step has used it, so no value is
// copied between registers.  Past the last step the loads repeat it.
template <int kDepth, class Rows, class Load, class Step>
__device__ __forceinline__ void walk(const Example& ex, int first, int dir,
                                     int n, const Load& load,
                                     const Step& step) {
  if (n <= 0) return;
  Ops ops[kDepth];
  Rows rows[kDepth];
  const auto fill = [&](int i, int k) {
    const int t = first + dir * (i < n ? i : n - 1);
    ex.load_ops(t, ops[k]);
    load(t, rows[k]);
  };
#pragma unroll
  for (int k = 0; k < kDepth; ++k) fill(k, k);
  for (int i0 = 0; i0 < n; i0 += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = i0 + k;
      if (i < n) {
        step(first + dir * i, ops[k], rows[k]);
        fill(i + kDepth, k);
      }
    }
  }
}

struct RiccatiRows {
  float r[NTAU];  // (rx, ru)
  float pin;
};
struct TauRows {
  float tau[NTAU];  // (x, u)
};
struct GainRows {
  float K[NTAU];  // (K, k)
  float pin;
};
struct DiffRows {
  float d[NTAU];  // (dx, du)
  float rx[NS];
};

// 1. the differential Riccati recursion on (C, -r), active set pinned,
// storing K[t], k[t]
__device__ __forceinline__ void riccati(const Example& ex) {
  const int T = ex.T;
  float V[NS][NS], v[NS];
  walk<kChainAhead, RiccatiRows>(
      ex, T - 1, -1, T,
      [&](int t, RiccatiRows& q) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) q.r[j] = ex.state(t, kR + j);
        q.pin = ex.state(t, kPin);
      },
      [&](int t, const Ops& m, const RiccatiRows& q) {
        float Qt[NTAU][NTAU], qt[NTAU];
        if (t == T - 1) {
#pragma unroll
          for (int a = 0; a < NTAU; ++a) {
#pragma unroll
            for (int j = 0; j < NTAU; ++j) Qt[a][j] = m.C[a][j];
            qt[a] = -q.r[a];
          }
        } else {
          float W[NS][NTAU];
#pragma unroll
          for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < NTAU; ++j)
              W[i][j] = dot3(V[i][0], V[i][1], V[i][2], m.F[0][j], m.F[1][j],
                             m.F[2][j]);
#pragma unroll
          for (int a = 0; a < NTAU; ++a) {
#pragma unroll
            for (int j = a; j < NTAU; ++j) {
              Qt[a][j] = m.C[a][j] + dot3(m.F[0][a], m.F[1][a], m.F[2][a],
                                          W[0][j], W[1][j], W[2][j]);
              Qt[j][a] = Qt[a][j];
            }
            qt[a] = -q.r[a] +
                    dot3(m.F[0][a], m.F[1][a], m.F[2][a], v[0], v[1], v[2]);
          }
        }
        // the n_ctrl = 1 control solve (_bwd_ctrl_solve,
        // mpc_tpu/ops/fused_bwd.py:162-198)
        const float Quu = Qt[3][3];
        const float qu = qt[3];
        const float inv = 1.f / Quu;
        const bool free_u = q.pin < 0.5f;
        const float kt = free_u ? -qu * inv : 0.f;
        float Kt[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) Kt[j] = free_u ? -Qt[3][j] * inv : 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) ex.state(t, kD + j) = Kt[j];
        ex.state(t, kD + 3) = kt;
        // cost-to-go (_bwd_vv_update, mpc_tpu/ops/fused_bwd.py:201-226)
        float QK[NS][NS], KQuu[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
#pragma unroll
          for (int j = 0; j < NS; ++j) QK[i][j] = Qt[i][3] * Kt[j];
          KQuu[i] = Quu * Kt[i];
        }
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
          for (int j = i; j < NS; ++j) {
            V[i][j] = ((Qt[i][j] + QK[i][j]) + QK[j][i]) + Kt[i] * KQuu[j];
            V[j][i] = V[i][j];
          }
        const float quk = qu + Quu * kt;
#pragma unroll
        for (int i = 0; i < NS; ++i)
          v[i] = (qt[i] + Qt[i][3] * kt) + Kt[i] * quk;
      });
}

// the costate lam[t] for t = T-1 .. 1 (lam[0] is read by nothing)
__device__ __forceinline__ void costate(const Example& ex) {
  const Operands& op = ex.op;
  const int T = ex.T;
  float lam_n[NS];
  walk<kCostateAhead, TauRows>(
      ex, T - 1, -1, T - 1,
      [&](int t, TauRows& q) {
        const int o = t * op.B + ex.b;
#pragma unroll
        for (int i = 0; i < NS; ++i) q.tau[i] = op.x[o * NS + i];
        q.tau[3] = op.u[o];
      },
      [&](int t, const Ops& m, const TauRows& q) {
        float lam[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          lam[i] = (dot3(m.C[i][0], m.C[i][1], m.C[i][2], q.tau[0], q.tau[1],
                         q.tau[2]) +
                    m.C[i][3] * q.tau[3]) +
                   m.c[i];
          if (t < T - 1)
            lam[i] = lam[i] + dot3(m.F[0][i], m.F[1][i], m.F[2][i], lam_n[0],
                                   lam_n[1], lam_n[2]);
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          ex.costates(t, kLam + i) = lam[i];
          lam_n[i] = lam[i];
        }
      });
}

// 2. the differential rollout from dx_0 = 0: dx[t], du[t] over K[t], k[t]
__device__ __forceinline__ void rollout(const Example& ex) {
  const int T = ex.T;
  float dx[NS] = {0.f, 0.f, 0.f};
  walk<kChainAhead, GainRows>(
      ex, 0, 1, T,
      [&](int t, GainRows& q) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) q.K[j] = ex.state(t, kD + j);
        q.pin = ex.state(t, kPin);
      },
      [&](int t, const Ops& m, const GainRows& q) {
        float du = dot3(q.K[0], q.K[1], q.K[2], dx[0], dx[1], dx[2]) + q.K[3];
        if (q.pin > 0.5f) du = 0.f;
        const float d[NTAU] = {dx[0], dx[1], dx[2], du};
#pragma unroll
        for (int j = 0; j < NTAU; ++j) ex.state(t, kD + j) = d[j];
        if (t < T - 1) {
          float nx[NS];
#pragma unroll
          for (int i = 0; i < NS; ++i)
            nx[i] = dot3(m.F[i][0], m.F[i][1], m.F[i][2], d[0], d[1], d[2]) +
                    m.F[i][3] * d[3];
#pragma unroll
          for (int i = 0; i < NS; ++i) dx[i] = nx[i];
        }
      });
}

// 3. the differential costate, and dx_init = -dlam[0]
__device__ __forceinline__ void diff_costate(const Example& ex) {
  const Operands& op = ex.op;
  const int T = ex.T;
  float dlam_n[NS];
  walk<kChainAhead, DiffRows>(
      ex, T - 1, -1, T,
      [&](int t, DiffRows& q) {
#pragma unroll
        for (int j = 0; j < NTAU; ++j) q.d[j] = ex.state(t, kD + j);
#pragma unroll
        for (int i = 0; i < NS; ++i) q.rx[i] = ex.state(t, kR + i);
      },
      [&](int t, const Ops& m, const DiffRows& q) {
        float dlam[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          dlam[i] = (dot3(m.C[i][0], m.C[i][1], m.C[i][2], q.d[0], q.d[1],
                          q.d[2]) +
                     m.C[i][3] * q.d[3]) -
                    q.rx[i];
          if (t < T - 1)
            dlam[i] = dlam[i] + dot3(m.F[0][i], m.F[1][i], m.F[2][i],
                                     dlam_n[0], dlam_n[1], dlam_n[2]);
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          ex.costates(t, kDlam + i) = dlam[i];
          dlam_n[i] = dlam[i];
        }
      });
#pragma unroll
  for (int i = 0; i < NS; ++i) op.dxi[ex.b * NS + i] = -dlam_n[i];
}

// One level of warp_sums' reduce-scatter: the lanes that differ in bit H
// swap halves of their first 2H entries, and each adds its partner's half
// to the half it keeps.  H is a template argument, so that every loop here
// has a trip count known at compile time and v stays in registers.
template <int H>
__device__ __forceinline__ void scatter_level(float (&v)[kRedAll], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The sums over a warp's lanes of v[0..kRedAll), in place: lane i gets the
// sum of entry i < 32 in v[0], by a reduce-scatter of five levels, and
// every lane gets those of entries 32.. in v[32..], by a butterfly.  A
// fixed tree over the lanes: the same bits every launch.
__device__ __forceinline__ void warp_sums(float (&v)[kRedAll], int lane) {
  static_assert(kRedAll >= 32, "a reduce-scatter of 32 entries");
#pragma unroll
  for (int i = 32; i < kRedAll; ++i) {
#pragma unroll
    for (int level = 0; level < 5; ++level)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16 >> level);
  }
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
}

// The gradients of step t from the block's state: the cost's (20 entries,
// dC then dc) and, for t < T-1, the dynamics' (15, dF then df).
struct Grads {
  float tau[NTAU], d[NTAU], lam_n[NS], dlam_n[NS];

  __device__ __forceinline__ void load(const Operands& op, const State& st,
                                       const State& cs, int t, int e, int b,
                                       bool link) {
    const int o = t * op.B + b;
#pragma unroll
    for (int i = 0; i < NS; ++i) tau[i] = op.x[o * NS + i];
    tau[3] = op.u[o];
#pragma unroll
    for (int j = 0; j < NTAU; ++j) d[j] = st.at(t, kD + j, e);
    if (link) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        lam_n[i] = cs.at(t + 1, kLam + i, e);
        dlam_n[i] = cs.at(t + 1, kDlam + i, e);
      }
    }
  }
  __device__ __forceinline__ void cost(float* g) const {
#pragma unroll
    for (int i = 0; i < NTAU; ++i) {
#pragma unroll
      for (int j = i; j < NTAU; ++j) {
        g[4 * i + j] = -0.5f * (d[i] * tau[j] + tau[i] * d[j]);
        g[4 * j + i] = g[4 * i + j];
      }
      g[16 + i] = -d[i];
    }
  }
  __device__ __forceinline__ void dyn(float* g) const {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int j = 0; j < NTAU; ++j)
        g[4 * i + j] = -(dlam_n[i] * tau[j] + lam_n[i] * d[j]);
      g[12 + i] = -dlam_n[i];
    }
  }
};

// The block's partial sums of step t: ``g`` holds lane k's example's
// values (``mine``: the lane has an example), warp_sums adds them over the
// lanes; lanes 0-19 store the cost's 20 entries, and for t < T-1 lanes
// 20-31 the dynamics' first 12 and lane 20 their last 3.
__device__ __forceinline__ void block_sums(const Operands& op, const Grads& g,
                                           int t, int T, int lane,
                                           bool mine) {
  const bool link = kDynShared && t < T - 1;
  // an empty lane, and a leaf that is not summed, add zeros
  float v[kRedAll] = {};
  if (mine) {
    if (kCostShared) g.cost(v);
    if (link) g.dyn(v + kRedCost);
  }
  warp_sums(v, lane);
  // lane i holds entry i < 32 in v[0], every lane entries 32.. in v[32..]
  if (lane < kRedCost) {
    if (kCostShared)
      op.part_cost[(blockIdx.x * T + t) * kRedCost + lane] = v[0];
  } else if (link) {
    float* row = op.part_dyn + (blockIdx.x * (T - 1) + t) * kRedDyn;
    row[lane - kRedCost] = v[0];
    if (lane == kRedCost) {
#pragma unroll
      for (int i = 32; i < kRedAll; ++i) row[i - kRedCost] = v[i];
    }
  }
}

// The rows of an example and step that the chains read: r and the mask.
struct RowRegs {
  float r[NTAU];
  float pin;
};

// The block's work.  kResident: the state is in shared memory, behind it
// the copy of the batch-shared operands; else the state is in the
// workspace and shared memory is not used.  A template, so that the
// compiler knows which loads and stores are shared memory's.
template <bool kResident>
__device__ __forceinline__ void block_backward(const Operands& op) {
  const int T = kT > 0 ? kT : op.T;
  const int B = op.B;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kExamples;
  const int n_ex = B - b0 < kExamples ? B - b0 : kExamples;
  const int padded = (int)gridDim.x * kExamples;
  const State cs{op.ws + b0, kCostates * padded, padded};
  const int state_floats =
      kResident ? (T * (kFields * kExamples + 1) + 3) & ~3 : 0;
  const State st = kResident
                       ? State{smem, kFields * kExamples + 1, kExamples}
                       : State{op.ws + T * kCostates * padded + b0,
                               kFields * padded, padded};
  float* const staged = kResident ? smem + state_floats : nullptr;
  // the examples' rows r and the mask into the state, parallel over t,
  // neighbouring threads on neighbouring examples
  const bool has_I = kHasI < 0 ? op.I != nullptr : kHasI != 0;
  if constexpr (kResident) {
    stage(op, T, staged);
#pragma unroll 4
    for (int i = tid; i < T * kExamples; i += kThreads) {
      const int t = i / kExamples;
      const int k = i - t * kExamples;
      if (k < n_ex) {
        const int o = t * B + b0 + k;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          cp_async4(&st.at(t, kR + j, k), op.rx + o * NS + j);
        cp_async4(&st.at(t, kR + 3, k), op.ru + o);
        if (has_I)
          cp_async4(&st.at(t, kPin, k), op.I + o);
        else
          st.at(t, kPin, k) = 0.f;
      }
    }
    cp_async_wait();
  } else {
    in_chunks<8, RowRegs>(
        T * kExamples,
        [&](int i, RowRegs& q) {
          const int t = i / kExamples;
          const int k = i - t * kExamples;
          if (k < n_ex) {
            const int o = t * B + b0 + k;
#pragma unroll
            for (int j = 0; j < NS; ++j) q.r[j] = op.rx[o * NS + j];
            q.r[3] = op.ru[o];
            q.pin = has_I ? op.I[o] : 0.f;
          }
        },
        [&](int i, const RowRegs& q) {
          const int t = i / kExamples;
          const int k = i - t * kExamples;
          if (k < n_ex) {
#pragma unroll
            for (int j = 0; j < NTAU; ++j) st.at(t, kR + j, k) = q.r[j];
            st.at(t, kPin, k) = q.pin;
          }
        });
  }
  __syncthreads();

  // ---- the chains: role 0 walks recurrences 1, 2 and 3, role 1 the
  // costate beside recurrence 1 ------------------------------------------
  const int role = tid / 32;
  const int lane = tid % 32;
  if (role < 2 && lane < n_ex) {
    const int b = b0 + lane;
    const Example ex{op,
                     T,
                     b,
                     lane,
                     operand(op.C, op.sCt, op.sCb, b, staged, kOffC,
                             kCostShared),
                     operand(op.c, op.sct, op.scb, b, staged, kOffc,
                             kCostShared),
                     operand(op.F, op.sFt, op.sFb, b, staged, kOffF,
                             kDynShared),
                     st,
                     cs};
    if (role == 0) {
      riccati(ex);
      if (kTeam == 1) costate(ex);
      rollout(ex);
      diff_costate(ex);
    } else if (kTeam > 1) {
      costate(ex);
    }
  }
  __syncthreads();

  // ---- the gradients, parallel over t -----------------------------------
  if (kCostShared || kDynShared) {
    // the block's partial sums: warp w takes steps w, w + kWarps, ...,
    // kSumAhead of them at a time with their loads in flight together,
    // lane k example k, and sums each entry over the lanes (warp_sums)
    for (int t0 = role; t0 < T; t0 += kSumAhead * kWarps) {
      Grads g[kSumAhead];
#pragma unroll
      for (int j = 0; j < kSumAhead; ++j) {
        const int t = t0 + j * kWarps;
        if (t < T && lane < n_ex)
          g[j].load(op, st, cs, t, lane, b0 + lane, kDynShared && t < T - 1);
      }
#pragma unroll
      for (int j = 0; j < kSumAhead; ++j) {
        const int t = t0 + j * kWarps;
        if (t < T) block_sums(op, g[j], t, T, lane, lane < n_ex);
      }
    }
  }
  if (!kCostShared || !kDynShared) {
    // per-example gradients: neighbouring threads on neighbouring examples
    in_chunks<4, Grads>(
        T * kExamples,
        [&](int i, Grads& g) {
          const int t = i / kExamples;
          const int k = i - t * kExamples;
          if (k < n_ex)
            g.load(op, st, cs, t, k, b0 + k, !kDynShared && t < T - 1);
        },
        [&](int i, const Grads& g) {
          const int t = i / kExamples;
          const int k = i - t * kExamples;
          if (k >= n_ex) return;
          const int o = t * B + b0 + k;
          float v[kRedCost];
          if (!kCostShared) {
            g.cost(v);
#pragma unroll
            for (int j = 0; j < 16; j += 4) store4(op.dC + o * 16 + j, v + j);
            store4(op.dc + o * NTAU, v + 16);
          }
          if (!kDynShared && t < T - 1) {
            g.dyn(v);
#pragma unroll
            for (int j = 0; j < 12; j += 4) store4(op.dF + o * 12 + j, v + j);
            if (op.df != nullptr) {
#pragma unroll
              for (int j = 0; j < NS; ++j)
                op.df[o * NS + j] = op.has_f ? v[12 + j] : 0.f;
            }
          }
        });
  }
}

// ``resident``: the state is in shared memory (K2's always is).
__global__ void __launch_bounds__(kThreads, 1)
    kkt_bwd_kernel(const Operands op, int resident) {
  if constexpr (kT > 0) {
    block_backward<true>(op);
  } else {
    if (resident)
      block_backward<true>(op);
    else
      block_backward<false>(op);
  }
}

// The second pass of the reductions, one thread an entry: entry e of the
// cost's partials [n_blocks, T, 20] (dC then dc of a step) or of the
// dynamics' [n_blocks, T-1, 15] (dF then df; no df for an absent f) is the
// sum of the blocks' partials in block order, the loads of kInFlight
// blocks in flight together.
constexpr int kInFlight = 32;

__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* part_cost, const float* part_dyn,
                           int n_blocks, int T, float* dC, float* dc,
                           float* dF, float* df) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_cost = kCostShared ? T * kRedCost : 0;
  const int n_dyn = kDynShared ? (T - 1) * kRedDyn : 0;
  const float* p;
  int n, per, first;
  float *a, *rest;
  if (e < n_cost) {
    p = part_cost, n = n_cost, per = kRedCost, first = NTAU * NTAU;
    a = dC, rest = dc;
  } else if (e - n_cost < n_dyn) {
    e -= n_cost;
    p = part_dyn, n = n_dyn, per = kRedDyn, first = NS * NTAU;
    a = dF, rest = df;
  } else {
    return;
  }
  float s = p[e];
  int blk = 1;
  for (; blk + kInFlight <= n_blocks; blk += kInFlight) {
    float q[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) q[k] = p[(blk + k) * n + e];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) s += q[k];
  }
  for (; blk < n_blocks; ++blk) s += p[blk * n + e];
  const int t = e / per;
  const int i = e % per;
  if (i < first)
    a[t * first + i] = s;
  else if (rest != nullptr)
    rest[t * (per - first) + i - first] = s;
}

// Launches the kernel on ``stream`` with the geometry of
// ops/fused_bwd.py (k2_launch, k4_launch), built with the same MPC_TEAM and
// MPC_EXAMPLES, then the block-order sums of the shared gradients; returns
// the cudaError_t of the launches, or of raising the kernel's
// shared-memory limit.  ``resident``: the state is in shared memory, else
// in the workspace ``ws`` behind the costates; ``smem_bytes`` is the
// block's dynamic shared memory.  Static, not inline: the
// limit it remembers belongs to this library's kernel (a static local of
// an inline function is one object for every library of the process).
static int launch(int B, int T, const float* C, long long sCt, long long sCb,
                  const float* c, long long sct, long long scb, const float* F,
                  long long sFt, long long sFb, const float* rx,
                  const float* ru, const float* x, const float* u,
                  const float* I, int has_f, float* ws, int resident,
                  int smem_bytes, float* dxi, float* dC, float* dc, float* dF,
                  float* df, float* part_cost, float* part_dyn, void* stream) {
  const int blocks = (B + kExamples - 1) / kExamples;
  const long long last = T - 1, lastb = B - 1, big = 1LL << 31;
  if (B <= 0 || T <= 0 || (kT > 0 && (T != kT || !resident)) ||
      (kHasI > 0 && I == nullptr) || ws == nullptr ||
      (T > 1 && F == nullptr) || (kCostShared && part_cost == nullptr) ||
      (kDynShared && T > 1 && part_dyn == nullptr) ||
      // 32-bit indices: the largest offset of each array
      last * sCt + lastb * sCb + 16 >= big ||
      last * sct + lastb * scb + 4 >= big ||
      last * sFt + lastb * sFb + 12 >= big || 16LL * T * B >= big ||
      1LL * T * (kCostates + kFields) * blocks * kExamples >= big ||
      1LL * blocks * T * kRedCost >= big)
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory has to be asked for; the
  // library remembers the most it has asked for
  static int smem_allowed = 48 * 1024;
  if (smem_bytes > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kkt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem_bytes;
  }
  Operands op;
  op.B = B;
  op.T = T;
  op.C = C;
  op.sCt = (int)sCt;
  op.sCb = (int)sCb;
  op.c = c;
  op.sct = (int)sct;
  op.scb = (int)scb;
  op.F = F;
  op.sFt = (int)sFt;
  op.sFb = (int)sFb;
  op.rx = rx;
  op.ru = ru;
  op.x = x;
  op.u = u;
  op.I = kHasI == 0 ? nullptr : I;
  op.has_f = has_f;
  op.ws = ws;
  op.dxi = dxi;
  op.dC = dC;
  op.dc = dc;
  op.dF = dF;
  op.df = df;
  op.part_cost = part_cost;
  op.part_dyn = part_dyn;
  cudaStream_t s = (cudaStream_t)stream;
  kkt_bwd_kernel<<<blocks, kThreads, smem_bytes, s>>>(op, resident ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (kCostShared ? T * kRedCost : 0) +
                (kDynShared ? (T - 1) * kRedDyn : 0);
  if (n > 0) {
    reduce_partials_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                             kReduceThreads, 0, s>>>(
        part_cost, part_dyn, blocks, T, dC, dc, dF, df);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace mpc_bwd
