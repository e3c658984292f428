"""Fused KKT backward: kernels K2 and K4 for Hopper, their plain PyTorch
versions, and the batched fixed point whose backward runs them.

Counterpart of mpc_tpu/ops/fused_bwd.py, whose ``_make_bwd_kernel``
(mpc_tpu/ops/fused_bwd.py:251-410) differentiates the converged
box-constrained LQR fixed point in one Pallas kernel: a differential
Riccati solve on (C, -r) with the active set pinned, the differential
rollout from dx_0 = 0, dC = -1/2 (dtau (x) tau + tau (x) dtau) and
dc = -dtau, the costate and differential-costate recursions, then dF,
df and dx_init (reference mpc/lqr_step.py:311-407).  There is no line
search, no inner QP and no outer loop, so per example it is one short
linear pass.  ``_make_bwd_kernel_long`` (mpc_tpu/ops/fused_bwd.py:
413-785) is the same function with the three passes as loops over per-t
scratch, and with the gradients of batch-shared dynamics reduced in the
kernel as those of a batch-shared cost are.

On the H100 both are one kernel, csrc/kkt_bwd.cuh: K2
(csrc/fused_kkt_bwd.cu) with T known at compile time and per-example
dynamics, K4 (csrc/fused_kkt_bwd_long.cu) with T a run-time argument and
F shared or per example.  Only the three true recurrences of an example
(the differential Riccati, the differential rollout, the differential
costate) are serial; the costate lam runs beside the first on a thread
of its own (a TEAM of threads an example, one in each role, each role
a warp), and every gradient is computed after the chains in a pass
parallel over t.  The state the chains read is in shared memory where
``k2_launch``/``k4_launch`` say it fits, with one copy a block of the
batch-shared operands; past that (K4 only) in a workspace in global
memory that the wrapper allocates.  A batch-shared cost or batch-shared
dynamics have their gradients reduced over the batch deterministically:
each block sums its examples by a fixed tree of warp shuffles, and a
second pass sums the blocks in order.  The launch geometry lives here alone and reaches the sources
as nvcc defines (``kernel_defines``, ``long_kernel_defines``).

``fused_kkt_backward_plain`` and ``fused_kkt_backward_long_plain`` are
the plain versions of those kernels: each kernel scalar is a [B] tensor
and the arithmetic runs in the kernels' order, which is one order
(float32 or float64).  ``fused_kkt_backward`` and
``fused_kkt_backward_long`` run them for tensors on the CPU; on a CUDA
tensor they launch K2 or K4 or raise, through the kernels'
``torch.library`` ops (ops/custom.py), which hold the launches.

Scope (``scope_gap_bwd``): K2 and K4 at n_state = 3, n_ctrl = 1, a
QuadCost whose C and c are each shared or batched, dynamics per example
(the pendulum's linearisation, a batched LinDx) or batch-shared (LinDx),
any T, float32 on the card; ``bwd_routes_long`` says which of the two
takes a backward.  Every other size with n_state + n_ctrl <= 32 (any
n_ctrl) goes to their dense configuration (``bwd_routes_dense``,
ops/fused_bwd_dense.py, csrc/fused_kkt_bwd_dense.cu), whatever the
layouts and T.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import fused, fused_bwd_dense
from .fused import _check_device
from .math import ACTIVE_TOL

# The launch geometry of K2 and K4.  An example is owned by a TEAM of
# threads, one in each role (csrc/kkt_bwd.cuh): role 0 walks the three
# recurrences, role 1 the costate lam beside the first; a role is a warp,
# a lane an example.  Both take 32 examples a block and a team of 4: the
# two roles and two more warps for the copies before the chains and the
# pass parallel over t, so B = 4096 is 128 blocks, one an SM.  Smaller
# blocks fill more SMs at config 4's B = 1024 but gain little there, since
# the chains' latency does not depend on the batch, and lose at B = 8192
# (PERF.md, PR 5).
K2_TEAM, K2_EXAMPLES = 4, 32
K4_TEAM, K4_EXAMPLES = 4, 32
# Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
# Floats of state a step and example: K, k (then dx, du), r and the mask
# (csrc/kkt_bwd.cuh:kFields); a block's state is [t, field, example] with
# one float of padding a step, so that threads on different steps read
# different banks.  Then one copy a block of the batch-shared C, c and F,
# 32 floats a step (kOpRow).  The costates lam and dlam, 6 floats a step
# and example, are a workspace in global memory (kCostates).
_STATE_FIELDS = 9
_OP_ROW = 32
_COSTATES = 6


def _bwd_launch(T, B, team, examples, resident=True) -> dict:
    state = T * (_STATE_FIELDS * examples + 1)
    state += -state % 4                    # the operands' copy is float4
    padded = -(-B // examples) * examples
    fields = _COSTATES + (0 if resident else _STATE_FIELDS)
    return dict(team=team, warps=team, examples=examples,
                blocks=-(-B // examples), resident=resident,
                smem_bytes=4 * (state + T * _OP_ROW) if resident else 0,
                workspace_bytes=4 * T * fields * padded)


def k2_launch(T, B) -> dict:
    """K2's launch geometry: team width, warps (a warp a role) and
    examples a block (at most 32, a lane each), blocks, the dynamic
    shared memory of a block, which holds the state of its examples'
    chains and its copy of the batch-shared cost (K2 refuses a T whose
    block does not fit: ``T_MAX_BWD``), and the workspace of the
    costates, [T, 6, blocks * examples] of float32."""
    return _bwd_launch(T, B, K2_TEAM, K2_EXAMPLES)


def k4_launch(T, B) -> dict:
    """K4's launch geometry: team width, warps and examples a block,
    blocks, where the state lives, and the workspace in global memory.

    A block of 32 examples holds 9 floats a step and example of state,
    and its copy of the batch-shared operands 32 floats a step: 4 *
    (289 + 32) = 1284 bytes a step, resident up to T = 181
    (``K4_T_RESIDENT``; the long configuration's T = 160 takes 205,440
    bytes).  Past that the state follows the costates in the workspace,
    [T, 6 + 9, blocks * examples] of float32, and the operands are read
    where they are, so any T runs."""
    geo = _bwd_launch(T, B, K4_TEAM, K4_EXAMPLES)
    if geo['smem_bytes'] <= SMEM_LIMIT:
        return geo
    return _bwd_launch(T, B, K4_TEAM, K4_EXAMPLES, resident=False)


def _longest_resident(launch) -> int:
    """The longest T whose block state ``launch`` keeps in shared
    memory."""
    T = 1
    while True:
        geo = launch(T + 1, 1)
        if not geo['resident'] or geo['smem_bytes'] > SMEM_LIMIT:
            return T
        T += 1


# K2's horizon limit: the longest T whose block of 32 examples holds its
# chains' state in shared memory (181).  It must stay at or above
# ops/fused.py:T_MAX (181), so that every horizon K1 solves has a K2
# backward.  Longer horizons go to K4.
T_MAX_BWD = _longest_resident(k2_launch)
# The longest horizon whose state K4 keeps in shared memory (181).
K4_T_RESIDENT = _longest_resident(k4_launch)

# One count per launch of K2, of K4 and of their dense configuration on
# the card, and nowhere else.
launch_counts = {'fused_kkt_bwd': 0, 'fused_kkt_bwd_long': 0,
                 'fused_kkt_bwd_dense': 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def bwd_routes_long(T, dyn_shared) -> bool:
    """THE K2-or-K4 routing predicate of the backward, shared by the
    fixed point's dispatch and the tests (as ``_bwd_route_long`` is in
    mpc_tpu/ops/fused_bwd.py:130-136).

    K4 takes batch-shared dynamics, because K2 is built for per-example
    F and has no reduction of dF, df, and anything past ``T_MAX_BWD``,
    the longest horizon whose chains' state K2's block holds in shared
    memory (K4 keeps it in global memory past its own limit, so it takes
    any T).  K2 keeps the rest, a per-example LinDx F included."""
    return bool(dyn_shared) or T > T_MAX_BWD


def bwd_routes_dense(n_state, n_ctrl) -> bool:
    """THE dense-configuration predicate of the backward, shared by the
    fixed point's dispatch and the tests (as ``fused.routes_dense`` is for
    the forward): every size but K2's and K4's 3 states and 1 control
    goes to csrc/fused_kkt_bwd_dense.cu, at any T and in any layout."""
    return (n_state, n_ctrl) != (3, 1)


def _dense_bwd_gap(n_state, n_ctrl) -> Optional[str]:
    """Why K2 and K4's dense configuration does not take these sizes
    (the dense forward's gate, ``fused.dense_gap``); None when it does or
    when they are K2's and K4's own."""
    gap = fused.dense_gap(n_state, n_ctrl) if bwd_routes_dense(
        n_state, n_ctrl) else None
    return None if gap is None else (
        f'the backward of a problem past the dense gate takes the eager '
        f'fixed point, as mpc_tpu takes its jnp path\'s there: {gap}')


def scope_gap_bwd(T, n_ctrl=1, dtype=torch.float32,
                  device=torch.device('cpu'), n_state=3,
                  slew=False) -> Optional[str]:
    """Why the backward kernels do not take the backward of a
    differentiable solve that K1, K3 or the dense configuration solved;
    None when K2, K4 or their dense configuration (``bwd_routes_dense``,
    ``bwd_routes_long``), or its plain version on the CPU, runs it.  The
    admission test alone: the dispatch runs the eager fixed point where it
    refuses, as mpc_tpu/learning.py:208-242 dispatches (float64 on the
    card, a slew penalty, sizes past the dense gate).  No horizon is
    refused: K4's and the dense backward's T is a run-time argument."""
    if slew:
        return ('a slew penalty\'s backward is the eager fixed point on the '
                'augmented problem, as in mpc_tpu (mpc_tpu/learning.py:'
                '196-242), so that gradients reach prev_ctrl')
    gap = _dense_bwd_gap(n_state, n_ctrl)
    if gap is not None:
        return gap
    if dtype not in (torch.float32, torch.float64):
        return f'dtype {dtype} is not supported (float32 or float64)'
    if dtype == torch.float64 and device.type == 'cuda':
        return ('the backward kernels are float32, as the TPU kernels are; '
                'float64 takes the eager fixed point')
    return None


def supports_bwd(T, n_ctrl=1, dtype=torch.float32,
                 device=torch.device('cpu'), n_state=3, slew=False) -> bool:
    """Whether K2, K4 or their dense configuration runs this backward
    (see ``scope_gap_bwd``)."""
    return scope_gap_bwd(T, n_ctrl, dtype, device, n_state, slew) is None


# ---------------------------------------------------------------------------
# work and bytes of one launch (the kernel's bound)
# ---------------------------------------------------------------------------

def k2_flops(T, B, cost_shared, ns=3, *, dyn_shared=False, has_f=True):
    """Arithmetic operations of K2 for n_ctrl = 1 (each +, -, *, /
    counts one; compares and selects none), counted from
    csrc/fused_kkt_bwd.cu; with ``dyn_shared`` or without ``has_f`` those
    of K4 (``k4_flops``), which runs the same passes.  The work does not
    depend on the data."""
    ntau = ns + 1
    ric = (ns * ntau * (2 * ns - 1)                # W = V F
           + ntau * (ntau + 1) // 2 * 2 * ns       # Qt = C + F^T W
           + ntau * 2 * ns)                        # qt = -r + F^T v
    ctrl = 1 + 2 + 2 * ns                          # inv, k, K
    vv = ns * ns + ns + ns * (ns + 1) // 2 * 4 + 2 + 4 * ns
    roll_u = 2 * ns                                # du = K dx + k
    roll_x = ns * (2 * ntau - 1)                   # dx' = F dtau
    dcost = ntau + ntau * (ntau + 1) // 2 * 4      # dc, dC (upper, mirrored)
    red = ntau * ntau + ntau if cost_shared else 0  # block and pass sums
    lam = 2 * ns * 2 * ntau                        # lam, dlam from C, c, r
    lam_f = 2 * ns * (2 * ns)                      # + F_x^T lam'
    n_df = ns if has_f else 0
    dyn = ns * ntau * 4 + n_df                     # dF, df
    red_dyn = ns * ntau + n_df if dyn_shared else 0
    per_t = ctrl + vv + roll_u + dcost + red + lam
    per_link = ric + roll_x + lam_f + dyn + red_dyn  # t < T-1 only
    # + the negations of r at t = T-1 and of dlam_0 into dx_init
    return B * (T * per_t + (T - 1) * per_link + ntau + ns)


def k4_flops(T, B, cost_shared, dyn_shared, has_f=True, ns=3):
    """Arithmetic operations of K4, counted from
    csrc/fused_kkt_bwd_long.cu (K2's passes, and the sums of dF, df for
    batch-shared dynamics)."""
    return k2_flops(T, B, cost_shared, ns, dyn_shared=dyn_shared,
                    has_f=has_f)


def k2_bytes(C, c, F, x_star, I_mask, has_f=True):
    """Bytes K2 or K4 (``k4_bytes``) must move on its operands: each
    input read once (shared ones once for the whole batch) and each
    output written once (reduced gradients once for the whole batch; no
    df for an absent f).  K4's workspace and the scratch of the
    reductions are neither."""
    T, B, ns = x_star.shape
    ntau = ns + 1
    e = x_star.element_size()
    ins = (C.numel() + c.numel() + F.numel()
           + T * B * (2 * ntau)                    # r = (dl_dx, dl_du), x*, u*
           + (I_mask.numel() if I_mask is not None else 0))
    cost_out = T * (ntau * ntau + ntau) * (1 if _cost_shared(C, c) else B)
    dyn_out = ((T - 1) * (ns * ntau + (ns if has_f else 0))
               * (1 if _dyn_shared(F) else B))
    return (ins + B * ns + cost_out + dyn_out) * e


k4_bytes = k2_bytes


# ---------------------------------------------------------------------------
# the plain versions of K2 and K4
# ---------------------------------------------------------------------------

def _cost_shared(C, c):
    """Whether the kernels reduce the cost gradient over the batch: C and
    c both shared (batch extent 1)."""
    return C.shape[1] == 1 and c.shape[1] == 1


def _dyn_shared(F):
    """Whether K4 reduces dF, df over the batch: F shared (batch extent
    1).  f has no values in the backward, so F's layout is the pair's."""
    return F.shape[1] == 1


def _sum3(a, b):
    """((a0 b0 + a1 b1) + a2 b2), the kernel's order for n_state = 3
    (and Python's ``sum`` order for any length)."""
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


def _kkt_passes(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask):
    """The three passes K2 and K4 share, per example: returns dx_init
    [B, ns], dC [T, B, ntau, ntau], dc [T, B, ntau], dF [T-1, B, ns,
    ntau] and df [T-1, B, ns] before any batch sum.  C, c and F may have
    a batch extent of 1 (shared, read for every example).  Same
    arithmetic in the same order as csrc/fused_kkt_bwd.cu and
    csrc/fused_kkt_bwd_long.cu."""
    T, B, ns = x_star.shape
    nt = ns + 1
    zero = x_star.new_zeros(B)
    Cl = [[[C[t, :, i, j] for j in range(nt)] for i in range(nt)]
          for t in range(T)]
    cl = [[c[t, :, i] for i in range(nt)] for t in range(T)]
    Fl = [[[F[t, :, i, j] for j in range(nt)] for i in range(ns)]
          for t in range(T - 1)]
    r = [list(dl_dx[t].unbind(-1)) + [dl_du[t, :, 0]] for t in range(T)]
    tau = [list(x_star[t].unbind(-1)) + [u_star[t, :, 0]] for t in range(T)]
    Iz = None if I_mask is None else [I_mask[t, :, 0] for t in range(T)]

    # ---- differential Riccati on (C, -r), active set pinned -----------
    K = [None] * T
    k = [None] * T
    V = v = None
    for t in range(T - 1, -1, -1):
        if t == T - 1:
            Qt = [[Cl[t][a][b] for b in range(nt)] for a in range(nt)]
            qt = [-r[t][a] for a in range(nt)]
        else:
            Ft = Fl[t]
            W = [[_sum3(V[i], [Ft[kk][j] for kk in range(ns)])
                  for j in range(nt)] for i in range(ns)]
            Qt = [[None] * nt for _ in range(nt)]
            for a in range(nt):
                for b in range(a, nt):
                    Qt[a][b] = Cl[t][a][b] + _sum3(
                        [Ft[kk][a] for kk in range(ns)],
                        [W[kk][b] for kk in range(ns)])
                    Qt[b][a] = Qt[a][b]
            qt = [-r[t][a] + _sum3([Ft[kk][a] for kk in range(ns)], v)
                  for a in range(nt)]
        Quu, qu = Qt[ns][ns], qt[ns]
        inv = 1.0 / Quu
        if Iz is None:
            kt = -qu * inv
            Kt = [-Qt[ns][j] * inv for j in range(ns)]
        else:
            free = Iz[t] < 0.5
            kt = torch.where(free, -qu * inv, zero)
            Kt = [torch.where(free, -Qt[ns][j] * inv, zero)
                  for j in range(ns)]
        K[t], k[t] = Kt, kt
        # cost-to-go in _bwd_vv_update's order (fused_bwd.py:201-226)
        QK = [[Qt[i][ns] * Kt[j] for j in range(ns)] for i in range(ns)]
        KQuu = [Quu * Kt[j] for j in range(ns)]
        V = [[None] * ns for _ in range(ns)]
        for i in range(ns):
            for j in range(i, ns):
                V[i][j] = ((Qt[i][j] + QK[i][j]) + QK[j][i]) + Kt[i] * KQuu[j]
                V[j][i] = V[i][j]
        quk = qu + Quu * kt
        v = [(qt[i] + Qt[i][ns] * kt) + Kt[i] * quk for i in range(ns)]

    # ---- differential rollout from dx_0 = 0, with dC and dc -----------
    dtau = [None] * T
    dC_t, dc_t = [], []
    dx = [zero] * ns
    for t in range(T):
        du = _sum3(K[t], dx) + k[t]
        if Iz is not None:
            du = torch.where(Iz[t] > 0.5, zero, du)
        d = dx + [du]
        dtau[t] = d
        g = [[None] * nt for _ in range(nt)]
        for i in range(nt):
            for j in range(i, nt):
                g[i][j] = -0.5 * (d[i] * tau[t][j] + tau[t][i] * d[j])
                g[j][i] = g[i][j]
        dC_t.append(torch.stack([torch.stack(row, -1) for row in g], -2))
        dc_t.append(torch.stack([-d[i] for i in range(nt)], -1))
        if t < T - 1:
            dx = [_sum3(Fl[t][i], d) for i in range(ns)]
    dC = torch.stack(dC_t, 0)
    dc = torch.stack(dc_t, 0)

    # ---- costate recursions, dF and df on the fly ---------------------
    dF = x_star.new_empty((T - 1, B, ns, nt))
    df = x_star.new_empty((T - 1, B, ns))
    lam_n = dlam_n = None
    for t in range(T - 1, -1, -1):
        Ct = Cl[t]
        lam = [(_sum3(Ct[i][:ns], tau[t][:ns]) + Ct[i][ns] * tau[t][ns])
               + cl[t][i] for i in range(ns)]
        dlam = [(_sum3(Ct[i][:ns], dtau[t][:ns]) + Ct[i][ns] * dtau[t][ns])
                - r[t][i] for i in range(ns)]
        if t < T - 1:
            Ft = Fl[t]
            for i in range(ns):
                for j in range(nt):
                    dF[t, :, i, j] = -(dlam_n[i] * tau[t][j]
                                       + lam_n[i] * dtau[t][j])
                df[t, :, i] = -dlam_n[i]
            lam = [lam[i] + _sum3([Ft[kk][i] for kk in range(ns)], lam_n)
                   for i in range(ns)]
            dlam = [dlam[i] + _sum3([Ft[kk][i] for kk in range(ns)], dlam_n)
                    for i in range(ns)]
        lam_n, dlam_n = lam, dlam
    dx_init = torch.stack([-dlam_n[i] for i in range(ns)], -1)
    return dx_init, dC, dc, dF, df


def fused_kkt_backward_plain(C, c, F, x_star, u_star, dl_dx, dl_du,
                             I_mask=None, *, has_f=True):
    """The plain PyTorch version of kernel K2, on the kernel's operands.

    C [T, 1 or B, ntau, ntau], c [T, 1 or B, ntau] (extent 1: shared, read
    for every example); F [T-1, B, ns, ntau]; x_star, dl_dx [T, B, ns];
    u_star, dl_du [T, B, 1]; I_mask None or [T, B, 1] float (1.0 = control
    pinned).  Returns (dx_init [B, ns], dC, dc, dF [T-1, B, ns, ntau],
    df [T-1, B, ns]); dC, dc are [T, ntau, ntau], [T, ntau] summed over
    the batch when C and c are both shared, else [T, B, ntau, ntau],
    [T, B, ntau].  df is zero when ``has_f`` is
    false.  Same arithmetic in the same order as csrc/fused_kkt_bwd.cu,
    apart from the order of the batch sum.
    """
    dx_init, dC, dc, dF, df = _kkt_passes(C, c, F, x_star, u_star, dl_dx,
                                          dl_du, I_mask)
    if _cost_shared(C, c):
        dC, dc = dC.sum(1), dc.sum(1)
    return dx_init, dC, dc, dF, df if has_f else torch.zeros_like(df)


def fused_kkt_backward_long_plain(C, c, F, x_star, u_star, dl_dx, dl_du,
                                  I_mask=None, *, has_f=True):
    """The plain PyTorch version of kernel K4, on the kernel's operands:
    those of ``fused_kkt_backward_plain`` with F [T-1, 1 or B, ns, ntau].

    Returns (dx_init, dC, dc, dF, df) as K2's plain version does, and for
    a shared F (extent 1) dF [T-1, ns, ntau] and df [T-1, ns] summed over
    the batch.  df is None when ``has_f`` is false: an absent f has no
    gradient.  Same arithmetic in the same order as
    csrc/fused_kkt_bwd_long.cu, apart from the order of the batch sums.
    """
    dx_init, dC, dc, dF, df = _kkt_passes(C, c, F, x_star, u_star, dl_dx,
                                          dl_du, I_mask)
    if _cost_shared(C, c):
        dC, dc = dC.sum(1), dc.sum(1)
    if _dyn_shared(F):
        dF, df = dF.sum(1), df.sum(1)
    return dx_init, dC, dc, dF, df if has_f else None


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# mpc_fused_kkt_bwd (K2) and mpc_fused_kkt_bwd_long (K4) take the same
# arguments (csrc/kkt_bwd.cuh:launch)
_ARGTYPES = [
    ctypes.c_int, ctypes.c_int,            # B, T
    _P, _I64, _I64,                        # C, t stride, batch stride
    _P, _I64, _I64,                        # c, t stride, batch stride
    _P, _I64, _I64,                        # F, t stride, batch stride
    _P, _P, _P, _P, _P,                    # dl_dx, dl_du, x*, u*, I
    ctypes.c_int,                          # has_f
    _P, ctypes.c_int, ctypes.c_int,        # workspace, resident, smem bytes
    _P, _P, _P, _P, _P,                    # dx_init, dC, dc, dF, df
    _P, _P,                                # cost partials, dynamics partials
    _P,                                    # stream
]


def kernel_defines(T, has_I, cost_shared) -> dict:
    """The nvcc defines of the K2 build for this horizon and layout."""
    return {'MPC_T': T, 'MPC_HAS_I': int(has_I),
            'MPC_COST_SHARED': int(cost_shared), 'MPC_TEAM': K2_TEAM,
            'MPC_EXAMPLES': K2_EXAMPLES}


def long_kernel_defines(cost_shared, dyn_shared) -> dict:
    """The nvcc defines of the K4 build for these layouts."""
    return {'MPC_COST_SHARED': int(cost_shared),
            'MPC_DYN_SHARED': int(dyn_shared), 'MPC_TEAM': K4_TEAM,
            'MPC_EXAMPLES': K4_EXAMPLES}


def _entry(name, defines, symbol):
    from . import _build
    fn = getattr(_build.load(name, defines), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _kernel_lib(T, has_I, cost_shared):
    return _entry('fused_kkt_bwd', kernel_defines(T, has_I, cost_shared),
                  'mpc_fused_kkt_bwd')


def _kernel_lib_long(cost_shared, dyn_shared):
    return _entry('fused_kkt_bwd_long',
                  long_kernel_defines(cost_shared, dyn_shared),
                  'mpc_fused_kkt_bwd_long')


def _strided(a, inner):
    """(pointer, t stride, batch stride) of a [T', 1 or B, ...] operand
    with ``inner`` elements per example and step; batch stride 0 for a
    shared one."""
    return (a.data_ptr(), a.shape[1] * inner,
            0 if a.shape[1] == 1 else inner)


def _check_operands(label, C, c, F, x_star, u_star, dl_dx, dl_du, I_mask):
    """Raise unless the operands are what K2 and K4 take: contiguous
    float32 on one device, the shapes of ``fused_kkt_backward_long_plain``
    and C, c, F aligned to 16 bytes (the kernels read them as float4)."""
    T, B, ns = x_star.shape
    ops = [C, c, F, x_star, u_star, dl_dx, dl_du] + (
        [I_mask] if I_mask is not None else [])
    for a in ops:
        if a.dtype != torch.float32 or a.device != x_star.device \
                or not a.is_contiguous():
            raise ValueError(f'{label} takes contiguous float32 operands on '
                             'one device')
    if (ns != 3 or C.shape[0] != T or C.shape[2:] != (4, 4)
            or c.shape[0] != T or c.shape[2:] != (4,)
            or C.shape[1] not in (1, B) or c.shape[1] not in (1, B)
            or F.shape[0] != T - 1 or F.shape[1] not in (1, B)
            or F.shape[2:] != (3, 4)
            or u_star.shape != (T, B, 1) or dl_dx.shape != (T, B, 3)
            or dl_du.shape != (T, B, 1)
            or (I_mask is not None and I_mask.shape != (T, B, 1))):
        raise ValueError(f'{label} operand shapes do not match')
    for a in (C, c, F):
        if a.data_ptr() % 16:
            raise ValueError(f'{label} takes C, c and F aligned to 16 bytes')


def fused_kkt_backward(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask=None,
                       *, has_f=True):
    """Run K2 on its operands (layouts as in ``fused_kkt_backward_plain``)
    through the op ``mpc_tpu_torch::k2_backward`` (ops/custom.py).

    On the CPU the op runs ``fused_kkt_backward_plain``.  On a CUDA
    tensor it launches csrc/fused_kkt_bwd.cu on the current stream with
    the geometry of ``k2_launch`` and raises on any operand the kernel
    does not take (T past ``T_MAX_BWD`` included) or on a launch
    error."""
    _check_device('K2', x_star)
    return tuple(torch.ops.mpc_tpu_torch.k2_backward(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, bool(has_f)))


def fused_kkt_backward_long(C, c, F, x_star, u_star, dl_dx, dl_du,
                            I_mask=None, *, has_f=True):
    """Run K4 on its operands (layouts as in
    ``fused_kkt_backward_long_plain``) through the op
    ``mpc_tpu_torch::k4_backward`` (ops/custom.py); df is None without
    ``has_f``.

    On the CPU the op runs ``fused_kkt_backward_long_plain``.  On a CUDA
    tensor it allocates what ``k4_launch`` says (the workspace past
    ``K4_T_RESIDENT``) and the scratch of the reductions, launches
    csrc/fused_kkt_bwd_long.cu on the current stream and raises on any
    operand the kernel does not take or on a launch error."""
    _check_device('K4', x_star)
    dxi, dC, dc, dF, df = torch.ops.mpc_tpu_torch.k4_backward(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, bool(has_f))
    return dxi, dC, dc, dF, df if has_f else None


# ---------------------------------------------------------------------------
# the batched fixed point
# ---------------------------------------------------------------------------

def _kernel_leaf(a, n_trailing, batched_shape=None):
    """A shared [T', ...] or batched [T', B, ...] leaf as the kernels'
    [T', 1 or B, ...] operand; with ``batched_shape`` a shared leaf is
    broadcast to it (its pair's other leaf is batched, and the kernels
    key a pair's reduction on both)."""
    if a.dim() == n_trailing + 1:
        a = a.unsqueeze(1)
        if batched_shape is not None:
            a = a.expand(batched_shape)
    return a.contiguous()


def _to_leaf(g, leaf):
    """A kernel's gradient in the layout of its leaf: summed over the
    batch for a shared leaf [T', ...] whose pair was batched, and
    reshaped where the kernel reduced a batch of one."""
    if g.dim() > leaf.dim():
        g = g.sum(1)
    return g.reshape(leaf.shape)


def active_set(u_star, u_lower, u_upper):
    """Controls on a bound at the solution (mpc_tpu/ops/fused_bwd.py:
    1123-1127) as K2's float mask [T, B, 1], 1.0 = pinned.  Computed from
    the u* the forward returned, never from a recast copy: K1 clamps, so
    an active control sits exactly on its bound."""
    return (((u_star - u_lower).abs() <= ACTIVE_TOL)
            | ((u_star - u_upper).abs() <= ACTIVE_TOL)).to(u_star.dtype)


@functools.lru_cache(maxsize=None)
def make_batched_fixed_point(n_state: int, has_bounds: bool, has_f: bool,
                             n_ctrl: int = 1):
    """Batched counterpart of the reference's no-op-forward LQR step
    (mpc_tpu/ops/fused_bwd.py:1096-1136) as a ``torch.autograd.Function``.

    ``apply(x_init, C, c, F, f, u_lower, u_upper, x_star, u_star)`` passes
    the converged x_star [T, B, n_state] and u_star [T, B, n_ctrl]
    through.  Its backward runs, over the whole batch, K2 or K4
    (``bwd_routes_long``) at 3 states and 1 control, their dense
    configuration (``bwd_routes_dense``) at every other admitted size, and
    returns gradients for x_init [B, n_state], C, c, F and f (None when
    ``has_f`` is false) in their own layouts: a shared leaf C
    [T, ntau, ntau], c [T, ntau], F [T-1, n_state, ntau] or f
    [T-1, n_state] gets the gradient summed over the batch (by the kernel
    itself: K2 and K4 when both leaves of its pair are shared, the dense
    backward for each shared leaf), a batched leaf [T, B, ...] a
    per-example one.  Bounds (broadcastable to u_star, or None without
    ``has_bounds``) get zeros, the reference's gradient; x_star and
    u_star get none.  Sizes past the dense gate raise.
    """
    dense = bwd_routes_dense(n_state, n_ctrl)
    gap = _dense_bwd_gap(n_state, n_ctrl)
    if gap is not None:
        raise NotImplementedError(gap)

    class BatchedFixedPoint(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_init, C, c, F, f, u_lower, u_upper, x_star,
                    u_star):
            # f has no values in the backward; its shape says where df goes
            ctx.f_shape = f.shape if has_f else None
            ctx.save_for_backward(C, c, F, u_lower if has_bounds else None,
                                  u_upper if has_bounds else None, x_star,
                                  u_star)
            # new outputs, not the inputs themselves, so that autograd
            # attaches this function's backward to them
            return x_star.view_as(x_star), u_star.view_as(u_star)

        @staticmethod
        @once_differentiable
        def backward(ctx, dl_dx, dl_du):
            C, c, F, lb, ub, x_star, u_star = ctx.saved_tensors
            I_mask = active_set(u_star, lb, ub) if has_bounds else None
            operands = (x_star.contiguous(), u_star.contiguous(),
                        dl_dx.contiguous(), dl_du.contiguous(), I_mask)
            if dense:
                f_shared = has_f and len(ctx.f_shape) == 2
                dxi, dC, dc, dF, df = fused_bwd_dense.fused_kkt_backward_dense(
                    _kernel_leaf(C, 2), _kernel_leaf(c, 1),
                    _kernel_leaf(F, 2), *operands, has_f=has_f,
                    f_shared=f_shared)
            else:
                dxi, dC, dc, dF, df = _k2_k4(C, c, F, has_f, ctx.f_shape,
                                            *operands)
            dlb, dub = (torch.zeros_like(b) if need else None for b, need in
                        zip((lb, ub), ctx.needs_input_grad[5:7]))
            if has_f:
                df = df.sum(1) if df.dim() > len(ctx.f_shape) else df
                df = df.reshape(ctx.f_shape)
            return (dxi, _to_leaf(dC, C), _to_leaf(dc, c), _to_leaf(dF, F),
                    df if has_f else None, dlb, dub, None, None)

    return BatchedFixedPoint


def _k2_k4(C, c, F, has_f, f_shape, x_star, u_star, dl_dx, dl_du, I_mask):
    """K2 or K4 (``bwd_routes_long``) on a backward's leaves, a shared
    leaf broadcast where its pair's other leaf is batched (K2 and K4 key a
    pair's reduction on both)."""
    T, B, ns = x_star.shape
    cost_shared = C.dim() == 3 and c.dim() == 2
    dyn_shared = F.dim() == 3 and (not has_f or len(f_shape) == 2)
    Ck = _kernel_leaf(C, 2, None if cost_shared else (T, B, ns + 1, ns + 1))
    ck = _kernel_leaf(c, 1, None if cost_shared else (T, B, ns + 1))
    Fk = _kernel_leaf(F, 2, None if dyn_shared else (T - 1, B, ns, ns + 1))
    run = (fused_kkt_backward_long if bwd_routes_long(T, dyn_shared)
           else fused_kkt_backward)
    return run(Ck, ck, Fk, x_star, u_star, dl_dx, dl_du, I_mask, has_f=has_f)
