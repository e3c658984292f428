"""Fused KKT backward: kernel K2 for Hopper, its plain PyTorch version,
and the batched fixed point whose backward runs it.

Counterpart of mpc_tpu/ops/fused_bwd.py, whose ``_make_bwd_kernel``
(mpc_tpu/ops/fused_bwd.py:251-410) differentiates the converged
box-constrained LQR fixed point in one Pallas kernel: a differential
Riccati solve on (C, -r) with the active set pinned, the differential
rollout from dx_0 = 0, dC = -1/2 (dtau (x) tau + tau (x) dtau) and
dc = -dtau, the costate and differential-costate recursions, then dF,
df and dx_init (reference mpc/lqr_step.py:311-407).  There is no line
search, no inner QP and no outer loop, so per example it is one short
linear pass.

On the H100 the same function is csrc/fused_kkt_bwd.cu with ONE EXAMPLE
PER THREAD, as K1.  A batch-shared cost has its gradients reduced over
the batch inside the kernel's source, deterministically: each block sums
its threads in a fixed order and a second pass sums the blocks in order.

``fused_kkt_backward_plain`` is the plain version of that kernel: each
kernel scalar is a [B] tensor and the arithmetic runs in the kernel's
order (float32 or float64).  ``fused_kkt_backward`` runs it for tensors
on the CPU; on a CUDA tensor it launches K2 or raises.

Scope (``scope_gap_bwd``): n_ctrl = 1, batched dynamics (F per example),
a QuadCost whose C and c are each shared or batched, T <= T_MAX_BWD,
float32 on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .diff import ACTIVE_TOL

# Horizon limit.  K2 keeps 8*T floats per thread in local memory (the
# gains K, k and the differentials dx, du of every step; the costate
# pass consumes lambda on the fly, so it is never stored), and CUDA
# reserves that much for every resident thread slot of the card (2048
# per SM x 132 SMs).  At T = 512 that is 16 KB a thread, 4.4 GB in all:
# the reservation K1 accepts at its own T_MAX = 256 (ops/fused.py).  So
# every solve K1 runs can be differentiated.  The loops over t are not
# unrolled, so nvcc's time does not grow with T.
T_MAX_BWD = 512

# One count per launch of K2 on the card, and nowhere else.
launch_counts = {'fused_kkt_bwd': 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def scope_gap_bwd(T, n_ctrl=1, dtype=torch.float32,
                  device=torch.device('cpu')) -> Optional[str]:
    """Why a differentiable solve is outside K2's scope, naming the
    ROADMAP item that brings it; None when K2 (or its plain version on
    the CPU) runs it."""
    if n_ctrl != 1:
        return ('the backward of n_ctrl > 1 with the masked Cholesky waits '
                'for ROADMAP queue 2 (K2 configurations)')
    if dtype not in (torch.float32, torch.float64):
        return f'dtype {dtype} is not supported (float32 or float64)'
    if dtype == torch.float64 and device.type == 'cuda':
        return ('float64 on the card waits for ROADMAP queue 2 (K2 '
                'configurations); float64 runs on the CPU with '
                'device="cpu"')
    if T > T_MAX_BWD:
        return (f'T={T} exceeds K2\'s T_MAX_BWD={T_MAX_BWD}; longer '
                'horizons wait for K4 (ROADMAP queue 2)')
    return None


def supports_bwd(T, n_ctrl=1, dtype=torch.float32,
                 device=torch.device('cpu')) -> bool:
    """Whether K2 runs this backward (see ``scope_gap_bwd``)."""
    return scope_gap_bwd(T, n_ctrl, dtype, device) is None


# ---------------------------------------------------------------------------
# work and bytes of one launch (the kernel's bound)
# ---------------------------------------------------------------------------

def k2_flops(T, B, cost_shared, ns=3):
    """Arithmetic operations of K2 for n_ctrl = 1 (each +, -, *, /
    counts one; compares and selects none), counted from
    csrc/fused_kkt_bwd.cu.  The work does not depend on the data."""
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
    dyn = ns * ntau * 4 + ns                       # dF, df
    per_t = ctrl + vv + roll_u + dcost + red + lam
    per_link = ric + roll_x + lam_f + dyn          # t < T-1 only
    # + the negations of r at t = T-1 and of dlam_0 into dx_init
    return B * (T * per_t + (T - 1) * per_link + ntau + ns)


def k2_bytes(C, c, F, x_star, I_mask):
    """Bytes K2 must move on its operands: each input read once (shared
    ones once for the whole batch) and each output written once."""
    T, B, ns = x_star.shape
    cost_shared = _cost_shared(C, c)
    ntau = ns + 1
    e = x_star.element_size()
    ins = (C.numel() + c.numel() + F.numel()
           + T * B * (2 * ntau)                    # r = (dl_dx, dl_du), x*, u*
           + (I_mask.numel() if I_mask is not None else 0))
    cost_out = T * (ntau * ntau + ntau) * (1 if cost_shared else B)
    outs = B * ns + cost_out + (T - 1) * B * (ns * ntau + ns)
    return (ins + outs) * e


# ---------------------------------------------------------------------------
# the plain version of K2
# ---------------------------------------------------------------------------

def _cost_shared(C, c):
    """Whether K2 reduces the cost gradient over the batch: C and c both
    shared (batch extent 1)."""
    return C.shape[1] == 1 and c.shape[1] == 1


def _sum3(a, b):
    """((a0 b0 + a1 b1) + a2 b2), the kernel's order for n_state = 3
    (and Python's ``sum`` order for any length)."""
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


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
    if _cost_shared(C, c):
        dC, dc = dC.sum(1), dc.sum(1)

    # ---- costate recursions, dF and df on the fly ---------------------
    dF = x_star.new_empty((T - 1, B, ns, nt))
    df = x_star.new_zeros((T - 1, B, ns))
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
                if has_f:
                    df[t, :, i] = -dlam_n[i]
            lam = [lam[i] + _sum3([Ft[kk][i] for kk in range(ns)], lam_n)
                   for i in range(ns)]
            dlam = [dlam[i] + _sum3([Ft[kk][i] for kk in range(ns)], dlam_n)
                    for i in range(ns)]
        lam_n, dlam_n = lam, dlam
    dx_init = torch.stack([-dlam_n[i] for i in range(ns)], -1)
    return dx_init, dC, dc, dF, df


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGTYPES = [
    ctypes.c_int,                          # B
    _P, _I64, _I64,                        # C, t stride, batch stride
    _P, _I64, _I64,                        # c, t stride, batch stride
    _P, _P, _P, _P, _P, _P,                # F, dl_dx, dl_du, x*, u*, I
    ctypes.c_int,                          # has_f
    _P, _P, _P, _P, _P, _P,                # dx_init, dC, dc, dF, df, partial
    _P,                                    # stream
]


def _kernel_lib(T, has_I, cost_shared):
    from . import _build
    lib = _build.load('fused_kkt_bwd', {'MPC_T': T,
                                        'MPC_HAS_I': int(has_I),
                                        'MPC_COST_SHARED': int(cost_shared)})
    fn = lib.mpc_fused_kkt_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.mpc_fused_kkt_bwd_threads.restype = ctypes.c_int
    return fn, lib.mpc_fused_kkt_bwd_threads()


def fused_kkt_backward(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask=None,
                       *, has_f=True):
    """Run K2 on its operands (layouts as in ``fused_kkt_backward_plain``).

    On the CPU this is ``fused_kkt_backward_plain``.  On a CUDA tensor it
    launches csrc/fused_kkt_bwd.cu on the current stream and raises on
    any operand the kernel does not take or on a launch error."""
    if x_star.device.type == 'cpu':
        return fused_kkt_backward_plain(C, c, F, x_star, u_star, dl_dx,
                                        dl_du, I_mask, has_f=has_f)
    if x_star.device.type != 'cuda':
        raise NotImplementedError(f'K2 runs on cuda or cpu, not '
                                  f'{x_star.device.type}')
    T, B, ns = x_star.shape
    has_I = I_mask is not None
    ops = [C, c, F, x_star, u_star, dl_dx, dl_du] + ([I_mask] if has_I
                                                    else [])
    for a in ops:
        if a.dtype != torch.float32 or a.device != x_star.device \
                or not a.is_contiguous():
            raise ValueError('K2 takes contiguous float32 operands on one '
                             'device')
    if (ns != 3 or T > T_MAX_BWD or C.shape[0] != T
            or C.shape[2:] != (4, 4) or c.shape[0] != T
            or c.shape[2:] != (4,) or C.shape[1] not in (1, B)
            or c.shape[1] not in (1, B) or F.shape != (T - 1, B, 3, 4)
            or u_star.shape != (T, B, 1) or dl_dx.shape != (T, B, 3)
            or dl_du.shape != (T, B, 1)
            or (has_I and I_mask.shape != (T, B, 1))):
        raise ValueError('K2 operand shapes do not match')
    cost_shared = _cost_shared(C, c)
    fn, threads = _kernel_lib(T, has_I, cost_shared)
    dev = x_star.device
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dxi = empty((B, 3))
    dC = empty((T, 4, 4) if cost_shared else (T, B, 4, 4))
    dc = empty((T, 4) if cost_shared else (T, B, 4))
    dF = empty((T - 1, B, 3, 4))
    df = empty((T - 1, B, 3))
    if B == 0:
        return dxi, dC.zero_(), dc.zero_(), dF, df
    n_blocks = -(-B // threads)
    # per-block partial sums of the shared-cost gradient, summed in block
    # order by the kernel's second pass
    partial = empty((n_blocks, T, 20)) if cost_shared else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(B,
                 C.data_ptr(), C.shape[1] * 16, 0 if C.shape[1] == 1 else 16,
                 c.data_ptr(), c.shape[1] * 4, 0 if c.shape[1] == 1 else 4,
                 F.data_ptr(), dl_dx.data_ptr(), dl_du.data_ptr(),
                 x_star.data_ptr(), u_star.data_ptr(),
                 I_mask.data_ptr() if has_I else None, int(has_f),
                 dxi.data_ptr(), dC.data_ptr(), dc.data_ptr(),
                 dF.data_ptr(), df.data_ptr(),
                 partial.data_ptr() if cost_shared else None, stream)
    if err != 0:
        raise RuntimeError(f'K2 launch failed with cudaError_t {err}')
    launch_counts['fused_kkt_bwd'] += 1
    return dxi, dC, dc, dF, df


# ---------------------------------------------------------------------------
# the batched fixed point
# ---------------------------------------------------------------------------

def _kernel_cost(a, n_trailing):
    """A shared [T, ...] or batched [T, B, ...] cost leaf as K2's
    [T, 1 or B, ...] operand."""
    if a.dim() == n_trailing + 1:
        a = a.unsqueeze(1)
    return a.contiguous()


def _to_leaf(g, leaf):
    """K2's cost gradient in the layout of its leaf: summed over the batch
    for a shared leaf [T, ...] beside a batched one, and reshaped where K2
    reduced a batch of one."""
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
def make_batched_fixed_point(n_state: int, has_bounds: bool, has_f: bool):
    """Batched counterpart of the reference's no-op-forward LQR step
    (mpc_tpu/ops/fused_bwd.py:1096-1136) as a ``torch.autograd.Function``.

    ``apply(x_init, C, c, F, f, u_lower, u_upper, x_star, u_star)`` passes
    the converged x_star [T, B, n_state] and u_star [T, B, 1] through.
    Its backward runs K2 over the whole batch and returns gradients for
    x_init [B, n_state], C, c, F [T-1, B, n_state, ntau] and f (None when
    ``has_f`` is false) in their own layouts: a shared leaf C [T, ntau,
    ntau] or c [T, ntau] gets the gradient summed over the batch (by K2
    itself when both are shared), a batched leaf [T, B, ...] a
    per-example one.  Bounds (broadcastable to u_star, or None without
    ``has_bounds``) get zeros, the reference's gradient; x_star and
    u_star get none.
    """
    if n_state != 3:
        raise NotImplementedError('K2 covers n_state = 3 (the pendulum); '
                                  'other models wait for ROADMAP queue 1 '
                                  'item 8')

    class BatchedFixedPoint(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_init, C, c, F, f, u_lower, u_upper, x_star,
                    u_star):
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
            dxi, dC, dc, dF, df = fused_kkt_backward(
                _kernel_cost(C, 2), _kernel_cost(c, 1), F.contiguous(),
                x_star.contiguous(), u_star.contiguous(),
                dl_dx.contiguous(), dl_du.contiguous(), I_mask, has_f=has_f)
            dlb, dub = (torch.zeros_like(b) if need else None for b, need in
                        zip((lb, ub), ctx.needs_input_grad[5:7]))
            return (dxi, _to_leaf(dC, C), _to_leaf(dc, c), dF,
                    df if has_f else None, dlb, dub, None, None)

    return BatchedFixedPoint
