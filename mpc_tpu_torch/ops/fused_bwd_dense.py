"""The dense configuration of K2 and K4: the KKT backward of a converged
box LQR of any admitted n_state and n_ctrl on Hopper, and its plain
PyTorch version.

Counterpart of the general-size configurations of the TPU kernels
``_make_bwd_kernel`` and ``_make_bwd_kernel_long``
(mpc_tpu/ops/fused_bwd.py:251-410, 413-785) with their helpers
``_bwd_ctrl_solve`` (:162-198) and ``_bwd_vv_update`` (:201-226), per
example the function of the eager fixed point (ops/diff.py): the
differential Riccati recursion on (C, -r) with the active controls
pinned, the differential rollout from dx_0 = 0, the costate lam and the
differential costate dlam, then dC = -1/2 (dtau tau^T + tau dtau^T),
dc = -dtau, dF = -(dlam' tau^T + lam' dtau^T), df = -dlam' and
dx_init = -dlam_0.  The control solve is ``_bwd_ctrl_solve``'s: the
closed-form 1/Quu for one control, the masked free-set Cholesky for
several controls with an active set, the Cholesky with a 1e-11 jitter
for several without.

The kernel is csrc/fused_kkt_bwd_dense.cu: ONE WARP AN EXAMPLE for the
three chains (the dense forward's Riccati step, csrc/riccati_dense.cuh,
and its control solve), then the gradients in a pass
parallel over t, and the batch sums of the shared leaves in a fixed
order: within a chunk of ``K4D_CHUNK`` examples one after the other,
then the chunks in order by a second pass.  n_state, n_ctrl, the active
set and f are nvcc defines (``bwd_dense_kernel_defines``); T and the
layouts of C, c, F (batch strides) and f are run-time arguments, so one
kernel stands for both TPU kernels at every size.  The launch geometry
is computed here (``k4d_launch``), so the CPU tests reach it.

``fused_kkt_backward_dense_plain`` is the plain version: each kernel
scalar is a [B] tensor and every dot product runs from its first term
on, in the kernel's order, in float32 or float64; only the batch sums
of shared leaves are taken in another order.  ``fused_kkt_backward_dense``
runs it for CPU tensors; on a CUDA tensor it launches the kernel or
raises, through the op ``mpc_tpu_torch::k4d_backward``
(ops/custom.py), which holds the launch.
"""

from __future__ import annotations

import ctypes

import torch

from .fused import _check_device
from .fused_dense import (CHOL_JITTER, PHASE_CLOCK_FLOATS, _chol_ops,
                          _cholesky, _ctrl_tile_floats, _dot,
                          _masked_free_chol, _solve_ops, _solve_rows, _upper,
                          prefetch_fits, riccati_tiles)

# Examples (warps) a block of the chains, as the dense forward.  The gate
# is the forward's (``fused.dense_gap``), and this card holds it: a lane
# a row of Q needs n_state + n_ctrl <= 32; at the corners a warp's tiles
# take 15,104 bytes (24s8c) to 17,136 (31s1c), a block of 4 warps at most
# 68,544 of the 232,448 a block may use, and the chains 168 registers at
# 24s8c without spills (chip_smoke.py [build]); past
# ``fused_dense.REG_CTRL_MAX`` controls the control block's factor is a
# tile of the warp's (csrc/box_qp_smem.cuh), 3,248 bytes more at 28
# controls; a gradient block's copy of its chunk is at most 32,256
# bytes, under the 49,152 a launch gets without asking.
K4D_WARPS = 4
# Examples a block of the gradient pass sums one after the other before
# the second pass sums the blocks in order; the threads of that block.
K4D_CHUNK = 64
K4D_GRAD_THREADS = 256


def _warp_floats(ns, nc, prefetch=None) -> int:
    """The floats of a warp's shared tiles in the chains
    (csrc/fused_kkt_bwd_dense.cu, oF to oL): the Riccati step's
    (``fused_dense.riccati_tiles``: F, W, V and Q, two sets of F and Q with
    ``prefetch``), the vectors q, v, tau, dtau, lam and dlam, the gains K
    and Quu K [nc][ns] and k; past ``fused_dense.REG_CTRL_MAX`` controls
    the factor L [nc][odd] (``fused_dense._ctrl_tile_floats``); padded to
    a multiple of 4; ``prefetch`` None takes the build's
    (``bwd_dense_prefetch``)."""
    if prefetch is None:
        prefetch = bwd_dense_prefetch(ns, nc)
    nt = ns + nc
    n = (riccati_tiles(ns, nc, prefetch) + 3 * nt + 3 * ns + 2 * nc * ns
         + nc + _ctrl_tile_floats(nc, 0))
    return n + -n % 4


def bwd_dense_prefetch(ns, nc) -> bool:
    """Whether the chains prefetch the next step's C and F (MPC_PREFETCH,
    csrc/riccati_dense.cuh), by the forward's rule
    (``fused_dense.prefetch_fits``)."""
    return prefetch_fits(ns, nc, 4 * K4D_WARPS * _warp_floats(ns, nc, False),
                         4 * K4D_WARPS * _warp_floats(ns, nc, True))


def _grad_floats(ns, nc) -> int:
    """The floats of a gradient block's shared copy of its chunk: tau,
    dtau [chunk][ntau], lam', dlam' [chunk][ns]."""
    return K4D_CHUNK * (2 * (ns + nc) + 2 * ns)


def k4d_launch(T, B, ns, nc, clocks=False) -> dict:
    """The dense backward's launch geometry: lanes an example (a warp),
    warps and examples a block of the chains, their blocks and dynamic
    shared memory; the gradient pass's chunks of ``K4D_CHUNK`` examples
    (its blocks are [T, chunks] of ``K4D_GRAD_THREADS`` threads) and its
    shared memory; and the workspace in global memory: the gains
    [B][T][nc (ns + 1)], dtau [T][B][ntau], lam and dlam [T][B][ns] of
    float32; ``clocks``: the phase account's build, each warp's counters
    above its tiles."""
    nt = ns + nc
    chunks = -(-B // K4D_CHUNK)
    return dict(team=32, warps=K4D_WARPS, examples=K4D_WARPS,
                blocks=-(-B // K4D_WARPS),
                smem_bytes=4 * K4D_WARPS * (_warp_floats(ns, nc) + (
                    PHASE_CLOCK_FLOATS if clocks else 0)),
                chunks=chunks, grad_smem_bytes=4 * _grad_floats(ns, nc),
                workspace_bytes=4 * T * B * (nc * (ns + 1) + nt + 2 * ns))


def bwd_dense_kernel_defines(ns, nc, has_I, has_f) -> dict:
    """The nvcc defines of the dense backward's build for these sizes,
    with or without the active set and f (compile-time flags, so that no
    load goes through the pointer of an absent operand)."""
    return {'MPC_NS': ns, 'MPC_NC': nc, 'MPC_HAS_I': int(has_I),
            'MPC_HAS_F': int(has_f), 'MPC_WARPS': K4D_WARPS,
            'MPC_CHUNK': K4D_CHUNK, 'MPC_GRAD_THREADS': K4D_GRAD_THREADS,
            'MPC_PREFETCH': int(bwd_dense_prefetch(ns, nc))}


# ---------------------------------------------------------------------------
# work and bytes of one launch (the kernel's bound)
# ---------------------------------------------------------------------------

def k4d_flops(T, B, ns, nc, *, has_I=True, has_f=True, reduced=()):
    """Arithmetic operations of the dense backward (each +, -, *, /,
    sqrt counts one; compares, selects and sign flips none), counted from
    csrc/fused_kkt_bwd_dense.cu; ``reduced`` names the leaves summed over
    the batch ('C', 'c', 'F', 'f'), one add an example and entry.  The
    work does not depend on the data: the masked factor runs on every
    entry whatever the active set."""
    nt = ns + nc
    if nc == 1:
        ctrl = 1 + 1 + ns                          # 1/Quu, k, K
    else:
        ctrl = _chol_ops(nc, not has_I) + (ns + 1) * _solve_ops(nc)
    vupd = (ns * ns * (2 * nc - 1) + nc * ns * (2 * nc - 1)
            + ns * (ns + 1) // 2 * (2 * nc + 2) + nc * (2 * nc - 1)
            + ns * 5 * nc)
    ric_link = (ns * nt * (2 * ns - 1)             # W = V F
                + nt * (nt + 1) // 2 * 2 * ns      # Q = C + F^T W
                + nt * 2 * ns)                     # q = -r + F^T v
    roll = nc * 2 * ns                             # du = K dx + k
    roll_link = ns * (2 * nt - 1)                  # dx' = F dtau
    lam = 2 * ns * 2 * nt                          # lam, dlam from C, c, r
    lam_link = 2 * ns * 2 * ns                     # + F_x^T lam'
    dcost = nt * nt * 4                            # dC (dc: sign flips)
    ddyn = ns * nt * 3                             # dF (df: sign flips)
    per_t = ctrl + vupd + roll + lam + dcost
    per_link = ric_link + roll_link + lam_link + ddyn
    red = {'C': T * nt * nt, 'c': T * nt, 'F': (T - 1) * ns * nt,
           'f': (T - 1) * ns if has_f else 0}
    return B * (T * per_t + (T - 1) * per_link
                + sum(red[k] for k in reduced))


def k4d_bytes(C, c, F, x_star, u_star, I_mask, has_f=True, f_shared=None):
    """Bytes the dense backward must move: each input read once (shared
    ones once for the whole batch) and each output written once (reduced
    gradients once for the whole batch; no df without f).  The workspace
    and the partial sums are neither."""
    T, B, ns = x_star.shape
    nc = u_star.shape[-1]
    nt = ns + nc
    e = x_star.element_size()
    if f_shared is None:
        f_shared = F.shape[1] == 1
    ins = (C.numel() + c.numel() + F.numel() + 2 * T * B * nt
           + (I_mask.numel() if I_mask is not None else 0))
    outs = (B * ns + C.numel() + c.numel() + F.numel()
            + ((T - 1) * ns * (1 if f_shared else B) if has_f else 0))
    return (ins + outs) * e


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _bwd_ctrl_solve(Q, q, I_t, ns):
    """``_bwd_ctrl_solve`` (mpc_tpu/ops/fused_bwd.py:162-198) at one step:
    (K [B, nc, ns], k [B, nc]) with the pinned controls' rows zero."""
    nc = q.shape[-1] - ns
    Quu = [[Q[:, ns + i, ns + j] for j in range(nc)] for i in range(nc)]
    qu = [q[:, ns + i] for i in range(nc)]
    Qux = Q[:, ns:, :ns]
    if I_t is None:
        if nc == 1:
            inv = 1.0 / Quu[0][0]
            return (-Qux) * inv[:, None, None], ((-qu[0]) * inv)[:, None]
        L = _cholesky(Quu, CHOL_JITTER)
        kt = [-v for v in _solve_rows(L, qu)]
        cols = _solve_rows(L, list(Qux.unbind(1)))
        return -torch.stack(cols, 1), torch.stack(kt, 1)
    free = [I_t[:, m] < 0.5 for m in range(nc)]
    if nc == 1:
        inv = 1.0 / Quu[0][0]
        kt = torch.where(free[0], (-qu[0]) * inv, 0.0)
        K = torch.where(free[0][:, None, None], (-Qux) * inv[:, None, None],
                        0.0)
        return K, kt[:, None]
    L = _masked_free_chol(Quu, free)
    kt = [-v for v in _solve_rows(L, [torch.where(free[i], qu[i], 0.0)
                                      for i in range(nc)])]
    cols = _solve_rows(L, [torch.where(free[i][:, None], Qux[:, i], 0.0)
                           for i in range(nc)])
    return -torch.stack(cols, 1), torch.stack(kt, 1)


def _chains(C, c, F, tau, r, I_mask, ns):
    """The three chains of an example, batched: the differential Riccati
    recursion (gains K, k), the differential rollout (dtau [T, B, ntau])
    and the costates (lam, dlam [T, B, ns]), in the kernel's order."""
    T, B, nt = tau.shape
    nc = nt - ns
    # ---- the differential Riccati on (C, -r), active set pinned ---------
    K, k = [None] * T, [None] * T
    V = v = None
    for t in range(T - 1, -1, -1):
        Ct = C[t].expand(B, nt, nt)
        if t == T - 1:
            Q, q = Ct, -r[t]
        else:
            Ft = F[t].expand(B, ns, nt)
            W = _dot(V[:, :, :, None], Ft[:, None, :, :], 2)
            Q = _upper(Ct + _dot(Ft[:, :, :, None], W[:, :, None, :], 1))
            q = -r[t] + _dot(Ft, v[:, :, None], 1)
        Kt, kt = _bwd_ctrl_solve(Q, q, None if I_mask is None else I_mask[t],
                                 ns)
        K[t], k[t] = Kt, kt
        # the cost-to-go as _bwd_vv_update sums it (:201-226)
        Qxu, Quu, qu = Q[:, :ns, ns:], Q[:, ns:, ns:], q[:, ns:]
        QK = _dot(Qxu[:, :, :, None], Kt[:, None, :, :], 2)
        KQuu = _dot(Quu[:, :, :, None], Kt[:, None, :, :], 2)
        kqk = _dot(Kt[:, :, :, None], KQuu[:, :, None, :], 1)
        V = _upper(((Q[:, :ns, :ns] + QK) + QK.transpose(1, 2)) + kqk)
        Quuk = _dot(Quu, kt[:, None, :], 2)
        v = (q[:, :ns] + _dot(Qxu, kt[:, None, :], 2)) \
            + _dot(Kt, (qu + Quuk)[:, :, None], 1)

    # ---- the differential rollout from dx_0 = 0 --------------------------
    dtau = []
    dx = tau.new_zeros(B, ns)
    for t in range(T):
        du = _dot(K[t], dx[:, None, :], -1) + k[t]
        if I_mask is not None:
            du = torch.where(I_mask[t] > 0.5, 0.0, du)
        dtau.append(torch.cat([dx, du], -1))
        if t < T - 1:
            dx = _dot(F[t], dtau[t][:, None, :], -1)
    dtau = torch.stack(dtau, 0)

    # ---- the costates lam and dlam, reverse time -------------------------
    lams, dlams = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        Cx = C[t][:, :ns]
        lam = (_dot(Cx[:, :, :ns], tau[t][:, None, :ns], -1)
               + _dot(Cx[:, :, ns:], tau[t][:, None, ns:], -1)) \
            + c[t][:, :ns]
        dlam = (_dot(Cx[:, :, :ns], dtau[t][:, None, :ns], -1)
                + _dot(Cx[:, :, ns:], dtau[t][:, None, ns:], -1)) \
            - r[t][:, :ns]
        if t < T - 1:
            Fx = F[t][:, :, :ns]
            lam = lam + _dot(Fx, lams[t + 1][:, :, None], 1)
            dlam = dlam + _dot(Fx, dlams[t + 1][:, :, None], 1)
        lams[t], dlams[t] = lam, dlam
    return dtau, torch.stack(lams, 0), torch.stack(dlams, 0)


def fused_kkt_backward_dense_plain(C, c, F, x_star, u_star, dl_dx, dl_du,
                                   I_mask=None, *, has_f=True,
                                   f_shared=None):
    """The plain PyTorch version of the dense backward, on its operands.

    C [T, 1 or B, ntau, ntau], c [T, 1 or B, ntau], F [T-1, 1 or B, ns,
    ntau] (extent 1: shared, read for every example); x_star, dl_dx
    [T, B, ns]; u_star, dl_du [T, B, nc]; I_mask None or [T, B, nc]
    float (1.0 = control pinned); ``f_shared`` whether f is batch-shared
    (F's layout when None).  Returns (dx_init [B, ns], dC, dc, dF, df),
    each gradient in its leaf's layout: [T, ntau, ntau], [T, ntau],
    [T-1, ns, ntau], [T-1, ns] summed over the batch for a shared leaf,
    with the batch axis for a batched one; df None without f.  Same
    arithmetic in the same order as csrc/fused_kkt_bwd_dense.cu, apart
    from the order of the batch sums."""
    T, B, ns = x_star.shape
    if f_shared is None:
        f_shared = F.shape[1] == 1
    tau = torch.cat([x_star, u_star], -1)
    r = torch.cat([dl_dx, dl_du], -1)
    dtau, lam, dlam = _chains(C, c, F, tau, r, I_mask, ns)
    dC = -0.5 * (dtau[..., :, None] * tau[..., None, :]
                 + tau[..., :, None] * dtau[..., None, :])
    dc = -dtau
    dF = -(dlam[1:, ..., :, None] * tau[:-1, ..., None, :]
           + lam[1:, ..., :, None] * dtau[:-1, ..., None, :])
    df = -dlam[1:] if has_f else None
    if C.shape[1] == 1:
        dC = dC.sum(1)
    if c.shape[1] == 1:
        dc = dc.sum(1)
    if F.shape[1] == 1:
        dF = dF.sum(1)
    if has_f and f_shared:
        df = df.sum(1)
    return -dlam[0], dC, dc, dF, df


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
ARGTYPES = [
    ctypes.c_int, ctypes.c_int,           # B, T
    _P, _I64, _I64,                       # C, t stride, batch stride
    _P, _I64, _I64,                       # c, t stride, batch stride
    _P, _I64, _I64,                       # F, t stride, batch stride
    _P, _P, _P, _P, _P,                   # x*, u*, dl_dx, dl_du, I
    ctypes.c_int,                         # f shared
    _P, ctypes.c_int, ctypes.c_int,       # workspace, smem bytes, grad smem
    _P, _P, _P, _P, _P,                   # dx_init, dC, dc, dF, df
    _P, _P,                               # cost and dynamics partial sums
    _P, ctypes.c_int,                     # clocks, the launches (1|2|4)
    _P,                                   # stream
]


def kernel_lib(ns, nc, has_I, has_f, clocks=False):
    """The build's entry point; ``clocks`` the phase account's build
    (MPC_PHASE_CLOCKS = 1, csrc/phase_clock.cuh)."""
    from . import _build
    defines = bwd_dense_kernel_defines(ns, nc, has_I, has_f)
    if clocks:
        defines['MPC_PHASE_CLOCKS'] = 1
    fn = _build.load('fused_kkt_bwd_dense', defines).mpc_fused_kkt_bwd_dense
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def partial_shapes(T, B, ns, nc, reduced):
    """The partial sums of the shared leaves ``reduced`` ('C', 'c', 'F',
    'f'), a chunk of examples each: [chunks, T, ntau^2 + ntau] where C or
    c is shared and [chunks, T-1, ns ntau + ns] where F or f is (None
    where neither leaf of the pair is)."""
    nt = ns + nc
    chunks = -(-B // K4D_CHUNK)
    red = set(reduced)
    return ((chunks, T, nt * nt + nt) if red & {'C', 'c'} else None,
            (chunks, T - 1, ns * nt + ns) if red & {'F', 'f'} and T > 1
            else None)


def fused_kkt_backward_dense(C, c, F, x_star, u_star, dl_dx, dl_du,
                             I_mask=None, *, has_f=True, f_shared=None):
    """Run the dense backward on its operands (layouts as in
    ``fused_kkt_backward_dense_plain``) through the op
    ``mpc_tpu_torch::k4d_backward`` (ops/custom.py); df is None without
    ``has_f``.

    On the CPU the op runs ``fused_kkt_backward_dense_plain``.  On a CUDA
    tensor it allocates the workspace of ``k4d_launch`` and the partial
    sums, launches csrc/fused_kkt_bwd_dense.cu on the current stream and
    raises on any operand the kernel does not take or on a launch
    error."""
    _check_device('the dense backward', x_star)
    if f_shared is None:
        f_shared = F.shape[1] == 1
    dxi, dC, dc, dF, df = torch.ops.mpc_tpu_torch.k4d_backward(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, bool(has_f),
        bool(f_shared))
    return dxi, dC, dc, dF, df if has_f else None
