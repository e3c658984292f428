"""The exact LQR solve at O(log T) depth: the parallel (associative-scan)
Riccati recursion (counterpart of mpc_tpu/ops/pscan.py:73-395).

For the linear-quadratic case the backward value recursion and the
forward affine rollout are both compositions of associative operators
(Sarkka & Garcia-Fernandez, "Temporal Parallelization of Dynamic
Programming and Linear Quadratic Control").  Each step's conditional
value function is held in dual form by the 5-tuple (A, b, C, eta, J),
built by eliminating u against the step's own quadratic; two of them
combine in closed form (M := I + C1 J2, N := I + J2 C1):

    A12 = A2 M^{-1} A1                 C12 = A2 M^{-1} C1 A2^T + C2
    b12 = A2 M^{-1} (b1 + C1 eta2) + b2
    eta12 = A1^T N^{-1} (eta2 - J2 b1) + eta1
    J12 = A1^T N^{-1} J2 A1 + J1

A reverse scan gives every cost-to-go (J_t, eta_t) at once, the gains
follow step by step independently, and the closed-loop rollout
x_{t+1} = M_t x_t + v_t is a second scan over affine maps.  ``u_zero_I``
masks (the active set of the fixed point's differential solve) are taken
by masking the control-space quantities of each step.  Box constraints
cannot use this path: the box QP of a step is not an affine-quadratic
operator.

The JAX package writes this for one instance and vmaps it; here the
operands are batched natively, time-major [T, *b, ...] as in ``lqr.py``
(*b broadcastable to the batch).  ``_scan`` is ``lax.associative_scan``'s
odd/even recursion written out, so that the combines happen in the JAX
package's order, and the small solves are its unrolled Gaussian
elimination with per-example partial pivoting (``torch.where``), a row
of the system at a time.  Products are ``linalg``'s elementwise sums, so
TF32 cannot reach them.

Each combine is a fixed sequence of ~160 small operations over all the
elements of a level, and a scan of T elements takes about 2 log2(T)
combines: on the eager route, where every operation costs host time,
that replaces the ~25 operations of each of the T steps of the
sequential recursion (``riccati_backward``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg


def _lsolve(M, R, pivot: bool = True):
    """Solve M X = R for small n by unrolled Gaussian elimination
    (mpc_tpu/ops/pscan.py:137-179).  M [..., n, n], R [..., n, m] ->
    X [..., n, m].

    The elimination runs over the rows of the system, each a tensor
    [..., n] (and [..., m] of the right-hand side), so every element sees
    the JAX package's scalar operations in its order.  With ``pivot``,
    each example picks its own largest pivot at each column by swapping
    whole rows where a later row's entry is larger in magnitude
    (``torch.where``); the columns left of the pivot, which the swap
    also moves, are never read again."""
    n = M.shape[-1]
    A = list(M.unbind(-2))
    B = list(R.unbind(-2))
    for k in range(n):
        if pivot:
            for i in range(k + 1, n):
                sw = (A[i][..., k].abs() > A[k][..., k].abs()).unsqueeze(-1)
                A[k], A[i] = (torch.where(sw, A[i], A[k]),
                              torch.where(sw, A[k], A[i]))
                B[k], B[i] = (torch.where(sw, B[i], B[k]),
                              torch.where(sw, B[k], B[i]))
        inv = 1.0 / A[k][..., k:k + 1]
        for i in range(k + 1, n):
            fac = A[i][..., k:k + 1] * inv
            A[i] = A[i] - fac * A[k]
            B[i] = B[i] - fac * B[k]
    X = [None] * n
    for i in reversed(range(n)):
        inv = 1.0 / A[i][..., i:i + 1]
        s = B[i]
        for j in range(i + 1, n):
            s = s - A[i][..., j:j + 1] * X[j]
        X[i] = s * inv
    return torch.stack(X, -2)


def _lsolve_vec(M, b):
    """``_lsolve`` for one right-hand side b [..., n]
    (mpc_tpu/ops/pscan.py:73-96's ``_solve_small_vec``)."""
    return _lsolve(M, b.unsqueeze(-1))[..., 0]


class _Elem(NamedTuple):
    A: torch.Tensor      # [K, B, ns, ns]
    b: torch.Tensor      # [K, B, ns]
    C: torch.Tensor      # [K, B, ns, ns]
    eta: torch.Tensor    # [K, B, ns]
    J: torch.Tensor      # [K, B, ns, ns]


def _T(X):
    return X.transpose(-1, -2)


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Associative combination of conditional value functions, e1 earlier
    in time than e2 (mpc_tpu/ops/pscan.py:180-232)."""
    ns = e1.A.shape[-1]
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2
    eye = torch.eye(ns, dtype=A1.dtype, device=A1.device)
    M = linalg.bmm(C1, J2) + eye
    N = linalg.bmm(J2, C1) + eye

    bCe = b1 + linalg.bmv(C1, n2)
    sol_M = _lsolve(M, torch.cat([A1, bCe.unsqueeze(-1), C1], -1))
    Minv_A1 = sol_M[..., :ns]
    Minv_bCe = sol_M[..., ns]
    Minv_C1 = sol_M[..., ns + 1:]

    eJb = n2 - linalg.bmv(J2, b1)
    sol_N = _lsolve(N, torch.cat([eJb.unsqueeze(-1), linalg.bmm(J2, A1)],
                                 -1))
    Ninv_e = sol_N[..., 0]
    Ninv_J2A1 = sol_N[..., 1:]

    A1T = _T(A1)
    return _Elem(
        A=linalg.bmm(A2, Minv_A1),
        b=linalg.bmv(A2, Minv_bCe) + b2,
        C=linalg.bmm(linalg.bmm(A2, Minv_C1), _T(A2)) + C2,
        eta=linalg.bmv(A1T, Ninv_e) + n1,
        J=linalg.bmm(A1T, Ninv_J2A1) + J1)


def _interleave(a, b):
    """a at the even positions of the leading axis, b at the odd ones;
    a has as many entries as b or one more."""
    out = torch.empty((a.shape[0] + b.shape[0],) + a.shape[1:],
                      dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def _scan(fn, elems):
    """Inclusive scan of ``fn`` over the leading axis of every field of
    the tuple ``elems``: ``lax.associative_scan``'s recursion (combine
    neighbouring pairs, scan the half, combine back the even positions),
    so the combines happen in its order."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    kind = type(elems)
    reduced = fn(kind(*(e[0:-1:2] for e in elems)),
                 kind(*(e[1::2] for e in elems)))
    odd = _scan(fn, reduced)
    if n % 2 == 0:
        even = fn(kind(*(e[:-1] for e in odd)),
                  kind(*(e[2::2] for e in elems)))
    else:
        even = fn(odd, kind(*(e[2::2] for e in elems)))
    even = (torch.cat([e[:1], r], 0) for e, r in zip(elems, even))
    return kind(*(_interleave(e, o) for e, o in zip(even, odd)))


def _free_mask(u_zero_I, dtype):
    return None if u_zero_I is None else (~u_zero_I).to(dtype)


def _masked_ctrl(C, c, free, ns):
    """Split the stage quadratic and apply the u_zero mask: clamped
    controls leave the problem (unit diagonal, zeroed couplings), as
    ``linalg.masked_free_matrix`` does without its regularisation
    (mpc_tpu/ops/pscan.py:233-253)."""
    Cxx, Cxu, Cuu = C[..., :ns, :ns], C[..., :ns, ns:], C[..., ns:, ns:]
    cx, cu = c[..., :ns], c[..., ns:]
    if free is not None:
        Cuu = Cuu * linalg.bger(free, free) + torch.diag_embed(1.0 - free)
        Cxu = Cxu * free.unsqueeze(-2)
        cu = cu * free
    return Cxx, Cxu, Cuu, cx, cu


def _operands(C, c, F, f, ns, u_zero_I):
    """Every operand expanded to one batch shape, the stage split and
    masked, the dynamics split into A, B (masked) and d."""
    T = c.shape[0]
    batch = torch.broadcast_shapes(
        C.shape[1:-2], c.shape[1:-1], F.shape[1:-2],
        *(() if f is None else (f.shape[1:-1],)),
        *(() if u_zero_I is None else (u_zero_I.shape[1:-1],)))
    C = C.expand((T,) + batch + C.shape[-2:])
    c = c.expand((T,) + batch + c.shape[-1:])
    F = F.expand((T - 1,) + batch + F.shape[-2:])
    free = _free_mask(u_zero_I, C.dtype)
    if free is not None:
        free = free.expand((T,) + batch + free.shape[-1:])
    Cxx, Cxu, Cuu, cx, cu = _masked_ctrl(C, c, free, ns)
    A_dyn, B_dyn = F[..., :ns], F[..., ns:]
    if free is not None:
        B_dyn = B_dyn * free[:-1].unsqueeze(-2)
    d_dyn = (torch.zeros((T - 1,) + batch + (ns,), dtype=C.dtype,
                         device=C.device) if f is None
             else f.expand((T - 1,) + batch + f.shape[-1:]))
    return Cxx, Cxu, Cuu, cx, cu, A_dyn, B_dyn, d_dyn


def _value_functions(ops):
    """All cost-to-go functions V_t(x) = 0.5 x^T J_t x - eta_t^T x,
    t = 0..T-1, from one reverse scan (mpc_tpu/ops/pscan.py:254-299)."""
    Cxx, Cxu, Cuu, cx, cu, A_dyn, B_dyn, d_dyn = ops
    # eliminate u within each stage (completion of squares)
    CuuinvCux = _lsolve(Cuu, _T(Cxu))
    Cuuinvcu = _lsolve_vec(Cuu, cu)
    Xt = Cxx - linalg.bmm(Cxu, CuuinvCux)
    ct = cx - linalg.bmv(Cxu, Cuuinvcu)
    # the terminal element: the last stage's value with its control
    # eliminated; A = 0 makes it absorbing under combination
    zero_m = torch.zeros_like(Xt[-1:])
    elems = _Elem(
        A=torch.cat([A_dyn - linalg.bmm(B_dyn, CuuinvCux[:-1]), zero_m]),
        b=torch.cat([d_dyn - linalg.bmv(B_dyn, Cuuinvcu[:-1]),
                     torch.zeros_like(ct[-1:])]),
        C=torch.cat([linalg.bmm(B_dyn, _lsolve(Cuu[:-1], _T(B_dyn))),
                     zero_m]),
        eta=-ct,
        J=Xt)
    # the reverse scan runs on the flipped sequence, so the arguments
    # swap to keep the first operand the earlier in time
    out = _scan(lambda a, b: _combine(b, a),
                _Elem(*(e.flip(0) for e in elems)))
    return out.J.flip(0), out.eta.flip(0)


def _gains(ops):
    """Per-step gains from the cost-to-go of the next step, every step
    independently (mpc_tpu/ops/pscan.py:300-347)."""
    Cxx, Cxu, Cuu, cx, cu, A_dyn, B_dyn, d_dyn = ops
    ns = Cxx.shape[-1]
    J, eta = _value_functions(ops)
    P, p = J[1:], -eta[1:]
    # (with u_zero masks the clamped diagonal stays at identity: the
    #  masked B columns make B^T P B zero there)
    BTP = linalg.bmm(_T(B_dyn), P)
    H = Cuu[:-1] + linalg.bmm(BTP, B_dyn)
    G = _T(Cxu[:-1]) + linalg.bmm(BTP, A_dyn)
    r = cu[:-1] + linalg.bmv(_T(B_dyn), linalg.bmv(P, d_dyn) + p)
    KH = _lsolve(H, torch.cat([G, r.unsqueeze(-1)], -1))
    # the last step: its control enters its own stage cost alone
    KH_last = _lsolve(Cuu[-1:], torch.cat(
        [_T(Cxu[-1:]), cu[-1:].unsqueeze(-1)], -1))
    KH = torch.cat([KH, KH_last])
    return -KH[..., :ns], -KH[..., ns]


def parallel_riccati_gains(C, c, F, f=None, n_state=None, u_zero_I=None):
    """Per-step LQR gains (K_t, k_t) at O(log T) depth, the parallel
    counterpart of ``lqr.riccati_backward`` for the unconstrained,
    optionally zero-pinned problem (mpc_tpu/ops/pscan.py:300-347).

    C [T, *b, ntau, ntau], c [T, *b, ntau] (the delta-space linear term in
    an iLQR step), F [T-1, *b, ns, ntau], f None or [T-1, *b, ns],
    u_zero_I None or a bool [T, *b, nc]; every *b broadcastable to one
    batch shape.  Returns K [T, *batch, nc, ns], k [T, *batch, nc]."""
    ns = F.shape[-2] if n_state is None else n_state
    return _gains(_operands(C, c, F, f, ns, u_zero_I))


def _affine_combine(m1, m2):
    """x -> M2 (M1 x + v1) + v2, m1 earlier in time."""
    M1, v1 = m1
    M2, v2 = m2
    return type(m1)(linalg.bmm(M2, M1), linalg.bmv(M2, v1) + v2)


class _Affine(NamedTuple):
    M: torch.Tensor      # [K, B, ns, ns]
    v: torch.Tensor      # [K, B, ns]


def parallel_lqr_solve(C, c, F, f, x_init, u_zero_I=None, n_state=None):
    """The exact unconstrained LQR solve at O(log T) depth, optionally
    with controls pinned to zero: ``lqr.lqr_solve``'s counterpart, same
    arguments and results (mpc_tpu/ops/pscan.py:350-395).  The
    closed-loop rollout is a second scan, over affine maps.  x_init
    [*batch, ns]; returns x [T, *batch, ns], u [T, *batch, nc]."""
    ns = F.shape[-2] if n_state is None else n_state
    ops = _operands(C, c, F, f, ns, u_zero_I)
    K, kff = _gains(ops)
    A_dyn, B_dyn, d_dyn = ops[5:]
    maps = _scan(_affine_combine, _Affine(
        A_dyn + linalg.bmm(B_dyn, K[:-1]),
        d_dyn + linalg.bmv(B_dyn, kff[:-1])))
    rest = linalg.bmv(maps.M, x_init) + maps.v
    x = torch.cat([x_init.expand(rest.shape[1:]).unsqueeze(0), rest])
    u = linalg.bmv(K, x) + kff
    if u_zero_I is not None:
        u = torch.where(u_zero_I, torch.zeros_like(u), u)
    return x, u
