"""LQR machinery of the eager solver: the Riccati recursion, the
line-searched rollout and the exact LQR solve (counterpart of
mpc_tpu/ops/lqr.py:35-450).  ``parallel_riccati`` hands the
unconstrained gains and the exact solve to the O(log T) scan of
``pscan.py``.

The JAX package writes each function for one instance with
``lax.scan``/``lax.while_loop`` and vmaps it.  Here the batch is native:
trajectories are time-major x [T, B, n_state], u [T, B, n_ctrl], and
each time-indexed operand is [T, *b, ...] (T-1 for the dynamics) with
*b broadcastable to the batch, so a batch-shared leaf keeps a batch
extent of 1.  The horizon loops are Python loops over t; the line
search's step sizes roll out side by side as a leading axis; loops that
end per example run a fixed number of trips, with ``torch.where``
freezing the examples that are done.  Every product is written with
``linalg``'s elementwise helpers, so TF32 cannot reach it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import linalg
from .pnqp import first_passing, pnqp
from .pscan import parallel_lqr_solve, parallel_riccati_gains


class RiccatiOut(NamedTuple):
    K: torch.Tensor          # [T, B, n_ctrl, n_state] feedback gains
    k: torch.Tensor          # [T, B, n_ctrl] feedforward terms
    n_qp_iter: torch.Tensor  # [B] PNQP iterations (0 unconstrained)


class ForwardOut(NamedTuple):
    new_x: torch.Tensor         # [T, B, n_state]
    new_u: torch.Tensor         # [T, B, n_ctrl]
    objs: torch.Tensor          # [T, B] stage objectives of the kept rollout
    full_du_norm: torch.Tensor  # [B] ||u - new_u(alpha=1)||
    alpha: torch.Tensor         # [B] accepted step size
    cost_total: torch.Tensor    # [B] sum of objs


def riccati_backward(C, c, F, u, n_state: int, f=None, u_lower=None,
                     u_upper=None, u_zero_I=None, delta_u=None,
                     pnqp_iter: int = 20) -> RiccatiOut:
    """Time-reversed Riccati recursion producing (K_t, k_t)
    (mpc_tpu/ops/lqr.py:58-191, reference mpc/lqr_step.py:52-160).

    C [T, *b, ntau, ntau], c [T, *b, ntau] (the delta-space linear term
    in an iLQR step), F [T-1, *b, n_state, ntau], f None or
    [T-1, *b, n_state], u [T, B, n_ctrl] the nominal controls that the
    box is re-centred at; bounds None or [T, *b, n_ctrl]; u_zero_I None
    or a bool [T, *b, n_ctrl] mask of controls pinned to zero (the
    unconstrained solve only, as in the JAX package); ``delta_u`` a
    trust-region half-width or None.  Without bounds the control solve is
    the n_ctrl = 1 closed form, the pseudo-inverse, or the masked
    Cholesky with u_zero_I; with bounds PNQP, warm-started from the
    previous step's k_t (at the first step, from the Newton point of
    Quu + 1e-11 I)."""
    T, ntau = c.shape[0], c.shape[-1]
    ns = n_state
    nc = ntau - ns
    batch = u.shape[1:-1]
    dtype, device = c.dtype, c.device
    constrained = u_lower is not None
    eye = torch.eye(nc, dtype=dtype, device=device)

    Ks, ks = [None] * T, [None] * T
    V = v = prev_kt = None
    n_qp = torch.zeros(batch, dtype=torch.int32, device=device)
    for t in reversed(range(T)):
        Ct = C[t].expand(batch + (ntau, ntau))
        ct = c[t].expand(batch + (ntau,))
        if V is None:
            # V_T = 0: the padded slice of the JAX scan adds exact zeros
            Qt, qt = Ct, ct
        else:
            Ft = F[t]
            FtT = Ft.transpose(-1, -2)
            Qt = Ct + linalg.bmm(linalg.bmm(FtT, V), Ft)
            qt = ct + linalg.bmv(FtT, v)
            if f is not None:
                qt = qt + linalg.bmv(FtT, linalg.bmv(V, f[t]))
        Qxx, Qxu = Qt[..., :ns, :ns], Qt[..., :ns, ns:]
        Qux, Quu = Qt[..., ns:, :ns], Qt[..., ns:, ns:]
        qx, qu = qt[..., :ns], qt[..., ns:]

        if not constrained:
            if u_zero_I is None:
                if nc == 1:
                    Kt = -Qux / Quu
                    kt = -qu / Quu[..., 0]
                else:
                    Kt = -linalg.solve_psd_pinv(Quu, Qux)
                    kt = -linalg.solve_psd_pinv(Quu, qu)
            else:
                uzt = u_zero_I[t]
                free = ~uzt
                qu_m = torch.where(uzt, torch.zeros_like(qu), qu)
                H_m = linalg.masked_free_matrix(Quu, free)
                Qux_m = linalg.mask_rows(Qux, free)
                Kt = -linalg.solve_spd(H_m, Qux_m)
                kt = -linalg.solve_spd(H_m, qu_m)
        else:
            lb = u_lower[t] - u[t]
            ub = u_upper[t] - u[t]
            if delta_u is not None:
                lb = torch.clamp(lb, min=-delta_u)
                ub = torch.clamp(ub, max=delta_u)
            if prev_kt is None and nc > 1:
                prev_kt = -linalg.solve_spd(Quu + 1e-11 * eye, qu)
            res = pnqp(Quu, qu, lb, ub, x_init=prev_kt, n_iter=pnqp_iter)
            kt = res.x
            Kt = -linalg.solve_spd(res.H_free,
                                   linalg.mask_rows(Qux, res.free))
            n_qp = n_qp + res.n_iter
        prev_kt = kt

        KtT = Kt.transpose(-1, -2)
        KtTQuu = linalg.bmm(KtT, Quu)
        V = Qxx + linalg.bmm(Qxu, Kt) + linalg.bmm(KtT, Qux) + \
            linalg.bmm(KtTQuu, Kt)
        v = qx + linalg.bmv(Qxu, kt) + linalg.bmv(KtT, qu) + \
            linalg.bmv(KtTQuu, kt)
        Ks[t], ks[t] = Kt, kt
    return RiccatiOut(torch.stack(Ks), torch.stack(ks), n_qp)


def stage_cost(true_cost, t, tau):
    """The true objective of step t at tau [..., ntau]: a (C, c) pair of
    [T, *b, ...] operands or a callable tau -> [...]."""
    if isinstance(true_cost, tuple):
        Cq, cq = true_cost
        return 0.5 * linalg.bquad(tau, Cq[t]) + linalg.bdot(tau, cq[t])
    return true_cost(tau)


def dynamics_step(true_dynamics, t, x, u):
    """One step of the true dynamics: an (F, f) pair of [T-1, *b, ...]
    operands (f may be None) or a callable (x, u) -> x_next."""
    if isinstance(true_dynamics, tuple):
        Fd, fd = true_dynamics
        nxt = linalg.bmv(Fd[t], torch.cat([x, u], -1))
        return nxt if fd is None else nxt + fd[t]
    return true_dynamics(x, u)


def _time_sum(terms):
    """Sum over the horizon in time order, one term at a time, so that
    the current trajectory's cost and a trial's come out of the same
    additions."""
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def total_cost(x, u, true_cost):
    """Total true objective of trajectories x [T, ..., ns], u [T, ..., nc]
    (mpc_tpu/ops/lqr.py:243-256): [...]."""
    tau = torch.cat([x, u], -1)
    return _time_sum([stage_cost(true_cost, t, tau[t])
                      for t in range(tau.shape[0])])


def _rollout(alpha, x_init, x, u, K, k, true_cost, true_dynamics,
             u_lower=None, u_upper=None, u_zero_I=None, delta_u=None):
    """Forward passes at step sizes ``alpha`` (mpc_tpu/ops/lqr.py:194-
    240): alpha is [A, 1, 1] (A step sizes side by side, a leading axis
    of the outputs) or [B, 1] (one per example).  new_u_t = K_t dx_t +
    u_t + alpha k_t, pinned by u_zero_I and clamped to the box (and the
    trust region), stepped through the true dynamics.  Returns
    new_x [T, ..., ns], new_u [T, ..., nc] and the stage objectives
    [T, ...]."""
    T = u.shape[0]
    u_shape = torch.broadcast_shapes(alpha.shape, k.shape[1:])
    new_xt = x_init.expand(u_shape[:-1] + x_init.shape[-1:])
    dxt = torch.zeros_like(new_xt)
    xs, us, objs = [], [], []
    for t in range(T):
        new_ut = linalg.bmv(K[t], dxt) + u[t] + alpha * k[t]
        if u_zero_I is not None:
            new_ut = torch.where(u_zero_I[t], torch.zeros_like(new_ut),
                                 new_ut)
        if u_lower is not None:
            lb, ub = u_lower[t], u_upper[t]
            if delta_u is not None:
                lb = torch.maximum(u[t] - delta_u, lb)
                ub = torch.minimum(u[t] + delta_u, ub)
            new_ut = linalg.eclamp(new_ut, lb, ub)
        xs.append(new_xt)
        us.append(new_ut)
        objs.append(stage_cost(true_cost, t,
                               torch.cat([new_xt, new_ut], -1)))
        if t < T - 1:
            new_xt = dynamics_step(true_dynamics, t, new_xt, new_ut)
            dxt = new_xt - x[t + 1]
    return torch.stack(xs), torch.stack(us), torch.stack(objs)


def _pick(stacked, kidx, axis):
    """stacked indexed along ``axis`` (the step-size axis, followed by the
    batch axis) by kidx [B]."""
    shape = list(stacked.shape)
    shape[axis] = 1
    view = [1] * stacked.dim()
    view[axis + 1] = kidx.shape[0]
    idx = kidx.view(view).expand(shape)
    return stacked.gather(axis, idx).squeeze(axis)


def _du_norm(u, new_u):
    """||u - new_u|| over the horizon and the controls, per example."""
    d = (u - new_u).transpose(0, 1).flatten(1)
    return torch.linalg.vector_norm(d, dim=-1)


def lqr_forward(x_init, x, u, K, k, true_cost, true_dynamics,
                u_lower=None, u_upper=None, u_zero_I=None, delta_u=None,
                linesearch_decay: float = 0.2, max_linesearch_iter: int = 10,
                parallel_linesearch: bool = True) -> ForwardOut:
    """Line-searched forward rollout (mpc_tpu/ops/lqr.py:259-345,
    reference mpc/lqr_step.py:164-261): the step sizes 1, d, d^2, ... in
    turn until the true cost does not exceed the current one, else the
    last; ``full_du_norm`` is the full step's.  With
    ``parallel_linesearch`` every step size of the schedule rolls out at
    once and the first passing one is kept (the same result)."""
    if delta_u is not None and u_lower is None:
        raise ValueError('delta_u needs bounds (reference '
                         'mpc/lqr_step.py:195)')
    old_cost = total_cost(x, u, true_cost)
    kw = dict(x_init=x_init, x=x, u=u, K=K, k=k, true_cost=true_cost,
              true_dynamics=true_dynamics, u_lower=u_lower,
              u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u)
    dtype, device = u.dtype, u.device
    if parallel_linesearch:
        # the schedule made on the CPU and copied, so that its bits do not
        # depend on the device's pow (the card's and the CPU's differ in
        # the last bit at 0.2 ** 3)
        alphas = (torch.tensor(linesearch_decay, dtype=dtype) ** torch.arange(
            max_linesearch_iter, dtype=dtype)).to(device)
        nxs, nus, objss = _rollout(alphas.view(-1, 1, 1), **kw)
        costs = _time_sum(list(objss))                     # [A, B]
        kidx = first_passing(costs <= old_cost)
        return ForwardOut(_pick(nxs, kidx, 1), _pick(nus, kidx, 1),
                          _pick(objss, kidx, 1), _du_norm(u, nus[:, 0]),
                          alphas[kidx], _pick(costs, kidx, 0))

    B = u.shape[1]
    alpha = torch.ones(B, dtype=dtype, device=device)
    new_x, new_u, objs = _rollout(alpha.unsqueeze(-1), **kw)
    full_du_norm = _du_norm(u, new_u)
    cost = _time_sum(list(objs))
    for _ in range(max_linesearch_iter - 1):
        live = cost > old_cost
        a = torch.where(live, alpha * linesearch_decay, alpha)
        nx, nu, ob = _rollout(a.unsqueeze(-1), **kw)
        lv = live.view(1, B, 1)
        new_x = torch.where(lv, nx, new_x)
        new_u = torch.where(lv, nu, new_u)
        objs = torch.where(live.view(1, B), ob, objs)
        cost = torch.where(live, _time_sum(list(ob)), cost)
        alpha = a
    return ForwardOut(new_x, new_u, objs, full_du_norm, alpha, cost)


def lqr_step_delta(x_init, C, c, F, f, x, u, n_state: int, true_cost,
                   true_dynamics, u_lower=None, u_upper=None, u_zero_I=None,
                   delta_u=None, linesearch_decay: float = 0.2,
                   max_linesearch_iter: int = 10, pnqp_iter: int = 20,
                   parallel_linesearch: bool = True,
                   parallel_riccati: bool = False):
    """One iLQR step in delta space (mpc_tpu/ops/lqr.py:348-408,
    reference mpc/lqr_step.py:277-309): recentre the linear cost at the
    current trajectory, c_back = C tau + c, run the Riccati recursion on
    the model, then the line-searched rollout through the true cost and
    dynamics.  ``f`` is folded into the trajectory and unused here, as
    in the reference.  ``parallel_riccati`` (``solver.uses_scan``'s
    answer) takes the gains of an unconstrained, unmasked step
    from the O(log T) scan; a box or u_zero_I step stays sequential.
    Returns (ForwardOut, n_qp_iter [B])."""
    tau = torch.cat([x, u], -1)
    c_back = linalg.bmv(C, tau) + c
    if (parallel_riccati and u_lower is None
            and u_zero_I is None):
        K, k = parallel_riccati_gains(C, c_back, F, None, n_state)
        back = RiccatiOut(K, k, torch.zeros(
            u.shape[1:-1], dtype=torch.int32, device=u.device))
    else:
        back = riccati_backward(C, c_back, F, u, n_state=n_state,
                                u_lower=u_lower, u_upper=u_upper,
                                u_zero_I=u_zero_I, delta_u=delta_u,
                                pnqp_iter=pnqp_iter)
    fwd = lqr_forward(x_init, x, u, back.K, back.k, true_cost=true_cost,
                      true_dynamics=true_dynamics, u_lower=u_lower,
                      u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u,
                      linesearch_decay=linesearch_decay,
                      max_linesearch_iter=max_linesearch_iter,
                      parallel_linesearch=parallel_linesearch)
    return fwd, back.n_qp_iter


def lqr_solve(C, c, F, f, x_init, u_zero_I=None,
              n_state: Optional[int] = None, parallel: bool = False):
    """Exact LQR solve, optionally with controls pinned to zero
    (mpc_tpu/ops/lqr.py:411-450): one Riccati pass and its rollout, or,
    with ``parallel`` (``solver.uses_scan``'s answer), the O(log T)
    ``pscan.parallel_lqr_solve``.  The fixed point's backward solves its
    differential problem with it.  x_init [B, n_state]; returns
    x [T, B, n_state], u [T, B, n_ctrl]."""
    T, ntau = c.shape[0], c.shape[-1]
    ns = F.shape[-2] if n_state is None else n_state
    if parallel:
        return parallel_lqr_solve(C, c, F, f, x_init, u_zero_I=u_zero_I,
                                  n_state=ns)
    batch = x_init.shape[:-1]
    u0 = torch.zeros((T,) + batch + (ntau - ns,), dtype=c.dtype,
                     device=c.device)
    back = riccati_backward(C, c, F, u0, n_state=ns, f=f, u_zero_I=u_zero_I)
    xs, us = [], []
    xt = x_init
    for t in range(T):
        ut = linalg.bmv(back.K[t], xt) + back.k[t]
        if u_zero_I is not None:
            ut = torch.where(u_zero_I[t], torch.zeros_like(ut), ut)
        xs.append(xt)
        us.append(ut)
        if t < T - 1:
            xt = dynamics_step((F, f), t, xt, ut)
    return torch.stack(xs), torch.stack(us)
