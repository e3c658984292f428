"""Trajectory helpers and the linearisation at a trajectory (counterpart
of mpc_tpu/solver.py:35-147).

``rollout``, ``trajectory_cost``, ``linearize_dynamics`` and
``quadratize_cost`` are ported, for the pendulum and for LinDx; the eager iLQR solver (``solve_single``)
waits for ROADMAP queue 1 item 3.  The functions take any leading batch
shape: x_init [..., n_state], x [T, ..., n_state] and u [T, ..., n_ctrl].
They are written with elementwise products and sums, never ``matmul`` or
``einsum``, so that a float32 call on the card gives the same bits
whether or not TF32 is allowed for matrix products.
"""

from __future__ import annotations

import torch

from .models.pendulum import PendulumDx
from .types import GradMethods, LinDx, QuadCost

# central-difference step of GradMethods.FINITE_DIFF
# (mpc_tpu/solver.py:97, reference mpc/util.py:8-18)
FD_EPS = 1e-4


def lin_dx_step(dynamics: LinDx, t, x, u):
    """x_{t+1} = F_t (x, u) + f_t for a LinDx whose leaves are shared
    ([T-1, ...], any leading batch shape of x) or batched ([T-1, B, ...]
    against x [B, n_state])."""
    tau = torch.cat([x, u], -1)
    nxt = (dynamics.F[t] * tau.unsqueeze(-2)).sum(-1)
    return nxt if dynamics.f is None else nxt + dynamics.f[t]


def rollout(dynamics, x_init, u):
    """Roll the dynamics (a callable (x, u) -> x_next, or a LinDx) along
    a control sequence (reference mpc/util.py:102-126).  Returns
    x [T, ..., n_state], whose first slice is x_init."""
    xs = [x_init]
    for t in range(u.shape[0] - 1):
        if isinstance(dynamics, LinDx):
            xs.append(lin_dx_step(dynamics, t, xs[t], u[t]))
        else:
            xs.append(dynamics(xs[t], u[t]))
    return torch.stack(xs, 0)


def trajectory_cost(cost: QuadCost, x, u):
    """Total objective sum_t 0.5 tau_t^T C_t tau_t + c_t^T tau_t of a
    trajectory (reference mpc/util.py:129-153).  C may be [ntau, ntau],
    [T, ntau, ntau] or [T, B, ntau, ntau]; c likewise.  Returns the
    per-example totals (shape of x without its first and last axes)."""
    T = x.shape[0]
    tau = torch.cat([x, u], -1)                      # [T, ..., ntau]
    C, c = cost.C, cost.c
    if C.dim() == 2:
        C = C.expand((T,) + C.shape)
    if c.dim() == 1:
        c = c.expand((T,) + c.shape)
    # shared [T, ntau, ntau] against batched tau [T, B, ntau]
    while C.dim() < tau.dim() + 1:
        C = C.unsqueeze(1)
    while c.dim() < tau.dim():
        c = c.unsqueeze(1)
    Ctau = (C * tau.unsqueeze(-2)).sum(-1)
    objs = 0.5 * (tau * Ctau).sum(-1) + (tau * c).sum(-1)
    return objs.sum(0)


def linearize_dynamics(dynamics, x, u, grad_method: GradMethods):
    """First-order dynamics model along a trajectory
    (mpc_tpu/solver.py:71-118, reference mpc/mpc.py:490-601).

    Returns F [T-1, ..., n_state, n_tau] and f [T-1, ..., n_state] with
    the residual f_t = step(x_t, u_t) - R_t x_t - S_t u_t, differentiable
    with respect to the model's parameters.  A ``LinDx`` is its own
    linearisation whatever the ``grad_method``: its F and f come back as
    given, shared or batched, f None when it has none
    (mpc_tpu/solver.py:87-88).  For ``PendulumDx(simple=True)``
    AUTO_DIFF and ANALYTIC take the hand-written Jacobian of the step
    (``step_jacobian``; the JAX pendulum has no ``grad_input``, so both
    take ``jax.jacrev`` there) and FINITE_DIFF central differences of
    ``forward`` with step ``FD_EPS``.
    """
    if isinstance(dynamics, LinDx):
        return dynamics.F, dynamics.f
    if not isinstance(dynamics, PendulumDx) or not dynamics.simple:
        raise NotImplementedError(
            'linearize_dynamics covers LinDx and PendulumDx(simple=True); '
            'other models wait for ROADMAP queue 1 item 8')
    xs, us = x[:-1], u[:-1]
    ns = xs.shape[-1]
    new_x = dynamics(xs, us)
    if grad_method in (GradMethods.AUTO_DIFF, GradMethods.ANALYTIC):
        F = dynamics.step_jacobian(xs, us)
    elif grad_method == GradMethods.FINITE_DIFF:
        z = torch.cat([xs, us], -1)
        cols = []
        for j in range(z.shape[-1]):
            e = torch.zeros_like(z)
            e[..., j] = FD_EPS
            hi, lo = z + e, z - e
            cols.append((dynamics(hi[..., :ns], hi[..., ns:])
                         - dynamics(lo[..., :ns], lo[..., ns:]))
                        / (2 * FD_EPS))
        F = torch.stack(cols, -1)
    else:
        raise NotImplementedError(f'{grad_method} waits for ROADMAP queue 1 '
                                  'item 9')
    f = (new_x - (F[..., :ns] * xs.unsqueeze(-2)).sum(-1)
         - (F[..., ns:] * us.unsqueeze(-2)).sum(-1))
    return F, f


def quadratize_cost(cost, x, u):
    """Second-order cost model along a trajectory
    (mpc_tpu/solver.py:121-147).  For a QuadCost this is the cost itself,
    a time-less [ntau, ntau] / [ntau] leaf broadcast over T (a view, so
    autograd sums its gradient back over T).  Returns (C, c, None).
    Non-quadratic costs wait for ROADMAP queue 2 (K1 configurations)."""
    if not isinstance(cost, QuadCost):
        raise NotImplementedError('non-quadratic costs wait for ROADMAP '
                                  'queue 2 (K1 configurations)')
    C, c = cost.C, cost.c
    T = x.shape[0]
    if C.dim() == 2:
        C = C.expand((T,) + C.shape)
    if c.dim() == 1:
        c = c.expand((T,) + c.shape)
    return C, c, None
