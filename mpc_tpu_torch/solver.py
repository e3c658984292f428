"""The eager iLQR solver, batched natively, and its differentiable fixed
point (counterpart of mpc_tpu/solver.py:35-153 and 237-508).

The JAX package writes its solver for one instance and vmaps it; here
one call solves a batch [B] at once, with the per-example semantics of
the vmapped ``lax.while_loop``: every example keeps its own best
trajectory, iteration count, step norm and "not improved" count, and an
example whose stopping test fails keeps its state while the others go
on.  The outer loop reads one flag back from the device an iteration, to
stop when no example is left (not while ``torch.export`` traces it: the
exported loop runs every iteration); everything inside it runs a fixed
number of trips.

This is the route of every problem the kernels do not take
(learning.batched_solve): float64 on the card, callable costs and
dynamics, models without a kernel step (the affine and passthrough
models, deeper MLPs, an MLP under slew), sizes past the dense gate,
delta_u without bounds (u_zero_I, and delta_u with bounds, go to the
kernels, and come here under ``use_fused='never'``).  It runs on
whatever device its inputs are on.

A callable cost maps tau [..., n_tau] to [...], and a callable model
maps x [..., n_state], u [..., n_ctrl] to [..., n_state], acting on the
last axis as the models do; a model may carry
``grad_input(x, u) -> (R [..., n_state, n_state], S [..., n_state,
n_ctrl])`` for GradMethods.ANALYTIC.

Products are elementwise multiplications and sums (``ops/linalg.py``),
never ``matmul`` or ``einsum``, so a float32 solve on the card gives the
same bits whether or not TF32 is allowed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .models.dynamics import NNDynamics
from .models.pendulum import PendulumDx
from .ops import linalg, lqr
from .ops.diff import make_lqr_fixed_point
from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
from .utils.device import resolve_device

# central-difference step of GradMethods.FINITE_DIFF
# (mpc_tpu/solver.py:97, reference mpc/util.py:8-18)
FD_EPS = 1e-4

# One count per eager solve (phase 1) and per eager fixed point (phase 2)
# on any device, so that a caller can tell which route ran.
eager_counts = {'eager_solve': 0, 'eager_fixed_point': 0}


def reset_eager_counts():
    for name in eager_counts:
        eager_counts[name] = 0


# ---------------------------------------------------------------------------
# trajectory helpers
# ---------------------------------------------------------------------------

def rollout(dynamics, x_init, u):
    """Roll the dynamics (a callable (x, u) -> x_next, or a LinDx with
    shared or batched leaves) along a control sequence (reference
    mpc/util.py:102-126).  x_init [..., n_state], u [T, ..., n_ctrl];
    returns x [T, ..., n_state], whose first slice is x_init."""
    step = tuple(dynamics) if isinstance(dynamics, LinDx) else dynamics
    xs = [x_init]
    for t in range(u.shape[0] - 1):
        xs.append(lqr.dynamics_step(step, t, xs[t], u[t]))
    return torch.stack(xs, 0)


def trajectory_cost(cost, x, u):
    """Total objective of trajectories x [T, ..., n_state],
    u [T, ..., n_ctrl] (reference mpc/util.py:129-153): a QuadCost whose
    C is [ntau, ntau], [T, ntau, ntau] or [T, B, ntau, ntau] (c likewise),
    or a callable tau -> [...].  Returns the per-example totals."""
    if not isinstance(cost, QuadCost):
        return lqr.total_cost(x, u, cost)
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


# ---------------------------------------------------------------------------
# linearisation and quadratisation along a trajectory
# ---------------------------------------------------------------------------

def _over_leading(fn, n_lead):
    """``fn`` vmapped over ``n_lead`` leading axes, one vmap an axis (the
    time and the batch axis each get their own, so no example's
    derivative can reach another's)."""
    for _ in range(n_lead):
        fn = torch.func.vmap(fn)
    return fn


def linearize_dynamics(dynamics, x, u, grad_method: GradMethods):
    """First-order dynamics model along trajectories x [T, ..., n_state],
    u [T, ..., n_ctrl] (mpc_tpu/solver.py:71-118, reference
    mpc/mpc.py:490-601).

    Returns F [T-1, ..., n_state, n_tau] and f [T-1, ..., n_state] with
    the residual f_t = step(x_t, u_t) - R_t x_t - S_t u_t, differentiable
    with respect to the model's parameters.  A LinDx is its own
    linearisation whatever the method (F and f as given, f None when it
    has none).  Otherwise:

    - ANALYTIC with a model that has ``grad_input``: (R, S) from it;
    - FINITE_DIFF: central differences of the step with ``FD_EPS``;
    - AUTO_DIFF, and ANALYTIC without ``grad_input``: ``torch.func.jacrev``
      vmapped over the time and the batch axes, except for the simple
      pendulum, whose hand-written ``step_jacobian`` (the Jacobian that
      kernel K1 computes, 1e-12 from ``jax.jacrev`` of the step in
      float64) takes its place, and for an MLP, whose analytic
      ``grad_input`` does (1e-12 from ``jax.jacfwd`` in float64,
      tests/test_torch_models.py).
    """
    if isinstance(dynamics, LinDx):
        return dynamics.F, dynamics.f
    xs, us = x[:-1], u[:-1]
    ns = xs.shape[-1]
    new_x = dynamics(xs, us)
    grad_input = getattr(dynamics, 'grad_input', None)
    if grad_input is not None and (grad_method == GradMethods.ANALYTIC or (
            grad_method == GradMethods.AUTO_DIFF
            and isinstance(dynamics, NNDynamics))):
        R, S = grad_input(xs, us)
        F = torch.cat([R, S], -1)
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
    elif isinstance(dynamics, PendulumDx) and dynamics.simple:
        F = dynamics.step_jacobian(xs, us)
    else:
        R, S = _over_leading(torch.func.jacrev(dynamics, argnums=(0, 1)),
                             xs.dim() - 1)(xs, us)
        F = torch.cat([R, S], -1)
    f = new_x - linalg.bmv(F[..., :ns], xs) - linalg.bmv(F[..., ns:], us)
    return F, f


def quadratize_cost(cost, x, u):
    """Second-order cost model along trajectories (mpc_tpu/solver.py:121-
    147, reference ``approximate_cost``, mpc/mpc.py:447-487).

    For a QuadCost this is the cost itself, a time-less [ntau, ntau] /
    [ntau] leaf broadcast over T (a view, so autograd sums its gradient
    back over T); returns (C, c, None).  For a callable cost, the Hessian
    and gradient at each tau_t by ``torch.func`` (vmapped over the time
    and batch axes) with the Taylor-shifted c_t = g_t - H_t tau_t;
    returns (C [T, ..., ntau, ntau], c [T, ..., ntau], costs [T, ...])."""
    if isinstance(cost, QuadCost):
        C, c = cost.C, cost.c
        T = x.shape[0]
        if C.dim() == 2:
            C = C.expand((T,) + C.shape)
        if c.dim() == 1:
            c = c.expand((T,) + c.shape)
        return C, c, None
    tau = torch.cat([x, u], -1)

    def per_t(tau_t):
        H = torch.func.hessian(cost)(tau_t)
        g = torch.func.grad(cost)(tau_t)
        return H, g - linalg.bmv(H, tau_t), cost(tau_t)

    return _over_leading(per_t, tau.dim() - 1)(tau)


# ---------------------------------------------------------------------------
# scope and operand layouts
# ---------------------------------------------------------------------------

def _tensors(*objs):
    for o in objs:
        if isinstance(o, torch.Tensor):
            yield o
        elif isinstance(o, (QuadCost, LinDx)):
            yield from _tensors(*o)
        elif isinstance(o, torch.nn.Module):
            yield from o.parameters()
            yield from o.buffers()


def wants_grad(cfg: MPCConfig, *objs) -> bool:
    """Whether a solve must attach the fixed point: ``cfg.backprop``,
    grad mode on, and a tensor in ``objs`` (x_init, a cost or dynamics
    object, the bounds) that requires grad."""
    return cfg.backprop and torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(*objs))


def uses_scan(cfg: MPCConfig) -> bool:
    """Whether ``cfg.parallel_riccati`` asks for the O(log T) scan
    (``ops/pscan.py``; mpc_tpu/ops/lqr.py:386-391, 418-423: True, or
    'auto' at T >= 128).  The eager solver then takes the gains of its
    unconstrained, unmasked iLQR steps from the scan, and its fixed point
    solves the differential problem with it."""
    return cfg.parallel_riccati is True or (
        cfg.parallel_riccati == 'auto' and cfg.T >= 128)


def unported_gap(cfg: MPCConfig, cost=None,
                 dtype=torch.float32) -> Optional[str]:
    """Why no route takes a problem; None when one does."""
    if cfg.slew_rate_penalty is not None and cost is not None \
            and not isinstance(cost, QuadCost):
        # the reference and the JAX package refuse it too
        # (mpc/mpc.py:451-457, mpc_tpu/solver.py:331-335)
        return ('Non-convex cost with a slew rate penalty is not '
                'implemented (same restriction as the reference, '
                'mpc/mpc.py:451-457).')
    if dtype not in (torch.float32, torch.float64):
        return f'dtype {dtype} is not supported (float32 or float64)'
    return None


def _leaf(a, n_trailing, T, dtype, device, name='', timeless=True):
    """A shared ([T, ...] or time-less) or batched ([T, B, ...]) leaf as
    [T, 1 or B, ...], a view where it can be, so that autograd carries a
    gradient back to the leaf in its own layout."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.dim() not in (n_trailing + 1, n_trailing + 2) and not (
            timeless and a.dim() == n_trailing):
        raise ValueError(f'{name} has {a.dim()} dimensions; it takes '
                         f'[T, ...] or [T, B, ...] with {n_trailing} '
                         'trailing ones')
    if a.dim() == n_trailing:
        return a.expand((T, 1) + a.shape)
    if a.dim() == n_trailing + 1:
        return a.unsqueeze(1)
    return a


def prev_ctrl_operand(cfg: MPCConfig, prev_ctrl, x_init):
    """The previous control of a slew-penalised solve as [B, n_ctrl] on
    x_init's device and dtype, from [B, n_ctrl] or [n_ctrl] (zeros when
    None, as mpc_tpu/solver.py:219-222); a view where it can be, so that
    a gradient reaches the caller's tensor."""
    B, nc = x_init.shape[0], cfg.n_ctrl
    if prev_ctrl is None:
        return torch.zeros((B, nc), dtype=x_init.dtype, device=x_init.device)
    pc = torch.as_tensor(prev_ctrl, dtype=x_init.dtype, device=x_init.device)
    if pc.dim() not in (1, 2) or pc.shape[-1] != nc:
        raise ValueError('prev_ctrl takes [B, n_ctrl] or [n_ctrl]')
    return pc.expand(B, nc)


def eager_operands(cfg: MPCConfig, x_init, cost, dynamics, u_init=None,
                   u_lower=None, u_upper=None, u_zero_I=None):
    """The eager solver's operands on x_init's device and dtype: cost and
    LinDx leaves, bounds and u_zero_I as [T(-1), 1 or B, ...] (scalar
    bounds too), u_init as [T, B, n_ctrl].  Callables pass through."""
    T, nc = cfg.T, cfg.n_ctrl
    dtype, device = x_init.dtype, x_init.device
    B = x_init.shape[0]
    if isinstance(cost, QuadCost):
        cost = QuadCost(_leaf(cost.C, 2, T, dtype, device, 'QuadCost.C'),
                        _leaf(cost.c, 1, T, dtype, device, 'QuadCost.c'))
    if isinstance(dynamics, LinDx):
        dynamics = LinDx(
            _leaf(dynamics.F, 2, T - 1, dtype, device, 'LinDx.F', False),
            None if dynamics.f is None else
            _leaf(dynamics.f, 1, T - 1, dtype, device, 'LinDx.f', False))
    if u_lower is not None:
        def bound(b):
            b = torch.as_tensor(b, dtype=dtype, device=device)
            return _leaf(b.expand(nc) if b.dim() == 0 else b, 1, T, dtype,
                         device, 'a bound')

        u_lower, u_upper = bound(u_lower), bound(u_upper)
    if u_zero_I is not None:
        u_zero_I = _leaf(u_zero_I, 1, T, torch.bool, device, 'u_zero_I',
                         False)
    if u_init is None:
        u_init = torch.zeros((T, B, nc), dtype=dtype, device=device)
    else:
        u_init = _leaf(u_init, 1, T, dtype, device, 'u_init',
                       False).expand(T, B, nc)
    return cost, dynamics, u_init, u_lower, u_upper, u_zero_I


# ---------------------------------------------------------------------------
# slew-rate state augmentation
# ---------------------------------------------------------------------------

class SlewProblem(NamedTuple):
    C: torch.Tensor          # [T, *b, naug, naug]
    c: torch.Tensor          # [T, *b, naug]
    F: torch.Tensor          # [T-1, *b, ns + nc, naug]
    f: Optional[torch.Tensor]
    x_init: torch.Tensor     # [B, nc + ns]: (u_{-1}, x_0)
    x: torch.Tensor          # [T, B, nc + ns]: (u_{t-1}, x_t)
    true_dynamics: object


def slew_block(penalty, n_state, n_ctrl, dtype, device):
    """The slew penalty on the augmented tau (u_{t-1}, x_t, u_t) as a
    quadratic form [naug, naug]: penalty (u_t - u_{t-1})^2 per control
    (mpc_tpu/solver.py:182-189, reference mpc/mpc.py:362-372)."""
    nc = n_ctrl
    naug = n_state + 2 * nc
    g = penalty * torch.eye(nc, dtype=dtype, device=device)
    blk = torch.zeros((naug, naug), dtype=dtype, device=device)
    blk[:nc, :nc] = g
    blk[-nc:, -nc:] = g
    blk[:nc, -nc:] = -g
    blk[-nc:, :nc] = -g
    return blk


def augment_cost(C, c, blk, n_ctrl):
    """A quadratic cost (C [..., ntau, ntau], c [..., ntau], any leading
    layout) on the augmented tau: zero rows and columns for u_{t-1} in
    front, plus the slew block."""
    nc = n_ctrl
    return (torch.nn.functional.pad(C, (nc, 0, nc, 0)) + blk,
            torch.nn.functional.pad(c, (nc, 0)))


def augment_lindx(F, f, n_state, n_ctrl):
    """Linear dynamics (F [..., ns, ntau], f [..., ns] or None, any
    leading layout) on the augmented state: the next (u_t, x_{t+1}) is
    [[0, I], [0, F]] (u_{t-1}, x_t, u_t) (+ (0, f))
    (mpc_tpu/solver.py:194-202, reference mpc/mpc.py:380-390)."""
    ns, nc = n_state, n_ctrl
    lead = F.shape[:-2]
    top = torch.cat([torch.zeros((nc, ns + nc), dtype=F.dtype,
                                 device=F.device),
                     torch.eye(nc, dtype=F.dtype, device=F.device)], 1)
    bottom = torch.cat([F.new_zeros(lead + (ns, nc)), F], -1)
    F_aug = torch.cat([top.expand(lead + top.shape), bottom], -2)
    f_aug = None if f is None else torch.nn.functional.pad(f, (nc, 0))
    return F_aug, f_aug


def augment_slew(cfg: MPCConfig, C, c, F, f, x_init, x, u, dynamics,
                 prev_ctrl) -> SlewProblem:
    """The slew-penalised problem as an LQR problem on the state augmented
    with the previous control (mpc_tpu/solver.py:154-236, reference
    mpc/mpc.py:362-445): the cost and a LinDx augmented by
    differentiable torch operations of (C, c, F, f), so that the fixed
    point's gradients reach them; a callable model wrapped to pass the
    control through.  prev_ctrl is [B, n_ctrl] (``prev_ctrl_operand``).
    With LinDx dynamics the reference would crash (mpc/mpc.py:413-416);
    here, as in the JAX package, the augmented LinDx is used."""
    ns, nc = cfg.n_state, cfg.n_ctrl
    blk = slew_block(cfg.slew_rate_penalty, ns, nc, C.dtype, C.device)
    C_aug, c_aug = augment_cost(C, c, blk, nc)
    F_aug, f_aug = augment_lindx(F, f, ns, nc)
    x_aug = torch.cat([torch.cat([prev_ctrl.unsqueeze(0), u[:-1]]), x], -1)
    if isinstance(dynamics, LinDx):
        true_dynamics = (F_aug, f_aug)
    else:
        def true_dynamics(tx, uu):
            # the control passes through (reference
            # CtrlPassthroughDynamics, mpc/dynamics.py:133-153)
            return torch.cat([uu, dynamics(tx[..., nc:], uu)], -1)
    return SlewProblem(C_aug, c_aug, F_aug, f_aug,
                       torch.cat([prev_ctrl, x_init], -1), x_aug,
                       true_dynamics)


# ---------------------------------------------------------------------------
# phase 1: the outer iLQR loop
# ---------------------------------------------------------------------------

def _solve_phase1(cfg: MPCConfig, x_init, cost, dynamics, u_init, u_lower,
                  u_upper, u_zero_I, prev_ctrl, trace=None) -> Solution:
    """The outer loop of mpc_tpu/solver.py:_solve_single (:295-446) for a
    batch, on operands from ``eager_operands`` and ``prev_ctrl_operand``,
    gradients off.  Under a slew penalty each step solves the augmented
    problem (``augment_slew``) and strips the states back to n_state.  At
    ``cfg.verbose`` > 0 the Solution carries ``iter_stats`` [B, lqr_iter,
    4]: per iteration the best cost, the full step's norm, the accepted
    step size and the PNQP iterations, NaN where an example had stopped.
    A list ``trace`` gets one dict an iteration of the examples'
    decisions: ``active`` (it ran), the accepted step size ``alpha``, the
    PNQP iterations ``n_qp``, the kept trial's ``cost`` and the full
    step's norm ``full_du`` [B]."""
    B = x_init.shape[0]
    dtype, device = x_init.dtype, x_init.device
    quad = isinstance(cost, QuadCost)
    lin = isinstance(dynamics, LinDx)
    true_dynamics = tuple(dynamics) if lin else dynamics

    x = rollout(dynamics, x_init, u_init)
    u = u_init
    best_x, best_u = x, u
    inf = torch.full((B,), float('inf'), dtype=dtype, device=device)
    best_cost, best_du, cur_du = inf, inf, inf
    i = torch.zeros(B, dtype=torch.int32, device=device)
    n_not_improved = torch.zeros_like(i)
    n_qp_total = torch.zeros_like(i)
    alpha = torch.ones(B, dtype=dtype, device=device)
    slew = cfg.slew_rate_penalty is not None
    iter_stats = (torch.full((B, cfg.lqr_iter, 4), float('nan'), dtype=dtype,
                             device=device) if cfg.verbose > 0 else None)
    step = dict(u_lower=u_lower, u_upper=u_upper, u_zero_I=u_zero_I,
                delta_u=cfg.delta_u, linesearch_decay=cfg.linesearch_decay,
                max_linesearch_iter=cfg.max_linesearch_iter,
                pnqp_iter=cfg.pnqp_iter,
                parallel_linesearch=cfg.parallel_linesearch,
                parallel_riccati=uses_scan(cfg))
    for it in range(cfg.lqr_iter):
        # the while loop's condition, before each body, per example
        # (mpc_tpu/solver.py:416-421)
        keep = (cur_du >= cfg.eps) & (n_not_improved <= cfg.not_improved_lim)
        active = (i < cfg.lqr_iter) & ((i == 0) | keep)
        # the one read of the device: under torch.export every iteration
        # runs (a finished example's state is frozen by the torch.where
        # below, so the result is the same)
        if it > 0 and not torch.compiler.is_exporting() \
                and not bool(active.any()):
            break
        F, f = linearize_dynamics(dynamics, x, u, cfg.grad_method)
        C, c, _ = quadratize_cost(cost, x, u)
        if slew:
            sp = augment_slew(cfg, C, c, F, f, x_init, x, u, dynamics,
                              prev_ctrl)
            fwd, n_qp = lqr.lqr_step_delta(
                sp.x_init, sp.C, sp.c, sp.F, sp.f, sp.x, u,
                n_state=cfg.n_state + cfg.n_ctrl, true_cost=(sp.C, sp.c),
                true_dynamics=sp.true_dynamics, **step)
            # strip u_{t-1} from the augmented states (mpc/mpc.py:444)
            fwd = fwd._replace(new_x=fwd.new_x[..., cfg.n_ctrl:])
        else:
            fwd, n_qp = lqr.lqr_step_delta(
                x_init, C, c, F, f, x, u, n_state=cfg.n_state,
                true_cost=(C, c) if quad else cost,
                true_dynamics=true_dynamics, **step)

        first = i == 0
        improved = fwd.cost_total <= best_cost + cfg.best_cost_eps
        take = (first | improved) & active
        nni = torch.where(improved & ~first, torch.zeros_like(i),
                          n_not_improved + 1)
        tk = take.view(1, B, 1)
        av = active.view(1, B, 1)
        best_x = torch.where(tk, fwd.new_x, best_x)
        best_u = torch.where(tk, fwd.new_u, best_u)
        best_cost = torch.where(take, fwd.cost_total, best_cost)
        best_du = torch.where(take, fwd.full_du_norm, best_du)
        x = torch.where(av, fwd.new_x, x)
        u = torch.where(av, fwd.new_u, u)
        cur_du = torch.where(active, fwd.full_du_norm, cur_du)
        n_not_improved = torch.where(active, nni, n_not_improved)
        n_qp_total = n_qp_total + torch.where(active, n_qp,
                                              torch.zeros_like(n_qp))
        alpha = torch.where(active, fwd.alpha, alpha)
        i = i + active.to(torch.int32)
        if iter_stats is not None:
            # the reference's table columns (mpc/mpc.py:287-297), one row
            # an iteration (mpc_tpu/solver.py:372-382)
            row = torch.stack([best_cost, fwd.full_du_norm, fwd.alpha,
                               n_qp.to(dtype)], -1)
            iter_stats[:, it] = torch.where(active.unsqueeze(-1), row,
                                            iter_stats[:, it])
        if trace is not None:
            trace.append(dict(active=active, alpha=fwd.alpha, n_qp=n_qp,
                              cost=fwd.cost_total,
                              full_du=fwd.full_du_norm))
    return Solution(x=best_x, u=best_u, costs=best_cost,
                    full_du_norm=best_du, n_iter=i, n_qp_iter=n_qp_total,
                    converged=best_du < cfg.eps, alpha=alpha,
                    iter_stats=iter_stats)


# ---------------------------------------------------------------------------
# phase 2: the differentiable fixed point
# ---------------------------------------------------------------------------

def fixed_point_phase(cfg: MPCConfig, x_init, cost, dynamics, best_x,
                      best_u, u_lower, u_upper, converged, prev_ctrl=None):
    """Attach the differentiable KKT fixed point at a solution
    (mpc_tpu/solver.py:459-508): re-linearise the dynamics and
    re-quadratise the cost at (best_x, best_u) with gradients on, then
    ``ops/diff.make_lqr_fixed_point``, whose backward solves the
    differential LQR problem eagerly (by the O(log T) scan where
    ``uses_scan``).  Under a slew penalty the fixed point is the
    augmented problem's (``augment_slew``), so gradients reach C, c, F,
    f, x_init and ``prev_ctrl`` ([B, n_ctrl] or [n_ctrl]) through the
    augmentation.  Leaves in any layout the solver takes; gradients come
    back in each leaf's own layout (summed over the batch for a shared
    one).  With ``cfg.detach_unconverged`` the unconverged examples
    carry none."""
    cost, dynamics, _, lb, ub, _ = eager_operands(
        cfg, x_init, cost, dynamics, u_lower=u_lower, u_upper=u_upper)
    bx, bu = best_x.detach(), best_u.detach()
    F, f = linearize_dynamics(dynamics, bx, bu, cfg.grad_method)
    C, c, _ = quadratize_cost(cost, bx, bu)
    slew = cfg.slew_rate_penalty is not None
    xs = bx
    if slew:
        sp = augment_slew(cfg, C, c, F, f, x_init, bx, bu, dynamics,
                          prev_ctrl_operand(cfg, prev_ctrl, x_init))
        C, c, F, f, x_init, xs = sp.C, sp.c, sp.F, sp.f, sp.x_init, sp.x
    fp = make_lqr_fixed_point(xs.shape[-1], lb is not None, f is not None,
                              uses_scan(cfg))
    eager_counts['eager_fixed_point'] += 1
    x, u = fp.apply(x_init, C, c, F, f, lb, ub, xs, bu)
    if slew:
        # strip u_{t-1} from the augmented states (mpc/mpc.py:444)
        x = x[..., cfg.n_ctrl:]
    if cfg.detach_unconverged:
        conv = converged[None, :, None]
        x = torch.where(conv, x, x.detach())
        u = torch.where(conv, u, u.detach())
    return x, u


def eager_batched_solve(cfg: MPCConfig, x_init, cost, dynamics, u_init=None,
                        u_lower=None, u_upper=None, u_zero_I=None,
                        prev_ctrl=None, differentiable=False,
                        trace=None) -> Solution:
    """The eager route of ``learning.batched_solve``: phase 1 with
    gradients off, then, when ``differentiable``, the fixed point at the
    solution.  Layouts as ``batched_solve`` takes them; runs on
    x_init's device.  ``trace``: see ``_solve_phase1``."""
    ops = eager_operands(cfg, x_init, cost, dynamics, u_init, u_lower,
                         u_upper, u_zero_I)
    eager_counts['eager_solve'] += 1
    with torch.no_grad():
        sol = _solve_phase1(
            cfg, x_init.detach(), *ops,
            prev_ctrl_operand(cfg, prev_ctrl, x_init).detach(), trace=trace)
    if not differentiable:
        return sol
    x, u = fixed_point_phase(cfg, x_init, cost, dynamics, sol.x, sol.u,
                             u_lower, u_upper, sol.converged, prev_ctrl)
    return sol._replace(x=x, u=u)


def solve_single(cfg: MPCConfig, x_init, cost, dynamics, u_init=None,
                 u_lower=None, u_upper=None, u_zero_I=None, prev_ctrl=None,
                 device=None) -> Solution:
    """Solve one MPC instance through the eager solver (the JAX package's
    ``solve_single``, mpc_tpu/solver.py:270-282): a batch of one.

    x_init [n_state]; a QuadCost with C [T, ntau, ntau] (or [ntau,
    ntau]) and c [T, ntau] (or [ntau]); a LinDx with F [T-1, n_state,
    ntau] and f [T-1, n_state] or None, or a callable model; u_init,
    bounds and u_zero_I [T, n_ctrl] (bounds may be scalars); prev_ctrl
    [n_ctrl], the control before the horizon under a slew penalty.
    Returns a Solution with x [T, n_state], u [T, n_ctrl] and scalar
    statistics (iter_stats [lqr_iter, 4] at verbose > 0);
    with ``cfg.backprop`` and inputs that require grad, x and u carry
    gradients through the fixed point.  Runs on ``device``, the CUDA card
    unless the caller asks for another."""
    device = resolve_device(device)
    x_init = torch.as_tensor(x_init, device=device)
    if x_init.dim() != 1 or x_init.shape[0] != cfg.n_state:
        raise ValueError('x_init must be [n_state]')
    if (u_lower is None) != (u_upper is None):
        raise ValueError('u_lower and u_upper must both be given or '
                         'both be None')
    differentiable = wants_grad(cfg, x_init, cost, dynamics, u_lower,
                                u_upper, prev_ctrl)
    gap = unported_gap(cfg, cost, x_init.dtype)
    if gap is not None:
        raise NotImplementedError(gap)
    sol = eager_batched_solve(cfg, x_init[None], cost, dynamics, u_init,
                              u_lower, u_upper, u_zero_I, prev_ctrl,
                              differentiable)
    return Solution(sol.x[:, 0], sol.u[:, 0], *(v[0] for v in sol[2:8]),
                    iter_stats=None if sol.iter_stats is None
                    else sol.iter_stats[0])
