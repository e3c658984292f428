"""User-facing MPC class (counterpart of mpc_tpu/mpc.py:116-357).

Same constructor knobs and defaults as the reference (mpc/mpc.py:77-144)
and the JAX package, the same time-major [T, n_batch, ...] layout and
the same ``(x, u, costs)`` return.  The class normalises shapes and
delegates to ``learning.batched_solve``, so both entry points take the
same path: the kernels for the problems they take (``u_zero_I`` and ``delta_u``
with bounds among them), the eager solver for the rest (``use_fused``,
``u_zero_I``, ``delta_u``, the slew penalty and ``prev_ctrl`` pass
through).  It runs on ``device``: the CUDA card unless
the caller asks for the CPU.

What the class adds to ``batched_solve`` is the reference's surface:
the printing of ``verbose`` > 0 (the initial mean cost and one
``table_log`` row an iteration, from the eager solver's ``iter_stats``),
the check of ANALYTIC_CHECK (a model's ``grad_input`` against
``torch.func.jacrev`` along the warm start) and the parity helpers
``linearize_dynamics`` and ``approximate_cost``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import solver
from .learning import batched_solve
from .ops import linalg
from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
from .utils.device import resolve_device
from .utils.logging import table_log

# the largest |analytic - autodiff| entry ANALYTIC_CHECK lets pass
# (mpc_tpu/mpc.py:429)
ANALYTIC_CHECK_TOL = 1e-8


class SlewRateCost:
    """Cost on the slew-augmented tau (u_{t-1}, x_t, u_t): the true cost
    of the un-augmented part plus the time-invariant quadratic slew
    penalty (mpc_tpu/mpc.py:86-113, reference mpc/mpc.py:36-55).

    ``cost`` maps the true tau (x_t, u_t) [..., n_state + n_ctrl] to
    [...]; ``slew_C`` is the [naug, naug] penalty block
    (``solver.slew_block``).  A callable cost of the port: it acts on the
    last axis of tau [..., naug] and returns [...]."""

    def __init__(self, cost, slew_C, n_state, n_ctrl):
        self.cost = cost
        self.slew_C = slew_C
        self.n_state = n_state
        self.n_ctrl = n_ctrl

    def __call__(self, tau):
        return self.cost(tau[..., self.n_ctrl:]) + \
            0.5 * linalg.bquad(tau, self.slew_C)


class MPC:
    """A batched box-constrained iLQR solver (reference-compatible API)."""

    def __init__(self, n_state, n_ctrl, T,
                 u_lower=None, u_upper=None,
                 u_zero_I=None,
                 u_init=None,
                 lqr_iter=10,
                 grad_method=GradMethods.ANALYTIC,
                 delta_u=None,
                 verbose=0,
                 eps=1e-7,
                 back_eps=1e-7,
                 n_batch=None,
                 linesearch_decay=0.2,
                 max_linesearch_iter=10,
                 exit_unconverged=True,
                 detach_unconverged=True,
                 backprop=True,
                 slew_rate_penalty=None,
                 prev_ctrl=None,
                 not_improved_lim=5,
                 best_cost_eps=1e-4,
                 pnqp_iter=20,
                 parallel_linesearch=True,
                 use_fused='auto',
                 matmul_precision='float32',
                 parallel_riccati='auto',
                 scan_unroll=4,
                 device=None):
        if (u_lower is None) != (u_upper is None):
            raise ValueError('u_lower and u_upper must both be given or '
                             'both be None')
        self.u_lower = u_lower
        self.u_upper = u_upper
        self.u_zero_I = u_zero_I
        self.u_init = u_init
        self.n_batch = n_batch
        self.prev_ctrl = prev_ctrl
        self.exit_unconverged = exit_unconverged
        self.device = resolve_device(device)
        self.cfg = MPCConfig(
            n_state=n_state, n_ctrl=n_ctrl, T=T,
            lqr_iter=lqr_iter,
            grad_method=grad_method,
            delta_u=float(delta_u) if delta_u is not None else None,
            verbose=verbose,
            eps=eps, back_eps=back_eps,
            linesearch_decay=linesearch_decay,
            max_linesearch_iter=max_linesearch_iter,
            exit_unconverged=exit_unconverged,
            detach_unconverged=detach_unconverged,
            backprop=backprop,
            slew_rate_penalty=(float(slew_rate_penalty)
                               if slew_rate_penalty is not None else None),
            not_improved_lim=not_improved_lim,
            best_cost_eps=best_cost_eps,
            pnqp_iter=pnqp_iter,
            parallel_linesearch=parallel_linesearch,
            use_fused=use_fused,
            matmul_precision=matmul_precision,
            parallel_riccati=parallel_riccati,
            scan_unroll=scan_unroll)

    @property
    def n_state(self):
        return self.cfg.n_state

    @property
    def n_ctrl(self):
        return self.cfg.n_ctrl

    @property
    def T(self):
        return self.cfg.T

    def __call__(self, x_init, cost, dx):
        sol = self.solve(x_init, cost, dx)
        if self.cfg.detach_unconverged and \
                (self.exit_unconverged or self.cfg.verbose >= 0):
            # host-side convergence check (the reference asserts here,
            # mpc/mpc.py:321-328); ``solve()`` does not synchronise
            if not bool(sol.converged.all()):
                if self.exit_unconverged:
                    raise AssertionError(
                        'LQR: some examples did not converge to a fixed '
                        'point (max ||full_du|| = '
                        f'{float(sol.full_du_norm.max()):.2e} > eps = '
                        f'{self.cfg.eps:.2e}). Pass exit_unconverged='
                        'False to continue with detached unconverged '
                        'examples.')
                print('LQR Warning: All examples did not converge to a '
                      'fixed point.')
                print('Detaching and *not* backpropping through the bad '
                      'examples.')
        return sol.x, sol.u, sol.costs

    def solve(self, x_init, cost, dx) -> Solution:
        """Full solve returning the per-example Solution.  Normalises
        shapes (reference mpc/mpc.py:193-236) and delegates to
        ``learning.batched_solve``; batch-shared cost, batch-shared LinDx
        and scalar bounds stay un-broadcast (batch stride 0 in the
        kernel).  At ``verbose`` > 0 it prints the initial mean cost and
        one row an iteration; under ANALYTIC_CHECK it checks the model's
        ``grad_input`` first, then solves as ANALYTIC."""
        cfg = self.cfg
        T, nc = cfg.T, cfg.n_ctrl
        dev = self.device
        x_init = torch.as_tensor(x_init, device=dev)
        dtype = x_init.dtype
        if x_init.dim() != 2:
            raise AssertionError('x_init must be [n_batch, n_state]')

        if isinstance(cost, QuadCost):
            C = torch.as_tensor(cost.C, dtype=dtype, device=dev)
            c = torch.as_tensor(cost.c, dtype=dtype, device=dev)
            if C.dim() not in (2, 3, 4) or c.dim() not in (1, 2, 3):
                raise ValueError('MPC Error: Unexpected QuadCost shape.')
            cost = QuadCost(C, c)

        # batch-size inference (reference mpc/mpc.py:193-199)
        if self.n_batch is not None:
            n_batch = self.n_batch
        elif isinstance(cost, QuadCost) and cost.C.dim() == 4:
            n_batch = cost.C.shape[1]
        else:
            n_batch = x_init.shape[0]
        if x_init.shape[0] != n_batch:
            raise AssertionError('x_init must be [n_batch, n_state]')

        # the reference tolerates [T, ...] time dims on a LinDx and never
        # touches the last slice (mpc_tpu/mpc.py:269-278)
        if isinstance(dx, LinDx):
            F = torch.as_tensor(dx.F, dtype=dtype, device=dev)
            f = dx.f
            if f is not None:
                f = torch.as_tensor(f, dtype=dtype, device=dev)
                if f.shape[0] == T:
                    f = f[:T - 1]
            dx = LinDx(F[:T - 1] if F.shape[0] == T else F, f)

        u_init = self.u_init
        if u_init is not None:
            u_init = torch.as_tensor(u_init, dtype=dtype, device=dev)

        # scalar bounds stay 0-d; array bounds broadcast to
        # [T, n_batch, n_ctrl] (reference mpc/mpc.py:81-83)
        lb = ub = None
        if self.u_lower is not None:
            lb = torch.as_tensor(self.u_lower, dtype=dtype, device=dev)
            ub = torch.as_tensor(self.u_upper, dtype=dtype, device=dev)
            if lb.dim() != 0 or ub.dim() != 0:
                lb = lb.expand(T, n_batch, nc)
                ub = ub.expand(T, n_batch, nc)

        # u_zero_I: [T, n_batch, n_ctrl] when given with a batch axis,
        # else [T, n_ctrl] shared (mpc_tpu/mpc.py:298-304)
        uz = self.u_zero_I
        if uz is not None:
            uz = torch.as_tensor(uz, dtype=torch.bool, device=dev)
            uz = uz.expand(T, n_batch, nc) if uz.dim() >= 3 \
                else uz.expand(T, nc)

        # prev_ctrl: [n_batch, n_ctrl], [n_ctrl] or [1, n_batch, n_ctrl]
        # (mpc_tpu/mpc.py:306-310)
        pc = self.prev_ctrl
        if pc is not None:
            pc = torch.as_tensor(pc, dtype=dtype, device=dev)
            if pc.dim() == 3:
                pc = pc[0]

        if cfg.grad_method == GradMethods.ANALYTIC_CHECK and \
                not isinstance(dx, LinDx):
            self._analytic_check(x_init, dx, u_init)
            cfg = dataclasses.replace(cfg, grad_method=GradMethods.ANALYTIC)

        if cfg.verbose > 0:
            # reference mpc/mpc.py:238-243
            u0 = u_init
            if u0 is None:
                u0 = torch.zeros((T, n_batch, nc), dtype=dtype, device=dev)
            elif u0.dim() == 2:
                u0 = u0.unsqueeze(1).expand(T, n_batch, nc)
            with torch.no_grad():
                c0 = solver.trajectory_cost(
                    cost, solver.rollout(dx, x_init, u0), u0)
            print('Initial mean(cost): {:.4e}'.format(float(c0.mean())))

        sol = batched_solve(cfg, x_init, cost, dx, u_init=u_init,
                            u_lower=lb, u_upper=ub, u_zero_I=uz,
                            prev_ctrl=pc, device=dev)
        if cfg.verbose > 0 and sol.iter_stats is not None:
            _print_iterations(sol.iter_stats)
        return sol

    def _analytic_check(self, x_init, dynamics, u_init):
        """A model's analytic ``grad_input`` against autodiff
        (``torch.func.jacrev``) at every (x_t, u_t) of the warm start's
        rollout, the points the solver linearises at first
        (mpc_tpu/mpc.py:398-437; the reference's ANALYTIC_CHECK branch,
        mpc/mpc.py:552-567, always asserts).  Raises AssertionError naming
        the worst step when an entry is off by more than
        ``ANALYTIC_CHECK_TOL``."""
        cfg = self.cfg
        T, ns, nc = cfg.T, cfg.n_state, cfg.n_ctrl
        grad_input = getattr(dynamics, 'grad_input', None)
        if grad_input is None:
            raise ValueError('ANALYTIC_CHECK requires dynamics.grad_input')
        B = x_init.shape[0]
        u = u_init
        if u is None:
            u = torch.zeros((T, B, nc), dtype=x_init.dtype,
                            device=x_init.device)
        elif u.dim() == 2:                         # batch-shared [T, nc]
            u = u.unsqueeze(1).expand(T, B, nc)
        with torch.no_grad():
            xs = solver.rollout(dynamics, x_init, u)
            xf = xs[:-1].reshape(-1, ns)
            uf = u[:-1].reshape(-1, nc)
            R_an, S_an = grad_input(xf, uf)
        R_ad, S_ad = torch.func.vmap(torch.func.jacrev(
            dynamics, argnums=(0, 1)))(xf, uf)
        per_pt = torch.maximum((R_an - R_ad).abs().amax((1, 2)),
                               (S_an - S_ad).abs().amax((1, 2)))
        per_t = per_pt.reshape(T - 1, B).amax(1)
        err = float(per_t.max())
        if err > ANALYTIC_CHECK_TOL:
            raise AssertionError(
                f'ANALYTIC_CHECK: analytic dynamics Jacobian is off by '
                f'{err:.2e} from autodiff (worst at trajectory step '
                f'{int(per_t.argmax())} of {T - 1}).')

    # -- reference-parity helpers ------------------------------------------
    def linearize_dynamics(self, x, u, dynamics, diff=None):
        """The dynamics linearised along trajectories x [T, B, n_state],
        u [T, B, n_ctrl]: F [T-1, B, n_state, n_tau], f [T-1, B, n_state]
        (mpc_tpu/mpc.py:440-449, reference mpc/mpc.py:490-601).  ``diff``
        is ignored: autograd follows how the result is used.  A LinDx's
        shared leaves come back broadcast over the batch, as the JAX
        package's vmap returns them."""
        F, f = solver.linearize_dynamics(dynamics, x, u, self.cfg.grad_method)
        T, B = x.shape[:2]
        if isinstance(dynamics, LinDx):
            F = F.unsqueeze(1).expand((T - 1, B) + F.shape[1:]) \
                if F.dim() == 3 else F
            if f is not None and f.dim() == 2:
                f = f.unsqueeze(1).expand((T - 1, B) + f.shape[1:])
        return F, f

    def approximate_cost(self, x, u, Cf, diff=None):
        """The cost quadratised along trajectories x [T, B, n_state],
        u [T, B, n_ctrl]: (C [T, B, n_tau, n_tau], c [T, B, n_tau], costs
        [T, B], None for a QuadCost) (mpc_tpu/mpc.py:451-460, reference
        mpc/mpc.py:447-487)."""
        if self.cfg.slew_rate_penalty is not None:
            raise NotImplementedError(
                'Using a non-convex cost with a slew rate penalty is not '
                'implemented (reference mpc/mpc.py:451-457).')
        C, c, costs = solver.quadratize_cost(Cf, x, u)
        if isinstance(Cf, QuadCost):
            T, B = x.shape[:2]
            if C.dim() == 3:
                C = C.unsqueeze(1).expand((T, B) + C.shape[1:])
            if c.dim() == 2:
                c = c.unsqueeze(1).expand((T, B) + c.shape[1:])
        return C, c, costs


def _print_iterations(iter_stats):
    """One ``table_log`` row an iteration, the reference's columns
    (mpc/mpc.py:287-297), aggregated over the batch from the recorded
    history [B, lqr_iter, 4]; an example that had stopped is NaN there
    and drops out of the aggregates (mpc_tpu/mpc.py:337-356)."""
    stats = iter_stats.detach().cpu().double().numpy()
    for i in range(stats.shape[1]):
        ran = ~np.isnan(stats[:, i, 0])
        if not ran.any():
            break
        table_log('lqr', (
            ('iter', i),
            ('mean(cost)', float(np.nanmean(stats[:, i, 0])), '{:.4e}'),
            ('||full_du||_max', float(np.nanmax(stats[:, i, 1])), '{:.2e}'),
            ('mean(alphas)', float(np.nanmean(stats[:, i, 2])), '{:.2e}'),
            ('total_qp_iters', int(np.nansum(stats[:, i, 3]))),
        ))
