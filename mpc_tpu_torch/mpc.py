"""User-facing MPC class (counterpart of mpc_tpu/mpc.py:116-357).

Same constructor knobs and defaults as the reference (mpc/mpc.py:77-144)
and the JAX package, the same time-major [T, n_batch, ...] layout and
the same ``(x, u, costs)`` return.  The class normalises shapes and
delegates to ``learning.batched_solve``, so both entry points take the
same path: the kernels for the problems they take, the eager solver for
the rest (``use_fused``, ``u_zero_I`` and ``delta_u`` pass through).  It
runs on ``device``: the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from .learning import batched_solve
from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
from .utils.device import resolve_device


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
        kernel)."""
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

        return batched_solve(cfg, x_init, cost, dx, u_init=u_init,
                             u_lower=lb, u_upper=ub, u_zero_I=uz,
                             prev_ctrl=self.prev_ctrl, device=dev)
