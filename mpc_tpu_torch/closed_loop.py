"""Closed-loop MPC rollouts on the device (counterpart of
mpc_tpu/closed_loop.py:36-118).

The reference's receding-horizon pattern is a host loop: solve, apply
the first control, shift the warm start, repeat
(mpc/env_dx/control.py:52-62; examples/gym_pendulum.py:92-100).  The JAX
package compiles the whole loop into one ``lax.scan``.  Here the loop is
Python, and what keeps it on the device is that nothing in a step reads
the card from the host: each step queues its solve (kernel K1 or K3
where the problem is in their scope, one launch a step), the environment
step and the warm-start shift, and the host goes on to the next step
while the card works.  The eager route reads one flag a solver
iteration (``solver._solve_phase1``), so a loop on it waits for the card
once an iteration.

The warm-start protocol is the host loop's (examples/control.py): the
solved sequence shifted left one step with a zero tail, so the results
equal a host loop of ``batched_solve`` calls bitwise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .learning import batched_solve
from .ops import linalg
from .types import LinDx, MPCConfig, QuadCost
from .utils.device import resolve_device


def _on(a, dtype, device):
    return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                  device=device)


def make_closed_loop(cfg: MPCConfig, cost, dynamics,
                     env_dynamics: Optional[Callable] = None,
                     u_lower=None, u_upper=None, device=None):
    """Build a closed-loop rollout function.

    ``cost`` and ``dynamics`` are the controller's internal model;
    ``env_dynamics`` (default: ``dynamics``) steps the environment, so a
    controller whose model is learned or wrong can be evaluated against
    the true dynamics (examples/gym_pendulum_approximate.py).  A callable
    environment follows the port's dynamics contract (``solver.rollout``):
    (x [B, n_state], u [B, n_ctrl]) -> [B, n_state].  A LinDx
    environment steps with its first-step system x' = F_0 [x; u] (+ f_0).

    Returns ``rollout(x_init, n_steps)`` with x_init [B, n_state],
    producing a dict with
      xs      [n_steps+1, B, n_state]  visited environment states
      us      [n_steps, B, n_ctrl]     applied (first) controls
      costs   [n_steps, B]             the controller's objective a solve
    Every solve goes through ``batched_solve`` on ``device`` (the CUDA
    card unless the caller asks for another).  Under a slew penalty each
    solve sees the last applied control as ``prev_ctrl`` (the reference's
    receding-horizon contract for u_{-1}, mpc/mpc.py:115-116).  The cost's
    leaves and the bounds are moved to the device once, here, so that a
    step copies nothing from the host."""
    device = resolve_device(device)
    env = env_dynamics if env_dynamics is not None else dynamics
    T, nc = cfg.T, cfg.n_ctrl
    has_slew = cfg.slew_rate_penalty is not None

    def rollout(x_init, n_steps: int):
        x = torch.as_tensor(x_init, device=device)
        dtype = x.dtype
        B = x.shape[0]
        cost_d = cost
        if isinstance(cost, QuadCost):
            cost_d = QuadCost(_on(cost.C, dtype, device),
                              _on(cost.c, dtype, device))
        dyn_d = dynamics
        if isinstance(dynamics, LinDx):
            dyn_d = LinDx(_on(dynamics.F, dtype, device),
                          _on(dynamics.f, dtype, device))
        lb, ub = _on(u_lower, dtype, device), _on(u_upper, dtype, device)
        if isinstance(env, LinDx):
            F, f = _on(env.F, dtype, device), _on(env.f, dtype, device)
            F0 = F[0] if F.dim() >= 3 else F
            f0 = None if f is None else (f[0] if f.dim() >= 2 else f)

            def env_step(xt, ut):
                xn = linalg.bmv(F0, torch.cat([xt, ut], -1))
                return xn if f0 is None else xn + f0
        else:
            env_step = env

        u_warm = torch.zeros((T, B, nc), dtype=dtype, device=device)
        prev = torch.zeros((B, nc), dtype=dtype, device=device)
        xs, us, costs = [x], [], []
        for _ in range(n_steps):
            sol = batched_solve(cfg, x, cost_d, dyn_d, u_init=u_warm,
                                u_lower=lb, u_upper=ub,
                                prev_ctrl=prev if has_slew else None,
                                device=device)
            u0 = sol.u[0]
            x = env_step(x, u0)
            # shift-left warm start, zero tail (examples/control.py,
            # reference examples/gym_pendulum.py:100)
            u_warm = torch.cat([sol.u[1:], torch.zeros_like(sol.u[:1])])
            prev = u0
            xs.append(x)
            us.append(u0)
            costs.append(sol.costs)
        return {'xs': torch.stack(xs), 'us': torch.stack(us),
                'costs': torch.stack(costs)}

    return rollout
