"""Trajectory helpers (counterpart of mpc_tpu/solver.py:35-70).

Only ``rollout`` and ``trajectory_cost`` are ported so far; the eager
iLQR solver (``solve_single`` and the linearisation helpers) waits for
ROADMAP queue 1 item 3.  Both functions take any leading batch shape:
x_init [..., n_state] and u [T, ..., n_ctrl].
"""

from __future__ import annotations

import torch

from .types import QuadCost


def rollout(dynamics, x_init, u):
    """Roll the dynamics (a callable (x, u) -> x_next) along a control
    sequence (reference mpc/util.py:102-126).  Returns x [T, ..., n_state],
    whose first slice is x_init.  LinDx rollouts come with the eager
    solver (ROADMAP queue 1 item 3)."""
    xs = [x_init]
    for t in range(u.shape[0] - 1):
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
