"""Non-quadratic cost models (counterpart of mpc_tpu/models/cost.py).

A cost is a callable ``cost(tau [..., n_tau]) -> [...]`` on the last
axis; the eager solver quadratises it along a trajectory through
``torch.func`` (``solver.quadratize_cost``), as the reference does with
double autograd (``approximate_cost``, mpc/mpc.py:447-487).  Its
quadratisation inside a kernel waits for ROADMAP queue 2.
"""

from __future__ import annotations

import torch
from torch import nn


class PseudoHuberCost(nn.Module):
    """Smooth robust tracking cost on tau = (x, u)
    (mpc_tpu/models/cost.py:30-77):

        cost(tau) = sum_i w_i delta^2 (sqrt(1 + ((tau_i - goal_i)
                    / delta)^2) - 1)

    quadratic near the goal and linear in the tails.  ``w`` and ``goal``
    [n_tau] and the scalar ``delta`` are buffers: tensors that require
    grad get gradients through the solve."""

    def __init__(self, w, goal, delta=1.0):
        super().__init__()
        w = torch.as_tensor(w)
        self.register_buffer('w', w)
        self.register_buffer('goal', torch.as_tensor(goal))
        self.register_buffer('delta', torch.as_tensor(
            delta, dtype=w.dtype, device=w.device))

    def forward(self, tau):
        r = (tau - self.goal) / self.delta
        return (self.w * self.delta ** 2
                * (torch.sqrt(1.0 + r * r) - 1.0)).sum(-1)
