"""Non-quadratic cost models (counterpart of mpc_tpu/models/cost.py).

A cost is a callable ``cost(tau [..., n_tau]) -> [...]`` on the last
axis; the eager solver quadratises it along a trajectory through
``torch.func`` (``solver.quadratize_cost``), as the reference does with
double autograd (``approximate_cost``, mpc/mpc.py:447-487).

``PseudoHuberCost`` also has the structure-of-arrays form that the
kernels run (mpc_tpu/models/cost.py:59-70): ``soa_params`` and
``soa_cost`` on components; ``huber_quad`` is its hand-written gradient
and (diagonal) Hessian, which K1, K3 and K3's dense configuration
compute inside the kernel at every iteration (csrc/cost.cuh), where the
TPU kernels take them by nested ``jax.jvp`` (mpc_tpu/ops/fused.py:
737-765).  The kernels get ``kernel_params()``, the vector [w, goal,
delta].
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.math import sqrt_rn


def huber_terms(tau, params):
    """The per-component terms of the pseudo-Huber cost, in
    ``soa_cost``'s arithmetic: for component i of the list ``tau``,
    w_i delta delta (sqrt(1 + r^2) - 1) with r = (tau_i - goal_i) /
    delta; ``params`` the scalars (w_0 .. w_n-1, goal_0 .., delta)."""
    n = len(tau)
    w, goal, delta = params[:n], params[n:2 * n], params[2 * n]
    out = []
    for i in range(n):
        r = (tau[i] - goal[i]) / delta
        out.append(w[i] * delta * delta * (sqrt_rn(1.0 + r * r) - 1.0))
    return out


def huber_cost(tau, params):
    """The pseudo-Huber stage cost of the components ``tau``: the terms of
    ``huber_terms`` summed over i = 0 .. n - 1 in sequence
    (mpc_tpu/models/cost.py:62-70, csrc/cost.cuh:Huber::stage)."""
    terms = huber_terms(tau, params)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def huber_quad(tau, params):
    """The gradient and the Hessian's diagonal of the pseudo-Huber cost at
    the components ``tau`` (csrc/cost.cuh:huber_quad): with
    r = (tau_i - goal_i) / delta and s = sqrt(1 + r^2),
    g_i = w_i delta r / s and H_ii = w_i / s^3.  The cost is separable,
    so every other entry of the Hessian is an exact zero.  Returns the
    lists (H, g)."""
    n = len(tau)
    w, goal, delta = params[:n], params[n:2 * n], params[2 * n]
    H, g = [], []
    for i in range(n):
        r = (tau[i] - goal[i]) / delta
        s = sqrt_rn(1.0 + r * r)
        g.append(w[i] * delta * r / s)
        H.append(w[i] / (s * s * s))
    return H, g


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

    # -- structure-of-arrays form (the kernels) ---------------------------
    def kernel_gap(self):
        """Why the kernels do not take this cost; None when they do: w and
        goal [n_tau] and delta a scalar, shared by the batch as the TPU
        kernel's SMEM scalars are."""
        if self.w.dim() != 1 or self.goal.shape != self.w.shape:
            return ('the kernels take a pseudo-Huber cost with w and goal '
                    f'[n_tau] (here {tuple(self.w.shape)} and '
                    f'{tuple(self.goal.shape)}): a batched or time-varying '
                    'goal runs on the eager solver')
        if self.delta.dim() != 0:
            return ('the kernels take a pseudo-Huber cost with a scalar '
                    f'delta (here {tuple(self.delta.shape)}); it runs on the '
                    'eager solver')
        return None

    def kernel_params(self):
        """[w, goal, delta] (2 n_tau + 1 values), detached: the kernels'
        cost operand."""
        return torch.cat([self.w.reshape(-1), self.goal.reshape(-1),
                          self.delta.reshape(1).to(self.w.dtype)]).detach()

    def soa_params(self):
        return tuple(self.kernel_params().unbind())

    def soa_cost(self, xs, us, params):
        """The cost of the components ``xs`` (a tuple) and ``us`` (a tuple,
        or one control), ``huber_cost``."""
        return huber_cost(list(xs) + (list(us) if isinstance(us, tuple)
                                      else [us]), params)
