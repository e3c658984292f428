"""Batched solve dispatch (counterpart of mpc_tpu/learning.py:123-179).

Forward dispatch only: the differentiable solve (the KKT fixed point and
kernel K2) and the training loops wait for ROADMAP queue 1 items 6-7.
"""

from __future__ import annotations

import torch

from .ops import fused
from .types import LinDx, MPCConfig, QuadCost, Solution
from .utils.device import resolve_device


def _tensors(*objs):
    for o in objs:
        if isinstance(o, torch.Tensor):
            yield o
        elif isinstance(o, (QuadCost, LinDx)):
            yield from _tensors(*o)
        elif isinstance(o, torch.nn.Module):
            yield from o.parameters()
            yield from o.buffers()


def batched_solve(cfg: MPCConfig, x_init, cost, dynamics, u_init=None,
                  u_lower=None, u_upper=None, u_zero_I=None, prev_ctrl=None,
                  device=None) -> Solution:
    """Solve a batch of MPC problems through the fused solve (kernel K1).

    ``x_init`` is [B, n_state]; cost leaves, bounds and u_init are
    time-major [T, B, ...] or batch-shared with the batch axis dropped
    (bounds may be scalars).  Everything runs on ``device``: the CUDA
    card by default (the kernel), or the CPU when asked (the kernel's
    plain PyTorch version, in float32 or float64).  A problem outside
    this slice raises NotImplementedError naming the ROADMAP item that
    brings it.

    ``cfg.backprop`` asks for a differentiable solve, which is not
    ported yet: the forward values are those of the JAX package's
    pass-through fixed point, and the call raises rather than return
    outputs that silently carry no gradient when autograd would need
    one.
    """
    if (u_lower is None) != (u_upper is None):
        # one-sided bounds would clamp against nothing; the reference
        # has no one-sided box either (mpc/mpc.py:127-130)
        raise ValueError('u_lower and u_upper must both be given or '
                         'both be None')
    device = resolve_device(device)
    x_init = torch.as_tensor(x_init, device=device)
    if x_init.dim() != 2 or x_init.shape[1] != cfg.n_state:
        raise ValueError('x_init must be [n_batch, n_state]')
    gap = fused.scope_gap(cfg, cost, dynamics, u_zero_I=u_zero_I,
                          prev_ctrl=prev_ctrl, dtype=x_init.dtype,
                          device=device)
    if gap is not None:
        raise NotImplementedError(gap)
    if cfg.backprop and torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors(x_init, cost, dynamics,
                                              u_init, u_lower, u_upper)):
        raise NotImplementedError(
            'gradients through the solve (backprop=True with inputs that '
            'require grad) wait for the differentiable path, ROADMAP '
            'queue 1 item 6 and kernel K2; pass backprop=False or solve '
            'under torch.no_grad()')
    with torch.no_grad():
        return fused.fused_batched_solve(cfg, x_init, cost, dynamics,
                                         u_init=u_init, u_lower=u_lower,
                                         u_upper=u_upper)
