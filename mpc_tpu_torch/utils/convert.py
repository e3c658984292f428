"""Carry problems between the JAX package and the port as numpy arrays.

The functions take plain numpy arrays (never ``mpc_tpu`` objects, so the
port imports nothing of the JAX package) and build the port's objects on
``device`` (the CUDA card unless the caller names another), keeping the
arrays' dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.cartpole import CartpoleDx
from ..models.pendulum import PendulumDx
from ..types import LinDx, QuadCost, Solution
from .device import resolve_device


def _tensor(a, device):
    # a copy: the caller's array is neither aliased nor written
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def pendulum_from_numpy(params, simple=True, device=None) -> PendulumDx:
    """(g, m, l) for the simple pendulum, (g, m, l, d, b) for the damped,
    biased one."""
    return PendulumDx(params=_tensor(params, device), simple=simple)


def cartpole_from_numpy(params, device=None) -> CartpoleDx:
    """(gravity, masscart, masspole, length)."""
    return CartpoleDx(params=_tensor(params, device))


def quad_cost_from_numpy(C, c, device=None) -> QuadCost:
    return QuadCost(_tensor(C, device), _tensor(c, device))


def lin_dx_from_numpy(F, f=None, device=None) -> LinDx:
    return LinDx(_tensor(F, device),
                 _tensor(f, device) if f is not None else None)


def solution_to_numpy(sol: Solution) -> Solution:
    """The same Solution with every tensor field as a numpy array."""
    return Solution(*(v.detach().cpu().numpy()
                      if isinstance(v, torch.Tensor) else v for v in sol))
