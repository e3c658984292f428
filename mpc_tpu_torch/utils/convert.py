"""Carry problems between the JAX package and the port as numpy arrays.

The functions take plain numpy arrays (never ``mpc_tpu`` objects, so the
port imports nothing of the JAX package) and build the port's objects on
``device`` (the CUDA card unless the caller names another), keeping the
arrays' dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.cartpole import CartpoleDx
from ..models.cost import PseudoHuberCost
from ..models.dynamics import AffineDynamics, NNDynamics
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


def nn_dynamics_from_numpy(params, activation='sigmoid', passthrough=True,
                           n_state=None, n_ctrl=None,
                           device=None) -> NNDynamics:
    """An MLP from mpc_tpu's ``NNDynamics.params`` as numpy arrays: a
    list of (W [n_out, n_in], b [n_out]).  n_state and n_ctrl, where
    given, are checked against the layers."""
    layers = []
    for W, b in params:
        W, b = _tensor(W, device), _tensor(b, device)
        lin = nn.utils.skip_init(nn.Linear, W.shape[1], W.shape[0],
                                 device=W.device, dtype=W.dtype)
        with torch.no_grad():
            lin.weight.copy_(W)
            lin.bias.copy_(b)
        layers.append(lin)
    model = NNDynamics(layers, activation, passthrough)
    if (n_state is not None and n_state != model.n_state) or (
            n_ctrl is not None and n_ctrl != model.n_ctrl):
        raise ValueError('the layers do not match n_state and n_ctrl')
    return model


def affine_from_numpy(A, B, c=None, device=None) -> AffineDynamics:
    return AffineDynamics(_tensor(A, device), _tensor(B, device),
                          None if c is None else _tensor(c, device))


def pseudo_huber_from_numpy(w, goal, delta=1.0,
                            device=None) -> PseudoHuberCost:
    return PseudoHuberCost(_tensor(w, device), _tensor(goal, device),
                           _tensor(delta, device))


def quad_cost_from_numpy(C, c, device=None) -> QuadCost:
    return QuadCost(_tensor(C, device), _tensor(c, device))


def lin_dx_from_numpy(F, f=None, device=None) -> LinDx:
    return LinDx(_tensor(F, device),
                 _tensor(f, device) if f is not None else None)


def solution_to_numpy(sol: Solution) -> Solution:
    """The same Solution with every tensor field as a numpy array."""
    return Solution(*(v.detach().cpu().numpy()
                      if isinstance(v, torch.Tensor) else v for v in sol))
