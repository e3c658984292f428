"""Batched solve dispatch and imitation learning (counterpart of
mpc_tpu/learning.py:42-324).

``batched_solve`` routes a problem as mpc_tpu/learning.py:151-273 does.
A problem that the kernels take (``ops/fused.scope_gap``) runs phase 1,
the iLQR solve, through kernel K1, K3 or K3's dense configuration
(``ops/fused.routes_dense``, ``routes_long``) with
gradients stopped (the reference's detached outer loop,
mpc/mpc.py:249-262); a differentiable solve then re-linearises the
dynamics and re-quadratises the cost at the solution, differentiably,
and attaches the batched fixed point whose backward is kernel K2 or K4
(``ops/fused_bwd.bwd_routes_long``) or their dense configuration
(``bwd_routes_dense``), or the eager fixed point where those do not take
the backward (float64 on the card, a slew penalty,
``fused_bwd.scope_gap_bwd``).  Every other problem, and every problem
under ``use_fused='never'``, runs the eager solver (``solver.py``) and
its fixed point, on the same device.  The route is chosen from the
problem alone before anything runs: a kernel that fails to build or
launch raises and never falls back to the eager solver.

``make_sharded_train_step`` (mpc_tpu/learning.py:327-388) trains over a
mesh of devices in one process or over the processes of a
``torch.distributed`` group; ``TrainState`` is what a checkpoint holds.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from . import solver
from .models.cartpole import CartpoleDx
from .models.cost import PseudoHuberCost
from .models.dynamics import NNDynamics
from .models.pendulum import PendulumDx
from .ops import fused, fused_bwd
from .solver import linearize_dynamics, quadratize_cost
from .types import LinDx, MPCConfig, QuadCost, Solution
from .utils.device import resolve_device


def _bound(b, dtype, device):
    """A scalar, [T, nc] or [T, B, nc] bound, broadcastable to u [T, B, nc]."""
    b = torch.as_tensor(b, dtype=dtype, device=device)
    return b.unsqueeze(1) if b.dim() == 2 else b


def _phase2_kernel_bwd(cfg, x_init, cost, dynamics, sol1, u_lower, u_upper):
    """Differentiable phase 2 (mpc_tpu/learning.py:42-120): the
    linearisation and quadratisation at phase 1's solution, then the
    batched fixed point whose backward runs K2, K4 or their dense
    configuration (at any other size than 3 states and 1 control,
    ``fused_bwd.bwd_routes_dense``).  Batch-shared cost
    leaves and a batch-shared LinDx stay un-broadcast ([T, ...]): the
    kernel returns their gradient summed over the batch when both leaves
    of the pair are shared, and the fixed point sums a per-example
    gradient back onto a shared leaf otherwise.  A pseudo-Huber cost is
    never shared (mpc_tpu/learning.py:63-75): it is quadratised at the
    solution, per example, differentiably (C [T, B, ntau, ntau] and c =
    g - H tau [T, B, ntau]), so that the gradients of C and c reach w,
    goal and delta by autograd."""
    dtype, device = x_init.dtype, x_init.device
    # phase 1's outputs carry no gradient; the problem's leaves do
    bx, bu = sol1.x.detach(), sol1.u.detach()
    if isinstance(cost, QuadCost):
        cost = QuadCost(torch.as_tensor(cost.C, dtype=dtype, device=device),
                        torch.as_tensor(cost.c, dtype=dtype, device=device))
    C, c, _ = quadratize_cost(cost, bx, bu)
    if isinstance(dynamics, LinDx):
        dynamics = LinDx(*(None if a is None else torch.as_tensor(
            a, dtype=dtype, device=device) for a in dynamics))
    F, f = linearize_dynamics(dynamics, bx, bu, cfg.grad_method)
    has_bounds = u_lower is not None
    lb = _bound(u_lower, dtype, device) if has_bounds else None
    ub = _bound(u_upper, dtype, device) if has_bounds else None
    fp = fused_bwd.make_batched_fixed_point(cfg.n_state, has_bounds,
                                            f is not None, cfg.n_ctrl)
    x, u = fp.apply(x_init, C, c, F, f, lb, ub, bx, bu)
    if cfg.detach_unconverged:
        conv = sol1.converged[None, :, None]
        x = torch.where(conv, x, x.detach())
        u = torch.where(conv, u, u.detach())
    return x, u


def _always_error(cfg, cost, dynamics, u_lower, dtype, gap):
    """The error of ``use_fused='always'`` outside the kernels' scope: a
    ValueError where mpc_tpu's own kernels refuse the problem too
    (mpc_tpu/ops/fused.py:supports, mpc_tpu/learning.py:165-168: float64,
    a cost or model without a structure-of-arrays form, delta_u without
    bounds), else a NotImplementedError naming the gate of the port's
    kernels that refuses it (an MLP past the dense configuration's MLP
    build, a LinDx past its size gate: problems mpc_tpu's kernels may
    take at their own sizes)."""
    msg = f'use_fused="always" but the kernels do not take this problem: {gap}'
    soa_model = isinstance(
        dynamics, (LinDx, PendulumDx, CartpoleDx, NNDynamics)) or \
        hasattr(dynamics, 'soa_step')
    soa_cost = isinstance(cost, (QuadCost, PseudoHuberCost)) or \
        hasattr(cost, 'soa_cost')
    if (dtype != torch.float32 or not soa_model or not soa_cost
            or (cfg.delta_u is not None and u_lower is None)):
        return ValueError(msg)
    return NotImplementedError(msg)


def batched_solve(cfg: MPCConfig, x_init, cost, dynamics, u_init=None,
                  u_lower=None, u_upper=None, u_zero_I=None, prev_ctrl=None,
                  device=None) -> Solution:
    """Solve a batch of MPC problems.

    ``x_init`` is [B, n_state]; cost and LinDx leaves, bounds, u_init and
    u_zero_I are time-major [T, B, ...] or batch-shared with the batch
    axis dropped (bounds may be scalars); a callable cost or model acts
    on the last axis of batched inputs (``solver.py``); ``prev_ctrl``,
    the control before the horizon under ``cfg.slew_rate_penalty``, is
    [B, n_ctrl] or [n_ctrl] (zeros when None; unused without a slew
    penalty).  Everything runs on ``device``: the CUDA card by default,
    or the CPU when asked.

    The route (module docstring): the kernels K1, K3 or K3's dense
    configuration (every MLP but K3's one-hidden-layer 3s1c one, in its
    MLP build) for a problem in
    their scope (``ops/fused.scope_gap``) unless ``cfg.use_fused`` is
    'never'; the eager solver otherwise, which 'always' refuses.  On the
    CPU the kernels' plain PyTorch versions run in their place, and they
    take float64, which on the card goes to the eager solver: so under
    'auto' a float64 problem in the kernels' scope takes a different
    algorithm on the CPU than on the card, and a CPU run that stands as
    a reference for the card's float64 passes use_fused='never'.  A slew
    penalty augments the state with the previous control
    (mpc_tpu/learning.py:196-242): the kernels solve the augmented
    problem where it is in their scope (a LinDx in K3 or its dense
    configuration, a pendulum, the cartpole or an MLP in the dense
    configuration through the passthrough step), and its fixed point is
    always the eager one.  A problem
    that no route takes raises NotImplementedError.

    With ``cfg.backprop`` and any of x_init, the cost's C or c, the
    model's parameters, a LinDx's F or f, the bounds or (under a slew
    penalty) prev_ctrl requiring grad (and grad mode on), x and u carry
    gradients to them through the KKT fixed point (phase 2: kernel K2,
    K4 or their dense configuration, or the eager fixed point).
    The bounds get a zero gradient, as in the reference.  costs, n_iter
    and the other statistics come from phase 1 and carry none.  A
    u_zero_I mask and ``cfg.delta_u`` shape phase 1 alone: phase 2
    differentiates the box's active set at the solution, as mpc_tpu's
    does on every route.
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
    dtype = x_init.dtype
    gap = solver.unported_gap(cfg, cost, dtype)
    if gap is not None:
        raise NotImplementedError(gap)
    # prev_ctrl means something under a slew penalty alone
    # (mpc_tpu/closed_loop.py:93-96, mpc_tpu/solver.py:219-222)
    slew = cfg.slew_rate_penalty is not None
    if not slew:
        prev_ctrl = None
    differentiable = solver.wants_grad(cfg, x_init, cost, dynamics, u_lower,
                                       u_upper, prev_ctrl)
    kernel_gap = fused.scope_gap(cfg, cost, dynamics, u_zero_I=u_zero_I,
                                 u_lower=u_lower, dtype=dtype, device=device)
    if kernel_gap is not None and cfg.use_fused == 'always':
        raise _always_error(cfg, cost, dynamics, u_lower, dtype, kernel_gap)
    if kernel_gap is not None or cfg.use_fused == 'never':
        return solver.eager_batched_solve(
            cfg, x_init, cost, dynamics, u_init=u_init, u_lower=u_lower,
            u_upper=u_upper, u_zero_I=u_zero_I, prev_ctrl=prev_ctrl,
            differentiable=differentiable)

    # phase 2 takes neither u_zero_I nor delta_u on any route, as in
    # mpc_tpu (mpc_tpu/learning.py:214-216, mpc_tpu/solver.py:459): its
    # active set comes from the box alone.
    # the kernels' backward may not take what their forward does; its
    # phase 2 is then the eager fixed point (mpc_tpu/learning.py:213-242),
    # as it always is under a slew penalty, whose backward the JAX package
    # keeps off its kernel too
    bwd_gap = differentiable and fused_bwd.scope_gap_bwd(
        cfg.T, cfg.n_ctrl, dtype, device, cfg.n_state, slew)
    with torch.no_grad():
        sol1 = fused.fused_batched_solve(cfg, x_init, cost, dynamics,
                                         u_init=u_init, u_lower=u_lower,
                                         u_upper=u_upper,
                                         prev_ctrl=prev_ctrl,
                                         u_zero_I=u_zero_I)
    if not differentiable:
        return sol1
    if bwd_gap:
        x, u = solver.fixed_point_phase(cfg, x_init, cost, dynamics,
                                        sol1.x, sol1.u, u_lower, u_upper,
                                        sol1.converged, prev_ctrl)
    else:
        x, u = _phase2_kernel_bwd(cfg, x_init, cost, dynamics, sol1,
                                  u_lower, u_upper)
    return sol1._replace(x=x, u=u)


def imitation_loss(theta, cfg: MPCConfig, x_init, u_expert,
                   make_cost: Callable, make_dynamics: Callable,
                   u_lower=None, u_upper=None, device=None):
    """Mean-squared imitation loss of the MPC controls against expert
    controls u_expert [T, B, n_ctrl] (mpc_tpu/learning.py:276-291).

    ``theta`` holds the learnable parameters (a dict of tensors or an
    ``nn.Module``); ``make_cost(theta)`` and ``make_dynamics(theta)``
    build the cost and the model.  Gradients flow through the solver's
    KKT fixed point."""
    sol = batched_solve(cfg, x_init, make_cost(theta), make_dynamics(theta),
                        u_lower=u_lower, u_upper=u_upper, device=device)
    return ((sol.u - u_expert) ** 2).mean()


def make_imitation_train_step(cfg: MPCConfig, optimizer,
                              make_cost: Callable, make_dynamics: Callable,
                              u_lower=None, u_upper=None, device=None):
    """An imitation-learning train step (mpc_tpu/learning.py:300-324),
    with a ``torch.optim`` optimizer over the parameters in ``theta``
    in place of optax.

    ``step(theta, x_init, u_expert)`` zeroes the gradients, takes the
    loss, back-propagates through the solve and steps the optimizer.  It
    returns the loss, detached."""

    def train_step(theta, x_init, u_expert):
        optimizer.zero_grad()
        loss = imitation_loss(theta, cfg, x_init, u_expert, make_cost,
                              make_dynamics, u_lower=u_lower,
                              u_upper=u_upper, device=device)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


class TrainState(NamedTuple):
    """A training state (mpc_tpu/learning.py:294) as
    ``utils.save_checkpoint`` writes it: the learnable parameters
    ``theta`` (a dict of tensors or an ``nn.Module``'s ``state_dict``),
    the optimizer's ``state_dict()`` and the number of steps taken."""
    theta: Any
    opt_state: Any
    step: int


def _theta_on(theta, device):
    """``theta`` with its tensors on ``device``, by differentiable copies
    where they are elsewhere (a module must already be there)."""
    if isinstance(theta, torch.nn.Module):
        if any(p.device != device for p in theta.parameters()):
            raise ValueError('a module theta must be on every device of the '
                             'mesh; pass a dict of tensors to shard over '
                             'devices')
        return theta
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, theta)


def make_sharded_train_step(cfg: MPCConfig, mesh, optimizer,
                            make_cost: Callable, make_dynamics: Callable,
                            u_lower=None, u_upper=None):
    """An imitation train step over a mesh (mpc_tpu/learning.py:327-388):
    the batch split in equal shards, each solved on its own device, the
    loss the mean of the shards' mean losses (the global mean, since the
    shards are equal), one optimizer step.

    ``mesh`` is either a tuple of devices (``parallel.make_mesh``): the
    step splits x_init [B, ns] and u_expert [T, B, nc] over it in this
    process, solves shard i on mesh[i] with theta copied there
    differentiably, takes the mean of the shard losses on mesh[0] and
    back-propagates once; B must divide evenly.  Or a ``DeviceMesh`` of
    every process of the group (``parallel.make_pod_mesh``): x_init and
    u_expert are this process's shard, solved where they are, and the
    loss and every parameter's gradient are averaged over the processes
    (one all-reduce of a sum, divided by the number of processes, as
    gloo has no average) before ``optimizer.step()``, so every process
    takes the same step.  Start the processes from the same parameters
    (``parallel.replicate``).

    ``make_cost`` and ``make_dynamics`` see one shard, so they must not
    depend on the batch size (mpc_tpu/learning.py:346-351): batch-shared
    layouts, e.g. QuadCost(C [T, ntau, ntau], c [T, ntau]); the bounds
    are scalars or shared [T, nc] likewise.  ``step(theta, x_init,
    u_expert)`` returns the loss, detached."""
    from torch.distributed.device_mesh import DeviceMesh
    over_processes = isinstance(mesh, DeviceMesh)
    if over_processes:
        import torch.distributed as dist
        if mesh.size() != dist.get_world_size():
            raise ValueError('the process mesh must hold every process of '
                             'the group')
    else:
        mesh = tuple(mesh)

    def loss_on(theta, x_init, u_expert, device):
        return imitation_loss(_theta_on(theta, device), cfg,
                              x_init.to(device), u_expert.to(device),
                              make_cost, make_dynamics, u_lower=u_lower,
                              u_upper=u_upper, device=device)

    def reduce_over_processes(loss):
        """The loss and the gradients averaged over the processes, in one
        all-reduce of one flat buffer."""
        grads = [p.grad for group in optimizer.param_groups
                 for p in group['params'] if p.grad is not None]
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1).to(loss.device) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= dist.get_world_size()
        offset = 1
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[0]

    def train_step(theta, x_init, u_expert):
        optimizer.zero_grad()
        if over_processes:
            loss = loss_on(theta, x_init, u_expert, x_init.device)
            loss.backward()
            loss = reduce_over_processes(loss)
        else:
            B, n = x_init.shape[0], len(mesh)
            if B % n:
                raise ValueError(f'batch {B} must divide evenly over {n} '
                                 'devices')
            b = B // n
            means = [loss_on(theta, x_init[i * b:(i + 1) * b],
                             u_expert[:, i * b:(i + 1) * b], dev).to(mesh[0])
                     for i, dev in enumerate(mesh)]
            loss = torch.stack(means).mean()
            loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
