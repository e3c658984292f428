"""Batch-sharded solving over the devices of one process (counterpart of
mpc_tpu/parallel/mesh.py:27-242).

Every MPC instance is independent, so a batch splits over devices with
no collective: the JAX package ``shard_map``s the solve over a ``Mesh``.
Here a mesh is an ordered tuple of ``torch.device``s, a shard is a slice
of the batch moved to its device, each shard is one ``batched_solve``
there (K1 or K3 where the problem is in the kernels' scope, queued on
that device's current stream with no read of the device between the
shards' launches), and the outputs are gathered onto the mesh's first
device in the batch's order.  A device may appear more than once: a
mesh of four ``cuda:0`` entries solves four shards one after the other
on one card.

The JAX package caches the compiled sharded program (mpc_tpu/parallel/
mesh.py:59-60, 225-241); nothing here is compiled, so there is no cache.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..types import LinDx, MPCConfig, QuadCost, Solution
from ..utils.device import resolve_device


def make_mesh(devices: Optional[Sequence] = None) -> tuple:
    """An ordered tuple of devices over which a batch is split: the given
    ones (a bare 'cuda' is the current card), by default every visible
    card.  Raises when there is no card and no ``devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh takes every visible CUDA card by '
                               'default and no card is available; pass '
                               'devices, e.g. ["cpu"] * 8')
        devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = resolve_device(d)
        if d.type == 'cuda' and d.index is None:
            d = torch.device('cuda', torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError('a mesh needs at least one device')
    return tuple(mesh)


def _batch_axis(a, batch_axis_by_rank=None):
    if batch_axis_by_rank is not None and a.dim() in batch_axis_by_rank:
        return batch_axis_by_rank[a.dim()]
    return 1 if a.dim() >= 3 else 0


def shard_batch(tree, mesh, batch_axis_by_rank=None) -> list:
    """Split every tensor of ``tree`` (nested dicts, lists, tuples,
    NamedTuples) on its batch axis over ``mesh``: one tree a device, each
    tensor's shard on that device.  The batch axis is 1 for a tensor of
    rank >= 3 (time-major [T, B, ...]) and 0 otherwise, unless
    ``batch_axis_by_rank`` ({rank: axis}) says otherwise
    (mpc_tpu/parallel/mesh.py:35-60).  Leaves that are not tensors are
    repeated."""
    from torch.utils import _pytree as pytree
    n = len(mesh)
    leaves, spec = pytree.tree_flatten(tree)
    per_device = [[] for _ in mesh]
    for a in leaves:
        if not isinstance(a, torch.Tensor):
            for shard in per_device:
                shard.append(a)
            continue
        ax = _batch_axis(a, batch_axis_by_rank)
        if a.shape[ax] % n:
            raise ValueError(f'batch {a.shape[ax]} does not divide evenly '
                             f'over {n} devices')
        for shard, part, dev in zip(per_device, a.chunk(n, ax), mesh):
            shard.append(part.to(dev))
    return [pytree.tree_unflatten(s, spec) for s in per_device]


def _on(device, cache):
    """A function that puts an operand on ``device``: a tensor moved
    there, a module copied there once (``cache``) unless its tensors
    already are; anything else as it is."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, torch.nn.Module):
            tensors = list(a.parameters()) + list(a.buffers())
            if all(t.device == device for t in tensors):
                return a
            if id(a) not in cache:
                import copy
                cache[id(a)] = copy.deepcopy(a).to(device)
            return cache[id(a)]
        return a
    return put


def solve_sharded(cfg: MPCConfig, mesh, x_init, cost, dynamics, u_init=None,
                  u_lower=None, u_upper=None, u_zero_I=None,
                  prev_ctrl=None) -> Solution:
    """Solve a batch split over ``mesh`` (``make_mesh``): the same
    arguments as ``learning.batched_solve`` and the same Solution,
    gathered onto ``mesh[0]`` in the batch's order, with ``iter_stats``
    None (mpc_tpu/parallel/mesh.py:221-223).

    The layout rules of mpc_tpu/parallel/mesh.py:112-175: x_init [B, ns]
    is split on axis 0; a cost or LinDx leaf, bound, u_init or u_zero_I
    that carries the batch ([T, B, ...]) is split on axis 1 and a
    batch-shared one is copied to every device; prev_ctrl [B, n_ctrl] is
    split and [n_ctrl] copied; scalar bounds stay scalars.  A callable
    cost or model (an ``nn.Module``) is copied to each device its tensors
    are not on, so gradients reach its parameters only where it already
    is (``learning.make_sharded_train_step`` builds a model on each
    shard's device instead).  B must divide evenly over the mesh."""
    from ..learning import batched_solve

    x_init = torch.as_tensor(x_init)
    n = len(mesh)
    B = x_init.shape[0]
    if B % n:
        raise ValueError(f'batch {B} must divide evenly over {n} devices')
    b = B // n

    def part(a, batched_ndim, axis, i):
        """Shard i of a leaf that carries the batch on ``axis`` when it
        has ``batched_ndim`` dimensions, else the leaf itself."""
        if a is None or not isinstance(a, torch.Tensor) \
                or a.dim() != batched_ndim:
            return a
        return a.narrow(axis, i * b, b)

    shards = []
    for i, dev in enumerate(mesh):
        put = _on(dev, {})

        def leaf(a, batched_ndim, axis=1):
            return put(part(a, batched_ndim, axis, i))

        if isinstance(cost, QuadCost):
            cost_i = QuadCost(leaf(cost.C, 4), leaf(cost.c, 3))
        else:
            cost_i = put(cost)
        if isinstance(dynamics, LinDx):
            dyn_i = LinDx(leaf(dynamics.F, 4), leaf(dynamics.f, 3))
        else:
            dyn_i = put(dynamics)
        shards.append(batched_solve(
            cfg, leaf(x_init, 2, 0), cost_i, dyn_i,
            u_init=leaf(u_init, 3), u_lower=leaf(u_lower, 3),
            u_upper=leaf(u_upper, 3), u_zero_I=leaf(u_zero_I, 3),
            prev_ctrl=leaf(prev_ctrl, 2, 0), device=dev))

    home = mesh[0]

    def gather(field, axis):
        return torch.cat([getattr(s, field).to(home) for s in shards], axis)

    return Solution(
        x=gather('x', 1), u=gather('u', 1), costs=gather('costs', 0),
        full_du_norm=gather('full_du_norm', 0), n_iter=gather('n_iter', 0),
        n_qp_iter=gather('n_qp_iter', 0), converged=gather('converged', 0),
        alpha=gather('alpha', 0), iter_stats=None)
