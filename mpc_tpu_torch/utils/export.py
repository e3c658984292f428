"""Serving artifacts: the solver's programs exported with ``torch.export``
(counterpart of mpc_tpu/utils/export.py:51-296).

The JAX package serialises a traced solve as a StableHLO module that
carries its Pallas kernels as ``tpu_custom_call`` payloads.  Here an
artifact is a ``torch.export.ExportedProgram`` saved to bytes
(``torch.export.save``): an ATen graph in which each kernel launch is one
node of its ``torch.library`` op (``mpc_tpu_torch::k1_solve``,
``::k3_solve``, ``::k2_backward``, ``::k4_backward``, ops/custom.py) and
everything around the kernels (operand layouts, the eager solver, the
linearisation, a gradient's backward pass, a closed loop's environment
steps) is traced into ATen operations.

Three layers, as in the JAX package:

``export_fn`` / ``load_fn``
    Any function of tensors, exported at example arguments (with
    ``dynamic_shapes`` for symbolic sizes), and loaded back into a
    callable module.

``export_solve``
    The batched solve with the runtime inputs ``(x_init, C, c[, F[, f]]
    [, u_lower, u_upper][, u_init])`` and the outputs ``(x, u, costs)``.

``export_closed_loop``
    ``make_closed_loop``'s rollout for a fixed number of steps:
    ``x_init -> {'xs', 'us', 'costs'}``; the Python loop unrolls its
    solves into the graph.

Differences from the JAX package:

- The artifact is an ``ExportedProgram``, not StableHLO, so only
  PyTorch loads it (``torch.export.load``), and the process that loads
  it must have imported ``mpc_tpu_torch.ops.custom`` so that the ops
  exist.  It needs none of the solver's modules (``solver``,
  ``learning``, ``ops/lqr``, ``ops/pnqp``, ``ops/diff``,
  ``ops/pscan``): "serving without the solver stack" means without
  those, not without any of the port.
- One artifact runs on one device.  ``device`` replaces ``platforms``:
  the route (the kernels or the eager solver, ``ops/fused.scope_gap``)
  is decided for the device the artifact is for, whatever device traced
  it, and a program traced on CPU tensors is moved to that device with
  ``torch.export.passes.move_to_device_pass`` (or moved when it is
  loaded, ``load_fn(data, device=...)``).  A multi-platform artifact has
  no counterpart.
- The eager solver stops early when no example is left by reading one
  flag from the device an iteration; while exporting it runs every
  iteration instead (solver.py), which gives the same results.  The
  kernels' ops take a batch of any size, so a batch-polymorphic
  artifact keeps the kernels where the JAX package falls back to its jnp
  path; ``max_batch`` pads to one static batch as it does.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import torch
from torch.export.passes import move_to_device_pass

from ..types import LinDx, MPCConfig, QuadCost
from .device import resolve_device

# the rank of each runtime input when it carries the batch axis (axis 0
# of x_init, axis 1 of the time-major leaves), mpc_tpu/utils/export.py:
# 245-251; a batch-shared leaf has one axis fewer
_BATCHED_NDIM = {'x_init': 2, 'C': 4, 'c': 3, 'F': 4, 'f': 3,
                 'u_lower': 3, 'u_upper': 3, 'u_init': 3}


class _Program(torch.nn.Module):
    """A function of tensors as the module that ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, *example_args, dynamic_shapes=None,
              device=None) -> bytes:
    """Export ``fn`` traced at ``example_args`` (tensors) and return the
    saved program's bytes.

    ``dynamic_shapes`` gives, for each argument in order, None or a dict
    {axis: ``torch.export.Dim``}.  ``fn`` may take gradients
    (``torch.autograd.grad``) inside: the backward is traced too, its
    kernels as their ops.  With ``device`` the program is moved there
    after the trace (``torch.export.passes.move_to_device_pass``)."""
    if dynamic_shapes is not None:
        dynamic_shapes = (tuple(dynamic_shapes),)
    ep = torch.export.export(_Program(fn), tuple(example_args),
                             dynamic_shapes=dynamic_shapes, strict=False)
    if device is not None:
        ep = move_to_device_pass(ep, torch.device(device))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _export_forward(fn, *example_args, **kw) -> bytes:
    """``export_fn`` with gradients off: a solve's artifact returns values
    and no gradient, and the solver's own no-grad regions then need no
    grad-mode nodes in the graph."""
    with torch.no_grad():
        return export_fn(fn, *example_args, **kw)


def load_program(data: bytes, device=None) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` saved in ``data``, moved to ``device``
    when one is given."""
    ep = torch.export.load(io.BytesIO(data))
    if device is not None:
        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def load_fn(data: bytes, device=None):
    """The program saved by ``export_fn`` (or ``export_solve``,
    ``export_closed_loop``) as a callable module, moved to ``device``
    when one is given."""
    return load_program(data, device).module()


def kernel_nodes(program) -> dict:
    """How many nodes of each kernel's op an exported program holds
    (``program`` an ``ExportedProgram`` or its bytes), its submodules
    included (a no-grad region inside a gradient program is one)."""
    if isinstance(program, (bytes, bytearray)):
        program = load_program(bytes(program))
    counts = {}
    for module in program.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            if node.op == 'call_function' and str(node.target).startswith(
                    'mpc_tpu_torch.'):
                name = str(node.target).split('.')[1]
                counts[name] = counts.get(name, 0) + 1
    return counts


def _route_for(cfg: MPCConfig, cost, dynamics, dtype, device,
               u_lower=None) -> MPCConfig:
    """Pin ``use_fused`` to the route ``device`` takes (the counterpart
    of ``_dispatch_for_platforms``, mpc_tpu/utils/export.py:83-122):
    batched_solve decides from the device it runs on, which is the
    tracing device, and float64 takes the kernels' plain versions on the
    CPU but the eager solver on the card."""
    if cfg.use_fused != 'auto':
        return cfg
    from ..ops import fused
    gap = fused.scope_gap(cfg, cost, dynamics, u_lower=u_lower, dtype=dtype,
                          device=device)
    return dataclasses.replace(cfg, use_fused='never' if gap else 'always')


def _tensor(a, dtype, device):
    """A runtime input as a tensor: a tensor stays where it is (its
    device is the one the program is traced on), anything else goes to
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _move_to(trace_device, target):
    """``target`` when a program traced on ``trace_device`` must be moved
    there, else None ('cuda' is whichever card traced it)."""
    if trace_device.type == target.type and target.index in (
            None, trace_device.index):
        return None
    return target


def _is_array(b):
    return b is not None and getattr(b, 'ndim', 0) > 0


def _pad_to_batch(a, axis, b_max):
    """``a`` padded along ``axis`` to ``b_max`` with copies of example 0,
    the real examples first (mpc_tpu/utils/export.py:124-133)."""
    shape = list(a.shape)
    shape[axis] = b_max
    # no tensor of b_max - b examples: at b = b_max it would be empty, and
    # an empty example specialises the symbolic batch to b_max
    both = torch.cat([a, a.narrow(axis, 0, 1).expand(shape)], axis)
    return both.index_select(axis, torch.arange(b_max, device=a.device))


def export_solve(cfg: MPCConfig, dynamics, cost: QuadCost, x_init,
                 u_lower=None, u_upper=None, u_init=None,
                 polymorphic_batch: bool = False,
                 max_batch: Optional[int] = None, device=None) -> bytes:
    """Export the batched solve as a serving artifact.

    ``x_init``, the cost, a LinDx's leaves, array bounds and ``u_init``
    are examples that fix the runtime inputs' shapes, dtypes and layouts
    (a batch-shared leaf stays shared); ``cfg`` is baked in.  The
    artifact takes, in order, ``x_init, C, c``, then ``F`` (and ``f``)
    for a LinDx, then ``u_lower, u_upper`` when they are arrays, then
    ``u_init`` when given, and returns ``(x, u, costs)``.  A callable
    model (the pendulum, an MLP) and scalar bounds are baked in.

    ``device`` is the device the artifact runs on (the card unless the
    caller names another; the route is the one that device takes).  The
    program is traced where the example tensors are, and moved to
    ``device`` if that is elsewhere.

    ``polymorphic_batch`` exports the batch axis of every batched input
    as one symbolic size.  With ``max_batch=N`` as well, the program pads
    any batch b <= N to N with copies of example 0, solves at N and
    returns the first b examples, so the kernel runs at one static
    batch (which K1 and K3 do not need, but a caller that wants one
    launch shape for every load does).

    The cost is a QuadCost, as in mpc_tpu/utils/export.py:135; a solve
    with another cost (the pseudo-Huber cost, baked in) exports through
    ``export_fn``."""
    from ..learning import batched_solve

    if not isinstance(cost, QuadCost):
        raise ValueError('export_solve takes a QuadCost (its C and c are '
                         'runtime inputs); export a solve with another cost '
                         'through export_fn')
    if (u_lower is None) != (u_upper is None):
        raise ValueError('u_lower and u_upper must both be given or '
                         'both be None (the reference has no one-sided '
                         'box, mpc/mpc.py:127-130)')
    if _is_array(u_lower) != _is_array(u_upper):
        raise ValueError(
            'u_lower and u_upper must both be arrays (runtime inputs) '
            'or both be scalars/None (baked constants); got '
            f'{type(u_lower).__name__} / {type(u_upper).__name__}')
    if max_batch is not None and not polymorphic_batch:
        raise ValueError('max_batch pads a polymorphic batch: pass '
                         'polymorphic_batch=True with it')
    target = resolve_device(device)
    x_init = _tensor(x_init, None, target)
    dtype, trace_device = x_init.dtype, x_init.device
    is_lindx = isinstance(dynamics, LinDx)
    ex = {'x_init': x_init, 'C': _tensor(cost.C, dtype, trace_device),
          'c': _tensor(cost.c, dtype, trace_device)}
    if is_lindx:
        ex['F'] = _tensor(dynamics.F, dtype, trace_device)
        if dynamics.f is not None:
            ex['f'] = _tensor(dynamics.f, dtype, trace_device)
    if _is_array(u_lower):
        ex['u_lower'] = _tensor(u_lower, dtype, trace_device)
        ex['u_upper'] = _tensor(u_upper, dtype, trace_device)
    if u_init is not None:
        ex['u_init'] = _tensor(u_init, dtype, trace_device)
    sig = list(ex)
    cfg = _route_for(cfg, QuadCost(ex['C'], ex['c']),
                     LinDx(ex['F'], ex.get('f')) if is_lindx else dynamics,
                     dtype, target, u_lower)

    def fn(*args):
        kw = dict(zip(sig, args))
        dyn = LinDx(kw['F'], kw.get('f')) if is_lindx else dynamics
        sol = batched_solve(cfg, kw['x_init'], QuadCost(kw['C'], kw['c']),
                            dyn, u_init=kw.get('u_init'),
                            u_lower=kw.get('u_lower', u_lower),
                            u_upper=kw.get('u_upper', u_upper),
                            device=trace_device)
        return sol.x, sol.u, sol.costs

    move = _move_to(trace_device, target)
    args = [ex[name] for name in sig]
    if not polymorphic_batch:
        return _export_forward(fn, *args, device=move)

    batch_axis = {name: (0 if name == 'x_init' else 1)
                  if ex[name].dim() == _BATCHED_NDIM[name] else None
                  for name in sig}
    b = torch.export.Dim('batch', min=1, max=max_batch)
    shapes = [None if batch_axis[name] is None else {batch_axis[name]: b}
              for name in sig]
    if max_batch is None:
        return _export_forward(fn, *args, dynamic_shapes=shapes,
                               device=move)

    def fn_padded(*args):
        # the first b examples by a gather, not a slice: a view of b of
        # the max_batch examples would tie b to max_batch in the trace
        first = torch.arange(args[0].shape[0], device=args[0].device)
        padded = [a if batch_axis[name] is None
                  else _pad_to_batch(a, batch_axis[name], max_batch)
                  for name, a in zip(sig, args)]
        x, u, costs = fn(*padded)
        return (x.index_select(1, first), u.index_select(1, first),
                costs.index_select(0, first))

    return _export_forward(fn_padded, *args, dynamic_shapes=shapes,
                           device=move)


def export_closed_loop(cfg: MPCConfig, cost, dynamics, x_init,
                       n_steps: int, env_dynamics=None, u_lower=None,
                       u_upper=None, device=None) -> bytes:
    """Export ``make_closed_loop``'s rollout (mpc_tpu/utils/export.py:
    277-296) as one artifact, ``x_init -> {'xs', 'us', 'costs'}`` for a
    fixed ``n_steps``: the controller's configuration, cost and model,
    the environment, the bounds and the warm-start shift are baked in,
    the ``n_steps`` solves unrolled.  ``device`` as in
    ``export_solve``."""
    from ..closed_loop import make_closed_loop

    target = resolve_device(device)
    x_init = _tensor(x_init, None, target)
    cfg = _route_for(cfg, cost, dynamics, x_init.dtype, target, u_lower)
    roll = make_closed_loop(cfg, cost, dynamics, env_dynamics=env_dynamics,
                            u_lower=u_lower, u_upper=u_upper,
                            device=x_init.device)
    return _export_forward(lambda x0: roll(x0, n_steps), x_init,
                           device=_move_to(x_init.device, target))
