"""Numerical debugging helpers (counterpart of mpc_tpu/utils/debug.py).

Three layers, from the cheapest to the most invasive:

  * ``finite_mask(sol)``: per-example finiteness of a batched Solution,
    computed on the device (no read by the host);
  * ``assert_finite(tree)``: a check of any nest of tensors, raising
    FloatingPointError that names the offending fields;
  * ``nan_checks()``: a context under which every PyTorch operator's
    output is checked for NaN, raising FloatingPointError at the first
    operator that makes one (the JAX package toggles ``jax_debug_nans``;
    this is the eager counterpart).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def finite_mask(solution):
    """[B] bool: True where every floating field of the batched Solution
    is finite for that example (x and u are time-major [T, B, ...], the
    statistics [B]).  ``iter_stats`` is NaN-padded by design and left
    out.  Combine with ``solution.converged`` to gate what follows a
    batched solve."""
    masks = []
    for name, leaf in zip(solution._fields, solution):
        if name == 'iter_stats' or not isinstance(leaf, torch.Tensor) \
                or not leaf.is_floating_point():
            continue
        ax = 1 if leaf.dim() >= 2 and name in ('x', 'u') else 0
        a = leaf.movedim(ax, 0) if leaf.dim() else leaf
        masks.append(torch.isfinite(a).reshape(a.shape[0], -1).all(1)
                     if a.dim() else torch.isfinite(a).reshape(1))
    return torch.stack(masks, 0).all(0)


def _named_leaves(tree, path=''):
    """(path, tensor) of every tensor in a nest of named tuples, dicts,
    lists and tuples, with paths as ``jax.tree_util.keystr`` writes them
    (``.field``, ``['key']``, ``[i]``)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
        for name, v in zip(tree._fields, tree):
            yield from _named_leaves(v, f'{path}.{name}')
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f'{path}[{k!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f'{path}[{i}]')


def assert_finite(tree, name='value'):
    """Check that every floating tensor in ``tree`` is finite; raises
    FloatingPointError naming the offending fields.  Reads the device
    (one value a tensor).  Returns ``tree``."""
    bad = [p for p, a in _named_leaves(tree)
           if a.is_floating_point() and not bool(torch.isfinite(a).all())]
    if bad:
        raise FloatingPointError(
            f'{name} contains non-finite values at: {", ".join(bad)}')
    return tree


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for a in tree_leaves(out):
            if isinstance(a, torch.Tensor) and a.is_floating_point() \
                    and bool(torch.isnan(a).any()):
                raise FloatingPointError(
                    f'nan_checks: {func} produced a NaN')
        return out


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """Check the output of every PyTorch operator run in the context for
    NaN and raise FloatingPointError naming the first operator that made
    one.  For debugging only: it reads the device after every operator,
    so each operator waits for the card and a solve runs many times
    slower.  ``enabled=False`` makes it a no-op."""
    if not enabled:
        yield
        return
    with _NanCheck():
        yield
