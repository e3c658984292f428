"""Compute ops of the port: the kernels as ``torch.library`` ops
(``custom``), the fused iLQR solve around K1 and K3 (``fused``) and
K3's dense configuration (``fused_dense``), the fused KKT backward
around K2 and K4 (``fused_bwd``) and their dense configuration
(``fused_bwd_dense``), the eager solver's
linear algebra, box QP and LQR pieces (``linalg``, ``pnqp``, ``lqr``),
the O(log T) Riccati scan (``pscan``), its differentiable fixed point
(``diff``) and the pendulum's elementwise helpers.

Importing the package registers the ops; the solver's modules (``lqr``,
``pnqp``, ``pscan``, ``diff``) load at their first use, so a process
that only runs exported programs never imports them."""

import importlib

from . import (custom, fused, fused_bwd, fused_bwd_dense, fused_dense,
               linalg, math)

_SOLVER_MODULES = ('diff', 'lqr', 'pnqp', 'pscan')

__all__ = ['custom', 'diff', 'fused', 'fused_bwd', 'fused_bwd_dense',
           'fused_dense', 'linalg', 'lqr', 'math', 'pnqp', 'pscan']


def __getattr__(name):
    if name in _SOLVER_MODULES:
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
