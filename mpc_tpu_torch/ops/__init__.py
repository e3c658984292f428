"""Compute ops of the port: the fused iLQR solve (kernels K1 and K3),
the fused KKT backward (kernels K2 and K4), the eager solver's linear
algebra, box QP and LQR pieces (``linalg``, ``pnqp``, ``lqr``), the O(log T)
Riccati scan (``pscan``), its differentiable fixed point (``diff``) and
the pendulum's elementwise helpers."""

from . import diff, fused, fused_bwd, linalg, lqr, math, pnqp, pscan

__all__ = ['diff', 'fused', 'fused_bwd', 'linalg', 'lqr', 'math', 'pnqp',
           'pscan']
