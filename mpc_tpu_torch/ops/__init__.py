"""Compute ops of the port: the fused iLQR solve (kernel K1), the fused
KKT backward (kernel K2) with its constants (``diff``), and the
pendulum's elementwise helpers."""

from . import diff, fused, fused_bwd, math

__all__ = ['diff', 'fused', 'fused_bwd', 'math']
