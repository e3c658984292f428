"""Compute ops of the port: the fused iLQR solve (kernel K1) and the
pendulum's elementwise helpers."""

from . import fused, math

__all__ = ['fused', 'math']
