"""Problems that the card checks and the CPU tests share, as numpy
arrays made from a seed."""

import numpy as np


def hw_sweep_delta_u(T, B, seed=3):
    """benchmarks/hw_sweep.py:145-170's trust-region problem at T, B: 3
    states and 2 controls, batched C = R R^T + I, c, F (the identity plus
    noise, an input block) and bounds, no f; solved with delta_u 0.3,
    pnqp_iter 20 and lqr_iter 8 there.  Returns (F, C, c, x0, lb, ub)."""
    ns, nc = 3, 2
    nt = ns + nc
    rng = np.random.RandomState(seed)
    R = rng.randn(T, B, nt, nt)
    C = np.einsum('tbij,tbkj->tbik', R, R) + np.eye(nt)
    c = rng.randn(T, B, nt)
    F = np.concatenate([np.tile(np.eye(ns), (T - 1, B, 1, 1))
                        + 0.1 * rng.randn(T - 1, B, ns, ns),
                        0.4 * rng.randn(T - 1, B, ns, nc)], 3)
    x0 = rng.randn(B, ns)
    lb = -np.abs(rng.randn(T, B, nc)) - .1
    ub = np.abs(rng.randn(T, B, nc)) + .1
    return F, C, c, x0, lb, ub
