"""Finite-difference utilities (counterpart of mpc_tpu/utils/fd.py).

Central differences, the reference's ``mpc/torch_numdiff.py`` (grad and
hess) plus the per-vector ``jacobian`` helper (mpc/util.py:8-18).  They
exist for testing, as an oracle independent of autograd, and are plain
numpy so that they can differentiate any black box: the function gets a
float64 numpy array and returns something ``np.asarray`` accepts.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def fd_jacobian(f: Callable, x, eps: float = 1e-4):
    """Central-difference Jacobian of ``f`` at vector ``x``
    (reference mpc/util.py:8-18).  Returns [n_out, n_in]."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    cols = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = eps
        cols.append((np.asarray(f(x + e)) - np.asarray(f(x - e))) / (2 * eps))
    return np.stack(cols, axis=-1)


def fd_grad(f: Callable, x, eps: float = 1e-4):
    """Central-difference gradient of scalar-valued ``f``
    (reference mpc/torch_numdiff.py:15-28)."""
    x = np.asarray(x, dtype=np.float64)
    flat = x.reshape(-1)
    g = np.zeros_like(flat)
    for i in range(flat.size):
        e = np.zeros_like(flat)
        e[i] = eps
        g[i] = (float(f((flat + e).reshape(x.shape))) -
                float(f((flat - e).reshape(x.shape)))) / (2 * eps)
    return g.reshape(x.shape)


def fd_hess(f: Callable, x, eps: float = 1e-4):
    """Central-difference Hessian of scalar-valued ``f``
    (reference mpc/torch_numdiff.py:31-45)."""
    x = np.asarray(x, dtype=np.float64)

    def g(z):
        return fd_grad(f, z, eps).reshape(-1)

    H = fd_jacobian(g, x.reshape(-1), eps)
    return 0.5 * (H + H.T)
