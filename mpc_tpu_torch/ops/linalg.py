"""Small-matrix linear algebra of the eager solver (counterpart of
mpc_tpu/ops/linalg.py:23-179).

The JAX package writes these for one problem instance and lets ``vmap``
add the batch.  Here every function takes leading batch dimensions:
matrices are [..., m, n] and vectors [..., n], broadcast against each
other as elementwise operations broadcast.

Products are written as elementwise multiplications summed over the last
axis, never ``matmul`` or ``einsum``: on the card a float32 ``matmul``
turns into TF32 when the caller allows it
(``torch.backends.cuda.matmul.allow_tf32``), and these products must give
the same bits either way.  Each sum runs over the last, contiguous axis
of a freshly computed product, so its order depends on the length of
that axis alone, not on the batch: an example's result does not depend on
the batch it is solved in.
"""

from __future__ import annotations

import torch

# Above this size the unrolled factorisation gives way to
# torch.linalg.cholesky_ex + cholesky_solve (mpc_tpu/ops/linalg.py:95).
_UNROLL_CHOL_N = 32


def bmv(X, y):
    """Matrix-vector product X [..., m, n] @ y [..., n] -> [..., m]
    (reference mpc/util.py:44)."""
    return (X * y.unsqueeze(-2)).sum(-1)


def bmm(X, Y):
    """Matrix product X [..., m, k] @ Y [..., k, n] -> [..., m, n]."""
    Yt = Y.transpose(-1, -2).contiguous()
    return (X.unsqueeze(-2) * Yt.unsqueeze(-3)).sum(-1)


def bger(x, y):
    """Outer product x [..., m] (x) y [..., n] -> [..., m, n]
    (reference mpc/util.py:40)."""
    return x.unsqueeze(-1) * y.unsqueeze(-2)


def bdot(x, y):
    """Dot product over the last axis (reference mpc/util.py:52)."""
    return (x * y).sum(-1)


def bquad(x, Q):
    """Quadratic form x^T Q x (reference mpc/util.py:48)."""
    return bdot(x, bmv(Q, x))


def bdiag(d):
    """Vector [..., n] -> diagonal matrix [..., n, n] (reference
    mpc/util.py:30)."""
    return torch.diag_embed(d)


def eclamp(x, lower, upper):
    """Elementwise clamp to [lower, upper], as ``jnp.clip``: the lower
    bound first, then the upper (reference mpc/util.py:56-70).  Bounds
    are tensors broadcastable to ``x`` or Python numbers."""
    lower = torch.as_tensor(lower, dtype=x.dtype, device=x.device)
    upper = torch.as_tensor(upper, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lower), upper)


def _is_vector(H, b):
    return b.dim() == H.dim() - 1


def _solve_1x1(H, b):
    h = H[..., 0, 0]
    return b / (h.unsqueeze(-1) if _is_vector(H, b) else h[..., None, None])


def solve_sym(H, b):
    """Solve H x = b for symmetric (not necessarily definite) tiny H
    [..., n, n]; ``b`` is [..., n] or [..., n, k]."""
    if H.shape[-1] == 1:
        return _solve_1x1(H, b)
    if _is_vector(H, b):
        return torch.linalg.solve(H, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(H, b)


def _chol_solve_unrolled(H, b):
    """Cholesky solve with the factorisation unrolled over n, in the JAX
    package's order of operations (mpc_tpu/ops/linalg.py:98-129).

    The factor is computed column by column with a rank-one update of the
    trailing block (one operation over the block a column), and the
    forward substitution a column at a time: each element then sees the
    same sequence of subtractions as in the scalar loops.  The backward
    substitution keeps the scalar loop, whose order a column form would
    reverse.  ``b`` is [..., n] or [..., n, k]."""
    n = H.shape[-1]
    vec = _is_vector(H, b)
    rhs = b.unsqueeze(-1) if vec else b                # [..., n, k]
    # diag[j] = L[j, j] and below[j] = L[j+1:, j], [..., 1] and [..., n-j-1]
    diag, below = [], []
    A = H
    for j in range(n):
        d = torch.sqrt(A[..., 0, :1])
        col = A[..., 1:, 0] / d
        diag.append(d)
        below.append(col)
        if j < n - 1:
            A = A[..., 1:, 1:] - col.unsqueeze(-1) * col.unsqueeze(-2)
    # forward substitution, L y = rhs
    y = []
    rem = rhs
    for i in range(n):
        yi = rem[..., 0, :] / diag[i]
        y.append(yi)
        if i < n - 1:
            rem = rem[..., 1:, :] - below[i].unsqueeze(-1) * yi.unsqueeze(-2)
    # backward substitution, L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - below[i][..., k - i - 1:k - i] * x[k]
        x[i] = s / diag[i]
    out = torch.stack(x, -2)
    return out.squeeze(-1) if vec else out


def solve_spd(H, b):
    """Solve H x = b for symmetric positive-definite tiny H [..., n, n]
    (mpc_tpu/ops/linalg.py:132-152): 1 / H for n = 1, the unrolled
    Cholesky up to ``_UNROLL_CHOL_N``, past it ``cholesky_ex`` and
    ``cholesky_solve`` (no host synchronisation).  ``b`` is [..., n] or
    [..., n, k]."""
    n = H.shape[-1]
    if n == 1:
        return _solve_1x1(H, b)
    if n <= _UNROLL_CHOL_N:
        return _chol_solve_unrolled(H, b)
    L = torch.linalg.cholesky_ex(H).L
    if _is_vector(H, b):
        return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.cholesky_solve(b, L)


def pinv_rtol(n, dtype):
    """``jnp.linalg.pinv``'s default cut-off relative to the largest
    singular value, 10 max(m, n) eps.  ``torch.linalg.pinv``'s default is
    ten times smaller, so the port passes this one explicitly."""
    return 10.0 * n * torch.finfo(dtype).eps


def solve_psd_pinv(H, b):
    """Solve through the pseudo-inverse, robust to semidefinite H
    (mpc_tpu/ops/linalg.py:155-165; the reference's per-example
    ``torch.pinverse``, mpc/lqr_step.py:89-94): singular values at or
    below ``pinv_rtol`` times the largest are dropped.  The SVD's factors
    are applied to ``b`` with elementwise products (no TF32)."""
    n = H.shape[-1]
    if n == 1:
        return _solve_1x1(H, b)
    U, S, Vh = torch.linalg.svd(H)
    cutoff = pinv_rtol(n, H.dtype) * S[..., :1]
    s_inv = torch.where(S > cutoff, 1.0 / S, torch.zeros_like(S))
    Ut = U.transpose(-1, -2)
    V = Vh.transpose(-1, -2)
    if _is_vector(H, b):
        return bmv(V, s_inv * bmv(Ut, b))
    return bmm(V, s_inv.unsqueeze(-1) * bmm(Ut, b))


def masked_free_matrix(H, free, clamped_diag=1.0, reg=1e-11):
    """Restrict symmetric H [..., n, n] to the free subspace ``free``
    [..., n] (bool): clamped rows and columns zeroed, ``clamped_diag``
    plus ``reg`` on their diagonal, ``reg`` on the free diagonal
    (mpc_tpu/ops/linalg.py:155-173; the reference leaves 1e-11 on the
    clamped diagonal, mpc/pnqp.py:44-49)."""
    free_f = free.to(H.dtype)
    return H * bger(free_f, free_f) + torch.diag_embed(
        clamped_diag * (1.0 - free_f) + reg)


def mask_rows(M, keep):
    """Zero the rows of M [..., n, k] where ``keep`` [..., n] is False
    (mpc_tpu/ops/linalg.py:176-179)."""
    return M * keep.to(M.dtype).unsqueeze(-1)
