"""Projected-Newton box-constrained QP of the eager solver (counterpart of
mpc_tpu/ops/pnqp.py:49-204):

    min_x 0.5 x^T H x + q^T x    s.t.  lower <= x <= upper

for a batch of problems at once: H [..., n, n], q, lower, upper [..., n].
The JAX package writes it for one instance with ``lax.while_loop``s and
vmaps it, so a finished instance's state stays frozen while the others
iterate.  Here the loops run a fixed number of trips (``n_iter`` Newton
steps, ``MAX_LS_ITER`` step sizes) and ``torch.where`` freezes the
instances that are done; the counts grow only for live ones.  The result
is the vmapped loop's, and nothing reads a value back to the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import linalg

GAMMA = 0.1
LS_DECAY = 0.1
MAX_LS_ITER = 10
CONV_TOL = 1e-4


class PnqpResult(NamedTuple):
    x: torch.Tensor          # solution [..., n]
    H_free: torch.Tensor     # free-subspace-masked Hessian of the last step
    free: torch.Tensor       # bool free set of the last step [..., n]
    n_iter: torch.Tensor     # int32 Newton steps taken [...]
    converged: torch.Tensor  # bool [...]


def _obj(H, q, x):
    return 0.5 * linalg.bquad(x, H) + linalg.bdot(q, x)


def first_passing(passing):
    """Index along axis 0 of the first True of ``passing`` [A, ...], or
    A - 1 where none is (the "first passing, else the last" choice of
    mpc_tpu/ops/pnqp.py:152-155 and ops/lqr.py:317-320), without an
    argmax over booleans: the count of leading False entries."""
    lead = (passing.to(torch.int32).cumsum(0) == 0).sum(0)
    return lead.clamp(max=passing.shape[0] - 1)


def take(stacked, k):
    """stacked [A, ..., n] indexed along axis 0 by k [...]."""
    idx = k.unsqueeze(0).unsqueeze(-1).expand((1,) + stacked.shape[1:])
    return stacked.gather(0, idx).squeeze(0)


def pnqp_1d(H, q, lower, upper):
    """Closed-form n = 1 box QP, x* = clamp(-q / H, lower, upper)
    (mpc_tpu/ops/pnqp.py:69-89)."""
    h = H[..., 0, :]
    x = linalg.eclamp(-q / h, lower, upper)
    g = h * x + q
    clamped = ((x == lower) & (g > 0)) | ((x == upper) & (g < 0))
    free = ~clamped
    batch = x.shape[:-1]
    return PnqpResult(
        x, linalg.masked_free_matrix(H, free), free,
        torch.ones(batch, dtype=torch.int32, device=x.device),
        torch.ones(batch, dtype=torch.bool, device=x.device))


def _armijo(H, q, x, xt, g, fx):
    num = fx - _obj(H, q, xt)
    den = linalg.bdot(g, x - xt)
    return (num / den).masked_fill(den.abs() < 1e-30, GAMMA + 1e-6)


def _search_parallel(H, q, lower, upper, x, dx, g, alphas):
    """Every step size of the fixed schedule 1, 0.1, ... at once, the
    first whose Armijo ratio passes kept (mpc_tpu/ops/pnqp.py:136-156)."""
    xt = linalg.eclamp(x + alphas * dx, lower, upper)
    armijo = _armijo(H, q, x, xt, g, _obj(H, q, x))
    return take(xt, first_passing(armijo > GAMMA))


def _search_seq(H, q, lower, upper, x, dx, g):
    """The reference-shaped search (mpc_tpu/ops/pnqp.py:158-182): decay
    while the ratio fails, keep the last trial computed."""
    alpha = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    armijo = torch.full(x.shape[:-1], GAMMA, dtype=x.dtype, device=x.device)
    x_trial = x
    for _ in range(MAX_LS_ITER):
        live = armijo <= GAMMA
        xt = linalg.eclamp(x + alpha * dx, lower, upper)
        arm = _armijo(H, q, x, xt, g, _obj(H, q, x))
        alpha = torch.where((live & (arm <= GAMMA)).unsqueeze(-1),
                            alpha * LS_DECAY, alpha)
        armijo = torch.where(live, arm, armijo)
        x_trial = torch.where(live.unsqueeze(-1), xt, x_trial)
    return x_trial


def pnqp(H, q, lower, upper, x_init=None, n_iter=20,
         parallel_armijo: bool = True) -> PnqpResult:
    """Solve a batch of box QPs (mpc_tpu/ops/pnqp.py:92-204).

    H [..., n, n] symmetric PSD, q [..., n], lower and upper broadcastable
    to q, ``x_init`` an optional warm start [..., n] (the previous
    Riccati step's k_t).  ``n_iter`` Newton steps at most; an instance
    whose Newton step is shorter than ``CONV_TOL`` stops, keeping the x
    it had before that step and that step's free set and masked H."""
    n = H.shape[-1]
    lower = torch.broadcast_to(torch.as_tensor(lower, dtype=q.dtype,
                                               device=q.device), q.shape)
    upper = torch.broadcast_to(torch.as_tensor(upper, dtype=q.dtype,
                                               device=q.device), q.shape)
    if n == 1:
        return pnqp_1d(H, q, lower, upper)
    if x_init is None:
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        x_init = -linalg.solve_spd(H + 1e-11 * eye, q)
    x = linalg.eclamp(x_init, lower, upper)
    search = _search_seq
    if parallel_armijo:
        # the schedule, [MAX_LS_ITER, 1, ..., 1], made once a call
        alphas = (torch.tensor(LS_DECAY, dtype=x.dtype) ** torch.arange(
            MAX_LS_ITER, dtype=x.dtype)).to(x.device).reshape(
                (MAX_LS_ITER,) + (1,) * x.dim())
        search = functools.partial(_search_parallel, alphas=alphas)

    batch = x.shape[:-1]
    free = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    H_free = linalg.masked_free_matrix(H, free).expand(batch + (n, n))
    i = torch.zeros(batch, dtype=torch.int32, device=x.device)
    done = torch.zeros(batch, dtype=torch.bool, device=x.device)
    for _ in range(n_iter):
        live = ~done
        g = linalg.bmv(H, x) + q
        clamped = ((x == lower) & (g > 0)) | ((x == upper) & (g < 0))
        fr = ~clamped
        Hf = linalg.masked_free_matrix(H, fr)
        dx = -linalg.solve_spd(Hf, g.masked_fill(clamped, 0.0))
        conv = torch.linalg.vector_norm(dx, dim=-1) < CONV_TOL
        x_new = torch.where(conv.unsqueeze(-1), x,
                            search(H, q, lower, upper, x, dx, g))
        lv = live.unsqueeze(-1)
        x = torch.where(lv, x_new, x)
        free = torch.where(lv, fr, free)
        H_free = torch.where(lv.unsqueeze(-1), Hf, H_free)
        i = i + live.to(torch.int32)
        done = torch.where(live, conv, done)
    return PnqpResult(x, H_free, free, i, done)
