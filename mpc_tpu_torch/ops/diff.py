"""The differentiable fixed point of the eager solver (counterpart of
mpc_tpu/ops/diff.py:34-138).

``make_lqr_fixed_point`` is the reference's LQR step in
``no_op_forward`` mode (mpc/lqr_step.py:277-282, 311-407) as a batched
``torch.autograd.Function``: the forward passes the converged
trajectory through; the backward differentiates the KKT conditions of
the box-constrained LQR fixed point (Amos et al., NeurIPS 2018) with the
eager ``lqr_solve`` on the differential problem, for any n_state and
n_ctrl and in float32 or float64 on any device.  The kernel path's
fixed point, whose backward is K2 or K4, is
``ops.fused_bwd.make_batched_fixed_point``.

The backward is written with the elementwise products of ``linalg``,
so a caller's TF32 setting cannot reach it (it runs after the caller's
context has ended, like the JAX package's custom_vjp backward whose
matmul precision had to be pinned, mpc_tpu/ops/diff.py:59-66).
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from . import linalg
from .lqr import lqr_solve
from .math import ACTIVE_TOL



def _to_shape(g, shape):
    """A gradient computed for the whole batch, summed back to the shape
    of the operand it belongs to (a batch extent of 1 for a shared one)."""
    return None if g is None else g.sum_to_size(shape)


@functools.lru_cache(maxsize=None)
def make_lqr_fixed_point(n_state: int, has_bounds: bool, has_f: bool,
                         parallel: bool = False):
    """The batched fixed point for a problem shape; with ``parallel``
    its backward solves the differential problem by the O(log T) scan
    (``lqr.lqr_solve``).

    ``apply(x_init, C, c, F, f, u_lower, u_upper, x_star, u_star)`` with
    x_init [B, n_state], C [T, *b, ntau, ntau], c [T, *b, ntau],
    F [T-1, *b, n_state, ntau], f None or [T-1, *b, n_state] and bounds
    None or [T, *b, n_ctrl] (*b of extent 1 or B) returns (x_star,
    u_star), [T, B, ...].  Its backward returns the gradients for x_init,
    C, c, F and f in the shapes they came in (summed over the batch where
    an extent is 1), zeros for the bounds (the reference's) and none for
    x_star, u_star (mpc_tpu/ops/diff.py:68-136)."""
    ns = n_state

    class LqrFixedPoint(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_init, C, c, F, f, u_lower, u_upper, x_star,
                    u_star):
            ctx.f_shape = f.shape if has_f else None
            ctx.save_for_backward(C, c, F, u_lower if has_bounds else None,
                                  u_upper if has_bounds else None, x_star,
                                  u_star)
            # new outputs, so that autograd attaches this backward to them
            return x_star.view_as(x_star), u_star.view_as(u_star)

        @staticmethod
        @once_differentiable
        def backward(ctx, dl_dx, dl_du):
            C, c, F, lb, ub, x_star, u_star = ctx.saved_tensors
            T = x_star.shape[0]
            r = torch.cat([dl_dx, dl_du], -1)
            I = None
            if has_bounds:
                I = ((u_star - lb).abs() <= ACTIVE_TOL) | \
                    ((u_star - ub).abs() <= ACTIVE_TOL)
            dx, du = lqr_solve(C, -r, F, None, torch.zeros_like(x_star[0]),
                               u_zero_I=I, n_state=ns, parallel=parallel)
            dxu = torch.cat([dx, du], -1)
            xu = torch.cat([x_star, u_star], -1)
            dC = -0.5 * (linalg.bger(dxu, xu) + linalg.bger(xu, dxu))
            dc = -dxu

            # costate recursions, reverse time (mpc_tpu/ops/diff.py:106-121)
            lams, dlams = [None] * T, [None] * T
            for t in reversed(range(T)):
                Cxx, Cxu = C[t, ..., :ns, :ns], C[t, ..., :ns, ns:]
                lam = linalg.bmv(Cxx, x_star[t]) + \
                    linalg.bmv(Cxu, u_star[t]) + c[t, ..., :ns]
                dlam = linalg.bmv(Cxx, dx[t]) + linalg.bmv(Cxu, du[t]) - \
                    r[t, ..., :ns]
                if t < T - 1:
                    FxT = F[t, ..., :ns].transpose(-1, -2)
                    lam = lam + linalg.bmv(FxT, lams[t + 1])
                    dlam = dlam + linalg.bmv(FxT, dlams[t + 1])
                lams[t], dlams[t] = lam, dlam
            lam_n = torch.stack(lams[1:])
            dlam_n = torch.stack(dlams[1:])
            dF = -(linalg.bger(dlam_n, xu[:-1]) + linalg.bger(lam_n, dxu[:-1]))
            df = -dlam_n if has_f else None
            dlb, dub = (torch.zeros_like(b) if need else None for b, need in
                        zip((lb, ub), ctx.needs_input_grad[5:7]))
            return (-dlams[0], _to_shape(dC, C.shape), _to_shape(dc, c.shape),
                    _to_shape(dF, F.shape), _to_shape(df, ctx.f_shape), dlb,
                    dub, None, None)

    return LqrFixedPoint
