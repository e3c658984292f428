"""The eager solver's operations against the JAX package's, on the CPU in
float64: the batched linear algebra (mpc_tpu_torch/ops/linalg.py), the
box QP (ops/pnqp.py) and the LQR pieces (ops/lqr.py).

The JAX functions are written for one instance; the same numpy inputs
go through ``jax.vmap`` of them and through the port's batched ones.

- linalg: 1e-12 relative (the factorisation keeps the JAX package's
  order of operations; measured ~1e-16), and the pseudo-inverse's cut-off
  where torch's default and jnp's differ.
- pnqp at n = 1, 2 and 3, both Armijo searches: x to 1e-12, the free set,
  the Newton count and the converged flag equal; against
  tests/oracles.py:box_qp as tests/test_pnqp.py holds mpc_tpu's (rtol
  1e-3, atol 1e-6: the Newton loop stops at a step norm of 1e-4).
- riccati_backward (each control solve), lqr_forward (both searches),
  lqr_step_delta and lqr_solve to 1e-12 relative; lqr_solve also against
  tests/oracles.py:lqr_dense.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_tpu.ops import linalg as jlinalg, lqr as jlqr, pnqp as jpnqp

from mpc_tpu_torch.ops import linalg, lqr, pnqp

from oracles import box_qp, lqr_dense

TOL = 1e-12


def _t(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, ref, tol=TOL, name=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale, (
        name, np.abs(got - ref).max() / scale)


def _spd(rng, B, n, shift=0.1):
    R = rng.randn(B, n, n)
    return R @ R.transpose(0, 2, 1) + shift * np.eye(n)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def test_products_match_numpy():
    rng = np.random.RandomState(0)
    X, Y = rng.randn(4, 3, 5), rng.randn(4, 5, 2)
    x, y = rng.randn(4, 5), rng.randn(4, 3)
    Q = _spd(rng, 4, 5)
    tX, tY, tx, ty, tQ = _t(X, Y, x, y, Q)
    _close(linalg.bmv(tX, tx), np.einsum('bij,bj->bi', X, x))
    _close(linalg.bmm(tX, tY), X @ Y)
    _close(linalg.bmm(tX[0], tY), X[0] @ Y)          # broadcast batch
    _close(linalg.bger(ty, tx), np.einsum('bi,bj->bij', y, x))
    _close(linalg.bdot(tx, tx), (x * x).sum(-1))
    _close(linalg.bquad(tx, tQ), np.einsum('bi,bij,bj->b', x, Q, x))
    _close(linalg.bdiag(tx), np.stack([np.diag(v) for v in x]))
    lo, hi = -0.5 * np.ones(5), 0.5 * np.ones(5)
    _close(linalg.eclamp(tx, torch.tensor(lo), torch.tensor(hi)),
           np.clip(x, lo, hi))
    _close(linalg.eclamp(tx, -0.5, 0.5), np.clip(x, -0.5, 0.5))


@pytest.mark.parametrize('n', [1, 2, 3, 5])
def test_solves_match_jax(n):
    rng = np.random.RandomState(n)
    B = 6
    H = _spd(rng, B, n)
    b, Bm = rng.randn(B, n), rng.randn(B, n, 3)
    free = rng.rand(B, n) < 0.6
    free[:, 0] = True
    tH, tb, tBm, tf = _t(H, b, Bm, free)
    for name, fn, jfn in (('solve_spd', linalg.solve_spd, jlinalg.solve_spd),
                          ('solve_sym', linalg.solve_sym, jlinalg.solve_sym),
                          ('pinv', linalg.solve_psd_pinv,
                           jlinalg.solve_psd_pinv)):
        _close(fn(tH, tb), jax.vmap(jfn)(*_j(H, b)), name=name)
        _close(fn(tH, tBm), jax.vmap(jfn)(*_j(H, Bm)), name=name + ' [n, k]')
    Hm = linalg.masked_free_matrix(tH, tf)
    _close(Hm, jax.vmap(jlinalg.masked_free_matrix)(*_j(H, free)))
    _close(linalg.mask_rows(tBm, tf),
           jax.vmap(jlinalg.mask_rows)(*_j(Bm, free)))
    _close(linalg.solve_spd(Hm, tb),
           jax.vmap(jlinalg.solve_spd)(jax.vmap(jlinalg.masked_free_matrix)(
               *_j(H, free)), jnp.asarray(b)), name='masked')


def test_unrolled_cholesky_beyond_unroll_limit():
    """Past _UNROLL_CHOL_N the factorisation is cholesky_ex +
    cholesky_solve; both sides agree with numpy."""
    rng = np.random.RandomState(3)
    n = linalg._UNROLL_CHOL_N + 2
    H, b = _spd(rng, 2, n, shift=n), rng.randn(2, n)
    _close(linalg.solve_spd(*_t(H, b)), np.linalg.solve(H, b[..., None])[..., 0],
           tol=1e-10)


def test_pinv_cut_off_is_jax_default():
    """A semidefinite Quu whose smallest singular value lies between
    torch's default cut-off (max(m, n) eps) and jnp's (10 max(m, n) eps)
    relative to the largest: jnp drops it, and so must the port."""
    n = 3
    eps = np.finfo(np.float64).eps
    U = np.linalg.qr(np.random.RandomState(4).randn(n, n))[0]
    s = np.array([1.0, 0.5, 5 * n * eps])
    H = (U * s) @ U.T
    b = np.ones(n)
    ref = jlinalg.solve_psd_pinv(*_j(H, b))
    got = linalg.solve_psd_pinv(*_t(H[None], b[None]))[0]
    _close(got, ref, tol=1e-9)
    # torch.linalg.pinv's own default keeps that singular value
    keep = torch.linalg.pinv(torch.tensor(H)) @ torch.tensor(b)
    assert np.abs(keep.numpy() - np.asarray(ref)).max() > 1e10
    assert linalg.pinv_rtol(n, torch.float64) == 10 * n * eps


# ---------------------------------------------------------------------------
# pnqp
# ---------------------------------------------------------------------------

def _qp(n, B=16, seed=0):
    rng = np.random.RandomState(seed + 10 * n)
    H = _spd(rng, B, n)
    q = 3 * rng.randn(B, n)
    lower, upper = -rng.rand(B, n), rng.rand(B, n)
    x0 = rng.randn(B, n)
    return H, q, lower, upper, x0


@pytest.mark.parametrize('parallel', [True, False], ids=['parallel', 'seq'])
@pytest.mark.parametrize('n', [1, 2, 3])
def test_pnqp_matches_jax(n, parallel):
    H, q, lower, upper, x0 = _qp(n)
    ref = jax.vmap(lambda *a: jpnqp.pnqp(*a[:4], x_init=a[4],
                                         parallel_armijo=parallel))(
        *_j(H, q, lower, upper, x0))
    got = pnqp.pnqp(*_t(H, q, lower, upper), x_init=torch.tensor(x0),
                    parallel_armijo=parallel)
    _close(got.x, ref.x, name='x')
    _close(got.H_free, ref.H_free, name='H_free')
    for name in ('free', 'n_iter', 'converged'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert n == 1 or got.n_iter.numpy().max() > 1
    oracle = np.stack([box_qp(H[i], q[i], lower[i], upper[i])
                       for i in range(len(H))])
    np.testing.assert_allclose(got.x.numpy(), oracle, rtol=1e-3, atol=1e-6)


def test_first_passing_index():
    p = torch.tensor([[False, True, False], [True, True, False],
                      [False, True, False]])
    np.testing.assert_array_equal(pnqp.first_passing(p).numpy(), [1, 0, 2])


# ---------------------------------------------------------------------------
# LQR pieces
# ---------------------------------------------------------------------------

def _lqr_problem(T, B, ns, nc, seed=0, shared=False, semidef=False):
    rng = np.random.RandomState(seed)
    nt = ns + nc
    C = _spd(rng, T * B, nt).reshape(T, B, nt, nt) / nt + np.eye(nt)
    if semidef:
        # a zero control weight: Quu semidefinite at t = T - 1
        C[T - 1, :, ns:, :] = 0
        C[T - 1, :, :, ns:] = 0
    c = rng.randn(T, B, nt)
    F = 0.4 * rng.randn(T - 1, B, ns, nt)
    F[..., :ns] += 0.8 * np.eye(ns)
    f = 0.1 * rng.randn(T - 1, B, ns)
    if shared:
        C, F = C[:, :1], F[:, :1]
    x = rng.randn(T, B, ns)
    u = 0.3 * rng.randn(T, B, nc)
    x0 = rng.randn(B, ns)
    return C, c, F, f, x, u, x0


RICCATI_CASES = {
    # n_ctrl, riccati keywords (lb/ub/uz/delta_u), semidefinite C
    'nc1_closed_form': (1, {}, False),
    'nc2_pinv': (2, {}, False),
    'nc3_pinv_semidefinite': (3, {}, True),
    'nc2_u_zero_I': (2, dict(uz=True), False),
    'nc1_box': (1, dict(box=True), False),
    'nc2_box': (2, dict(box=True), False),
    'nc3_box_delta_u': (3, dict(box=True, delta_u=0.2), False),
    'nc2_with_f': (2, dict(with_f=True), False),
}


@pytest.mark.parametrize('case', list(RICCATI_CASES))
def test_riccati_backward_matches_jax(case):
    nc, kw, semidef = RICCATI_CASES[case]
    T, B, ns = 6, 5, 3
    C, c, F, f, x, u, x0 = _lqr_problem(T, B, ns, nc, semidef=semidef)
    rng = np.random.RandomState(1)
    lb = ub = uz = None
    if kw.get('box'):
        lb, ub = -0.4 - rng.rand(T, B, nc), 0.4 + rng.rand(T, B, nc)
    if kw.get('uz'):
        uz = rng.rand(T, B, nc) < 0.4
    f_in = f if kw.get('with_f') else None
    du = kw.get('delta_u')

    def one(C, c, F, u, f, lb, ub, uz):
        return jlqr.riccati_backward(C, c, F, u, ns, f=f, u_lower=lb,
                                     u_upper=ub, u_zero_I=uz, delta_u=du)

    axes = tuple(None if a is None else 1 for a in (C, c, F, u, f_in, lb,
                                                    ub, uz))
    ref = jax.vmap(one, in_axes=axes)(*_j(C, c, F, u, f_in, lb, ub, uz))
    got = lqr.riccati_backward(*_t(C, c, F, u), ns, f=_t(f_in)[0],
                               u_lower=_t(lb)[0], u_upper=_t(ub)[0],
                               u_zero_I=_t(uz)[0], delta_u=du)
    _close(got.K, np.moveaxis(np.asarray(ref.K), 0, 1), name='K')
    _close(got.k, np.moveaxis(np.asarray(ref.k), 0, 1), name='k')
    np.testing.assert_array_equal(got.n_qp_iter.numpy(),
                                  np.asarray(ref.n_qp_iter))


@pytest.mark.parametrize('parallel', [True, False], ids=['parallel', 'seq'])
@pytest.mark.parametrize('nc', [1, 2])
def test_lqr_step_and_forward_match_jax(nc, parallel):
    """One delta-space iLQR step on a LinDx box problem with a shared C
    and F (lqr_step_delta: Riccati and the line-searched rollout)."""
    T, B, ns = 6, 8, 3
    C, c, F, f, _, u, x0 = _lqr_problem(T, B, ns, nc, seed=2, shared=True)
    lb, ub = -0.5 * np.ones((T, 1, nc)), 0.5 * np.ones((T, 1, nc))
    u = np.clip(u, -0.5, 0.5)
    tC, tc, tF, tf, tu, tx0 = _t(C, c, F, f, u, x0)
    xs = [tx0]                                  # a rollout of u
    for t in range(T - 1):
        xs.append(lqr.dynamics_step((tF, tf), t, xs[t], tu[t]))
    tx = torch.stack(xs)
    kw = dict(linesearch_decay=0.3, max_linesearch_iter=6,
              parallel_linesearch=parallel)
    # the true dynamics differ from the model, so that full steps can
    # raise the true cost and the search goes on
    got, n_qp = lqr.lqr_step_delta(
        tx0, tC, tc, tF, tf, tx, tu, ns, (tC, tc), (1.6 * tF, tf),
        u_lower=torch.tensor(lb), u_upper=torch.tensor(ub), **kw)

    def one(x0, c, f, x, u):
        return jlqr.lqr_step_delta(
            x0, jnp.asarray(C[:, 0]), c, jnp.asarray(F[:, 0]), f, x, u, ns,
            (jnp.asarray(C[:, 0]), c), (1.6 * jnp.asarray(F[:, 0]), f),
            u_lower=jnp.asarray(lb[:, 0]), u_upper=jnp.asarray(ub[:, 0]),
            **kw)

    ref, ref_qp = jax.vmap(one, in_axes=(0, 1, 1, 1, 1))(
        *_j(x0, c, f, tx.numpy(), u))
    _close(got.new_x, np.moveaxis(np.asarray(ref.new_x), 0, 1), name='x')
    _close(got.new_u, np.moveaxis(np.asarray(ref.new_u), 0, 1), name='u')
    _close(got.objs, np.moveaxis(np.asarray(ref.objs), 0, 1), name='objs')
    for name in ('full_du_norm', 'cost_total', 'alpha'):
        _close(getattr(got, name), getattr(ref, name), name=name)
    np.testing.assert_array_equal(n_qp.numpy(), np.asarray(ref_qp))
    assert (got.alpha.numpy() < 1).any()     # some searches went past 1


@pytest.mark.parametrize('case', ['nc2_with_f', 'nc2_u_zero_I'])
def test_lqr_solve_matches_jax_and_dense(case):
    T, B, ns, nc = 6, 4, 3, 2
    C, c, F, f, _, _, x0 = _lqr_problem(T, B, ns, nc, seed=3)
    uz = None
    if case == 'nc2_u_zero_I':
        uz = np.random.RandomState(5).rand(T, B, nc) < 0.4
    tx, tu = lqr.lqr_solve(*_t(C, c, F, f, x0), u_zero_I=_t(uz)[0],
                           n_state=ns)
    rx, ru = jax.vmap(
        lambda C, c, F, f, x0, uz: jlqr.lqr_solve(C, c, F, f, x0,
                                                  u_zero_I=uz, n_state=ns),
        in_axes=(1, 1, 1, 1, 0, None if uz is None else 1))(
        *_j(C, c, F, f, x0, uz))
    _close(tx, np.moveaxis(np.asarray(rx), 0, 1), name='x')
    _close(tu, np.moveaxis(np.asarray(ru), 0, 1), name='u')
    if uz is None:
        for b in range(B):
            dx, du = lqr_dense(C[:, b], c[:, b], F[:, b], f[:, b], x0[b], T,
                               ns, nc)
            _close(tu[:, b], du, tol=1e-10, name='dense u')
            _close(tx[:, b], dx, tol=1e-10, name='dense x')
