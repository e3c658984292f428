"""The O(log T) Riccati scan of the port (mpc_tpu_torch/ops/pscan.py) on
the CPU, against mpc_tpu's (mpc_tpu/ops/pscan.py) and against the port's
sequential recursion.

- ``parallel_riccati_gains`` and ``parallel_lqr_solve`` (with f, with
  u_zero_I) against mpc_tpu.ops.pscan in float64 within 1e-12 relative
  (measured ~1e-15: the same combines in the same order);
- the same against the port's sequential ``lqr_solve`` and
  ``riccati_backward`` within 1e-12; with u_zero_I within 1e-10 (as
  tests/test_pscan.py holds mpc_tpu's), because the sequential masked
  solve adds 1e-11 to the clamped control block and the scan does not
  (mpc_tpu/ops/pscan.py:_masked_ctrl; measured 1.7e-12);
- solver-level parallel_riccati=True and 'auto' against False within
  1e-9 (tests/test_pscan.py:127-154); 'auto' below T = 128 is the
  sequential solve, bitwise;
- a differentiable eager solve at T = 130, which takes the scan under
  the default 'auto' in both phases, with gradients against jax.grad of
  mpc_tpu's within 1e-8;
- the float32 pivoting case of tests/test_pscan.py at its tolerance, and
  a reversed batch bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.ops import pscan as jpscan

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import lqr, pscan

jax.config.update('jax_enable_x64', True)


def _problem(T, ns, nc, seed=0, B=None):
    """tests/test_pscan.py's random LQR problem; with B, B of them."""
    rng = np.random.RandomState(seed)
    ntau = ns + nc
    lead = (T,) if B is None else (T, B)
    C = rng.randn(*lead, ntau, ntau)
    C = np.einsum('...ij,...kj->...ik', C, C) + 2.0 * np.eye(ntau)
    c = rng.randn(*lead, ntau)
    F = np.concatenate(
        [np.eye(ns) + 0.1 * rng.randn(T - 1, *lead[1:], ns, ns),
         0.5 * rng.randn(T - 1, *lead[1:], ns, nc)], -1)
    f = 0.1 * rng.randn(T - 1, *lead[1:], ns)
    x0 = rng.randn(*lead[1:], ns)
    return C, c, F, f, x0


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


CASES = [(3, 2, 1, False), (7, 3, 2, False), (20, 3, 2, True),
         (130, 2, 1, True)]


@jax.jit
def _j_solve(C, c, F, f, x0, uz):
    return jpscan.parallel_lqr_solve(C, c, F, f, x0, u_zero_I=uz,
                                     n_state=F.shape[1])


@jax.jit
def _j_gains(C, c, F):
    return jpscan.parallel_riccati_gains(C, c, F, None, F.shape[1])


def _mask(T, nc, masked):
    return np.random.RandomState(T).rand(T, nc) < 0.3 if masked else None


def _batched(*arrays):
    """numpy per-instance arrays as the port's [T, 1, ...] / [1, ...]."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif a.ndim == 1:
            out.append(torch.tensor(a)[None])
        else:
            out.append(torch.tensor(a)[:, None])
    return out


@pytest.mark.parametrize('T,ns,nc,masked', CASES)
def test_parallel_lqr_solve_matches_jax(T, ns, nc, masked):
    C, c, F, f, x0 = _problem(T, ns, nc, seed=T)
    uz = _mask(T, nc, masked)
    xj, uj = _j_solve(*(jnp.asarray(a) for a in (C, c, F, f, x0)),
                      None if uz is None else jnp.asarray(uz))
    Ct, ct, Ft, ft, x0t, uzt = _batched(C, c, F, f, x0, uz)
    xt, ut = pscan.parallel_lqr_solve(Ct, ct, Ft, ft, x0t, u_zero_I=uzt,
                                      n_state=ns)
    _rel(xt[:, 0], xj, 1e-12, 'x')
    _rel(ut[:, 0], uj, 1e-12, 'u')
    # the port's sequential solve
    xs, us = lqr.lqr_solve(Ct, ct, Ft, ft, x0t, u_zero_I=uzt, n_state=ns)
    tol = 1e-10 if masked else 1e-12
    _rel(xt, xs.numpy(), tol, 'x vs sequential')
    _rel(ut, us.numpy(), tol, 'u vs sequential')


@pytest.mark.parametrize('T,ns,nc', [(5, 3, 1), (33, 2, 2)])
def test_parallel_gains_match_jax_and_sequential(T, ns, nc):
    C, c, F, f, x0 = _problem(T, ns, nc, seed=11 + T)
    Kj, kj = _j_gains(*(jnp.asarray(a) for a in (C, c, F)))
    Ct, ct, Ft = _batched(C, c, F)
    Kt, kt = pscan.parallel_riccati_gains(Ct, ct, Ft, None, ns)
    _rel(Kt[:, 0], Kj, 1e-12, 'K')
    _rel(kt[:, 0], kj, 1e-12, 'k')
    back = lqr.riccati_backward(Ct, ct, Ft, torch.zeros(T, 1, nc,
                                                        dtype=torch.float64),
                                n_state=ns)
    _rel(Kt, back.K.numpy(), 1e-12, 'K vs sequential')
    _rel(kt, back.k.numpy(), 1e-12, 'k vs sequential')


def test_batched_problem_and_reversed_batch():
    """A batch of distinct problems ([T, B, ...] leaves, a shared f) at
    once equals each solved alone, and the reversed batch gives the same
    bits reversed."""
    T, ns, nc, B = 20, 3, 2, 5
    C, c, F, f, x0 = _problem(T, ns, nc, seed=2, B=B)
    uz = np.random.RandomState(4).rand(T, B, nc) < 0.3
    args = [torch.tensor(a) for a in (C, c, F, f[:, :1], x0)]
    uzt = torch.tensor(uz)
    x, u = pscan.parallel_lqr_solve(*args, u_zero_I=uzt, n_state=ns)
    for b in (0, 3):
        xb, ub = _j_solve(*(jnp.asarray(a) for a in (
            C[:, b], c[:, b], F[:, b], f[:, 0], x0[b], uz[:, b])))
        _rel(x[:, b], xb, 1e-12, 'x')
        _rel(u[:, b], ub, 1e-12, 'u')
    r = [a.flip(1) for a in args[:3]] + [args[3], args[4].flip(0)]
    xr, ur = pscan.parallel_lqr_solve(*r, u_zero_I=uzt.flip(1), n_state=ns)
    assert torch.equal(xr.flip(1), x) and torch.equal(ur.flip(1), u)


def test_lsolve_partial_pivoting_f32():
    """tests/test_pscan.py's pivoting case: leading pivots tiny enough
    that unpivoted float32 elimination blows up."""
    rng = np.random.RandomState(0)
    n = 5
    M = rng.randn(64, n, n).astype(np.float32)
    M[:, 0, 0] *= 1e-7
    M[:, 1, 1] *= 1e-6
    Bm = rng.randn(64, n, 3).astype(np.float32)
    X = pscan._lsolve(torch.tensor(M), torch.tensor(Bm)).numpy()
    ref = np.linalg.solve(M.astype(np.float64), Bm.astype(np.float64))
    err = np.max(np.abs(X - ref) / np.maximum(1.0, np.abs(ref)))
    assert err < 1e-4, f'pivoted f32 solve rel err {err:.2e}'
    # mpc_tpu's unrolled elimination gives the same answer
    Xj = np.asarray(jax.jit(jpscan._solve_small)(jnp.asarray(M),
                                                 jnp.asarray(Bm)))
    assert np.max(np.abs(X - Xj) / np.maximum(1.0, np.abs(Xj))) < 1e-4


def _lindx_cfg(T, port=True, **kw):
    base = dict(n_state=3, n_ctrl=2, T=T, lqr_iter=3, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2,
                max_linesearch_iter=3, use_fused='never')
    base.update(kw)
    return mt.MPCConfig(**base) if port else mpc_tpu.MPCConfig(
        **dict(base, grad_method=mpc_tpu.GradMethods.ANALYTIC))


def test_solver_parallel_riccati_phase1():
    """A whole unconstrained iLQR solve with parallel_riccati=True and
    'auto' against False (tests/test_pscan.py:127-154)."""
    T, B = 12, 4
    C, c, F, f, _ = _problem(T, 3, 2, seed=2)
    x0 = torch.tensor(np.random.RandomState(2).randn(B, 3))
    cost = mt.QuadCost(torch.tensor(C), torch.tensor(c))
    dyn = mt.LinDx(torch.tensor(F), torch.tensor(f))
    ref = mt.batched_solve(_lindx_cfg(T, parallel_riccati=False), x0, cost,
                           dyn, device='cpu')
    par = mt.batched_solve(_lindx_cfg(T, parallel_riccati=True), x0, cost,
                           dyn, device='cpu')
    _rel(par.u, ref.u.numpy(), 1e-9, 'u')
    _rel(par.x, ref.x.numpy(), 1e-9, 'x')
    aut = mt.batched_solve(_lindx_cfg(T, parallel_riccati='auto'), x0, cost,
                           dyn, device='cpu')
    assert torch.equal(aut.u, ref.u) and torch.equal(aut.x, ref.x)


def test_differentiable_solve_at_t130_matches_jax_grad():
    """T = 130 under the default parallel_riccati='auto': the unconstrained
    phase 1 takes the scan's gains and the fixed point's differential
    solve takes parallel_lqr_solve; gradients to c, F, f and x_init
    against jax.grad of mpc_tpu's batched_solve, whose jnp path takes the
    same scans."""
    T, B = 130, 2
    C, c, F, f, _ = _problem(T, 2, 1, seed=6)
    x0 = np.random.RandomState(6).randn(B, 2)
    w = np.random.RandomState(8).randn(T, B, 1)
    kw = dict(n_state=2, n_ctrl=1, lqr_iter=2, backprop=True)
    cfg = _lindx_cfg(T, **kw)
    assert solver.uses_scan(cfg)
    ts = [torch.tensor(a, requires_grad=True) for a in (c, F, f, x0)]
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, ts[3], mt.QuadCost(torch.tensor(C), ts[0]),
                           mt.LinDx(ts[1], ts[2]), device='cpu')
    ((sol.u * torch.tensor(w)).sum() + 0.5 * (sol.x ** 2).sum()).backward()
    assert solver.eager_counts == {'eager_solve': 1, 'eager_fixed_point': 1}

    def loss(c_, F_, f_, x0_):
        s = j_batched_solve(_lindx_cfg(T, port=False, **kw), x0_,
                            mpc_tpu.QuadCost(jnp.asarray(C), c_),
                            mpc_tpu.LinDx(F_, f_))
        return jnp.sum(s.u * w) + 0.5 * jnp.sum(s.x ** 2)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (c, F, f, x0)))
    for name, t, r in zip(('c', 'F', 'f', 'x_init'), ts, ref):
        _rel(t.grad, r, 1e-8, name)
    # the sequential arm of the port gives the same gradients
    ts2 = [torch.tensor(a, requires_grad=True) for a in (c, F, f, x0)]
    sol2 = mt.batched_solve(dataclasses.replace(cfg, parallel_riccati=False),
                            ts2[3], mt.QuadCost(torch.tensor(C), ts2[0]),
                            mt.LinDx(ts2[1], ts2[2]), device='cpu')
    ((sol2.u * torch.tensor(w)).sum() + 0.5 * (sol2.x ** 2).sum()).backward()
    for name, t, t2 in zip(('c', 'F', 'f', 'x_init'), ts, ts2):
        _rel(t.grad, t2.grad.numpy(), 1e-8, name + ' vs sequential')
