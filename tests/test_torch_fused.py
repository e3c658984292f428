"""The port's fused solve (the plain PyTorch version of kernel K1, which
the CPU path runs) against the JAX package.

- float64: against mpc_tpu's jnp solver (``use_fused='never'``) on x,
  u, costs, full_du_norm, n_iter, n_qp_iter and alpha.  Tolerance 1e-8:
  the two run the same iterations in a different operation order (the
  jnp path linearises the atan2 step by autodiff and solves the box QP
  through pnqp).  Converged solves agree to ~1e-12; the largest gap
  measured, 3.2e-9 in u, is in the unconverged 'headline' case, whose
  O(1) Newton steps amplify the ~1e-15 differences of the Jacobians.
  alpha is compared where the full step is larger than 1e-6: below that
  the trial cost equals the current one to round-off and either step
  size is a correct choice.
- float32: against the Pallas kernel itself in interpret mode, at the
  configurations of tests/test_fused.py and tests/test_fused_fulltile.py
  (so the persistent compile cache is shared) and with their
  tolerances; alpha is compared where the full step exceeds 1e-2:
  smaller steps (measured up to 5e-3) change the cost by less than its
  float32 rounding, and the two kernels then tie-break differently.
- layouts, batch reversal and a ragged batch on the port alone: lanes
  are independent, so these are bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_tpu import GradMethods, MPCConfig, QuadCost
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.ops.fused import fused_batched_solve as j_fused_batched_solve

import mpc_tpu_torch as mt
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (pendulum_from_numpy,
                                         quad_cost_from_numpy,
                                         solution_to_numpy)

PARAMS = np.array([10., 1., 1.])
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])
FIELDS = ('x', 'u', 'costs', 'full_du_norm', 'n_iter', 'n_qp_iter')


def _x0(B, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1).astype(dtype)


def _cfg_kw(T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=2,
                grad_method=GradMethods.AUTO_DIFF, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2,
                max_linesearch_iter=2)
    base.update(kw)
    return base


def _port_solve(kw, x0, C, c, lb=None, ub=None, u_init=None):
    sol = mt.batched_solve(
        mt.MPCConfig(**kw), torch.tensor(x0), quad_cost_from_numpy(C, c,
                                                                  'cpu'),
        pendulum_from_numpy(PARAMS.astype(x0.dtype), device='cpu'),
        u_init=None if u_init is None else torch.tensor(u_init),
        u_lower=lb if lb is None or np.isscalar(lb) else torch.tensor(lb),
        u_upper=ub if ub is None or np.isscalar(ub) else torch.tensor(ub),
        device='cpu')
    return solution_to_numpy(sol)


# (T, B, cfg overrides, bounds, batched cost, u_init)
F64_CASES = {
    # the headline's shape of problem, unconverged so steps are real
    'headline': (10, 8, dict(lqr_iter=3, max_linesearch_iter=5),
                 'scalar', False, False),
    'unbounded': (6, 8, dict(lqr_iter=3), None, False, False),
    # per-example stopping on eps, batched cost and bounds, warm start
    'eps_batched': (8, 8, dict(lqr_iter=8, eps=1e-3,
                               max_linesearch_iter=5),
                    'batched', True, True),
    # per-example stopping on the not-improved counter
    'not_improved': (6, 8, dict(lqr_iter=6, best_cost_eps=-1e-3,
                                not_improved_lim=1,
                                max_linesearch_iter=3),
                     'scalar', False, False),
}


@pytest.mark.parametrize('case', list(F64_CASES))
def test_plain_f64_matches_jnp_path(case):
    T, B, over, bounds, batched_cost, warm = F64_CASES[case]
    rng = np.random.RandomState(5)
    x0 = _x0(B)
    C, c = np.diag(Q), P
    if batched_cost:
        C = np.broadcast_to(C, (T, B, 4, 4)) * (1 + 0.1 * rng.rand(T, B, 1, 1))
        c = np.broadcast_to(c, (T, B, 4)) + 0.1 * rng.randn(T, B, 4)
    lb = ub = None
    if bounds == 'scalar':
        lb, ub = -2.0, 2.0
    elif bounds == 'batched':
        lb = -2.0 + 0.5 * rng.rand(T, B, 1)
        ub = 2.0 - 0.5 * rng.rand(T, B, 1)
    u_init = 0.5 * rng.randn(T, B, 1) if warm else None

    kw = _cfg_kw(T, **over)
    ref = j_batched_solve(
        MPCConfig(**kw, use_fused='never'), jnp.asarray(x0),
        QuadCost(jnp.asarray(C), jnp.asarray(c)),
        JPendulumDx(params=jnp.asarray(PARAMS)),
        u_init=None if u_init is None else jnp.asarray(u_init),
        u_lower=None if lb is None else jnp.asarray(lb),
        u_upper=None if ub is None else jnp.asarray(ub))
    out = _port_solve(kw, x0, C, c, lb, ub, u_init)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    real = np.asarray(ref.full_du_norm) > 1e-6
    np.testing.assert_array_equal(out.alpha[real], np.asarray(ref.alpha)[real])
    if case == 'eps_batched':
        assert len(set(out.n_iter.tolist())) > 1     # lanes stopped apart
    if case == 'not_improved':
        assert (out.n_iter < kw['lqr_iter']).any()


def _jax_pendulum_f32(B):
    """tests/test_fused_fulltile.py:_pendulum (same arrays, same calls)."""
    dx = JPendulumDx(params=jnp.array([10., 1., 1.], jnp.float32))
    x0 = _x0(B, dtype=np.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q).astype(jnp.float32),
                    jnp.asarray(p, jnp.float32))
    return dx, x0, cost


@pytest.mark.parametrize('B', [16, 1024])
def test_plain_f32_matches_pallas_interpret(B):
    """B=16: tests/test_fused.py::test_fused_smem_cost_scalar_bounds's
    configuration and tolerances (u, x 2e-5; costs 1e-4).  B=1024 (a
    full TPU tile): tests/test_fused_fulltile.py's bang-bang tail (mean
    |du| < 1e-4, under 0.5% of entries off by more than 1e-3)."""
    dx, x0, cost = _jax_pendulum_f32(B)
    kw = _cfg_kw(5)
    ref = j_fused_batched_solve(MPCConfig(**kw, use_fused='never'),
                                jnp.asarray(x0), cost, dx,
                                u_lower=jnp.float32(-2.),
                                u_upper=jnp.float32(2.), interpret=True)
    out = _port_solve(kw, x0, np.asarray(cost.C), np.asarray(cost.c),
                      -2.0, 2.0)
    d = np.abs(out.u - np.asarray(ref.u))
    if B == 16:
        np.testing.assert_allclose(out.u, np.asarray(ref.u), atol=2e-5)
        np.testing.assert_allclose(out.x, np.asarray(ref.x), atol=2e-5)
    else:
        assert d.mean() < 1e-4, d.mean()
        assert (d > 1e-3).mean() < 0.005, (d > 1e-3).mean()
    np.testing.assert_allclose(out.costs, np.asarray(ref.costs), atol=1e-4)
    np.testing.assert_array_equal(out.n_iter, np.asarray(ref.n_iter))
    np.testing.assert_array_equal(out.n_qp_iter, np.asarray(ref.n_qp_iter))
    moved = np.asarray(ref.full_du_norm) > 1e-2
    assert moved.sum() >= B // 8
    np.testing.assert_array_equal(out.alpha[moved],
                                  np.asarray(ref.alpha)[moved])


def _problem(B, T, seed=0):
    rng = np.random.RandomState(seed)
    return (_x0(B, seed, np.float32), np.diag(Q).astype(np.float32),
            P.astype(np.float32), rng)


def _headline_kw(T):
    return _cfg_kw(T, lqr_iter=4, max_linesearch_iter=5)


def _assert_same(a, b):
    for f in FIELDS + ('alpha',):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_layouts_are_equivalent():
    """Shared vs batched C and c (each on its own), and scalar vs [T, 1]
    vs [T, B, 1] bounds: the same problem, bitwise the same result."""
    T, B = 6, 32
    x0, C, c, _ = _problem(B, T)
    kw = _headline_kw(T)
    base = _port_solve(kw, x0, C, c, -2.0, 2.0)
    CB = np.ascontiguousarray(np.broadcast_to(C, (T, B, 4, 4)))
    cB = np.ascontiguousarray(np.broadcast_to(c, (T, B, 4)))
    CT = np.ascontiguousarray(np.broadcast_to(C, (T, 4, 4)))
    lbT = np.full((T, 1), -2.0, np.float32)
    lbB = np.full((T, B, 1), -2.0, np.float32)
    for Ci, ci, lb in ((CB, cB, -2.0), (CB, c, -2.0), (C, cB, -2.0),
                       (CT, c, -2.0), (C, c, lbT), (C, c, lbB)):
        ub = 2.0 if np.isscalar(lb) else -lb
        _assert_same(_port_solve(kw, x0, Ci, ci, lb, ub), base)


def test_batch_reversal_is_bitwise():
    """A solve of the reversed batch, un-reversed, is bitwise the same
    (no example reads another's data: the round-2 TPU Jacobian bug)."""
    T, B = 8, 256
    x0, C, c, rng = _problem(B, T)
    u_init = (0.5 * rng.randn(T, B, 1)).astype(np.float32)
    kw = _headline_kw(T)
    a = _port_solve(kw, x0, C, c, -2.0, 2.0, u_init)
    r = _port_solve(kw, x0[::-1].copy(), C, c, -2.0, 2.0,
                    u_init[:, ::-1].copy())
    for f in FIELDS + ('alpha',):
        v = getattr(r, f)
        v = v[:, ::-1] if v.ndim == 3 else v[::-1]
        np.testing.assert_array_equal(getattr(a, f), v, err_msg=f)


def test_ragged_batch():
    """B=2050 (two 1024-example TPU tiles and a tail; 33 blocks of the
    card's kernel): every example equals its solve in a small batch."""
    T, B = 5, 2050
    x0, C, c, _ = _problem(B, T)
    kw = _headline_kw(T)
    full = _port_solve(kw, x0, C, c, -2.0, 2.0)
    assert np.isfinite(full.x).all() and np.isfinite(full.u).all()
    idx = np.array([0, 1, 1023, 1024, 2047, 2048, 2049])
    part = _port_solve(kw, x0[idx], C, c, -2.0, 2.0)
    for f in FIELDS + ('alpha',):
        v = getattr(full, f)
        v = v[:, idx] if v.ndim == 3 else v[idx]
        np.testing.assert_array_equal(v, getattr(part, f), err_msg=f)


def test_bound_counts():
    """k1_flops/k1_bytes: work grows with the iterations and trials that
    ran, bytes with the batch; the headline is operation-bound."""
    per_solve = fused.k1_flops(20, 3, 1, lqr_iter=10, n_alpha=15)
    assert fused.k1_flops(20, 3, 1, 20, 30, batch=2) == 2 * per_solve
    assert 50e3 < per_solve < 200e3
    B, T = 4096, 20
    x0, C, c, _ = _problem(B, T)
    ops = fused.k1_operands(
        mt.MPCConfig(**_headline_kw(T)), torch.tensor(x0),
        quad_cost_from_numpy(C, c, 'cpu'),
        pendulum_from_numpy(PARAMS.astype(np.float32), device='cpu'),
        u_lower=-2.0, u_upper=2.0)
    nbytes = fused.k1_bytes(ops)
    assert nbytes == 4 * (3 + T * 20 + B * 3 + T * B + 2 * T
                          + T * B * 4 + 6 * B)
    assert B * per_solve / 67e12 > nbytes / 3.35e12


def test_wrapper_never_falls_back_off_the_cpu():
    """Only a tensor on the CPU runs the plain version; any other device
    launches the kernel or raises (here: the meta device)."""
    T, B = 3, 4
    dev = torch.device('meta')
    args = (pendulum_from_numpy(PARAMS, device='cpu'),
            torch.zeros(3, device=dev), torch.zeros(T, 1, 4, 4, device=dev),
            torch.zeros(T, 1, 4, device=dev), torch.zeros(B, 3, device=dev),
            torch.zeros(T, B, device=dev), None, None)
    with pytest.raises(NotImplementedError):
        fused.fused_ilqr(*args, alphas=[1.0], lqr_iter=1, eps=0.0,
                         best_cost_eps=1e-4, not_improved_lim=5.0)
