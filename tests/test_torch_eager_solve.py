"""Whole solves and gradients of the eager solver against the JAX
package, on the CPU in float64.

``mpc_tpu_torch.batched_solve(use_fused='never', device='cpu')`` against
``mpc_tpu.learning.batched_solve(use_fused='never')`` (its vmapped jnp
solver) on the same numpy inputs: x, u and costs within 1e-10 relative
to each one's largest entry, full_du_norm within 1e-10 of the largest
step, n_iter, n_qp_iter and converged equal, alpha equal where the full
step is real (> 1e-6: below it the trial costs tie to round-off and two
implementations rightly choose differently).
Under FINITE_DIFF the two packages' Jacobians differ by ~1e-12 (XLA's
and libm's sin, cos and atan2 differ by an ulp, which central
differences with a step of 1e-4 magnify by 1e4), so those solves are
held to 1e-8 (measured 2e-9).

Gradients of a loss of x and u through ``backprop=True`` against
``jax.grad`` through mpc_tpu within 1e-8 relative, at n_ctrl = 1 (the
pendulum) and n_ctrl = 2 (LinDx with an active box); and the eager fixed
point against the kernels' plain backward (K2 and K4) on the same
primal, 1e-11.  Also the route and its counter, ``solve_single``, the
kernels' forward with the eager fixed point as phase 2, and the models'
conversions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import CartpoleDx as JCartpoleDx
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused_bwd
from mpc_tpu_torch.ops.diff import make_lqr_fixed_point
from mpc_tpu_torch.utils.convert import (cartpole_from_numpy,
                                         lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy,
                                         solution_to_numpy)

PEND = np.array([10., 1., 1.])
DAMPED = np.array([10., 1., 1., 0.1, 0.05])
CART = np.array([9.8, 1.0, 0.1, 0.5])
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _x0_pend(B, seed=0):
    th = np.pi * (2 * np.random.RandomState(seed).rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def _x0_cart(B, seed=0):
    th = 0.5 * (2 * np.random.RandomState(seed).rand(B) - 1)
    z = np.zeros(B)
    return np.stack([z, z, np.cos(th), np.sin(th), z], 1)


def _lindx(T, B, ns, nc, seed=0, semidef=False):
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
    A /= max(1.0, np.abs(np.linalg.eigvals(A)).max())
    F = np.tile(np.concatenate([A, 0.5 * rng.randn(ns, nc)], 1)[None],
                (T - 1, 1, 1))
    C = np.tile(np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)])),
                (T, 1, 1))
    if semidef:
        # no weight on the last control at the last two steps: Quu is
        # semidefinite at the last, and the pseudo-inverse solves it
        C[-2:, -1, -1] = 0.0
    c = 0.3 * rng.randn(T, ns + nc)
    return F, C, c, rng.randn(B, ns)


class _JTanh:
    """A callable model with an analytic Jacobian, one instance."""

    def __init__(self, A, Bm):
        self.A, self.Bm = jnp.asarray(A), jnp.asarray(Bm)

    def __call__(self, x, u):
        return jnp.tanh(self.A @ x) + self.Bm @ u

    def grad_input(self, x, u):
        z = self.A @ x
        return (1 - jnp.tanh(z) ** 2)[:, None] * self.A, self.Bm


class _TTanh:
    """The same model, batched on the leading axes."""

    def __init__(self, A, Bm):
        self.A, self.Bm = torch.tensor(A), torch.tensor(Bm)

    def __call__(self, x, u):
        return torch.tanh((self.A * x.unsqueeze(-2)).sum(-1)) + \
            (self.Bm * u.unsqueeze(-2)).sum(-1)

    def grad_input(self, x, u):
        z = (self.A * x.unsqueeze(-2)).sum(-1)
        return ((1 - torch.tanh(z) ** 2).unsqueeze(-1) * self.A,
                self.Bm.expand(x.shape[:-1] + self.Bm.shape))


def _pend_case(simple, gm, **cfg):
    prm = PEND if simple else DAMPED
    x0 = _x0_pend(6)
    return dict(
        cfg=dict(dict(n_state=3, n_ctrl=1, T=8, lqr_iter=6, eps=1e-3,
                      grad_method=gm, linesearch_decay=0.2,
                      max_linesearch_iter=4), **cfg),
        jax=lambda: (jnp.asarray(x0), mpc_tpu.QuadCost(jnp.diag(Q),
                                                       jnp.asarray(P)),
                     JPendulumDx(params=jnp.asarray(prm), simple=simple)),
        torch=lambda: (torch.tensor(x0), quad_cost_from_numpy(np.diag(Q), P,
                                                             'cpu'),
                       pendulum_from_numpy(prm, simple=simple, device='cpu')),
        bounds=dict(u_lower=-2., u_upper=2.))


def _cart_case(gm):
    x0 = _x0_cart(6)
    q = np.array([0.1, 0.1, 1., 1., 0.1, 0.001])
    p = np.array([0., 0., -1., 0., 0., 0.])
    return dict(
        # eps stops the solve while its last step is real: a Newton step
        # of ~1e-6 (the next one at 1e-4) changes the cost by round-off,
        # and two line searches then rightly keep different step sizes
        cfg=dict(n_state=5, n_ctrl=1, T=8, lqr_iter=6, eps=1e-2,
                 grad_method=gm, linesearch_decay=0.5, max_linesearch_iter=2),
        jax=lambda: (jnp.asarray(x0), mpc_tpu.QuadCost(jnp.diag(q),
                                                       jnp.asarray(p)),
                     JCartpoleDx(params=jnp.asarray(CART))),
        torch=lambda: (torch.tensor(x0), quad_cost_from_numpy(np.diag(q), p,
                                                             'cpu'),
                       cartpole_from_numpy(CART, 'cpu')),
        bounds=dict(u_lower=-100., u_upper=100.))


def _callable_cost_case():
    x0 = _x0_pend(6, seed=1)
    w, g = np.array([1., 1., 0.1, 0.01]), np.array([1., 0., 0., 0.])
    wt, gt = torch.tensor(w), torch.tensor(g)
    return dict(
        cfg=dict(n_state=3, n_ctrl=1, T=8, lqr_iter=6, eps=1e-3,
                 grad_method=mt.GradMethods.AUTO_DIFF,
                 linesearch_decay=0.2, max_linesearch_iter=4),
        jax=lambda: (jnp.asarray(x0),
                     lambda tau: jnp.sum(w * jnp.sqrt(1 + (tau - g) ** 2)),
                     JPendulumDx(params=jnp.asarray(PEND))),
        torch=lambda: (torch.tensor(x0),
                       lambda tau: (wt * torch.sqrt(1 + (tau - gt) ** 2)
                                    ).sum(-1),
                       pendulum_from_numpy(PEND, device='cpu')),
        bounds=dict(u_lower=-2., u_upper=2.))


def _grad_input_case(gm):
    T, B, ns, nc = 8, 5, 4, 2
    F, C, c, x0 = _lindx(T, B, ns, nc, seed=3)
    A, Bm = F[0, :, :ns], F[0, :, ns:]
    return dict(
        cfg=dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=6, eps=1e-6,
                 grad_method=gm),
        jax=lambda: (jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C),
                                                       jnp.asarray(c)),
                     _JTanh(A, Bm)),
        torch=lambda: (torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
                       _TTanh(A, Bm)),
        bounds=dict(u_lower=-0.5, u_upper=0.5))


def _lindx_case(nc, box, semidef=False, **cfg):
    T, B, ns = 8, 5, 4
    F, C, c, x0 = _lindx(T, B, ns, nc, seed=nc, semidef=semidef)
    return dict(
        cfg=dict(dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=6, eps=1e-6),
                 **cfg),
        jax=lambda: (jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C),
                                                       jnp.asarray(c)),
                     mpc_tpu.LinDx(jnp.asarray(F), None)),
        torch=lambda: (torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
                       lin_dx_from_numpy(F, None, 'cpu')),
        bounds=dict(u_lower=-0.5, u_upper=0.5) if box else {})


def _u_zero_I_case():
    case = _lindx_case(2, False, lqr_iter=1)
    uz = np.random.RandomState(9).rand(8, 5, 2) < 0.3
    case['jax_kw'] = dict(u_zero_I=jnp.asarray(uz))
    case['torch_kw'] = dict(u_zero_I=torch.tensor(uz))
    return case


AD, FD = mt.GradMethods.AUTO_DIFF, mt.GradMethods.FINITE_DIFF
CASES = {
    'pendulum_simple': lambda: _pend_case(True, AD),
    'pendulum_damped': lambda: _pend_case(False, AD),
    'pendulum_seq_linesearch': lambda: _pend_case(
        True, AD, parallel_linesearch=False),
    'pendulum_eps_mixed_stops': lambda: _pend_case(True, AD, eps=1e-2),
    'pendulum_not_improved_lim': lambda: _pend_case(
        True, AD, eps=0.0, lqr_iter=8, best_cost_eps=-1e-3,
        not_improved_lim=1),
    'cartpole_autodiff': lambda: _cart_case(AD),
    'cartpole_finite_diff': lambda: _cart_case(FD),
    'callable_cost': _callable_cost_case,
    'grad_input_analytic': lambda: _grad_input_case(mt.GradMethods.ANALYTIC),
    'lindx_nc2_box': lambda: _lindx_case(2, True),
    'lindx_nc3_box': lambda: _lindx_case(3, True),
    'lindx_nc2_unbounded': lambda: _lindx_case(2, False),
    'lindx_nc3_semidefinite_pinv': lambda: _lindx_case(3, False, True),
    'lindx_u_zero_I': _u_zero_I_case,
    'lindx_delta_u': lambda: _lindx_case(2, True, delta_u=0.2),
}


def _jgm(gm):
    return getattr(mpc_tpu.GradMethods, gm.name)


@pytest.mark.parametrize('name', list(CASES))
def test_whole_solve_matches_jax(name):
    case = CASES[name]()
    cfg = dict(case['cfg'], backprop=False, exit_unconverged=False)
    jcfg = dict(cfg, use_fused='never')
    if 'grad_method' in jcfg:
        jcfg['grad_method'] = _jgm(jcfg['grad_method'])
    ref = j_batched_solve(mpc_tpu.MPCConfig(**jcfg), *case['jax'](),
                          **case['bounds'], **case.get('jax_kw', {}))
    solver.reset_eager_counts()
    got = solution_to_numpy(mt.batched_solve(
        mt.MPCConfig(**cfg, use_fused='never'), *case['torch'](),
        device='cpu', **case['bounds'], **case.get('torch_kw', {})))
    assert solver.eager_counts == {'eager_solve': 1, 'eager_fixed_point': 0}
    tol = 1e-8 if cfg.get('grad_method') == FD else 1e-10
    for field in ('x', 'u', 'costs'):
        r = np.asarray(getattr(ref, field))
        np.testing.assert_allclose(getattr(got, field), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=field)
    r = np.asarray(ref.full_du_norm)
    np.testing.assert_allclose(got.full_du_norm, r, rtol=0,
                               atol=tol * max(r.max(), 1.0))
    for field in ('n_iter', 'n_qp_iter', 'converged'):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(ref, field)), field)
    real = r > 1e-6
    np.testing.assert_array_equal(got.alpha[real], np.asarray(ref.alpha)[real])
    if name == 'pendulum_eps_mixed_stops':
        assert len(set(got.n_iter)) > 1 and got.converged.all()
    if name == 'pendulum_not_improved_lim':
        assert len(set(got.n_iter)) > 1 and (got.n_iter < 8).all()
    if name == 'lindx_nc2_box':
        assert (np.abs(got.u) == 0.5).mean() > 0.05     # the box is active


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _loss(u, x, w):
    return (w * u).sum() + 0.5 * (x ** 2).sum()


def _damped_grads(route):
    """Gradients of a loss of u and x through a differentiable solve of
    the damped pendulum, to c, x_init and its five parameters: the port
    on ``route`` ('never': the eager solver and its fixed point; 'auto':
    the kernel route, phase 1 in the plain K1 and phase 2 in the plain
    K2) and jax.grad of mpc_tpu's jnp path.  Returns (the port's, the
    reference's, the eager counts)."""
    T, B = 6, 6
    x0 = _x0_pend(B, seed=4)
    w = np.random.RandomState(5).randn(T, B, 1)
    cfg = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=0.0,
               exit_unconverged=False, detach_unconverged=False,
               linesearch_decay=0.2, max_linesearch_iter=3)

    def j_loss(cv, x, prm):
        sol = j_batched_solve(
            mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                              use_fused='never', **cfg), x,
            mpc_tpu.QuadCost(jnp.diag(Q), cv),
            JPendulumDx(params=prm, simple=False), u_lower=-2., u_upper=2.)
        return _loss(sol.u, sol.x, w)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (P, x0, DAMPED)))
    cv, xt, prm = (torch.tensor(a, requires_grad=True) for a in (P, x0, DAMPED))
    solver.reset_eager_counts()
    sol = mt.batched_solve(
        mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, use_fused=route,
                     **cfg), xt,
        mt.QuadCost(torch.diag(torch.tensor(Q)), cv),
        mt.models.PendulumDx(params=prm, simple=False),
        u_lower=-2., u_upper=2., device='cpu')
    _loss(sol.u, sol.x, torch.tensor(w)).backward()
    return (cv.grad, xt.grad, prm.grad), ref, dict(solver.eager_counts)


def test_pendulum_gradients_match_jax():
    """n_ctrl = 1: c, x_init and the damped pendulum's five parameters
    through the eager route (use_fused='never'), 1e-8 relative."""
    got, ref, counts = _damped_grads('never')
    assert counts == {'eager_solve': 1, 'eager_fixed_point': 1}
    for name, a, b in zip(('dc', 'dx_init', 'dparams'), ref, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-8 * np.abs(a).max(), name


def test_pendulum_gradients_kernel_route_match_jax():
    """The same gradients through the kernel route, which now takes the
    damped pendulum: phase 1 in K1's plain version, phase 2 in K2's, no
    eager solve or fixed point; 1e-7 relative (the kernel route's float64
    sits up to ~1e-8 from the jnp path's gradients, which add 1e-11 to
    the control block in PNQP and the masked solve)."""
    got, ref, counts = _damped_grads('auto')
    assert counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for name, a, b in zip(('dc', 'dx_init', 'dparams'), ref, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-7 * np.abs(a).max(), name


def test_lindx_box_gradients_match_jax():
    """n_ctrl = 2 with an active box: C (shared), c (per example), F
    (shared), f (per example) and x_init."""
    T, B, ns, nc = 6, 5, 3, 2
    F, C, c, x0 = _lindx(T, B, ns, nc, seed=6)
    rng = np.random.RandomState(7)
    c = c[:, None] + 0.3 * rng.randn(T, B, ns + nc)
    f = 0.1 * rng.randn(T - 1, B, ns)
    w = rng.randn(T, B, nc)
    cfg = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=8, eps=1e-6,
               exit_unconverged=False, detach_unconverged=False)

    def j_loss(C, c, F, f, x):
        sol = j_batched_solve(mpc_tpu.MPCConfig(use_fused='never', **cfg),
                              x, mpc_tpu.QuadCost(C, c), mpc_tpu.LinDx(F, f),
                              u_lower=-0.3, u_upper=0.3)
        return _loss(sol.u, sol.x, w)

    args = (C, c, F, f, x0)
    ref = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                                      for a in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    sol = mt.batched_solve(mt.MPCConfig(**cfg), leaves[4],
                           mt.QuadCost(leaves[0], leaves[1]),
                           mt.LinDx(leaves[2], leaves[3]), u_lower=-0.3,
                           u_upper=0.3, device='cpu')
    assert (sol.u.detach().abs() == 0.3).any()
    assert sol.converged.all()
    _loss(sol.u, sol.x, torch.tensor(w)).backward()
    for name, a, b in zip('C c F f x_init'.split(), ref, leaves):
        a = np.asarray(a)
        assert b.grad.shape == a.shape, name
        assert np.abs(a - b.grad.numpy()).max() <= 1e-8 * np.abs(a).max(), \
            name


@pytest.mark.parametrize('dyn_shared', [False, True], ids=['K2', 'K4'])
def test_eager_fixed_point_equals_plain_kernel_backward(dyn_shared):
    """Same primal, same cotangents: the eager fixed point's gradients
    equal the kernels' plain backward (K2 for per-example F, K4 for a
    shared one), shared C and c summed over the batch."""
    T, B = 7, 6
    rng = np.random.RandomState(8)
    Cr = rng.randn(T, 4, 4)
    C = Cr @ Cr.transpose(0, 2, 1) + np.eye(4)
    c = rng.randn(T, 4)
    F = 0.3 * rng.randn(T - 1, 1 if dyn_shared else B, 3, 4)
    F[..., :3] += 0.8 * np.eye(3)
    if dyn_shared:
        F = F[:, 0]
    f = 0.1 * rng.randn(*F.shape[:-1])
    xs, us = rng.randn(T, B, 3), np.clip(rng.randn(T, B, 1), -1, 1)
    dx, du = rng.randn(T, B, 3), rng.randn(T, B, 1)
    x0 = rng.randn(B, 3)
    grads = []
    for fp in (make_lqr_fixed_point(3, True, True),
               fused_bwd.make_batched_fixed_point(3, True, True)):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (x0, C, c, F, f)]
        lb, ub = torch.tensor(-1.).expand(T, 1, 1), torch.tensor(1.)
        Cin, cin, Fin, fin = leaves[1:]
        if fp is not fused_bwd.make_batched_fixed_point(3, True, True):
            # the eager fixed point takes [T, 1 or B, ...] leaves
            Cin, cin = Cin.unsqueeze(1), cin.unsqueeze(1)
            if dyn_shared:
                Fin, fin = Fin.unsqueeze(1), fin.unsqueeze(1)
            ub = ub.expand(T, 1, 1)
        x, u = fp.apply(leaves[0], Cin, cin, Fin, fin, lb, ub,
                        torch.tensor(xs), torch.tensor(us))
        ((x * torch.tensor(dx)).sum() + (u * torch.tensor(du)).sum()
         ).backward()
        grads.append([a.grad.numpy() for a in leaves])
    for name, a, b in zip('x_init C c F f'.split(), grads[1], grads[0]):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-11 * np.abs(a).max(), name


def test_kernel_forward_with_eager_fixed_point(monkeypatch):
    """Where the kernels take the forward but not the backward, phase 1
    runs in the kernel (its plain version here) and phase 2 is the eager
    fixed point (mpc_tpu/learning.py:213-242); its gradients equal K2's
    within 1e-8 (measured 1.4e-9: the pendulum's control weight of 1e-3
    magnifies the difference of the two orders of operations)."""
    T, B = 5, 4
    x0 = _x0_pend(B, seed=2)
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=0.0,
                       exit_unconverged=False, detach_unconverged=False,
                       grad_method=mt.GradMethods.AUTO_DIFF)
    grads = []
    for gap in (None, 'the backward kernels refuse it here'):
        monkeypatch.setattr(fused_bwd, 'scope_gap_bwd',
                            lambda *a, g=gap: g)
        xt = torch.tensor(x0, requires_grad=True)
        solver.reset_eager_counts()
        sol = mt.batched_solve(cfg, xt, quad_cost_from_numpy(np.diag(Q), P,
                                                             'cpu'),
                               pendulum_from_numpy(PEND, device='cpu'),
                               u_lower=-2., u_upper=2., device='cpu')
        (sol.u ** 2).sum().backward()
        assert solver.eager_counts == {
            'eager_solve': 0, 'eager_fixed_point': int(gap is not None)}
        grads.append(xt.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0,
                               atol=1e-8 * np.abs(grads[0]).max())


def test_solve_single_is_a_batch_of_one():
    T = 6
    x0 = _x0_pend(3, seed=6)
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=1e-3,
                       exit_unconverged=False, backprop=False,
                       use_fused='never')
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PEND, device='cpu')
    full = mt.batched_solve(cfg, torch.tensor(x0), cost, dx, u_lower=-2.,
                            u_upper=2., device='cpu')
    one = mt.solve_single(cfg, torch.tensor(x0[1]), cost, dx, u_lower=-2.,
                          u_upper=2., device='cpu')
    assert one.x.shape == (T, 3) and one.u.shape == (T, 1)
    assert one.n_iter.shape == ()
    np.testing.assert_array_equal(one.u.numpy(), full.u[:, 1].numpy())
    np.testing.assert_array_equal(one.x.numpy(), full.x[:, 1].numpy())
    assert int(one.n_iter) == int(full.n_iter[1])
    # differentiable as well
    xg = torch.tensor(x0[1], requires_grad=True)
    s = mt.solve_single(mt.MPCConfig(**dict(
        vars(cfg), backprop=True)), xg, cost, dx, u_lower=-2., u_upper=2.,
        device='cpu')
    s.u.sum().backward()
    assert xg.grad.shape == (3,) and torch.isfinite(xg.grad).all()


def test_trace_records_decisions_and_orders_part_only_at_ties():
    """The eager solver's decision trace (``eager_batched_solve(trace=)``)
    sums up to the solution's statistics, and the same box problem with
    its states and controls permuted (other sums, the same problem) gives
    the same controls within 1e-10 on every example whose decisions
    match, and costs within 1e-12 on those that part (a tie)."""
    T, B, ns, nc, iters = 8, 8, 5, 3, 5
    F, C, c, x0 = _lindx(T, B, ns, nc, seed=4)
    c = np.tile(c[:, None], (1, B, 1)) + 0.5 * np.random.RandomState(
        5).randn(T, B, ns + nc)
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T, lqr_iter=iters, eps=0.0,
                       exit_unconverged=False, backprop=False,
                       use_fused='never')
    ps, pc = np.array([3, 0, 4, 1, 2]), np.array([2, 0, 1])
    pt = np.concatenate([ps, ns + pc])
    runs = []
    for perm in (False, True):
        Fp, Cp, cp, xp = (F[:, ps][:, :, pt], C[:, pt][:, :, pt],
                          c[..., pt], x0[:, ps]) if perm else (F, C, c, x0)
        trace = []
        sol = solver.eager_batched_solve(
            cfg, torch.tensor(xp), quad_cost_from_numpy(Cp, cp, 'cpu'),
            lin_dx_from_numpy(Fp, None, 'cpu'), u_lower=-0.5, u_upper=0.5,
            trace=trace)
        assert len(trace) == iters
        n_qp = sum(torch.where(d['active'], d['n_qp'], 0) for d in trace)
        assert torch.equal(n_qp, sol.n_qp_iter)
        assert torch.equal(trace[-1]['alpha'], sol.alpha)
        u = sol.u.clone()
        if perm:
            u[..., pc] = sol.u
        runs.append((u, sol.costs, trace))
    (ua, ca, ta), (ub, cb, tb) = runs
    parted = torch.zeros(B, dtype=torch.bool)
    for a, b in zip(ta, tb):
        parted |= (a['alpha'] != b['alpha']) | (a['n_qp'] != b['n_qp'])
    keep = ~parted
    assert (ua[:, keep] - ub[:, keep]).abs().max() <= \
        1e-10 * ua.abs().max()
    assert ((ca - cb).abs() <= 1e-12 * ca.abs()).all()
    assert (ua.abs() == 0.5).any()


def test_models_convert_and_step_like_jax():
    """cartpole_from_numpy and the damped pendulum carry their
    parameters, and the steps match the JAX models' (1e-14)."""
    rng = np.random.RandomState(1)
    cart = cartpole_from_numpy(CART, 'cpu')
    assert cart.params.dtype == torch.float64
    np.testing.assert_array_equal(cart.params.numpy(), CART)
    damped = pendulum_from_numpy(DAMPED, simple=False, device='cpu')
    np.testing.assert_array_equal(damped.params.numpy(), DAMPED)
    with pytest.raises(ValueError):
        pendulum_from_numpy(PEND, simple=False, device='cpu')
    xc, uc = _x0_cart(5) + 0.1 * rng.randn(5, 5), 150 * rng.randn(5, 1)
    np.testing.assert_allclose(
        cart(torch.tensor(xc), torch.tensor(uc)).numpy(),
        np.asarray(JCartpoleDx(params=jnp.asarray(CART))(
            jnp.asarray(xc), jnp.asarray(uc))), rtol=0, atol=1e-14)
    xp, up = _x0_pend(5), 3 * rng.randn(5, 1)
    np.testing.assert_allclose(
        damped(torch.tensor(xp), torch.tensor(up)).numpy(),
        np.asarray(JPendulumDx(params=jnp.asarray(DAMPED), simple=False)(
            jnp.asarray(xp), jnp.asarray(up))), rtol=0, atol=1e-14)
    q, p = cart.get_true_obj()
    qj, pj = JCartpoleDx().get_true_obj()
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-7)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-7)
