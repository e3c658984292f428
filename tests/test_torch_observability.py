"""The port's observability and debugging surface against mpc_tpu's, on
the CPU in float64: what ``MPC(verbose=...)`` prints (the reference's
mpc/mpc.py:238-243, 287-297, 326-328), ANALYTIC_CHECK, the numerical
debugging helpers of ``mpc_tpu_torch.utils`` and the parity helpers
``MPC.linearize_dynamics`` and ``MPC.approximate_cost`` (1e-12).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
import mpc_tpu.utils.logging as jlogging
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
import mpc_tpu_torch.utils.logging as tlogging
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.utils import assert_finite, finite_mask, nan_checks

jax.config.update('jax_enable_x64', True)

Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _problem(B=4):
    rng = np.random.RandomState(0)
    th = np.pi * (2 * rng.rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def _both(x0, **kw):
    """The same solve through mt.MPC (on the CPU) and mpc_tpu.MPC, with
    AUTO_DIFF."""
    t = mt.MPC(3, 1, 6, device='cpu', grad_method=mt.GradMethods.AUTO_DIFF,
               **kw).solve(
        torch.tensor(x0), mt.QuadCost(torch.tensor(np.diag(Q)),
                                      torch.tensor(P)),
        PendulumDx(device='cpu', dtype=torch.float64))
    j = mpc_tpu.MPC(3, 1, 6, grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                    **kw).solve(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(np.diag(Q)),
                                          jnp.asarray(P)), JPendulumDx())
    return t, j


@pytest.mark.parametrize('lqr_iter,eps', [(2, 0.0), (6, 1e-2)])
def test_verbose_prints_what_mpc_tpu_prints(capsys, monkeypatch, lqr_iter,
                                            eps):
    """verbose=1: the initial mean cost and one table row an iteration,
    line by line as mpc_tpu prints them (the same numbers at their
    printed precision); with eps > 0 examples stop early and drop out of
    the rows (NaN-padded iter_stats).  Each package prints a table's
    header once a process: the test gives both fresh sets of seen tables
    and leaves the process's own as they were, so that a test after it in
    the process still sees its header."""
    x0 = _problem()
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=lqr_iter, eps=eps, verbose=1,
              exit_unconverged=False, detach_unconverged=False,
              backprop=False, max_linesearch_iter=2)
    monkeypatch.setattr(tlogging, '_seen_tables', set())
    monkeypatch.setattr(jlogging, '_seen_tables', set())
    capsys.readouterr()
    t, j = _both(x0, **kw)
    out = capsys.readouterr().out.splitlines()
    n = len(out) // 2
    port, ref = out[:n], out[n:]
    assert len(out) == 2 * n and port == ref, out
    assert port[0].startswith('Initial mean(cost): ')
    assert port[1] == ('| iter | mean(cost) | ||full_du||_max | '
                       'mean(alphas) | total_qp_iters |')
    assert len(port) == 2 + int(t.n_iter.max())
    stats = t.iter_stats.numpy()
    assert stats.shape == (4, lqr_iter, 4)
    np.testing.assert_allclose(stats, np.asarray(j.iter_stats), rtol=1e-12,
                               atol=0)


def test_unconverged_warning(capsys):
    """verbose >= 0 warns when detaching unconverged examples; verbose=-1
    is silent (reference mpc/mpc.py:326-328)."""
    x0 = torch.tensor(_problem())
    cost = mt.QuadCost(torch.tensor(np.diag(Q)), torch.tensor(P))
    dx = PendulumDx(device='cpu', dtype=torch.float64)
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=1,
              grad_method=mt.GradMethods.AUTO_DIFF, eps=1e-10,
              exit_unconverged=False, detach_unconverged=True,
              backprop=False, max_linesearch_iter=2, use_fused='never',
              device='cpu')
    capsys.readouterr()
    mt.MPC(3, 1, 6, **kw)(x0, cost, dx)
    out = capsys.readouterr().out
    assert 'LQR Warning: All examples did not converge to a fixed point.' \
        in out
    assert 'Detaching and *not* backpropping through the bad examples.' \
        in out
    mt.MPC(3, 1, 6, verbose=-1, **kw)(x0, cost, dx)
    assert 'LQR Warning' not in capsys.readouterr().out


class _Cubic(torch.nn.Module):
    """f(x, u) = 0.9 x + 0.1 x^3 + B u, and a grad_input that is the
    Jacobian at x_frozen whatever x (``frozen``), or the true one."""

    def __init__(self, frozen):
        super().__init__()
        self.frozen = frozen
        self.Bm = torch.tensor([[0.1], [0.2], [0.3]], dtype=torch.float64)
        self.x_frozen = torch.full((3,), 0.5, dtype=torch.float64)

    def forward(self, x, u):
        return 0.9 * x + 0.1 * x ** 3 + (self.Bm * u.unsqueeze(-2)).sum(-1)

    def grad_input(self, x, u):
        xa = self.x_frozen.expand(x.shape) if self.frozen else x
        R = torch.diag_embed(0.9 + 0.3 * xa ** 2)
        return R, self.Bm.expand(x.shape[:-1] + (3, 1))


class _JCubic:
    Bm = jnp.asarray(np.array([[0.1], [0.2], [0.3]]))

    def __init__(self, frozen):
        self.frozen = frozen

    def __call__(self, x, u):
        return 0.9 * x + 0.1 * x ** 3 + self.Bm @ u

    def grad_input(self, x, u):
        xa = jnp.full(3, 0.5) if self.frozen else x
        return jnp.diag(0.9 + 0.3 * xa ** 2), self.Bm


def test_analytic_check_passes_and_raises_as_mpc_tpu():
    """ANALYTIC_CHECK compares grad_input with autodiff at every point of
    the warm start's rollout: a Jacobian right at x_init but wrong later
    raises mpc_tpu's AssertionError, word for word; the true one passes
    and the solve goes on as ANALYTIC."""
    ns, nc, T, B = 3, 1, 6, 2
    kw = dict(n_batch=B, lqr_iter=2, exit_unconverged=False, backprop=False)
    tctrl = mt.MPC(ns, nc, T, device='cpu',
                   grad_method=mt.GradMethods.ANALYTIC_CHECK, **kw)
    jctrl = mpc_tpu.MPC(ns, nc, T,
                        grad_method=mpc_tpu.GradMethods.ANALYTIC_CHECK, **kw)
    tx0 = torch.full((B, ns), 0.5, dtype=torch.float64)
    tcost = mt.QuadCost(torch.eye(ns + nc, dtype=torch.float64),
                        torch.zeros(ns + nc, dtype=torch.float64))
    jcost = mpc_tpu.QuadCost(jnp.eye(ns + nc), jnp.zeros(ns + nc))
    with pytest.raises(AssertionError) as want:
        jctrl(jnp.full((B, ns), 0.5), jcost, _JCubic(True))
    with pytest.raises(AssertionError, match='trajectory step') as got:
        tctrl(tx0, tcost, _Cubic(True))
    assert str(got.value) == str(want.value)
    xs, us, _ = tctrl(tx0, tcost, _Cubic(False))
    jxs, jus, _ = jctrl(jnp.full((B, ns), 0.5), jcost, _JCubic(False))
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError, match='grad_input'):
        tctrl(tx0, tcost, lambda x, u: x)


def test_debug_helpers():
    """finite_mask, assert_finite and nan_checks (the JAX package's
    tests/test_observability.py:test_debug_helpers)."""
    B, T = 3, 4
    ok = mt.Solution(
        x=torch.zeros(T, B, 3), u=torch.zeros(T, B, 1), costs=torch.zeros(B),
        full_du_norm=torch.zeros(B), n_iter=torch.zeros(B, dtype=torch.int32),
        n_qp_iter=torch.zeros(B, dtype=torch.int32),
        converged=torch.ones(B, dtype=torch.bool), alpha=torch.ones(B),
        iter_stats=torch.full((B, 2, 4), float('nan')))
    m = finite_mask(ok)
    assert m.shape == (B,) and bool(m.all())
    u = ok.u.clone()
    u[1, 2, 0] = float('nan')
    bad = ok._replace(u=u)
    assert finite_mask(bad).tolist() == [True, True, False]
    with pytest.raises(FloatingPointError, match=r'solution .*\.u'):
        assert_finite(bad._replace(iter_stats=None), 'solution')
    ok = ok._replace(iter_stats=None)
    assert assert_finite(ok) is ok
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]"):
        assert_finite({'a': torch.ones(2), 'b': [torch.ones(1),
                                                 torch.tensor([np.inf])]})
    with pytest.raises(FloatingPointError, match='div'):
        with nan_checks():
            z = torch.zeros(3)
            z / z
    z = torch.zeros(3)
    assert torch.isnan(z / z).all()          # the mode is gone again
    with nan_checks(enabled=False):
        assert torch.isnan(z / z).all()
    with nan_checks():                        # a clean solve runs through
        mt.batched_solve(mt.MPCConfig(n_state=3, n_ctrl=1, T=4, lqr_iter=2,
                                      backprop=False),
                         torch.tensor(_problem(2)),
                         mt.QuadCost(torch.tensor(np.diag(Q)),
                                     torch.tensor(P)),
                         PendulumDx(device='cpu', dtype=torch.float64),
                         u_lower=-2.0, u_upper=2.0, device='cpu')


def _pseudo_huber_t(tau):
    return (torch.sqrt(1.0 + (tau - 0.3) ** 2) - 1.0).sum(-1) + \
        0.1 * tau[..., 0] * tau[..., 3]


def _pseudo_huber_j(tau):
    return jnp.sum(jnp.sqrt(1.0 + (tau - 0.3) ** 2) - 1.0) + \
        0.1 * tau[0] * tau[3]


@pytest.mark.parametrize('method', ['AUTO_DIFF', 'FINITE_DIFF'])
def test_linearize_dynamics_and_approximate_cost_match_jax(method):
    T, B = 5, 3
    rng = np.random.RandomState(3)
    x = np.concatenate([_problem(B)[None]] * T) + 0.1 * rng.randn(T, B, 3)
    u = rng.randn(T, B, 1)
    tctrl = mt.MPC(3, 1, T, device='cpu',
                   grad_method=getattr(mt.GradMethods, method))
    jctrl = mpc_tpu.MPC(3, 1, T,
                        grad_method=getattr(mpc_tpu.GradMethods, method))
    F, f = tctrl.linearize_dynamics(torch.tensor(x), torch.tensor(u),
                                    PendulumDx(device='cpu',
                                               dtype=torch.float64))
    Fj, fj = jctrl.linearize_dynamics(jnp.asarray(x), jnp.asarray(u),
                                      JPendulumDx())
    # FINITE_DIFF differs in the transcendentals' last bits (x1e4 by
    # the central difference, as tests/test_torch_eager_solve.py notes)
    tol = 1e-12 if method == 'AUTO_DIFF' else 1e-8
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj), rtol=0, atol=tol)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=0, atol=tol)
    C, c, costs = tctrl.approximate_cost(torch.tensor(x), torch.tensor(u),
                                         _pseudo_huber_t)
    Cj, cj, cj_costs = jctrl.approximate_cost(jnp.asarray(x), jnp.asarray(u),
                                              _pseudo_huber_j)
    for a, b in ((C, Cj), (c, cj), (costs, cj_costs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    C, c, none = tctrl.approximate_cost(
        torch.tensor(x), torch.tensor(u),
        mt.QuadCost(torch.tensor(np.diag(Q)), torch.tensor(P)))
    Cj, cj, _ = jctrl.approximate_cost(
        jnp.asarray(x), jnp.asarray(u),
        mpc_tpu.QuadCost(jnp.asarray(np.diag(Q)), jnp.asarray(P)))
    assert none is None and C.shape == (T, B, 4, 4)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=0, atol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match='slew'):
        mt.MPC(3, 1, T, slew_rate_penalty=0.1, device='cpu').approximate_cost(
            torch.tensor(x), torch.tensor(u), _pseudo_huber_t)
