"""The port's MPC front end and dispatch, on the CPU.

- a few receding-horizon swing-up steps of mpc_tpu_torch.MPC against
  mpc_tpu.MPC in float64 (tolerance 1e-8: each solve agrees to ~1e-12 and
  the closed loop carries the states on; see test_torch_fused.py);
- the reference's exit semantics; the knobs and problems the kernels do
  not take (use_fused='never', with u_zero_I and delta_u too, the damped
  pendulum, n_ctrl = 2, a callable cost) through the eager solver against
  mpc_tpu's jnp path (1e-10 in float64); the knobs that no route took
  before (slew, prev_ctrl, verbose, ANALYTIC_CHECK, the O(log T) scan)
  against mpc_tpu.MPC; gradients through
  backprop=True, the default device, and an import of the port that
  brings in nothing of JAX or mpc_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         pseudo_huber_from_numpy,
                                         quad_cost_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = np.array([10., 1., 1.])
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _x0(B, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def test_swingup_steps_match_jax_mpc():
    """The pendulum's receding-horizon swing-up loop, shortened to three
    steps, through both MPC classes."""
    B, T = 4, 20
    kw = dict(u_lower=-2., u_upper=2., lqr_iter=50, n_batch=B,
              grad_method=mpc_tpu.GradMethods.AUTO_DIFF, eps=1e-2,
              exit_unconverged=False, backprop=False,
              linesearch_decay=0.2, max_linesearch_iter=5)
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    tdx = pendulum_from_numpy(PARAMS, device='cpu')
    jcost = mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)), jnp.asarray(P))
    tcost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    jx = jnp.asarray(_x0(B))
    tx = torch.tensor(_x0(B))
    ju = tu = None
    for _ in range(3):
        jxs, jus, jcs = mpc_tpu.MPC(3, 1, T, u_init=ju, **kw)(jx, jcost, jdx)
        txs, tus, tcs = mt.MPC(3, 1, T, u_init=tu, device='cpu',
                               **kw)(tx, tcost, tdx)
        for a, b in ((txs, jxs), (tus, jus), (tcs, jcs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8)
        jx = jdx(jx, jus[0])
        tx = tdx(tx, tus[0])
        ju = jnp.concatenate([jus[1:], jnp.zeros((1, B, 1))], 0)
        tu = torch.cat([tus[1:], torch.zeros(1, B, 1, dtype=tus.dtype)], 0)


def _one_solve(T=5, **kw):
    """A generic-angle (th = 2.0) pendulum solve through the port."""
    x0 = torch.tensor([[np.cos(2.0), np.sin(2.0), 0.0]])
    ctrl = mt.MPC(3, 1, T, device='cpu', **kw)
    return ctrl(x0, quad_cost_from_numpy(np.diag(Q), P, 'cpu'),
                pendulum_from_numpy(PARAMS, device='cpu'))


def test_exit_unconverged_raises():
    with pytest.raises(AssertionError, match='did not converge'):
        _one_solve(u_lower=-2., u_upper=2., lqr_iter=1, eps=1e-9,
                   backprop=False)
    # converged (or not asked to check): returns the reference's triple
    x, u, costs = _one_solve(u_lower=-2., u_upper=2., lqr_iter=1,
                             eps=1e-9, backprop=False,
                             exit_unconverged=False,
                             detach_unconverged=False)
    assert x.shape == (5, 1, 3) and u.shape == (5, 1, 1)
    assert costs.shape == (1,)


# the knobs that raised NotImplementedError until ROADMAP queue 1 items 5
# and 6 were ported: MPC keywords, each given to both packages
SURFACE_KNOBS = {
    'slew': dict(slew_rate_penalty=0.1),
    'prev_ctrl': dict(prev_ctrl=np.zeros(1)),
    'verbose': dict(verbose=1),
    'parallel_riccati': dict(parallel_riccati=True, use_fused='never'),
}
# what still raises, as mpc_tpu raises it
OUT_OF_SCOPE = {
    'analytic_check': dict(grad_method='ANALYTIC_CHECK'),
}


def _knob_args(pkg, knobs):
    a = dict(knobs, backprop=False, exit_unconverged=False)
    if 'grad_method' in a:
        a['grad_method'] = getattr(pkg.GradMethods, a['grad_method'])
    if 'prev_ctrl' in a:
        a['prev_ctrl'] = (torch.tensor if pkg is mt else jnp.asarray)(
            a['prev_ctrl'])
    return a


def _jax_one_solve(knobs):
    """``_one_solve``'s problem through mpc_tpu.MPC."""
    x0 = np.array([[np.cos(2.0), np.sin(2.0), 0.0]])
    jcost = mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)), jnp.asarray(P))
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    return mpc_tpu.MPC(3, 1, 5, **_knob_args(mpc_tpu, knobs))(
        jnp.asarray(x0), jcost, jdx)


@pytest.mark.parametrize('case', list(OUT_OF_SCOPE))
def test_out_of_scope_knobs_raise(case):
    """ANALYTIC_CHECK on the pendulum, which has no grad_input, raises
    mpc_tpu's ValueError, word for word."""
    with pytest.raises(ValueError, match='grad_input') as want:
        _jax_one_solve(OUT_OF_SCOPE[case])
    with pytest.raises(ValueError) as got:
        _one_solve(**_knob_args(mt, OUT_OF_SCOPE[case]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('case', list(SURFACE_KNOBS))
def test_surface_knobs_match_jax_mpc(case, monkeypatch):
    """The knobs that no route took before queue 1 items 5 and 6 run as
    mpc_tpu runs them: a slew penalty, prev_ctrl (unused without one),
    verbose and the O(log T) scan solve and match mpc_tpu.MPC in float64
    (1e-10 relative).  Verbose tables are recorded in fresh sets of seen
    tables, so the process's own stay as they were."""
    import mpc_tpu.utils.logging as jlogging
    import mpc_tpu_torch.utils.logging as tlogging
    monkeypatch.setattr(tlogging, '_seen_tables', set())
    monkeypatch.setattr(jlogging, '_seen_tables', set())
    got = _one_solve(**_knob_args(mt, SURFACE_KNOBS[case]))
    ref = _jax_one_solve(SURFACE_KNOBS[case])
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()


# u_zero_I and delta_u with bounds go to the kernels under 'auto'
# (tests/test_torch_uzero.py holds that route against mpc_tpu); here they
# run on the eager solver under use_fused='never', which must match the
# jnp path's arithmetic
EAGER_KNOBS = {
    'u_zero_I': dict(u_zero_I=np.array([[False], [True], [False], [True],
                                        [False]]), use_fused='never'),
    'delta_u': dict(u_lower=-2., u_upper=2., delta_u=0.5,
                    use_fused='never'),
    'eager_solver': dict(u_lower=-2., u_upper=2., use_fused='never'),
}


@pytest.mark.parametrize('case', list(EAGER_KNOBS))
def test_eager_knobs_match_jax_mpc(case):
    """Knobs through the MPC front end on the eager solver
    (use_fused='never') match mpc_tpu.MPC (its jnp path) in float64; the
    pendulum's swing-up from a generic angle, 4 iterations, 1e-10
    relative."""
    kw = dict(EAGER_KNOBS[case], lqr_iter=4, backprop=False,
              exit_unconverged=False,
              grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    th = np.array([2.0, -1.0, 0.5])
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(3)], 1)
    jkw = dict(kw, use_fused='never')
    if 'u_zero_I' in jkw:
        jkw['u_zero_I'] = jnp.asarray(jkw['u_zero_I'])
    jxs, jus, jcs = mpc_tpu.MPC(3, 1, 5, **jkw)(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)),
                                          jnp.asarray(P)),
        JPendulumDx(params=jnp.asarray(PARAMS)))
    solver.reset_eager_counts()
    txs, tus, tcs = mt.MPC(3, 1, 5, device='cpu', **kw)(
        torch.tensor(x0), quad_cost_from_numpy(np.diag(Q), P, 'cpu'),
        pendulum_from_numpy(PARAMS, device='cpu'))
    assert solver.eager_counts['eager_solve'] == 1
    for a, b in ((txs, jxs), (tus, jus), (tcs, jcs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())


def _solve_long_horizon():
    """The pendulum one step past K1's horizon limit: the streaming
    solve (K3's plain version here) takes it."""
    T = fused.T_MAX + 1
    x, u, costs = _one_solve(T=T, u_lower=-2., u_upper=2., lqr_iter=1,
                             backprop=False, exit_unconverged=False)
    return T, 1, x, u, costs


def _solve_lindx():
    """A LinDx with F and f, handed to ``batched_solve``."""
    T, B = 5, 2
    rng = np.random.RandomState(0)
    F = np.tile(np.concatenate([0.9 * np.eye(3), 0.3 * np.ones((3, 1))], 1),
                (T - 1, 1, 1))
    sol = mt.batched_solve(
        _cfg(lqr_iter=2, exit_unconverged=False), torch.tensor(_x0(B)),
        quad_cost_from_numpy(np.diag(Q), P, 'cpu'),
        lin_dx_from_numpy(F, 0.1 * rng.randn(T - 1, 3), 'cpu'),
        u_lower=-2., u_upper=2., device='cpu')
    return T, B, sol.x, sol.u, sol.costs


@pytest.mark.parametrize('solve', [_solve_long_horizon, _solve_lindx],
                         ids=['long_horizon', 'lindx'])
def test_streaming_route_problems_solve(solve):
    """Problems that route to the streaming solve (K3's plain version
    here): finite values of the expected shapes inside the box."""
    T, B, x, u, costs = solve()
    assert x.shape == (T, B, 3) and u.shape == (T, B, 1)
    assert costs.shape == (B,)
    for a in (x, u, costs):
        assert torch.isfinite(a).all()
    assert float(u.abs().max()) <= 2.0


def _cfg(**kw):
    base = dict(n_state=3, n_ctrl=1, T=5, backprop=False)
    base.update(kw)
    return mt.MPCConfig(**base)


def test_out_of_scope_problems_raise():
    """Malformed layouts, one-sided bounds and 'always' outside the
    kernels' scope raise before anything runs (the O(log T) scan, which
    raised too until it was ported, runs); problems the kernels refuse
    are named by ``fused.scope_gap`` (and solve eagerly:
    test_problems_outside_the_kernels_solve_eagerly)."""
    T = 5
    x0 = torch.tensor(_x0(2))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    with pytest.raises(ValueError, match='LinDx.F'):
        mt.batched_solve(_cfg(), x0, cost, lin_dx_from_numpy(
            np.zeros((T - 1, 2, 3, 4, 1)), None, 'cpu'), device='cpu')
    with pytest.raises(ValueError, match='both'):
        mt.batched_solve(_cfg(), x0, cost, dx, u_lower=-2., device='cpu')
    # 'always': a ValueError where mpc_tpu's kernels refuse the problem
    # too (a plain callable model), else NotImplementedError naming the
    # kernel configuration that waits
    with pytest.raises(ValueError, match='always'):
        mt.batched_solve(_cfg(use_fused='always'), x0, cost,
                         lambda x, u: x, device='cpu')
    q32, p32 = np.diag(Q).astype(np.float32), P.astype(np.float32)
    damped = PendulumDx(simple=False, device='cpu')
    # delta_u with bounds is in the kernels' scope
    # (tests/test_torch_uzero.py); a problem they refuse for another
    # reason (an MLP of five hidden layers, past the dense configuration's
    # MLP build) raises under 'always' with delta_u too; an MLP of 4
    # states, refused here before that build, now solves
    cost5 = quad_cost_from_numpy(np.eye(5, dtype=np.float32),
                                 np.zeros(5, np.float32), 'cpu')
    mlp4 = mt.NNDynamics.init(4, 1, (8,) * 5, 'sigmoid', device='cpu',
                              generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match='hidden layers'):
        mt.batched_solve(_cfg(n_state=4, use_fused='always', delta_u=0.5),
                         torch.zeros(2, 4), cost5, mlp4,
                         u_lower=-2., u_upper=2., device='cpu')
    mlp4 = mt.NNDynamics.init(4, 1, (8,), 'sigmoid', device='cpu',
                              generator=torch.Generator().manual_seed(0))
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(n_state=4, use_fused='always', delta_u=0.5),
                           torch.zeros(2, 4), cost5, mlp4, u_lower=-2.,
                           u_upper=2., device='cpu')
    assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 0
    # the pseudo-Huber cost, refused here before the kernels' cost build,
    # now solves under 'always' (the plain K1 on the CPU)
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(use_fused='always'), x0.float(),
                           pseudo_huber_from_numpy(np.diag(q32), p32,
                                                   device='cpu'),
                           damped, device='cpu')
    assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 0
    # the damped pendulum, refused here before its K1 and K3
    # configurations, now solves under 'always' (the plain K1 on the CPU)
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(use_fused='always'), x0.float(),
                           quad_cost_from_numpy(q32, p32, 'cpu'), damped,
                           device='cpu')
    assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 0
    # the scan (unconstrained at T >= 128 under 'auto', or
    # differentiable), which raised before ops/pscan.py, now runs
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(T=128, use_fused='never', lqr_iter=1), x0,
                           cost, dx, device='cpu')
    x0g = x0.clone().requires_grad_()
    sol2 = mt.batched_solve(_cfg(T=128, use_fused='never', backprop=True,
                                 lqr_iter=1), x0g, cost, dx, u_lower=-2.,
                            u_upper=2., device='cpu')
    sol2.u.sum().backward()
    assert torch.isfinite(sol.u).all() and torch.isfinite(x0g.grad).all()
    assert solver.eager_counts == {'eager_solve': 2, 'eager_fixed_point': 1}
    # float64 on the card: the kernels refuse it, the eager solver takes it
    gap = fused.scope_gap(_cfg(), cost, dx, dtype=torch.float64,
                          device=torch.device('cuda'))
    assert 'float64' in gap and 'eager' in gap
    assert fused.supports(_cfg(), cost, dx, dtype=torch.float64)
    assert fused.scope_gap(_cfg(use_fused='never'), cost, dx) is None


OUTSIDE_KERNELS = {
    'damped_pendulum': dict(n_ctrl=1, simple=False),
    'n_ctrl_2': dict(n_ctrl=2, simple=True),
    'callable_cost': dict(n_ctrl=1, simple=True, callable_cost=True),
}


@pytest.mark.parametrize('case', list(OUTSIDE_KERNELS))
def test_problems_outside_the_kernels_solve_eagerly(case):
    """The problems that once raised here run on the eager solver
    (use_fused='never': the damped pendulum now also has its K1 and K3
    configurations, held in tests/test_torch_soa.py) and match
    mpc_tpu.learning.batched_solve (its jnp path) in float64: x, u within
    1e-10 relative, n_iter equal.  n_ctrl = 2 drives the pendulum's
    torque with the sum of two controls."""
    kw = OUTSIDE_KERNELS[case]
    nc = kw['n_ctrl']
    prm = np.array([10., 1., 1., 0.1, 0.2]) if not kw['simple'] else PARAMS
    q = np.concatenate([Q[:3], 0.01 * np.ones(nc)])
    p = np.concatenate([P[:3], np.zeros(nc)])
    x0 = _x0(3, seed=2)
    jdx = JPendulumDx(params=jnp.asarray(prm), simple=kw['simple'])
    tdx = pendulum_from_numpy(prm, simple=kw['simple'], device='cpu')
    if nc == 2:
        jdyn = lambda x, u: jdx(x, u[..., :1] + u[..., 1:])
        tdyn = lambda x, u: tdx(x, u[..., :1] + u[..., 1:])
    else:
        jdyn, tdyn = jdx, tdx
    if kw.get('callable_cost'):
        jcost = lambda tau: jnp.sum(q * jnp.sqrt(1 + (tau - p) ** 2))
        qt, pt = torch.tensor(q), torch.tensor(p)
        tcost = lambda tau: (qt * torch.sqrt(1 + (tau - pt) ** 2)).sum(-1)
    else:
        jcost = mpc_tpu.QuadCost(jnp.diag(jnp.asarray(q)), jnp.asarray(p))
        tcost = quad_cost_from_numpy(np.diag(q), p, 'cpu')
    cfg = dict(n_state=3, n_ctrl=nc, T=5, lqr_iter=4, eps=1e-3,
               backprop=False, exit_unconverged=False,
               grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    js = j_batched_solve(mpc_tpu.MPCConfig(**cfg, use_fused='never'),
                         jnp.asarray(x0), jcost, jdyn, u_lower=-1.,
                         u_upper=1.)
    ts = mt.batched_solve(mt.MPCConfig(**cfg, use_fused='never'),
                          torch.tensor(x0), tcost, tdyn, u_lower=-1.,
                          u_upper=1., device='cpu')
    for a, b in ((ts.x, js.x), (ts.u, js.u)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())
    np.testing.assert_array_equal(ts.n_iter.numpy(), np.asarray(js.n_iter))


def test_backprop_guard():
    """backprop=True (the default) runs the forward solve with the same
    values as backprop=False; with an input that requires grad, x and u
    now carry gradients back to it (they once raised here); under
    torch.no_grad() the solve returns plain values."""
    x0 = torch.tensor(_x0(3))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    a = mt.batched_solve(_cfg(backprop=True), x0, cost, dx, u_lower=-2., u_upper=2.,
                         device='cpu')
    b = mt.batched_solve(_cfg(), x0, cost, dx, u_lower=-2., u_upper=2., device='cpu')
    np.testing.assert_array_equal(a.u.numpy(), b.u.numpy())
    xg = x0.clone().requires_grad_()
    s = mt.batched_solve(_cfg(backprop=True), xg, cost, dx, u_lower=-2., u_upper=2.,
                         device='cpu')
    np.testing.assert_array_equal(s.u.detach().numpy(), b.u.numpy())
    (s.u.sum() + s.x.sum()).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    Cg = cost.C.clone().requires_grad_()
    s = mt.batched_solve(_cfg(backprop=True), x0, mt.QuadCost(Cg, cost.c),
                         dx, u_lower=-2., u_upper=2., device='cpu')
    s.u.sum().backward()
    assert torch.isfinite(Cg.grad).all() and Cg.grad.abs().sum() > 0
    # bounds alone requiring grad: the reference's zero gradient
    lb = torch.tensor(-2., dtype=x0.dtype, requires_grad=True)
    s = mt.batched_solve(_cfg(backprop=True), x0, cost, dx, u_lower=lb,
                         u_upper=2., device='cpu')
    np.testing.assert_array_equal(s.u.detach().numpy(), b.u.numpy())
    s.u.sum().backward()
    assert lb.grad is not None and float(lb.grad) == 0.0
    with torch.no_grad():
        c = mt.batched_solve(_cfg(backprop=True), xg, cost, dx, u_lower=-2., u_upper=2.,
                             device='cpu')
    assert c.u.grad_fn is None
    np.testing.assert_array_equal(c.u.numpy(), b.u.numpy())


def test_default_device_is_the_card(monkeypatch):
    """With no card, an entry point left at its default device raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x0 = torch.tensor(_x0(2))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.batched_solve(_cfg(), x0, cost, dx)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.MPC(3, 1, 5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PendulumDx()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        quad_cost_from_numpy(np.diag(Q), P)


def test_port_imports_nothing_of_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest), the
    port's modules and chip_smoke.py import neither jax nor mpc_tpu."""
    code = (
        'import sys, importlib\n'
        'for m in ("mpc_tpu_torch", "mpc_tpu_torch.ops.fused",\n'
        '          "mpc_tpu_torch.ops._build", "mpc_tpu_torch.mpc",\n'
        '          "mpc_tpu_torch.learning", "mpc_tpu_torch.solver",\n'
        '          "mpc_tpu_torch.utils.convert", "mpc_tpu_torch.ops.fused_bwd",\n'
        '          "mpc_tpu_torch.ops.diff", "mpc_tpu_torch.utils.fd",\n'
        '          "mpc_tpu_torch.types", "mpc_tpu_torch.models.pendulum",\n'
        '          "mpc_tpu_torch.models.cartpole", "mpc_tpu_torch.ops.lqr",\n'
        '          "mpc_tpu_torch.ops.pnqp", "mpc_tpu_torch.ops.linalg",\n'
        '          "chip_smoke"):\n'
        '    importlib.import_module(m)\n'
        'bad = [n for n in sys.modules if n in ("jax", "mpc_tpu")\n'
        '       or n.startswith(("jax.", "mpc_tpu."))]\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == '[]'
