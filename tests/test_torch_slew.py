"""Slew-rate penalties and prev_ctrl in the port, on the CPU, against
mpc_tpu in float64.

- ``SlewRateCost`` against mpc_tpu's on the same tau (1e-12);
- the three behaviours of tests/test_slew.py (the reference's
  test_lqr_slew_rate: a vanishing penalty gives the unpenalised
  solution, a unit one raises the objective and shrinks the slew), and x
  and u against ``mpc_tpu.MPC(slew_rate_penalty=...)`` within 1e-10
  relative: the affine model with 4 controls and the pendulum, both on
  the eager solver (the pendulum pinned there with use_fused='never'),
  and the pendulum through the kernel route (the plain dense
  configuration's model-step build with the passthrough step) within
  1e-9;
- the slew-augmented double integrator (2 states, 1 control: a LinDx of
  3 augmented states) through the kernel route (the plain K3 on the
  CPU) against mpc_tpu's jnp path within 1e-10, and the three layouts
  of prev_ctrl that ``MPC`` takes;
- gradients through both routes (the fixed point is the eager one, on
  the augmented problem) to c, F, x_init and prev_ctrl against
  ``jax.grad`` within 1e-8 relative;
- ``fused.scope_gap`` judges the augmented problem: the pendulum and a
  3-state LinDx go to the dense configuration, the double integrator to
  K3, the MLP to the eager route naming its ROADMAP queue 2 item.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import AffineDynamics as JAffine
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (affine_from_numpy,
                                         lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy)

jax.config.update('jax_enable_x64', True)

TOL = 1e-10
GRAD_TOL = 1e-8
DT = 0.05


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


def _affine_problem():
    """tests/test_slew.py's problem (reference tests/test_mpc.py:802-
    830): 3 states, 4 controls, T=5, per-example C and c."""
    rng = np.random.RandomState(1)
    B, ns, nc, T = 2, 3, 4, 5
    C = rng.randn(T, B, ns + nc, ns + nc)
    C = np.matmul(C.transpose(0, 1, 3, 2), C)
    c = rng.randn(T, B, ns + nc)
    x0 = rng.randn(B, ns)
    R = np.eye(ns) + 0.2 * rng.randn(ns, ns)
    S = rng.randn(ns, nc)
    f = rng.randn(ns)
    return (ns, nc, T), C, c, x0, (R, S, f)


def _affine_solve(slew, port=True, **kw):
    (ns, nc, T), C, c, x0, (R, S, f) = _affine_problem()
    args = dict(lqr_iter=10, backprop=False, exit_unconverged=False,
                eps=1e-4, slew_rate_penalty=slew, **kw)
    if port:
        return mt.MPC(ns, nc, T, device='cpu', **args)(
            torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
            affine_from_numpy(R, S, f, device='cpu'))
    return mpc_tpu.MPC(ns, nc, T, **args)(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        JAffine(jnp.asarray(R), jnp.asarray(S), jnp.asarray(f)))


def test_slew_rate_cost_matches_jax():
    """SlewRateCost(tau) = cost(tau[nc:]) + 0.5 tau^T slew_C tau on a
    batch of augmented tau, against mpc_tpu's on each."""
    rng = np.random.RandomState(1)
    ns, nc = 3, 2
    naug = ns + 2 * nc
    slew_C = rng.randn(naug, naug)
    slew_C = slew_C + slew_C.T
    tau = rng.randn(6, naug)
    port = mt.SlewRateCost(lambda t: (t ** 2).sum(-1) + t.sum(-1),
                           torch.tensor(slew_C), ns, nc)
    ref = mpc_tpu.SlewRateCost(lambda t: jnp.sum(t ** 2) + jnp.sum(t),
                               jnp.asarray(slew_C), ns, nc)
    want = np.array([float(ref(jnp.asarray(t))) for t in tau])
    _rel(port(torch.tensor(tau)), want, 1e-12)
    # the block the solver builds is the penalty on u_t - u_{t-1}
    blk = solver.slew_block(0.5, ns, nc, torch.float64, 'cpu').numpy()
    z = rng.randn(naug)
    d = z[-nc:] - z[:nc]
    np.testing.assert_allclose(z @ blk @ z, 0.5 * d @ d, rtol=1e-12)


def test_slew_rate():
    """tests/test_slew.py's three behaviours through the port."""
    x, u, objs = _affine_solve(None)
    x_eps, u_eps, _ = _affine_solve(1e-6)
    np.testing.assert_allclose(x.numpy(), x_eps.numpy(), atol=1e-3)
    np.testing.assert_allclose(u.numpy(), u_eps.numpy(), atol=1e-3)
    x_slew, u_slew, objs_slew = _affine_solve(1.0)
    # the slew objective includes the penalty
    assert bool((objs < objs_slew).all())
    d = float(torch.linalg.vector_norm(u[:-1] - u[1:]))
    d_slew = float(torch.linalg.vector_norm(u_slew[:-1] - u_slew[1:]))
    assert d_slew < d


@pytest.mark.parametrize('slew', [1e-6, 1.0])
def test_slew_affine_matches_jax_mpc(slew):
    """The affine model with 4 controls (eager route) against
    mpc_tpu.MPC."""
    got = _affine_solve(slew)
    ref = _affine_solve(slew, port=False)
    for name, a, b in zip(('x', 'u', 'costs'), got, ref):
        _rel(a, b, TOL, name)


def _pendulum(B=3, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    q = np.array([1., 1., 0.1, 0.001])
    p = np.array([-1., 0., 0., 0.])
    return x0, np.diag(q), p, rng.uniform(-1, 1, (B, 1))


def _slew_pendulum_mpc(layout, route):
    """The pendulum under slew 0.5 with prev_ctrl in ``layout`` through
    the port's MPC on ``route`` and through mpc_tpu.MPC, 4 iterations:
    (the port's x, u, costs; the reference's; the eager solves)."""
    B, T = 3, 8
    x0, C, c, pc = _pendulum(B)
    pc = {'batched': pc, 'shared': pc[0], 'leading_one': pc[None]}[layout]
    kw = dict(u_lower=-2., u_upper=2., lqr_iter=4, eps=1e-3,
              slew_rate_penalty=0.5, grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
              exit_unconverged=False, backprop=False)
    solver.reset_eager_counts()
    got = mt.MPC(3, 1, T, prev_ctrl=torch.tensor(pc), device='cpu',
                 use_fused=route, **kw)(
        torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
        pendulum_from_numpy([10., 1., 1.], device='cpu'))
    n_eager = solver.eager_counts['eager_solve']
    ref = mpc_tpu.MPC(3, 1, T, prev_ctrl=jnp.asarray(pc), **kw)(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        JPendulumDx())
    return got, ref, n_eager


@pytest.mark.parametrize('layout', ['batched', 'shared', 'leading_one'])
def test_slew_pendulum_prev_ctrl_layouts_match_jax_mpc(layout):
    """The pendulum under slew 0.5 on the eager route (use_fused='never')
    with prev_ctrl [B, nc], [nc] and [1, B, nc] against mpc_tpu.MPC."""
    got, ref, n_eager = _slew_pendulum_mpc(layout, 'never')
    assert n_eager == 1
    for name, a, b in zip(('x', 'u', 'costs'), got, ref):
        _rel(a, b, TOL, name)


@pytest.mark.parametrize('layout', ['batched', 'shared', 'leading_one'])
def test_slew_pendulum_prev_ctrl_layouts_kernel_route(layout):
    """The same through the kernel route (use_fused='auto'): the
    augmented pendulum of 4 states in the dense configuration's
    model-step build (its plain version on the CPU), no eager solve,
    against mpc_tpu.MPC within 1e-9 relative (the kernel route's 1-D box
    QP in closed form against the jnp path's PNQP, which adds 1e-11 to
    the control block)."""
    got, ref, n_eager = _slew_pendulum_mpc(layout, 'auto')
    assert n_eager == 0
    for name, a, b in zip(('x', 'u', 'costs'), got, ref):
        _rel(a, b, 1e-9, name)


def _double_integrator(B, T, seed=3):
    """The double integrator (p, v), dt 0.05: F = [[1, dt, 0],
    [0, 1, dt]], diagonal C (1, 0.1, 0.01), a target position per
    example in c."""
    rng = np.random.RandomState(seed)
    F = np.array([[1., DT, 0.], [0., 1., DT]])
    F = np.broadcast_to(F, (T - 1, 2, 3)).copy()
    C = np.diag([1., 0.1, 0.01])
    target = rng.uniform(-1, 1, (B,))
    c = np.zeros((T, B, 3))
    c[..., 0] = -target
    x0 = rng.randn(B, 2) * 0.5
    pc = rng.uniform(-1, 1, (B, 1))
    return x0, C, c, F, pc


def _di_cfg(T, port=True, **kw):
    base = dict(n_state=2, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                slew_rate_penalty=0.5, linesearch_decay=0.2,
                max_linesearch_iter=3, backprop=False)
    base.update(kw)
    return mt.MPCConfig(**base) if port else mpc_tpu.MPCConfig(
        **dict(base, grad_method=mpc_tpu.GradMethods.ANALYTIC))


def test_slew_lindx_kernel_route_matches_jnp_path():
    """The augmented double integrator takes the kernels' route (the plain
    K3 on the CPU, no eager solve) and matches mpc_tpu's jnp path."""
    B, T = 4, 12
    x0, C, c, F, pc = _double_integrator(B, T)
    cfg = _di_cfg(T)
    cost = quad_cost_from_numpy(C, c, 'cpu')
    dyn = lin_dx_from_numpy(F, None, 'cpu')
    assert fused.scope_gap(cfg, cost, dyn) is None
    solver.reset_eager_counts()
    got = mt.batched_solve(cfg, torch.tensor(x0), cost, dyn, u_lower=-2.,
                           u_upper=2., prev_ctrl=torch.tensor(pc),
                           device='cpu')
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    ref = j_batched_solve(
        _di_cfg(T, port=False, use_fused='never'), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None), u_lower=-2., u_upper=2.,
        prev_ctrl=jnp.asarray(pc))
    assert got.x.shape == (T, B, 2)
    for name in ('x', 'u', 'costs'):
        _rel(getattr(got, name), getattr(ref, name), TOL, name)
    # the eager route of the port on the same problem agrees too
    eager = mt.batched_solve(_di_cfg(T, use_fused='never'), torch.tensor(x0),
                             cost, dyn, u_lower=-2., u_upper=2.,
                             prev_ctrl=torch.tensor(pc), device='cpu')
    _rel(eager.u, ref.u, TOL, 'eager u')


def _di_grads(route):
    """Gradients of a loss of u and x through a differentiable slew solve
    of the double integrator, to c, F, x_init and prev_ctrl: the port
    (``route``: 'kernel' runs phase 1 in the plain K3, 'eager' on the
    eager solver; phase 2 is the eager fixed point either way) and
    jax.grad of mpc_tpu's batched_solve."""
    B, T = 3, 8
    x0, C, c, F, pc = _double_integrator(B, T, seed=5)
    w = np.random.RandomState(7).randn(T, B, 1)
    kw = dict(lqr_iter=12, detach_unconverged=False, backprop=True)
    cfg = _di_cfg(T, use_fused='auto' if route == 'kernel' else 'never', **kw)
    ts = [torch.tensor(a, requires_grad=True) for a in (c, F, x0, pc)]
    sol = mt.batched_solve(cfg, ts[2], mt.QuadCost(torch.tensor(C), ts[0]),
                           mt.LinDx(ts[1], None), u_lower=-2., u_upper=2.,
                           prev_ctrl=ts[3], device='cpu')
    ((sol.u * torch.tensor(w)).sum() + 0.5 * (sol.x ** 2).sum()).backward()

    def loss(c_, F_, x0_, pc_):
        s = j_batched_solve(_di_cfg(T, port=False, use_fused='never', **kw),
                            x0_, mpc_tpu.QuadCost(jnp.asarray(C), c_),
                            mpc_tpu.LinDx(F_, None), u_lower=-2., u_upper=2.,
                            prev_ctrl=pc_)
        return jnp.sum(s.u * w) + 0.5 * jnp.sum(s.x ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (c, F, x0, pc)))
    return [t.grad for t in ts], ref


@pytest.mark.parametrize('route', ['kernel', 'eager'])
def test_slew_gradients_match_jax(route):
    got, ref = _di_grads(route)
    for name, g, r in zip(('c', 'F', 'x_init', 'prev_ctrl'), got, ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        _rel(g, r, GRAD_TOL, name)


def test_scope_gap_judges_the_augmented_problem():
    T = 10
    x0, C, c, pc = _pendulum()
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, slew_rate_penalty=0.5)
    pend = pendulum_from_numpy([10., 1., 1.], device='cpu')
    cost = quad_cost_from_numpy(C, c, 'cpu')
    # the pendulum augments to 4 states: the dense configuration's
    # model-step build, through the passthrough step
    assert fused.scope_gap(cfg, cost, pend) is None
    assert fused.routes_dense(fused.SlewSoA(pend, 1), 4, 1)
    assert not fused.routes_dense(pend, 3, 1)
    # an MLP under slew: the dense configuration's MLP build through its
    # passthrough rows
    mlp = mt.NNDynamics.init(3, 1, (8,), generator=torch.Generator(
    ).manual_seed(0), device='cpu', dtype=torch.float64)
    assert fused.scope_gap(cfg, cost, mlp) is None
    assert fused.routes_dense(fused.SlewSoA(mlp, 1), 4, 1)
    # a 3-state LinDx augments to 4 states: K3's dense configuration
    lin3 = lin_dx_from_numpy(np.zeros((T - 1, 3, 4)), None, 'cpu')
    assert fused.scope_gap(cfg, cost, lin3) is None
    assert fused.routes_dense(lin3, 4, 1)
    # the double integrator augments to K3's three states
    _, C2, c2, F, _ = _double_integrator(2, T)
    cfg2 = _di_cfg(T)
    dyn = lin_dx_from_numpy(F, None, 'cpu')
    assert fused.scope_gap(cfg2, quad_cost_from_numpy(C2, c2, 'cpu'),
                           dyn) is None
    assert fused.routes_long(dyn, T)
    # a callable cost with a slew penalty is refused, as in the reference
    with pytest.raises(NotImplementedError, match='slew rate penalty'):
        mt.batched_solve(cfg, torch.tensor(x0), lambda tau: (tau ** 2).sum(-1),
                         pend, device='cpu')
