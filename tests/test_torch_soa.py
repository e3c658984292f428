"""The nonlinear models in the kernels, on the CPU against mpc_tpu in
float64: the cartpole and the slew-augmented models through the dense
configuration's model-step build, the damped pendulum through K1 and K3.

- (1) the cartpole's ``soa_step`` and ``soa_jacobian`` against mpc_tpu's
  ``soa_step`` and ``jax.jacfwd`` of it, 1e-12, with controls on and past
  +-100, angles near +-pi and the degenerate (0, 0);
- (2) the damped pendulum's against mpc_tpu's ``__call__`` (the true
  arctan2) and ``jax.jacfwd`` of it, 1e-12, and against its polynomial
  ``soa_step`` within 1e-6 (the TPU kernel's atan2, ~1e-7 in float32);
  (0, 0) finite in value and Jacobian, angle 0 as atan2 takes it;
- (3) the slew passthrough ``fused.SlewSoA`` against mpc_tpu's
  ``_SlewSoA`` and ``jax.jacfwd`` of its step, 1e-12 (the damped inner
  model 1e-6, its polynomial atan2);
- (4) whole solves on the kernel route (the plain versions: the dense
  model-step build, K1, K3) against ``mpc_tpu.learning.batched_solve
  (use_fused='never')``: x and u within 1e-9 relative (1e-7 at the long
  horizons, see SOLVES), n_iter equal;
- (5) gradients of differentiable cartpole and damped-pendulum solves on
  the kernel route (phase 2 the plain dense backward or the plain K2)
  against ``jax.grad``, 1e-7 relative;
- (6) routing: ``scope_gap`` admits each problem, 'always' solves it,
  each predicate sends it where ROADMAP's table says;
- (7) a cartpole solve exports through ``utils/export.py`` with one
  ``k3d_solve`` node and gives the live path's bits;
- the damped pendulum's plain K1 against mpc_tpu's interpret-mode Pallas
  K1 at T=5, B=8 in float32 (1e-4: the polynomial atan2 and float32
  round-off), the op's schema (opcheck), operation counts and launch
  geometry;
- the model-step build's workspace layout (``fused_dense.dense_ws_shared``:
  shared memory at config 3, the cartpole at T=200 up to 528 examples and
  the slew headline, global memory where the shared layout would add
  waves) with the shared memory and defines that follow from it, and the
  LinDx and MLP builds' geometry and defines pinned at the MLP build's
  redesign's rows.

The kernel route's float64 sits up to ~1e-9 from mpc_tpu's jnp path where
the eager route sits at 1e-14: the jnp path's PNQP adds 1e-11 to the
control block and its line search decides ties at round-off its own way,
so the tolerances are 1e-9 for iterates and 1e-7 for gradients, with eps
chosen so that the last accepted step is real.
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
from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import CartpoleDx, PendulumDx
from mpc_tpu_torch.ops import fused, fused_dense as fd
from mpc_tpu_torch.utils import export as ex
from mpc_tpu_torch.utils.convert import (cartpole_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy)

jax.config.update('jax_enable_x64', True)

PEND = np.array([10., 1., 1.])
DAMPED = np.array([10., 1., 1., 0.1, 0.05])
CART = np.array([9.8, 1.0, 0.1, 0.5])
STEP_TOL = 1e-12
POLY_TOL = 1e-6
SOLVE_TOL = 1e-9
GRAD_TOL = 1e-7


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


def _cart_points(n=40, seed=0):
    """States and controls of the cartpole: generic, angles near +-pi,
    renormalisation drift, (cos, sin) = (0, 0); controls inside, exactly
    on and past +-100."""
    rng = np.random.RandomState(seed)
    th = np.concatenate([rng.uniform(-np.pi, np.pi, n - 3),
                         [np.pi - 1e-9, -np.pi + 1e-9, 0.3]])
    r = rng.uniform(0.95, 1.05, n)
    x = np.stack([rng.randn(n), rng.randn(n), r * np.cos(th),
                  r * np.sin(th), 2 * rng.randn(n)], 1)
    x[-1, 2:4] = 0.0
    u = rng.uniform(-150, 150, n)
    u[:4] = (100.0, -100.0, 100.5, -140.0)
    return x, u


def _pend_points(n=40, seed=1):
    rng = np.random.RandomState(seed)
    th = np.concatenate([rng.uniform(-np.pi, np.pi, n - 2),
                         [np.pi - 1e-9, -np.pi + 1e-9]])
    r = rng.uniform(0.95, 1.05, n)
    x = np.stack([r * np.cos(th), r * np.sin(th), rng.randn(n)], 1)
    x[-3, :2] = 0.0
    u = rng.uniform(-3, 3, n)
    u[:4] = (2.0, -2.0, 2.5, -3.0)
    return x, u


def _port_step(model, x, u):
    return torch.stack(model.soa_step(tuple(torch.tensor(x).unbind(-1)),
                                      torch.tensor(u), model.soa_params()),
                       -1).numpy()


def _port_jac(model, x, u):
    rows = model.soa_jacobian(tuple(torch.tensor(x).unbind(-1)),
                              torch.tensor(u), model.soa_params())
    return torch.stack([torch.stack(r, -1) for r in rows], -2).numpy()


def _jac_of(step, x, u):
    """jax.jacfwd of ``step(z) -> [ns]`` at each (x_i, u_i)."""
    return np.stack([np.asarray(jax.jacfwd(step)(jnp.asarray(np.r_[a, b])))
                     for a, b in zip(x, u)])


# ---------------------------------------------------------------------------
# (1)-(3) the steps and their Jacobians
# ---------------------------------------------------------------------------

def test_cartpole_step_and_jacobian_match_jax():
    x, u = _cart_points()
    jdx = JCartpoleDx(params=jnp.asarray(CART))
    tdx = cartpole_from_numpy(CART, 'cpu')
    ref = np.stack(jdx.soa_step(tuple(jnp.asarray(x).T), jnp.asarray(u),
                                jdx.soa_params()), 1)
    _rel(_port_step(tdx, x, u), ref, STEP_TOL, 'step')
    J = _jac_of(lambda z: jnp.stack(jdx.soa_step(tuple(z[:5]), z[5],
                                                 jdx.soa_params())), x, u)
    got = _port_jac(tdx, x, u)
    _rel(got, J, STEP_TOL, 'jacobian')
    # the control column: the full derivative on +-100, 0 past it
    assert np.all(got[:2, 1, 5] != 0) and np.all(got[2:4, :, 5] == 0)
    assert np.isfinite(got[-1]).all()
    # step_jacobian is the same function on [..., 5] and [..., 1]
    np.testing.assert_array_equal(
        tdx.step_jacobian(torch.tensor(x), torch.tensor(u[:, None])).numpy(),
        got)


def test_damped_pendulum_step_and_jacobian_match_jax():
    x, u = _pend_points()
    jdx = JPendulumDx(params=jnp.asarray(DAMPED), simple=False)
    tdx = pendulum_from_numpy(DAMPED, simple=False, device='cpu')
    ref = np.asarray(jdx(jnp.asarray(x), jnp.asarray(u[:, None])))
    got = _port_step(tdx, x, u)
    _rel(got, ref, STEP_TOL, 'step vs __call__')
    poly = np.stack(jdx.soa_step(tuple(jnp.asarray(x).T), jnp.asarray(u),
                                 jdx.soa_params()), 1)
    assert np.abs(got - poly).max() <= POLY_TOL
    J = _jac_of(lambda z: jdx(z[:3], z[3:]), x, u)
    Jt = _port_jac(tdx, x, u)
    keep = np.ones(len(x), bool)
    keep[-3] = False            # jax's arctan2 derivative is NaN at (0, 0)
    _rel(Jt[keep], J[keep], STEP_TOL, 'jacobian')
    # (0, 0): atan2's angle 0, finite, only the path through dth left
    assert np.isfinite(Jt[-3]).all() and np.all(Jt[-3][:, :2] == 0)
    _rel(got[-3], ref[-3], STEP_TOL, 'step at (0, 0)')
    assert np.all(Jt[:2, 2, 3] != 0) and np.all(Jt[2:4, :, 3] == 0)


@pytest.mark.parametrize('model', ['pendulum', 'damped_pendulum',
                                   'cartpole'])
def test_slew_passthrough_matches_jax(model):
    if model == 'cartpole':
        x, u = _cart_points(seed=3)
        jm, tm = JCartpoleDx(params=jnp.asarray(CART)), cartpole_from_numpy(
            CART, 'cpu')
        tol = STEP_TOL
    else:
        x, u = _pend_points(seed=4)
        # away from (0, 0), where jax's derivative of arctan2 is NaN, and
        # off |cos| = |sin|, where its polynomial atan2's min/max tie
        # splits the derivative
        x[-3, :2] = (0.3, -0.2)
        simple = model == 'pendulum'
        prm = PEND if simple else DAMPED
        jm = JPendulumDx(params=jnp.asarray(prm), simple=simple)
        tm = pendulum_from_numpy(prm, simple=simple, device='cpu')
        tol = STEP_TOL if simple else POLY_TOL
    prev = np.random.RandomState(5).uniform(-3, 3, len(x))
    xa = np.concatenate([prev[:, None], x], 1)
    ns = xa.shape[1]
    jw, tw = jfused._SlewSoA(jm, 1), fused.SlewSoA(tm, 1)
    assert tw.n_state == ns
    ref = np.stack(jw.soa_step(tuple(jnp.asarray(xa).T), jnp.asarray(u),
                               jw.soa_params()), 1)
    _rel(_port_step(tw, xa, u), ref, tol, 'step')
    J = _jac_of(lambda z: jnp.stack(jw.soa_step(tuple(z[:ns]), z[ns],
                                                jw.soa_params())), xa, u)
    got = _port_jac(tw, xa, u)
    assert np.abs(got - J).max() <= tol * max(np.abs(J).max(), 1.0)
    # the first row picks u_t, the u_{t-1} column is zero
    np.testing.assert_array_equal(got[:, 0], np.eye(ns + 1)[ns][None]
                                  .repeat(len(x), 0))
    np.testing.assert_array_equal(got[:, :, 0], 0.0)


# ---------------------------------------------------------------------------
# (4) whole solves through the plain versions
# ---------------------------------------------------------------------------

def _x0(model, B, seed):
    rng = np.random.RandomState(seed)
    if model == 'cartpole':
        th = 0.5 * (2 * rng.rand(B) - 1)
        z = np.zeros(B)
        return np.stack([z, z, np.cos(th), np.sin(th), z], 1)
    th = np.pi * (2 * rng.rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def _models(model):
    if model == 'cartpole':
        return (JCartpoleDx(params=jnp.asarray(CART)),
                cartpole_from_numpy(CART, 'cpu'), 100.0)
    simple = model == 'pendulum'
    prm = PEND if simple else DAMPED
    return (JPendulumDx(params=jnp.asarray(prm), simple=simple),
            pendulum_from_numpy(prm, simple=simple, device='cpu'), 2.0)


# (model, T, B, lqr_iter, slew, eps, tolerance): the cartpole at T=8 and
# 130, the damped pendulum at T=10 (K1) and past T_MAX (K3), the slew
# pendulum and cartpole with prev_ctrl (the dense configuration).  The
# long horizons run a few unconverged iterations, whose rollouts amplify
# the ~1e-15 differences of the two Jacobians (autodiff of the atan2
# step there, hand-written here) over their 130 and 183 steps: held to
# 1e-7 (measured 1.2e-9 and 1.9e-8; tests/test_torch_long.py holds the
# simple pendulum past T_MAX to 1e-6 for the same reason).
SOLVES = {
    'cartpole_T8': ('cartpole', 8, 6, 10, None, 1e-2, SOLVE_TOL),
    'cartpole_T130': ('cartpole', 130, 3, 3, None, 1e-2, 1e-7),
    'damped_T10': ('damped_pendulum', 10, 6, 10, None, 1e-3, SOLVE_TOL),
    'damped_long': ('damped_pendulum', fused.T_MAX + 2, 3, 2, None, 1e-3,
                    1e-7),
    'slew_pendulum': ('pendulum', 10, 5, 10, 0.5, 1e-3, SOLVE_TOL),
    'slew_cartpole': ('cartpole', 10, 4, 10, 0.3, 1e-2, SOLVE_TOL),
}


def _solve_cfg(model, T, lqr_iter, slew, eps, port=True, **kw):
    nc_kw = dict(linesearch_decay=0.5, max_linesearch_iter=2) \
        if model == 'cartpole' else dict(linesearch_decay=0.2,
                                         max_linesearch_iter=5)
    base = dict(n_state=5 if model == 'cartpole' else 3, n_ctrl=1, T=T,
                lqr_iter=lqr_iter, eps=eps, exit_unconverged=False,
                detach_unconverged=False, slew_rate_penalty=slew, **nc_kw)
    base.update(kw)
    if port:
        return mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **base)
    return mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             use_fused='never', **base)


@pytest.mark.parametrize('case', list(SOLVES))
def test_kernel_route_solves_match_jnp_path(case):
    model, T, B, lqr_iter, slew, eps, tol = SOLVES[case]
    jdx, tdx, box = _models(model)
    x0 = _x0(model, B, seed=len(case))
    q, p = (np.asarray(a) for a in jdx.get_true_obj())
    C = np.diag(q)
    prev = np.random.RandomState(9).uniform(-1, 1, (B, 1)) if slew else None
    cfg = _solve_cfg(model, T, lqr_iter, slew, eps, backprop=False)
    assert fused.scope_gap(cfg, quad_cost_from_numpy(C, p, 'cpu'), tdx) is None
    solver.reset_eager_counts()
    got = mt.batched_solve(cfg, torch.tensor(x0),
                           quad_cost_from_numpy(C, p, 'cpu'), tdx,
                           u_lower=-box, u_upper=box,
                           prev_ctrl=None if prev is None else
                           torch.tensor(prev), device='cpu')
    assert solver.eager_counts['eager_solve'] == 0
    ref = j_batched_solve(
        _solve_cfg(model, T, lqr_iter, slew, eps, port=False, backprop=False),
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(p)),
        jdx, u_lower=-box, u_upper=box,
        prev_ctrl=None if prev is None else jnp.asarray(prev))
    assert got.x.shape == (T, B, x0.shape[1])
    _rel(got.x, ref.x, tol, 'x')
    _rel(got.u, ref.u, tol, 'u')
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


# ---------------------------------------------------------------------------
# (5) gradients through the kernel route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('model', ['cartpole', 'damped_pendulum'])
def test_kernel_route_gradients_match_jax(model):
    """d loss / d (params, x_init, c) of a differentiable solve: phase 1
    in the plain dense model-step build (cartpole) or the plain K1
    (damped pendulum), phase 2 the plain dense backward on per-example F
    at 5 states and 1 control, or the plain K2; no eager solve or fixed
    point."""
    T, B = 6, 4
    jdx, tdx, box = _models(model)
    prm0 = CART if model == 'cartpole' else DAMPED
    x0 = _x0(model, B, seed=11)
    q, p = (np.asarray(a) for a in jdx.get_true_obj())
    C = np.diag(q)
    w = np.random.RandomState(12).randn(T, B, 1)
    eps = 1e-2 if model == 'cartpole' else 1e-3
    kw = dict(backprop=True)

    def j_loss(prm, x, c):
        m = JCartpoleDx(params=prm) if model == 'cartpole' else \
            JPendulumDx(params=prm, simple=False)
        s = j_batched_solve(_solve_cfg(model, T, 10, None, eps, port=False,
                                       **kw), x,
                            mpc_tpu.QuadCost(jnp.asarray(C), c), m,
                            u_lower=-box, u_upper=box)
        return jnp.sum(w * s.u) + 0.5 * jnp.sum(s.x ** 2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (prm0, x0, p)))
    prm, xt, ct = (torch.tensor(a, requires_grad=True) for a in (prm0, x0, p))
    m = CartpoleDx(params=prm) if model == 'cartpole' else PendulumDx(
        params=prm, simple=False)
    solver.reset_eager_counts()
    sol = mt.batched_solve(_solve_cfg(model, T, 10, None, eps, **kw), xt,
                           mt.QuadCost(torch.tensor(C), ct), m,
                           u_lower=-box, u_upper=box, device='cpu')
    ((sol.u * torch.tensor(w)).sum() + 0.5 * (sol.x ** 2).sum()).backward()
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for name, g, r in zip(('params', 'x_init', 'c'),
                          (prm.grad, xt.grad, ct.grad), ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        _rel(g, r, GRAD_TOL, name)


# ---------------------------------------------------------------------------
# (6) routing
# ---------------------------------------------------------------------------

def test_routing_of_the_nonlinear_models():
    cart = CartpoleDx(device='cpu')
    damped = PendulumDx(simple=False, device='cpu')
    pend = PendulumDx(device='cpu')
    q5, p5 = cart.get_true_obj()
    q3, p3 = pend.get_true_obj()
    cost5 = mt.QuadCost(torch.diag(q5), p5)
    cost3 = mt.QuadCost(torch.diag(q3), p3)

    def cfg(ns, T, **kw):
        return mt.MPCConfig(n_state=ns, n_ctrl=1, T=T, **kw)

    for c, cost, dyn in ((cfg(5, 25), cost5, cart),
                         (cfg(5, 300), cost5, cart),
                         (cfg(3, 20), cost3, damped),
                         (cfg(3, 300), cost3, damped),
                         (cfg(3, 20, slew_rate_penalty=0.5), cost3, pend),
                         (cfg(3, 20, slew_rate_penalty=0.5), cost3, damped),
                         (cfg(5, 25, slew_rate_penalty=0.5), cost5, cart)):
        assert fused.scope_gap(c, cost, dyn) is None
        assert fused.scope_gap(c, cost, dyn, device=torch.device('cuda')) \
            is None
    # the cartpole and every slew model: the dense configuration at any T
    assert fused.routes_dense(cart, 5, 1)
    for m in (pend, damped, cart):
        w = fused.SlewSoA(m, 1)
        assert fused.routes_dense(w, m.n_state + 1, 1)
        assert fd.dense_model(w) == (fd.dense_model(m)[0], True)
    # the damped pendulum: K1 up to T_MAX, K3 past it
    assert not fused.routes_dense(damped, 3, 1)
    assert not fused.routes_long(damped, fused.T_MAX)
    assert fused.routes_long(damped, fused.T_MAX + 1)
    # float64 on the card is the eager solver's; a mismatched size is
    # refused; the MLP under slew waits
    assert 'float64' in fused.scope_gap(cfg(5, 25), cost5, cart,
                                        dtype=torch.float64,
                                        device=torch.device('cuda'))
    assert 'states' in fused.scope_gap(cfg(3, 25), cost5, cart)
    # 'always' solves each (the plain versions on the CPU)
    for ns, cost, dyn, x0, box in (
            (5, cost5, cart, torch.tensor(_x0('cartpole', 2, 0),
                                          dtype=torch.float32), 100.0),
            (3, cost3, damped, torch.tensor(_x0('pendulum', 2, 0),
                                            dtype=torch.float32), 2.0)):
        solver.reset_eager_counts()
        sol = mt.batched_solve(cfg(ns, 4, use_fused='always', lqr_iter=2),
                               x0, cost, dyn, u_lower=-box, u_upper=box,
                               device='cpu')
        assert torch.isfinite(sol.u).all()
        assert solver.eager_counts['eager_solve'] == 0
    # the backward: per-example F at 5 states goes to the dense backward,
    # the damped pendulum to K2 / K4, a slew penalty to the eager fixed
    # point
    from mpc_tpu_torch.ops import fused_bwd
    assert fused_bwd.bwd_routes_dense(5, 1)
    assert not fused_bwd.bwd_routes_dense(3, 1)
    assert fused_bwd.scope_gap_bwd(25, 1, torch.float32,
                                   torch.device('cuda'), 5) is None
    assert 'slew' in fused_bwd.scope_gap_bwd(20, 1, torch.float32,
                                             torch.device('cuda'), 3, True)


# ---------------------------------------------------------------------------
# (7) export
# ---------------------------------------------------------------------------

def test_cartpole_solve_exports_as_one_node():
    T, B = 4, 3
    cart = CartpoleDx(device='cpu', dtype=torch.float64)
    q, p = cart.get_true_obj()
    C, c = torch.diag(q), p
    x0 = torch.tensor(_x0('cartpole', B, 2))
    cfg = _solve_cfg('cartpole', T, 2, None, 0.0, backprop=False)
    data = ex.export_solve(cfg, cart, mt.QuadCost(C, c), x0, u_lower=-100.0,
                           u_upper=100.0, device='cpu')
    assert ex.kernel_nodes(data) == {'k3d_solve': 1}
    out = ex.load_fn(data)(x0, C, c)
    live = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), cart,
                            u_lower=-100.0, u_upper=100.0, device='cpu')
    assert all(torch.equal(a, b) for a, b in
               zip(out, (live.x, live.u, live.costs)))


# ---------------------------------------------------------------------------
# the op, the interpret-mode K1, counts and geometry
# ---------------------------------------------------------------------------

def _model_op_args(model, slew, T=3, B=2, seed=0):
    rng = np.random.RandomState(seed)
    ns = fd.model_of(model, slew).n_state
    nt = ns + 1
    x0 = _x0('cartpole' if model == 'cartpole' else 'pendulum', B, seed)
    if slew:
        x0 = np.concatenate([rng.uniform(-1, 1, (B, 1)), x0], 1)
    C = np.diag(rng.uniform(0.1, 1.0, nt))[None, None].repeat(T, 0)
    c = rng.randn(T, 1, nt)
    prm = {'pendulum': PEND, 'damped_pendulum': DAMPED,
           'cartpole': CART}[model]

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
    return (None, None, t(C), t(c), t(x0), t(0.3 * rng.randn(T, B, 1)),
            t(-np.ones((T, 1, 1))), t(np.ones((T, 1, 1)))), t(prm)


@pytest.mark.parametrize('model,slew', [('cartpole', False),
                                        ('pendulum', True),
                                        ('damped_pendulum', True)])
def test_opcheck_k3d_model(model, slew):
    args, prm = _model_op_args(model, slew)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3d_solve,
                          (*args, [1.0, 0.5], 2, 0.0, 1e-4, 5.0, 20, model,
                           slew, prm))


def test_damped_k1_op_and_k3_op():
    """The K1 and K3 ops take the damped pendulum's 5 parameters: their
    plain versions run its step (another trajectory than the simple
    pendulum's with the same g, m, l), and the two kernels' plain
    versions agree to float32 round-off."""
    rng = np.random.RandomState(3)
    T, B = 4, 3
    C = torch.tensor(np.diag([1., 1., 0.1, 0.001])[None, None].repeat(T, 0),
                     dtype=torch.float32)
    c = torch.zeros(T, 1, 4)
    x0 = torch.tensor(_x0('pendulum', B, 1), dtype=torch.float32)
    u0 = torch.tensor(rng.randn(T, B), dtype=torch.float32)
    lb, ub = -2 * torch.ones(T, 1), 2 * torch.ones(T, 1)
    kw = ([1.0, 0.2], 2, 0.0, 1e-4, 5.0)
    damped = torch.tensor(DAMPED, dtype=torch.float32)
    a = torch.ops.mpc_tpu_torch.k1_solve(damped, C, c, x0, u0, lb, ub, *kw)
    b = torch.ops.mpc_tpu_torch.k1_solve(damped[:3].contiguous(), C, c, x0,
                                         u0, lb, ub, *kw)
    assert not torch.equal(a[0], b[0])
    ref = fused.fused_solve_plain(PendulumDx(params=damped, simple=False),
                                  damped, C, c, x0, u0, lb, ub,
                                  alphas=kw[0], lqr_iter=2, eps=0.0,
                                  best_cost_eps=1e-4, not_improved_lim=5.0)
    assert all(torch.equal(p, q) for p, q in zip(a, ref))
    k3 = torch.ops.mpc_tpu_torch.k3_solve(damped, None, None, C, c, x0, u0,
                                          lb, ub, *kw, 0, '', False)
    ref3 = fused.fused_solve_long_plain(
        PendulumDx(params=damped, simple=False), damped, None, None, C, c,
        x0, u0, lb, ub, alphas=kw[0], lqr_iter=2, eps=0.0,
        best_cost_eps=1e-4, not_improved_lim=5.0)
    assert all(torch.equal(p, q) for p, q in zip(k3, ref3))
    assert float((k3[1] - a[1]).abs().max()) < 1e-5
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k1_solve,
                          (damped, C, c, x0, u0, lb, ub, *kw))


def test_damped_plain_k1_matches_pallas_interpret():
    """The plain K1 in float32 against mpc_tpu's interpret-mode Pallas K1
    on the damped pendulum, T=5, B=8: u within 1e-4 (the TPU kernel's
    polynomial atan2, ~1e-7 a step, and float32 round-off on an
    otherwise identical algorithm)."""
    T, B = 5, 8
    x0 = _x0('pendulum', B, 6).astype(np.float32)
    q = np.array([1., 1., 0.1, 0.001], np.float32)
    p = np.array([-1., 0., 0., 0.], np.float32)
    kw = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              linesearch_decay=0.2, max_linesearch_iter=3, backprop=False)
    jdx = JPendulumDx(params=jnp.asarray(DAMPED, jnp.float32), simple=False)
    ref = jfused.fused_batched_solve(
        mpc_tpu.MPCConfig(**kw), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.diag(jnp.asarray(q)), jnp.asarray(p)), jdx,
        u_lower=jnp.float32(-2.), u_upper=jnp.float32(2.), interpret=True)
    tdx = PendulumDx(params=torch.tensor(DAMPED, dtype=torch.float32),
                     simple=False)
    got = mt.batched_solve(mt.MPCConfig(**kw), torch.tensor(x0),
                           mt.QuadCost(torch.diag(torch.tensor(q)),
                                       torch.tensor(p)), tdx,
                           u_lower=-2., u_upper=2., device='cpu')
    assert np.abs(got.u.numpy() - np.asarray(ref.u)).max() <= 1e-4
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


def test_counts_and_geometry_of_the_model_step_build():
    # the Jacobians' block of the workspace: 720 floats an example for
    # the cartpole at T=25
    assert fd.dense_workspace_floats(25, 5, 1, model=True) - \
        fd.dense_workspace_floats(25, 5, 1) == 720
    # config 3 keeps it in its warps' shared memory (1,172 floats a warp)
    geo = fd.k3d_launch(25, 512, 5, 1, 2, model=True)
    assert geo['ws_shared'] and geo['workspace_bytes'] == 0
    assert geo['smem_bytes'] == fd.k3d_smem_bytes(5, 1) + 4 * 4 * 1172
    assert fd.dense_kernel_defines(5, 1, True, False, 'cartpole') == {
        'MPC_NS': 5, 'MPC_NC': 1, 'MPC_HAS_BOUNDS': 1, 'MPC_HAS_F': 0,
        'MPC_WARPS': fd.DENSE_WARPS, 'MPC_PREFETCH': 0, 'MPC_MODEL': 3,
        'MPC_SLEW': 0}
    assert fd.dense_kernel_defines(4, 1, True, False, 'pendulum',
                                   True)['MPC_SLEW'] == 1
    with pytest.raises(ValueError):
        fd.dense_kernel_defines(5, 1, True, True, 'cartpole')
    assert fused.kernel_defines(20, True, damped=True)['MPC_DAMPED'] == 1
    assert fused.long_kernel_defines(False, True,
                                     damped=True)['MPC_DAMPED'] == 1
    # the operation counts: a model's Jacobians before every sweep, its
    # step in every rollout; the slew passthrough adds none
    base = fd.k3d_flops(25, 5, 1, 10, 10, model_ops=(0, 0))
    cart = fd.k3d_flops(25, 5, 1, 10, 10, model_ops=fd.model_op_counts(
        'cartpole'))
    assert cart - base == 10 * 24 * 92 + (1 + 10) * 24 * 40
    assert fused.k1_flops(20, 3, 1, 10, 10, damped=True) < fused.k1_flops(
        20, 3, 1, 10, 10)
    assert fd.model_op_counts('damped_pendulum') == \
        fused.pendulum_op_counts(True)


# (T, B, n_state, n_ctrl) -> the model-step build's workspace in shared
# memory: config 3 (T=25, B=512, 128 blocks), the cartpole at T=200 and
# B=512 (one block an SM either way) and up to 528 examples, the headline
# under slew (B=4096: 1,024 blocks, one wave at 8 blocks an SM), the
# slew-augmented cartpole; global memory where the shared layout's
# blocks an SM would add waves (the cartpole at T=200 past 132 blocks)
LAYOUTS = [((25, 512, 5, 1), True), ((200, 512, 5, 1), True),
           ((200, 528, 5, 1), True), ((20, 4096, 4, 1), True),
           ((25, 2050, 6, 1), True), ((200, 532, 5, 1), False),
           ((200, 2050, 5, 1), False)]


@pytest.mark.parametrize('shape,shared', LAYOUTS)
def test_workspace_layout_of_the_model_step_build(shape, shared):
    T, B, ns, nc = shape
    assert fd.dense_ws_shared(T, B, ns, nc) is shared
    geo = fd.k3d_launch(T, B, ns, nc, 5, model=True)
    one = fd.k3d_smem_bytes(ns, nc)
    ws = fd.dense_workspace_floats(T, ns, nc, True)
    assert geo['ws_shared'] is shared
    if shared:
        # the four warps' workspaces above their tiles, 4-float aligned
        assert geo['smem_bytes'] == one + 4 * fd.DENSE_WARPS * (
            -(-ws // 4) * 4) <= fused.SMEM_LIMIT
        assert geo['workspace_bytes'] == 0
    else:
        assert geo['smem_bytes'] == one
        assert geo['workspace_bytes'] == 4 * B * ws
        # the shared layout would cost the launch waves
        smem = one + 16 * (-(-ws // 4) * 4)
        blocks = geo['blocks']
        regs = fd.step_min_blocks(ns, nc)
        assert fd.waves(blocks, min(fd.blocks_an_sm(smem), regs)) > \
            fd.waves(blocks, min(fd.blocks_an_sm(one), regs))
    # the clocked build keeps the layout, its counters above the tiles
    clocked = fd.k3d_launch(T, B, ns, nc, 5, model=True, clocks=True)
    assert clocked['ws_shared'] is shared and clocked['smem_bytes'] == \
        geo['smem_bytes'] + 4 * fd.DENSE_WARPS * fd.PHASE_CLOCK_FLOATS
    model = 'cartpole' if ns in (5, 6) else 'pendulum'
    d = fd.dense_kernel_defines(ns, nc, True, False, model, ns in (4, 6),
                                ws_shared=geo['ws_shared'])
    assert d.get('MPC_WS_SHARED', 0) == int(shared)
    without = dict(d)
    without.pop('MPC_WS_SHARED', None)
    assert without == fd.dense_kernel_defines(ns, nc, True, False, model,
                                              ns in (4, 6))


def test_shared_workspace_is_the_model_step_builds_alone():
    # a LinDx or an MLP build has no shared workspace
    with pytest.raises(ValueError):
        fd.dense_kernel_defines(5, 1, True, False, ws_shared=True)
    with pytest.raises(ValueError):
        fd.dense_kernel_defines(2, 1, True, False, 'mlp', mlp=(
            (3, 64, 64, 2), 'sigmoid', True), ws_shared=True)
    assert not fd.k3d_launch(20, 2048, 2, 1, 5, True,
                             (3, 64, 64, 2))['ws_shared']
    assert not fd.k3d_launch(20, 2048, 5, 1, 5)['ws_shared']
    # registers: 64 a lane give the slew-augmented pendulums' build 8
    # blocks an SM (80 gave 6: two waves at B=4096), the cartpole's keeps
    # 4 (one block an SM at config 3 and T=200 either way)
    assert [fd.blocks_by_registers(r) for r in (64, 80, 90, 128)] == \
        [8, 6, 5, 4]
    assert (fd.step_min_blocks(4, 1), fd.step_min_blocks(5, 1),
            fd.step_min_blocks(6, 1)) == (8, 4, 4)
    assert fd.waves(1024, 8) == 1 and fd.waves(1024, 6) == 2


# the LinDx and MLP builds' geometry and defines at the rows of the MLP
# build's redesign, as they were before the model-step build took its
# shared workspace: (k3d_launch's arguments, dense_kernel_defines'
# arguments, its keywords) -> (geometry, defines)
_BASE = {'MPC_HAS_BOUNDS': 1, 'MPC_HAS_F': 0, 'MPC_WARPS': 4,
         'MPC_PREFETCH': 0}
PINNED = {
    '24s4c': (((20, 2048, 24, 4, 10), (24, 4, True, False), {}),
              (512, 49728, 0, 25559040),
              dict(_BASE, MPC_NS=24, MPC_NC=4)),
    '5s1c': (((20, 2048, 5, 1, 10), (5, 1, True, False), {}),
             (512, 2752, 0, 2949120), dict(_BASE, MPC_NS=5, MPC_NC=1)),
    'tvlqr': (((5, 128, 3, 4, 10), (3, 4, False, True), {}),
              (32, 2496, 0, 76800),
              dict(_BASE, MPC_NS=3, MPC_NC=4, MPC_HAS_BOUNDS=0,
                   MPC_HAS_F=1)),
    'mlp-deep': (((20, 2048, 2, 1, 5, True, (3, 64, 64, 2)),
                  (2, 1, True, False, 'mlp'),
                  dict(mlp=((3, 64, 64, 2), 'sigmoid', True))),
                 (512, 27408, 2, 2408448),
                 dict(_BASE, MPC_NS=2, MPC_NC=1, MPC_MODEL=4, MPC_SLEW=0,
                      MPC_ACT=0, MPC_NN_DEPTH=2)),
    'mlp-slew': (((20, 2048, 4, 1, 3, True, (4, 100, 3)),
                  (4, 1, True, False, 'mlp', True),
                  dict(mlp=((4, 100, 3), 'sigmoid', True))),
                 (512, 12200, 4, 5570560),
                 dict(_BASE, MPC_NS=4, MPC_NC=1, MPC_MODEL=4, MPC_SLEW=1,
                      MPC_ACT=0, MPC_NN_DEPTH=1)),
}


@pytest.mark.parametrize('row', list(PINNED))
def test_lindx_and_mlp_builds_keep_their_geometry(row):
    (launch, dargs, dkw), (blocks, smem, chunk, ws), defines = PINNED[row]
    assert fd.k3d_launch(*launch) == dict(
        team=32, warps=4, examples=4, blocks=blocks, smem_bytes=smem,
        chunk=chunk, ws_shared=False, workspace_bytes=ws)
    assert fd.dense_kernel_defines(*dargs, **dkw) == defines
