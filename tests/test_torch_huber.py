"""The pseudo-Huber cost inside the kernels, on the CPU against mpc_tpu in
float64: K1, K3 and K3's dense configuration in their cost build
(MPC_COST = 1, csrc/cost.cuh), through their plain versions.

- (1) ``soa_cost`` and the hand-written quadratisation (H diagonal, g)
  against mpc_tpu's ``soa_cost`` and ``jax.hessian`` / ``jax.grad`` of
  it, 1e-12, with r = 0, |r| >> 1 and delta != 1;
- (2) whole solves on the kernel route (the plain K1, K3 and dense
  versions) against ``mpc_tpu.learning.batched_solve(use_fused='never')``:
  x and u within SOLVES' tolerance relative, n_iter equal;
- (3) the plain K1 in float32 against mpc_tpu's interpret-mode Pallas K1
  at T=4, B=8, unbounded, within tests/test_fused_soacost.py's
  tolerances (the one interpret-mode comparison: it takes ~13 s);
- (4) gradients to w, goal, delta and x_init through the kernel route
  (K1 then K2, K3 then K4, the dense forward then the dense backward,
  each on per-example C) against ``jax.grad`` of mpc_tpu's jnp path;
- (5) routing: ``scope_gap`` admits each problem, 'always' solves it, a
  batched goal and a plain callable cost go to the eager solver with
  their reasons, each predicate sends each problem where ROADMAP's table
  says;
- (6) an ``export_fn`` of a pseudo-Huber solve gives the live path's bits,
  its solve one kernel node;
- the ops' schemas with the cost parameters (opcheck) and the operation
  counts.

The kernel route's float64 sits ~1e-9 from the jnp path where the eager
route sits at 1e-14 (tests/test_torch_soa.py: the jnp path's PNQP adds
1e-11 to the control block and its line search decides round-off ties
its own way; the pendulum's Jacobians are autodiff of its step there,
hand-written here), so iterates are held to 1e-9 relative and gradients
to 1e-7, with eps chosen so that the last accepted step is real.
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
from mpc_tpu.models import PseudoHuberCost as JHuber
from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import PseudoHuberCost
from mpc_tpu_torch.models.cost import huber_quad
from mpc_tpu_torch.ops import fused, fused_bwd, fused_dense as fd
from mpc_tpu_torch.utils import export as ex
from mpc_tpu_torch.utils.convert import (cartpole_from_numpy,
                                         lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         pseudo_huber_from_numpy)

from test_torch_models import both_mlps, mlp_params

jax.config.update('jax_enable_x64', True)

PEND = np.array([10., 1., 1.])
DAMPED = np.array([10., 1., 1., 0.1, 0.05])
CART = np.array([9.8, 1.0, 0.1, 0.5])
# the serving row's cost (benchmarks/hw_sweep.py:255-267)
W4 = np.array([1., 1., .1, .1])
GOAL4 = np.array([1., 0., 0., 0.])
DELTA = 0.9
QUAD_TOL = 1e-12
SOLVE_TOL = 1e-9
GRAD_TOL = 1e-7


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


# ---------------------------------------------------------------------------
# (1) the cost and its quadratisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('delta', [0.7, 1.0, 2.5])
def test_soa_cost_and_quadratisation_match_jax(delta):
    """Components at the goal (r = 0), near it and in the tails (|r| up
    to ~30) against jax in float64, to 1e-12; far in the tails (|r| up to
    ~3e3) against the closed form in extended precision, to 1e-12.  There
    jax's nested jvp is not the yardstick: it forms H as 1/s - r^2/s^3,
    which cancels r^2-fold (at |r| = 1e3, to ~1e-10)."""
    rng = np.random.RandomState(int(10 * delta))
    n, m = 5, 40
    w = rng.uniform(0.01, 2.0, n)
    goal = rng.randn(n)
    tau = goal + np.concatenate([np.zeros((1, n)),
                                 0.1 * delta * rng.randn(m // 2, n),
                                 10.0 * delta * rng.randn(m // 2 - 1, n)])
    jc = JHuber(jnp.asarray(w), jnp.asarray(goal), jnp.asarray(delta))
    tc = pseudo_huber_from_numpy(w, goal, delta, device='cpu')
    jp = jc.soa_params()
    cols = tuple(jnp.asarray(tau[:, i]) for i in range(n))
    ref = np.asarray(jc.soa_cost(cols[:-1], cols[-1], jp))
    tt = tuple(torch.tensor(tau[:, i]) for i in range(n))
    tp = tc.soa_params()
    assert len(tp) == 2 * n + 1
    _rel(tc.soa_cost(tt[:-1], tt[-1], tp), ref, QUAD_TOL, 'soa_cost')
    _rel(tc(torch.tensor(tau)), ref, QUAD_TOL, 'forward')
    H, g = huber_quad(list(tt), tp)
    H, g = torch.stack(H, -1).numpy(), torch.stack(g, -1).numpy()
    for k in range(m):
        Hj = np.asarray(jax.hessian(jc)(jnp.asarray(tau[k])))
        gj = np.asarray(jax.grad(jc)(jnp.asarray(tau[k])))
        # the off-diagonal entries are exact zeros in both
        np.testing.assert_array_equal(Hj - np.diag(np.diag(Hj)), 0.0)
        _rel(H[k], np.diag(Hj), QUAD_TOL, f'H {k}')
        _rel(g[k], gj, QUAD_TOL, f'g {k}')
    # at the goal: H = w, g = 0
    np.testing.assert_allclose(H[0], w, rtol=1e-15)
    np.testing.assert_array_equal(g[0], 0.0)
    # far in the tails: H -> 0, |g| -> w delta, against the closed form
    far = goal + 1000.0 * delta * rng.randn(8, n)
    Hf, gf = huber_quad([torch.tensor(far[:, i]) for i in range(n)], tp)
    r = (far.astype(np.longdouble) - goal) / np.longdouble(delta)
    s = np.sqrt(1 + r * r)
    _rel(torch.stack(Hf, -1).numpy(), (w / s ** 3).astype(np.float64),
         QUAD_TOL, 'far H')
    _rel(torch.stack(gf, -1).numpy(), (w * delta * r / s).astype(np.float64),
         QUAD_TOL, 'far g')


def test_kernel_params_and_gate():
    c = pseudo_huber_from_numpy(W4, GOAL4, DELTA, device='cpu')
    np.testing.assert_array_equal(c.kernel_params().numpy(),
                                  np.r_[W4, GOAL4, DELTA])
    assert not c.kernel_params().requires_grad
    assert c.kernel_gap() is None
    batched = pseudo_huber_from_numpy(W4, np.tile(GOAL4, (3, 1)), DELTA,
                                      device='cpu')
    assert 'batched' in batched.kernel_gap()
    per_comp = pseudo_huber_from_numpy(W4, GOAL4, np.ones(4), device='cpu')
    assert 'scalar delta' in per_comp.kernel_gap()


# ---------------------------------------------------------------------------
# (2) whole solves through the plain versions
# ---------------------------------------------------------------------------

def _pend_x0(B, seed):
    th = np.pi * (2 * np.random.RandomState(seed).rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def _lindx(ns, nc, T, seed):
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
    Bm = 0.5 * rng.randn(ns, nc)
    return np.tile(np.concatenate([A, Bm], 1)[None], (T - 1, 1, 1))


def _problem(case, T, B):
    """(jax model, port model, x0, w, goal, box, kernel) of a case."""
    rng = np.random.RandomState(len(case) + T)
    if case in ('pendulum', 'damped'):
        prm = PEND if case == 'pendulum' else DAMPED
        simple = case == 'pendulum'
        return (JPendulumDx(params=jnp.asarray(prm), simple=simple),
                pendulum_from_numpy(prm, simple=simple, device='cpu'),
                _pend_x0(B, T), W4, GOAL4, 2.0)
    if case == 'cartpole':
        th = 0.5 * (2 * rng.rand(B) - 1)
        z = np.zeros(B)
        x0 = np.stack([z, z, np.cos(th), np.sin(th), z], 1)
        jm = JCartpoleDx(params=jnp.asarray(CART))
        q, _ = jm.get_true_obj()
        return (jm, cartpole_from_numpy(CART, 'cpu'), x0, np.asarray(q),
                np.r_[np.asarray(jm.goal_state), 0.0], 100.0)
    if case == 'mlp':
        jm, tm = both_mlps(mlp_params((8,), seed=2), 'sigmoid')
        return jm, tm, _pend_x0(B, 5), W4, GOAL4, 1.0
    ns, nc = (3, 1) if case == 'lindx' else (5, 2)
    F = _lindx(ns, nc, T, 7)
    x0 = rng.randn(B, ns)
    w = np.r_[np.ones(ns), 0.1 * np.ones(nc)]
    goal = np.r_[0.5 * rng.randn(ns), np.zeros(nc)]
    return (mpc_tpu.LinDx(jnp.asarray(F)), lin_dx_from_numpy(F, None, 'cpu'),
            x0, w, goal, 0.8)


def _cfg(ns, nc, T, lqr_iter, eps, port=True, **kw):
    base = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=lqr_iter, eps=eps,
                exit_unconverged=False, detach_unconverged=False,
                linesearch_decay=0.2, max_linesearch_iter=3, backprop=False)
    base.update(kw)
    if port:
        return mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **base)
    return mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             use_fused='never', **base)


# (case, T, B, lqr_iter, eps, kernel, tolerance): K1 on the pendulums, K3
# on a LinDx of 3 states and 1 control, on the pendulum past T_MAX and on
# an MLP, the dense configuration on a 5-state, 2-control LinDx and on the
# cartpole.  The long pendulum's unconverged rollouts amplify the
# Jacobians' ~1e-15 differences over 183 steps (tests/test_torch_soa.py:
# SOLVES), so it is held to 1e-7.
SOLVES = {
    'K1_pendulum': ('pendulum', 10, 6, 10, 1e-3, 'K1', SOLVE_TOL),
    'K1_damped': ('damped', 10, 6, 10, 1e-3, 'K1', SOLVE_TOL),
    'K3_lindx': ('lindx', 12, 5, 8, 1e-6, 'K3', SOLVE_TOL),
    'K3_pendulum_long': ('pendulum', fused.T_MAX + 2, 3, 2, 1e-3, 'K3',
                         1e-7),
    'K3_mlp': ('mlp', 6, 5, 6, 1e-4, 'K3', SOLVE_TOL),
    'dense_lindx_5s2c': ('lindx52', 8, 4, 8, 1e-6, 'dense', SOLVE_TOL),
    'dense_cartpole': ('cartpole', 8, 5, 10, 1e-2, 'dense', SOLVE_TOL),
}


@pytest.mark.parametrize('case', list(SOLVES))
def test_kernel_route_huber_solves_match_jnp_path(case):
    model, T, B, lqr_iter, eps, kernel, tol = SOLVES[case]
    jm, tm, x0, w, goal, box = _problem(model, T, B)
    ns, nc = x0.shape[1], len(w) - x0.shape[1]
    cfg = _cfg(ns, nc, T, lqr_iter, eps)
    cost = pseudo_huber_from_numpy(w, goal, DELTA, device='cpu')
    assert fused.scope_gap(cfg, cost, tm, dtype=torch.float64) is None
    assert fused.routes_dense(tm, ns, nc) == (kernel == 'dense')
    if kernel != 'dense':
        assert fused.routes_long(tm, T) == (kernel == 'K3')
    solver.reset_eager_counts()
    got = mt.batched_solve(cfg, torch.tensor(x0), cost, tm, u_lower=-box,
                           u_upper=box, device='cpu')
    assert solver.eager_counts['eager_solve'] == 0
    ref = j_batched_solve(_cfg(ns, nc, T, lqr_iter, eps, port=False),
                          jnp.asarray(x0),
                          JHuber(jnp.asarray(w), jnp.asarray(goal),
                                 jnp.asarray(DELTA)), jm,
                          u_lower=-box, u_upper=box)
    _rel(got.x, ref.x, tol, 'x')
    _rel(got.u, ref.u, tol, 'u')
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


def test_tails_full_starts_score_the_true_cost():
    """The line search scores the true cost (trouble 1 of the design):
    full +-pi starts and a goal far from x0 put every component in the
    linear tails, where the quadratic model and the cost part.  The plain
    K1 tracks the jnp path there, and its best cost is the true cost of
    its own trajectory."""
    T, B = 12, 8
    x0 = _pend_x0(B, 11)
    goal = np.array([-1., 0., 6., 0.])
    w = np.array([1., 1., .1, .01])
    cfg = _cfg(3, 1, T, 12, 1e-3)
    cost = pseudo_huber_from_numpy(w, goal, 0.3, device='cpu')
    dx = pendulum_from_numpy(PEND, device='cpu')
    got = mt.batched_solve(cfg, torch.tensor(x0), cost, dx, u_lower=-2.,
                           u_upper=2., device='cpu')
    ref = j_batched_solve(_cfg(3, 1, T, 12, 1e-3, port=False),
                          jnp.asarray(x0),
                          JHuber(jnp.asarray(w), jnp.asarray(goal),
                                 jnp.asarray(0.3)),
                          JPendulumDx(params=jnp.asarray(PEND)),
                          u_lower=-2., u_upper=2.)
    _rel(got.u, ref.u, SOLVE_TOL, 'u')
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    tau = torch.cat([got.x, got.u], -1)
    r = (tau - torch.tensor(goal)) / 0.3
    # most state components lie in the linear tails
    assert float((r[..., :3].abs() > 3.0).double().mean()) > 0.5
    true = cost(tau).sum(0)
    _rel(got.costs, true, 1e-12, 'best cost is the true cost')


# ---------------------------------------------------------------------------
# (3) the one interpret-mode comparison
# ---------------------------------------------------------------------------

def test_plain_k1_f32_matches_pallas_interpret():
    """tests/test_fused_soacost.py's unbounded problem (T=4, B=8, the
    pendulum from +-pi, w (1, 1, 0.1, 0.01), goal (1, 0, 0, 0), delta
    0.7) through the plain K1 in float32 against mpc_tpu's
    interpret-mode Pallas K1, with that test's tolerances: x and u 3e-5,
    the costs 1e-4, n_iter equal."""
    T, B = 4, 8
    th = np.pi * (2 * np.random.RandomState(0).rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1).astype(np.float32)
    w = np.array([1.0, 1.0, 0.1, 0.01], np.float32)
    goal = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    kw = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              backprop=False, linesearch_decay=0.2, max_linesearch_iter=2)
    ref = jfused.fused_batched_solve(
        mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF, **kw),
        jnp.asarray(x0), JHuber(jnp.asarray(w), jnp.asarray(goal),
                                jnp.asarray(0.7, jnp.float32)),
        JPendulumDx(params=jnp.asarray(PEND, jnp.float32)), interpret=True)
    got = mt.batched_solve(
        mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                     use_fused='always', **kw), torch.tensor(x0),
        pseudo_huber_from_numpy(w, goal, np.float32(0.7), device='cpu'),
        pendulum_from_numpy(PEND.astype(np.float32), device='cpu'),
        device='cpu')
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=3e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=3e-5)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               atol=1e-4)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


# ---------------------------------------------------------------------------
# (4) gradients through the kernel route
# ---------------------------------------------------------------------------

# (case, T, B, lqr_iter, eps, the backward): K1 then K2; a LinDx of 3
# states and 1 control (shared F) through K3 then K4; the 5-state,
# 2-control LinDx through the dense forward and the dense backward
GRADS = {
    'K1_K2': ('pendulum', 6, 4, 10, 1e-3, 'K2'),
    'K3_K4': ('lindx', 6, 4, 10, 1e-6, 'K4'),
    'dense_dense_bwd': ('lindx52', 5, 3, 10, 1e-6, 'dense'),
}


@pytest.mark.parametrize('case', list(GRADS))
def test_kernel_route_huber_gradients_match_jax(case):
    model, T, B, lqr_iter, eps, bwd = GRADS[case]
    jm, tm, x0, w0, goal0, box = _problem(model, T, B)
    ns, nc = x0.shape[1], len(w0) - x0.shape[1]
    wt = np.random.RandomState(12).randn(T, B, nc)
    kw = dict(backprop=True)

    def j_loss(w, goal, delta, x):
        s = j_batched_solve(_cfg(ns, nc, T, lqr_iter, eps, port=False, **kw),
                            x, JHuber(w, goal, delta), jm, u_lower=-box,
                            u_upper=box)
        return jnp.sum(wt * s.u) + 0.5 * jnp.sum(s.x ** 2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (w0, goal0, DELTA, x0)))
    # the backward that runs: K2 or K4 (routes_long) or the dense one
    assert fused_bwd.bwd_routes_dense(ns, nc) == (bwd == 'dense')
    if bwd != 'dense':
        # the LinDx's F is batch-shared: K4 reduces dF over the batch
        assert fused_bwd.bwd_routes_long(T, model == 'lindx') == (
            bwd == 'K4')
    w, goal, delta, x = (torch.tensor(a, requires_grad=True)
                         for a in (w0, goal0, np.array(DELTA), x0))
    cost = PseudoHuberCost(w, goal, delta)
    assert solver.wants_grad(_cfg(ns, nc, T, 1, 0.0, **kw), cost)
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(ns, nc, T, lqr_iter, eps, **kw), x, cost, tm,
                           u_lower=-box, u_upper=box, device='cpu')
    ((sol.u * torch.tensor(wt)).sum() + 0.5 * (sol.x ** 2).sum()).backward()
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for name, g, r in zip(('w', 'goal', 'delta', 'x_init'),
                          (w.grad, goal.grad, delta.grad, x.grad), ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        _rel(g, r, GRAD_TOL, name)


def _kkt_x_init_grad(C, F, pinned, r):
    """d (r . tau) / d x_init of the differential LQR problem of one
    example, by one dense solve of its KKT system in float64 (an oracle
    that shares no code with either backward): min 0.5 tau^T C tau over
    tau = (x, u) subject to x_0 = x_init, x_{t+1} = F_t tau_t and u_t = 0
    where ``pinned``.  The gradient is the multiplier of x_0 = x_init in
    the solve with right-hand side (r, 0)."""
    T, nt = C.shape[0], C.shape[-1]
    ns = F.shape[1]
    N = T * nt
    rows = []
    for t in range(T - 1):
        a = np.zeros((ns, N))
        a[:, (t + 1) * nt:(t + 1) * nt + ns] = np.eye(ns)
        a[:, t * nt:(t + 1) * nt] -= F[t]
        rows.append(a)
    a = np.zeros((ns, N))
    a[:, :ns] = np.eye(ns)
    rows.append(a)
    for t in np.nonzero(pinned)[0]:
        a = np.zeros((1, N))
        a[0, t * nt + ns] = 1.0
        rows.append(a)
    A = np.concatenate(rows)
    H = np.zeros((N, N))
    for t in range(T):
        H[t * nt:(t + 1) * nt, t * nt:(t + 1) * nt] = C[t]
    K = np.block([[H, A.T], [A, np.zeros((len(A), len(A)))]])
    y = np.linalg.solve(K, np.r_[r.reshape(-1), np.zeros(len(A))])
    return y[N + (T - 1) * ns:N + T * ns]


# config 3's cartpole (benchmarks/configs.py:173-202) with the pseudo-Huber
# cost of its QuadCost's diagonal and target: three of the seed-2 starts of
# chip_smoke.py's [grad-huber] row (B=512), whose controls sit in the
# cost's linear tails (H_uu ~1e-9) and on the box, so that the free
# control block's Q_uu falls to ~1e-7 at the horizon's end
CART_TAIL_STARTS = (150, 185, 417)


def test_dense_backward_is_the_exact_kkt_where_the_jnp_path_regularises(
        monkeypatch):
    """The x_init gradient of config 3's pseudo-Huber row through the
    dense backward (the kernel route's phase 2) against a direct KKT
    solve in float64, and against mpc_tpu's two backwards: its Pallas K2
    (interpret mode, float32) gives the KKT answer as the dense backward
    does, while its jnp fixed point, and the port's eager fixed point
    that copies it, solve the masked control block with 1e-11 added to
    its free diagonal (linalg.masked_free_matrix) and sit ~1e-4 of the
    gradient's scale off it here, in float64 too.  With that term set to
    0 the eager fixed point is the KKT answer.  Tolerances: 1e-9 for
    float64, BWD_TOL = 1e-4 (chip_smoke.py) for the float32 backwards."""
    from mpc_tpu.ops.diff import make_lqr_fixed_point as j_fixed_point
    from mpc_tpu.ops.fused_bwd import fused_kkt_backward
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd, linalg
    from mpc_tpu_torch.ops.diff import make_lqr_fixed_point
    from mpc_tpu_torch.solver import linearize_dynamics, quadratize_cost
    T, box = 25, 100.0
    th = 0.5 * (2 * np.random.RandomState(2).rand(512) - 1)[
        list(CART_TAIL_STARTS)]
    z = np.zeros(len(th))
    x0 = np.stack([z, z, np.cos(th), np.sin(th), z], 1)
    B = len(th)
    dx32 = cartpole_from_numpy(CART.astype(np.float32), 'cpu')
    w, goal = dx32.get_true_obj()[0].numpy(), np.r_[dx32.goal_state, 0.0]
    cfg = _cfg(5, 1, T, 10, 0.0, linesearch_decay=0.5, max_linesearch_iter=2)
    sol = mt.batched_solve(cfg, torch.tensor(x0, dtype=torch.float32),
                           pseudo_huber_from_numpy(
                               w, goal.astype(np.float32), np.float32(DELTA),
                               device='cpu'), dx32,
                           u_lower=-box, u_upper=box, device='cpu')

    def operands(dtype):
        xs, us = sol.x.to(dtype), sol.u.to(dtype)
        cost = pseudo_huber_from_numpy(w.astype(np.float64), goal, DELTA,
                                       device='cpu').to(dtype)
        C, _, _ = quadratize_cost(cost, xs, us)
        F, _ = linearize_dynamics(cartpole_from_numpy(CART, 'cpu').to(dtype),
                                  xs, us, mt.GradMethods.AUTO_DIFF)
        return dict(C=C.contiguous(), c=torch.zeros_like(C[..., 0]),
                    F=F.contiguous(), x_star=xs, u_star=us,
                    dl_dx=torch.zeros_like(xs), dl_du=2.0 * us / box ** 2,
                    I_mask=fused_bwd.active_set(us, -box, box))

    o64, o32 = operands(torch.float64), operands(torch.float32)
    r = torch.cat([o64['dl_dx'], o64['dl_du']], -1).numpy()
    kkt = np.stack([_kkt_x_init_grad(o64['C'][:, b].numpy(),
                                     o64['F'][:, b].numpy(),
                                     o64['I_mask'][:, b, 0].numpy() > 0.5,
                                     r[:, b]) for b in range(B)])
    dense64 = fbd.fused_kkt_backward_dense_plain(**o64, has_f=False)[0]
    dense32 = fbd.fused_kkt_backward_dense_plain(**o32, has_f=False)[0]
    _rel(dense64, kkt, 1e-9, 'dense backward f64 vs KKT')
    _rel(dense32.double(), kkt, 1e-4, 'dense backward f32 vs KKT')
    J = (lambda a: jnp.asarray(a.numpy()))
    k2 = fused_kkt_backward(5, *(J(o32[k]) for k in (
        'C', 'c', 'F', 'x_star', 'u_star', 'dl_dx', 'dl_du')),
        I_mask=J(o32['I_mask']), has_f=False, interpret=True)[0]
    _rel(np.asarray(k2, np.float64), kkt, 1e-4, 'mpc_tpu K2 f32 vs KKT')

    def eager():
        xi = torch.zeros(B, 5, dtype=torch.float64, requires_grad=True)
        lb = torch.full((T, B, 1), -box, dtype=torch.float64)
        _, u = make_lqr_fixed_point(5, True, False).apply(
            xi, o64['C'], o64['c'], o64['F'], None, lb, -lb, o64['x_star'],
            o64['u_star'])
        ((u / box) ** 2).sum().backward()
        return xi.grad

    jfp = j_fixed_point(5, True, False, precision='highest')
    jnp_path = np.stack([np.asarray(jax.grad(
        lambda xi, b=b: jnp.sum((jfp(xi, J(o64['C'][:, b]),
                                     J(o64['c'][:, b]), J(o64['F'][:, b]),
                                     jnp.zeros((T - 1, 5)),
                                     jnp.full((T, 1), -box),
                                     jnp.full((T, 1), box),
                                     J(o64['x_star'][:, b]),
                                     J(o64['u_star'][:, b]))[1] / box) ** 2))(
        jnp.zeros(5))) for b in range(B)])
    eager64 = eager()
    _rel(eager64, jnp_path, 1e-9, 'eager fixed point vs mpc_tpu jnp path')
    gap = np.abs(eager64.numpy() - kkt).max() / np.abs(kkt).max()
    assert gap > 1e-5, gap
    reg0 = linalg.masked_free_matrix
    monkeypatch.setattr(linalg, 'masked_free_matrix',
                        lambda H, free, clamped_diag=1.0, reg=0.0:
                        reg0(H, free, clamped_diag, 0.0))
    _rel(eager(), kkt, 1e-9, 'eager fixed point without the 1e-11 vs KKT')


# ---------------------------------------------------------------------------
# (5) routing
# ---------------------------------------------------------------------------

def test_routing_of_the_pseudo_huber_cost():
    huber4 = pseudo_huber_from_numpy(W4, GOAL4, DELTA, device='cpu')
    pend = pendulum_from_numpy(PEND, device='cpu')
    damped = pendulum_from_numpy(DAMPED, simple=False, device='cpu')
    cart = cartpole_from_numpy(CART, 'cpu')
    lin3 = lin_dx_from_numpy(_lindx(3, 1, 20, 1), None, 'cpu')
    lin52 = lin_dx_from_numpy(_lindx(5, 2, 20, 1), None, 'cpu')
    _, mlp, _, _, _, _ = _problem('mlp', 20, 2)
    huber6 = pseudo_huber_from_numpy(np.ones(6), np.zeros(6), DELTA,
                                     device='cpu')
    huber7 = pseudo_huber_from_numpy(np.ones(7), np.zeros(7), DELTA,
                                     device='cpu')
    # (problem, where it goes): K1 up to T_MAX, K3 past it and for a LinDx
    # and an MLP, the dense configuration's LinDx and model-step builds
    table = (
        (3, 1, 20, huber4, pend, 'K1'), (3, 1, 20, huber4, damped, 'K1'),
        (3, 1, fused.T_MAX, huber4, pend, 'K1'),
        (3, 1, fused.T_MAX + 1, huber4, pend, 'K3'),
        (3, 1, 20, huber4, lin3, 'K3'), (3, 1, 20, huber4, mlp, 'K3'),
        (5, 2, 20, huber7, lin52, 'dense'), (5, 1, 25, huber6, cart,
                                             'dense'))
    for ns, nc, T, cost, dyn, where in table:
        cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T)
        for dev in ('cpu', 'cuda'):
            assert fused.scope_gap(cfg, cost, dyn,
                                   device=torch.device(dev)) is None
        dense = fused.routes_dense(dyn, ns, nc)
        assert dense == (where == 'dense')
        if not dense:
            assert fused.routes_long(dyn, T) == (where == 'K3')
    # the cost build keeps the QuadCost build's geometry, so its horizon
    # limit is T_MAX too: H and g are computed in the Riccati step
    assert fused.T_MAX == 181
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=20)
    # a batched goal, a per-component delta, a plain callable cost and a
    # size mismatch: the eager solver, with the reason (a slew penalty is
    # refused before any route, below)
    batched = pseudo_huber_from_numpy(W4, np.tile(GOAL4, (4, 1)), DELTA,
                                      device='cpu')
    assert 'batched' in fused.scope_gap(cfg, batched, pend)
    assert 'callable cost' in fused.scope_gap(cfg, lambda tau: (tau ** 2)
                                              .sum(-1), pend)
    assert '6 components' in fused.scope_gap(cfg, huber6, pend)
    # 'always' solves each (the plain versions on the CPU), no eager solve
    x3 = torch.tensor(_pend_x0(2, 0), dtype=torch.float32)
    lin3 = lin_dx_from_numpy(_lindx(3, 1, 4, 1), None, 'cpu')
    lin52 = lin_dx_from_numpy(_lindx(5, 2, 4, 1), None, 'cpu')
    for ns, nc, T, cost, dyn, x0, box in (
            (3, 1, 4, huber4, pend, x3, 2.0),
            (3, 1, 4, huber4, lin3, x3, 2.0),
            (3, 1, 4, huber4, mlp, x3, 2.0),
            (5, 2, 4, huber7, lin52, torch.ones(2, 5), 1.0),
            (5, 1, 4, huber6, cart, torch.tensor(_problem('cartpole', 4, 2)[2],
                                                 dtype=torch.float32),
             100.0)):
        cost32 = PseudoHuberCost(*(a.float() for a in (cost.w, cost.goal,
                                                       cost.delta)))
        dyn32 = dyn.to(torch.float32) if isinstance(dyn, torch.nn.Module) \
            else mt.LinDx(dyn.F.float(), None)
        solver.reset_eager_counts()
        sol = mt.batched_solve(mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T,
                                            lqr_iter=2, use_fused='always'),
                               x0, cost32, dyn32, u_lower=-box, u_upper=box,
                               device='cpu')
        assert torch.isfinite(sol.u).all()
        assert solver.eager_counts['eager_solve'] == 0
    # outside the kernels: 'always' names the reason, a NotImplementedError
    # for the batched goal and a ValueError for the callable cost (mpc_tpu's
    # kernels refuse it too); under 'auto' the callable cost solves eagerly
    with pytest.raises(NotImplementedError, match='batched'):
        mt.batched_solve(mt.MPCConfig(n_state=3, n_ctrl=1, T=4,
                                      use_fused='always'), x3,
                         batched.float(), pend.to(torch.float32),
                         device='cpu')
    solver.reset_eager_counts()
    sol = mt.batched_solve(mt.MPCConfig(n_state=3, n_ctrl=1, T=4, lqr_iter=2),
                           x3, lambda tau: (tau ** 2).sum(-1),
                           pend.to(torch.float32), u_lower=-2., u_upper=2.,
                           device='cpu')
    assert solver.eager_counts['eager_solve'] == 1
    assert torch.isfinite(sol.u).all()
    with pytest.raises(ValueError, match='callable cost'):
        mt.batched_solve(mt.MPCConfig(n_state=3, n_ctrl=1, T=4,
                                      use_fused='always'), x3,
                         lambda tau: (tau ** 2).sum(-1),
                         pend.to(torch.float32), device='cpu')
    # the slew penalty with a non-quadratic cost stays an error
    with pytest.raises(NotImplementedError, match='slew'):
        mt.batched_solve(mt.MPCConfig(n_state=3, n_ctrl=1, T=4,
                                      slew_rate_penalty=0.5), x3,
                         huber4.float(), pend.to(torch.float32),
                         device='cpu')


# ---------------------------------------------------------------------------
# (6) export, the ops and the counts
# ---------------------------------------------------------------------------

def test_huber_solve_exports_as_one_kernel_node():
    T, B = 5, 3
    cfg = _cfg(3, 1, T, 3, 0.0)
    cost = pseudo_huber_from_numpy(W4, GOAL4, DELTA, device='cpu')
    dx = pendulum_from_numpy(PEND, device='cpu')
    x0 = torch.tensor(_pend_x0(B, 3))

    def solve(x):
        sol = mt.batched_solve(cfg, x, cost, dx, u_lower=-2., u_upper=2.,
                               device='cpu')
        return sol.x, sol.u, sol.costs

    data = ex.export_fn(solve, x0)
    assert ex.kernel_nodes(data) == {'k1_solve': 1}
    # export_solve stays QuadCost-only, as mpc_tpu's is
    with pytest.raises(ValueError, match='QuadCost'):
        ex.export_solve(cfg, dx, cost, x0, device='cpu')
    x1 = torch.tensor(_pend_x0(B, 4))
    out = ex.load_fn(data)(x1)
    assert all(torch.equal(a, b) for a, b in zip(out, solve(x1)))


def _k_args(T=3, B=2, seed=0):
    rng = np.random.RandomState(seed)
    t = (lambda a: torch.tensor(np.ascontiguousarray(a),
                                dtype=torch.float32))
    return (t(_pend_x0(B, seed)), t(0.3 * rng.randn(T, B)),
            -2 * torch.ones(T, 1), 2 * torch.ones(T, 1),
            t(np.r_[W4, GOAL4, DELTA]))


def test_opcheck_forward_ops_with_cost_params():
    x0, u0, lb, ub, cp = _k_args()
    kw = ([1.0, 0.2], 2, 0.0, 1e-4, 5.0)
    prm = torch.tensor(PEND, dtype=torch.float32)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k1_solve,
                          (prm, None, None, x0, u0, lb, ub, *kw, cp))
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3_solve,
                          (prm, None, None, None, None, x0, u0, lb, ub, *kw,
                           0, '', False, cp))
    T, B = u0.shape
    cp7 = torch.tensor(np.r_[np.ones(7), np.zeros(7), DELTA],
                       dtype=torch.float32)
    F = torch.tensor(_lindx(5, 2, T, 3)[:, None], dtype=torch.float32)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3d_solve,
                          (F, None, None, None, torch.ones(B, 5),
                           torch.zeros(T, B, 2), -torch.ones(T, 1, 2),
                           torch.ones(T, 1, 2), *kw, 20, '', False, None,
                           cp7))
    # the op's plain version on the CPU is the plain K1's, bitwise
    a = torch.ops.mpc_tpu_torch.k1_solve(prm, None, None, x0, u0, lb, ub,
                                         *kw, cp)
    ref = fused.fused_solve_plain(
        pendulum_from_numpy(PEND.astype(np.float32), device='cpu'), prm,
        None, None, x0, u0, lb, ub, alphas=kw[0], lqr_iter=2, eps=0.0,
        best_cost_eps=1e-4, not_improved_lim=5.0, cost_params=cp)
    assert all(torch.equal(p, q) for p, q in zip(a, ref))
    with pytest.raises(ValueError, match='not both'):
        from mpc_tpu_torch.ops import custom
        custom._check_cost('K1', torch.zeros(3, 1, 4, 4), None, cp, 4)


def test_huber_operation_counts_and_bytes():
    """The cost build's counts replace the QuadCost's stage cost and
    C tau + c by the pseudo-Huber terms and quadratisation
    (fused.cost_op_counts, from csrc/cost.cuh, with w delta and w delta^2
    formed once a launch: fused.cost_setup_ops); its bytes read the
    parameter vector in place of C and c."""
    assert fused.cost_op_counts(4, True) == (4 * 7 + 3, 4 * 10)
    assert fused.cost_op_counts(4, False) == (40, 32)
    assert fused.cost_setup_ops(4, True) == 8
    assert fused.cost_setup_ops(4, False) == 0
    T, it, na, B = 20, 6, 9, 2
    quad = fused.k1_flops(T, 3, 1, it, na, batch=B)
    hub = fused.k1_flops(T, 3, 1, it, na, batch=B, huber=True)
    stage = (31 - 40) * (B * T + na * T)
    cb = (40 - 32) * it * T
    assert hub - quad == stage + cb + 8
    assert fused.k3_flops(T, 3, 1, it, na, huber=True) - fused.k3_flops(
        T, 3, 1, it, na) == (31 - 40) * (T + na * T) + cb + 8
    nt = 7
    s_q, c_q = fused.cost_op_counts(nt, False)
    s_h, c_h = fused.cost_op_counts(nt, True)
    assert fd.k3d_flops(T, 5, 2, it, na, huber=True) - fd.k3d_flops(
        T, 5, 2, it, na) == ((s_h - s_q) * (T + na * T) + (c_h - c_q) * it * T
                             + 2 * nt)
    cfg = _cfg(3, 1, T, it, 0.0)
    x0 = torch.tensor(_pend_x0(B, 0), dtype=torch.float32)
    dx = pendulum_from_numpy(PEND.astype(np.float32), device='cpu')
    oq = fused.k1_operands(cfg, x0, mt.QuadCost(torch.eye(4), torch.zeros(4)),
                           dx, u_lower=-2., u_upper=2.)
    oh = fused.k1_operands(cfg, x0, pseudo_huber_from_numpy(
        W4.astype(np.float32), GOAL4.astype(np.float32), np.float32(DELTA),
        device='cpu'), dx, u_lower=-2., u_upper=2.)
    assert oh['C'] is None and oh['c'] is None
    assert fused.k1_bytes(oq) - fused.k1_bytes(oh) == 4 * (T * 20 - 9)
