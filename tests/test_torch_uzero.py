"""Controls pinned to zero (``u_zero_I``) and the trust region
``delta_u`` inside the kernels, on the CPU against mpc_tpu: K1, K3 and
K3's dense configuration in their MPC_HAS_UZ builds and with a run-time
delta_u, through their plain versions.

- (1) the plain K1 in float32 against mpc_tpu's interpret-mode Pallas K1
  on tests/test_fused.py's three problems (an unbounded solve with a
  shared mask, a bounded one with a batched mask, a bounded one under
  delta_u = 0.3): x and u within 3e-5, the costs 1e-4, n_iter equal
  (the tolerances of tests/test_torch_huber.py's interpret-mode
  comparison: float32 reassociation between two implementations);
- (2) whole solves on the kernel route (the plain K3 and dense versions)
  against ``mpc_tpu.learning.batched_solve(use_fused='never')`` in
  float64: x and u within SOLVE_TOL relative, n_iter equal, pinned
  controls exactly 0.0.  The jnp path's masked solve adds 1e-11 to the
  masked block's diagonal (``masked_free_matrix``, mpc_tpu/ops/
  linalg.py:155-173) and its box QP's Hessian where the kernels' factors
  have none, so a masked unbounded step differs by about 1e-11 /
  lambda_min(Quu) relative (lambda_min >= 0.01 in these problems: 1e-9),
  and the box QP's stop (step norm < 1e-4) moves with it; the
  iterations carry both on.  1e-8 holds that with room.  Measured: u
  within 1.4e-13 to 3.9e-12 relative (the 3-state LinDx in K3 and the
  unbounded 3-state, 4-control one), 8.6e-12 (slew), 2.4e-9 (the MLP),
  2.6e-9 and 6.9e-9 (the bounded multi-control rows);
- (3) one iteration from a warm start moves no control by more than
  delta_u, in each kernel;
- (4) the route: each problem takes one kernel call and no eager solve;
  delta_u without bounds stays outside the kernels (a ValueError under
  'always', as in mpc_tpu);
- (5) gradients of a masked (and of a trust-region) differentiable solve
  through the kernel route (the plain K1 then the plain K2; the dense
  forward then the dense backward) against ``jax.grad`` of mpc_tpu's
  ``batched_solve`` in float64, within GRAD_TOL relative: phase 2 takes
  neither the mask nor delta_u on either side;
- the ops' schemas with the mask and delta_u (opcheck) and the operation
  counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused, fused_dense as fd
from mpc_tpu_torch.utils.convert import (lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy)
from mpc_tpu_torch.utils.problems import hw_sweep_delta_u

from test_torch_models import both_mlps, mlp_params

jax.config.update('jax_enable_x64', True)

PEND = np.array([10., 1., 1.])
SOLVE_TOL = 1e-8
GRAD_TOL = 1e-7
DELTA = 0.3


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


def _pendulum(T, B, bounded, dtype=np.float32, seed=0):
    """tests/test_fused.py's pendulum problem: starts from +-pi, the
    true cost batched, box +-2."""
    th = np.pi * (2 * np.random.RandomState(seed).rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1).astype(dtype)
    q, p = JPendulumDx().get_true_obj()
    C = np.broadcast_to(np.diag(np.asarray(q)), (T, B, 4, 4)).astype(dtype)
    c = np.broadcast_to(np.asarray(p), (T, B, 4)).astype(dtype)
    box = (np.full((T, B, 1), -2.0, dtype), np.full((T, B, 1), 2.0, dtype)) \
        if bounded else (None, None)
    return x0, C, c, box


def _lindx(T, B, ns, nc, seed, batched=False):
    """A LinDx of ns states and nc controls: F near the identity with a
    random input block, C = R R^T + I batched or shared, c random."""
    rng = np.random.RandomState(seed)
    nt = ns + nc
    A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
    F = np.concatenate([np.tile(A, (T - 1, 1, 1)),
                        0.4 * rng.randn(T - 1, ns, nc)], 2)
    R = 0.3 * rng.randn(T, nt, nt)
    C = np.einsum('tij,tkj->tik', R, R) + np.eye(nt)
    c = rng.randn(T, nt)
    if batched:
        C = C[:, None] + 0.01 * np.eye(nt) * rng.rand(T, B, 1, 1)
        c = c[:, None] + 0.1 * rng.randn(T, B, nt)
    return F, C, c, rng.randn(B, ns)


def _cfg(ns, nc, T, port=True, **kw):
    base = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=4, eps=1e-6,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=3)
    base.update(kw)
    if port:
        if 'grad_method' in base:
            base['grad_method'] = getattr(mt.GradMethods,
                                          base['grad_method'].name)
        return mt.MPCConfig(**base)
    return mpc_tpu.MPCConfig(**dict(base, use_fused='never'))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


class _Calls:
    """Counts the calls of the three kernels' wrappers (on the CPU their
    plain versions run; fused.launch_counts counts launches on the card
    alone)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for mod, name in ((fused, 'fused_ilqr'), (fused, 'fused_ilqr_long'),
                          (fd, 'fused_ilqr_dense')):
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **k)
        return call


# ---------------------------------------------------------------------------
# (1) the plain K1 against mpc_tpu's interpret-mode Pallas K1
# ---------------------------------------------------------------------------

# (T, B, bounded, mask, delta_u): tests/test_fused.py:150-222
K1_PALLAS = {
    'unbounded_shared_mask': (4, 8, False, 'shared', None),
    'bounded_batched_mask': (5, 16, True, 'batched', None),
    'bounded_delta_u': (5, 16, True, None, DELTA),
}


@pytest.mark.parametrize('case', list(K1_PALLAS))
def test_plain_k1_f32_matches_pallas_interpret(case, monkeypatch):
    T, B, bounded, mask, delta = K1_PALLAS[case]
    x0, C, c, (lb, ub) = _pendulum(T, B, bounded)
    uz = None
    if mask == 'shared':
        uz = np.zeros((T, 1), bool)
        uz[1, 0] = True
    elif mask == 'batched':
        uz = np.random.RandomState(3).rand(T, B, 1) < 0.3
    kw = dict(lqr_iter=2, eps=0.0, max_linesearch_iter=2, delta_u=delta,
              grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    ref = jfused.fused_batched_solve(
        _cfg(3, 1, T, port=False, **kw), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        JPendulumDx(params=jnp.asarray(PEND, jnp.float32)),
        u_lower=_j(lb), u_upper=_j(ub), u_zero_I=_j(uz), interpret=True)
    calls = _Calls(monkeypatch)
    solver.reset_eager_counts()
    got = mt.batched_solve(
        dataclasses.replace(_cfg(3, 1, T, **kw), use_fused='always'),
        torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
        pendulum_from_numpy(PEND.astype(np.float32), device='cpu'),
        u_lower=_t(lb), u_upper=_t(ub), u_zero_I=_t(uz), device='cpu')
    assert calls.n == {'fused_ilqr': 1}
    assert solver.eager_counts['eager_solve'] == 0
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=3e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=3e-5)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               atol=1e-4)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    if uz is not None:
        pinned = torch.tensor(np.broadcast_to(
            uz if uz.ndim == 3 else uz[:, None], (T, B, 1)).copy())
        assert float(got.u[pinned].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (2) whole solves on the kernel route against the jnp path, float64
# ---------------------------------------------------------------------------

def _solve_case(case):
    """The problem of a SOLVES case: cfg keywords, the model ('lindx' or
    'pendulum'), F, C, c, x0, bounds, mask, prev_ctrl, and the kernel
    wrapper its route calls."""
    p = dict(kw={}, model='lindx', F=None, C=None, c=None, lb=None,
             ub=None, uz=None, pc=None, kernel='fused_ilqr_dense')
    if case.startswith('k3_') and case != 'k3_mlp_mask':
        T, B = 8, 6
        p['F'], p['C'], p['c'], p['x0'] = _lindx(T, B, 3, 1, seed=5,
                                                 batched=True)
        p.update(lb=-0.6, ub=0.6, kernel='fused_ilqr_long')
        if case == 'k3_delta_u':
            p['kw'] = dict(delta_u=DELTA)
        else:
            p['uz'] = np.random.RandomState(2).rand(T, B, 1) < 0.3
        if case == 'k3_mask_unbounded':
            p.update(lb=None, ub=None)
    elif case == 'dense_mask_multictrl':
        # tests/test_fused.py:224-240's configuration: 3 states, 4
        # controls, unbounded, a shared mask pinning two entries
        T = 4
        p['F'], p['C'], p['c'], p['x0'] = _lindx(T, 8, 3, 4, seed=7)
        p['uz'] = np.zeros((T, 4), bool)
        p['uz'][0, 1] = p['uz'][2, 3] = True
    elif case == 'dense_batched_mask_box':
        T, B = 5, 8
        p['F'], p['C'], p['c'], p['x0'] = _lindx(T, B, 3, 4, seed=8,
                                                 batched=True)
        p.update(lb=-0.5, ub=0.5, kw=dict(pnqp_iter=20),
                 uz=np.random.RandomState(4).rand(T, B, 4) < 0.3)
    elif case == 'dense_sweep_delta_u':
        # hw_sweep's 8 iterations cut to 2: past them the box QP's stop
        # (step norm < 1e-4) parts the trip counts at round-off ties, with
        # or without delta_u, and the eager route, which copies the jnp
        # path's arithmetic, parts from it too (measured at 8 iterations:
        # the kernel route 4.6e-8 relative, the eager route 1.9e-9)
        p['F'], p['C'], p['c'], p['x0'], p['lb'], p['ub'] = \
            hw_sweep_delta_u(8, 6)
        p['kw'] = dict(delta_u=DELTA, pnqp_iter=20, lqr_iter=2)
    elif case == 'k3_mlp_mask':
        # K3's MLP configuration (8 hidden units) with a shared mask
        T, B = 6, 5
        p['x0'] = _pendulum(T, B, False, np.float64, seed=9)[0]
        uz = np.zeros((T, 1), bool)
        uz[2:4, 0] = True
        p.update(model='mlp', lb=-2.0, ub=2.0, uz=uz,
                 kernel='fused_ilqr_long', kw=dict(T=T, eps=1e-4,
                                                   lqr_iter=6))
    else:
        # the headline pendulum under a slew penalty with a batched mask
        # and the box: the dense configuration's model-step build
        T, B = 6, 6
        p['x0'] = _pendulum(T, B, False, np.float64, seed=4)[0]
        p.update(model='pendulum', lb=-2.0, ub=2.0,
                 uz=np.random.RandomState(5).rand(T, B, 1) < 0.3,
                 pc=0.1 * np.random.RandomState(6).randn(B, 1),
                 kw=dict(slew_rate_penalty=0.5, eps=1e-3, T=T,
                         grad_method=mpc_tpu.GradMethods.AUTO_DIFF))
    return p


SOLVES = ['k3_batched_mask', 'k3_mask_unbounded', 'k3_delta_u',
          'k3_mlp_mask', 'dense_mask_multictrl', 'dense_batched_mask_box',
          'dense_sweep_delta_u', 'slew_mask']


def _bound(b, conv):
    return b if b is None or np.isscalar(b) else conv(b)


@pytest.mark.parametrize('case', SOLVES)
def test_kernel_route_solves_match_jnp_path(case, monkeypatch):
    p = _solve_case(case)
    x0, uz, kw = p['x0'], p['uz'], dict(p['kw'])
    ns = x0.shape[1]
    if p['model'] in ('pendulum', 'mlp'):
        nc, T = 1, kw.pop('T')
        if p['model'] == 'mlp':
            jdyn, tdyn = both_mlps(mlp_params((8,), seed=3), 'sigmoid')
        else:
            jdyn = JPendulumDx(params=jnp.asarray(PEND))
            tdyn = pendulum_from_numpy(PEND, device='cpu')
        q, c = (np.asarray(a) for a in JPendulumDx().get_true_obj())
        C = np.diag(q)
    else:
        F, C, c = p['F'], p['C'], p['c']
        nc, T = F.shape[-1] - ns, C.shape[0]
        jdyn = mpc_tpu.LinDx(jnp.asarray(F), None)
        tdyn = lin_dx_from_numpy(F, None, 'cpu')
    ref = j_batched_solve(
        _cfg(ns, nc, T, port=False, **kw), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)), jdyn,
        u_lower=_bound(p['lb'], _j), u_upper=_bound(p['ub'], _j),
        u_zero_I=_j(uz), prev_ctrl=_j(p['pc']))
    calls = _Calls(monkeypatch)
    solver.reset_eager_counts()
    got = mt.batched_solve(
        _cfg(ns, nc, T, **kw), torch.tensor(x0),
        quad_cost_from_numpy(C, c, 'cpu'), tdyn,
        u_lower=_bound(p['lb'], _t), u_upper=_bound(p['ub'], _t),
        u_zero_I=_t(uz), prev_ctrl=_t(p['pc']), device='cpu')
    assert calls.n == {p['kernel']: 1}
    assert solver.eager_counts['eager_solve'] == 0
    _rel(got.u, ref.u, SOLVE_TOL, 'u')
    _rel(got.x, ref.x, SOLVE_TOL, 'x')
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    if uz is not None:
        pinned = np.broadcast_to(uz if uz.ndim == 3 else uz[:, None],
                                 got.u.shape)
        assert float(got.u[torch.tensor(pinned.copy())].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (3) the trust region bounds each iteration's step
# ---------------------------------------------------------------------------

def _warm_problem(kernel):
    """(cfg, x0, cost, dynamics, bounds, u_init) in float64 for a kernel:
    the pendulum (K1), a 3-state LinDx (K3), a 3-state 4-control LinDx
    (dense; tests/test_lqr_linear.py:102-117's sizes, its random box);
    the warm start inside the box."""
    rng = np.random.RandomState(8)
    T, B = 5, 4
    if kernel == 'fused_ilqr':
        x0 = _pendulum(T, B, False, np.float64, seed=1)[0]
        dyn = pendulum_from_numpy(PEND, device='cpu')
        q, c = (np.asarray(a) for a in JPendulumDx().get_true_obj())
        C, nc, lb, ub = np.diag(q), 1, -2.0, 2.0
    else:
        nc = 1 if kernel == 'fused_ilqr_long' else 4
        F, C, c, x0 = _lindx(T, B, 3, nc, seed=9)
        dyn = lin_dx_from_numpy(F, None, 'cpu')
        lb, ub = -rng.rand(T, B, nc), rng.rand(T, B, nc)
    u0 = np.clip(rng.randn(T, B, nc), lb, ub)
    cfg = _cfg(3, nc, T, lqr_iter=1, delta_u=0.1, pnqp_iter=20)
    return (cfg, torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'), dyn,
            dict(u_lower=_bound(lb, _t), u_upper=_bound(ub, _t)),
            torch.tensor(u0))


@pytest.mark.parametrize('kernel', ['fused_ilqr', 'fused_ilqr_long',
                                    'fused_ilqr_dense'])
def test_one_iteration_moves_no_control_past_delta_u(kernel, monkeypatch):
    """After one iteration from a warm start inside the box, |u - u_init|
    <= delta_u (reference tests/test_mpc.py:197-240, the JAX package's
    tests/test_lqr_linear.py:102-117), up to the rounding of u_init +-
    delta_u; and the controls stay in the box."""
    cfg, x0, cost, dyn, bk, u0 = _warm_problem(kernel)
    calls = _Calls(monkeypatch)
    sol = mt.batched_solve(cfg, x0, cost, dyn, u_init=u0, device='cpu',
                           **bk)
    assert calls.n == {kernel: 1}
    step = (sol.u - u0).abs()
    assert float(step.max()) <= 0.1 * (1 + 1e-12)
    assert float(step.max()) > 0.05           # the region does bind
    lo = torch.as_tensor(bk['u_lower']).expand_as(sol.u)
    hi = torch.as_tensor(bk['u_upper']).expand_as(sol.u)
    assert bool(((sol.u >= lo) & (sol.u <= hi)).all())


# ---------------------------------------------------------------------------
# (4) routing
# ---------------------------------------------------------------------------

def test_scope_admits_masks_and_trust_regions():
    """scope_gap takes a [T, nc] or [T, B, nc] mask and delta_u with
    bounds in every kernel; delta_u without bounds and a mask of another
    rank stay outside (as mpc_tpu/ops/fused.py:211-214), and 'always'
    raises a ValueError for the former, as mpc_tpu does."""
    T = 5
    cost = quad_cost_from_numpy(np.eye(4), np.zeros(4), 'cpu')
    pend = pendulum_from_numpy(PEND, device='cpu')
    lin = lin_dx_from_numpy(np.zeros((T - 1, 3, 4)), None, 'cpu')
    cfg = _cfg(3, 1, T)
    for dyn in (pend, lin):
        for uz in (torch.zeros(T, 1), torch.zeros(T, 6, 1, dtype=torch.bool)):
            assert fused.scope_gap(cfg, cost, dyn, u_zero_I=uz) is None
        assert fused.scope_gap(dataclasses.replace(cfg, delta_u=0.1), cost,
                               dyn, u_lower=-1.0) is None
        assert 'bounds' in fused.scope_gap(
            dataclasses.replace(cfg, delta_u=0.1), cost, dyn)
        assert 'u_zero_I' in fused.scope_gap(cfg, cost, dyn,
                                             u_zero_I=torch.zeros(T))
        # a trust region that is not finite and positive in float32 stays
        # on the eager route under 'auto' (the launchers refuse it)
        for d in (0.0, -0.1, float('nan'), float('inf'), 1e-50):
            assert 'finite and positive' in fused.scope_gap(
                dataclasses.replace(cfg, delta_u=d), cost, dyn,
                u_lower=-1.0)
    with pytest.raises(ValueError, match='always'):
        mt.batched_solve(dataclasses.replace(cfg, delta_u=0.1,
                                             use_fused='always'),
                         torch.zeros(2, 3), cost, pend, device='cpu')
    # the plain versions refuse a trust region without a box too
    ops = fused.k1_operands(cfg, torch.zeros(2, 3), cost, pend)
    with pytest.raises(ValueError, match='bounds'):
        fused.fused_solve_plain(**dict(ops, delta_u=0.1))


def test_zero_trust_region_solves_eagerly(monkeypatch):
    """delta_u = 0 with bounds is outside the kernels' scope: under 'auto'
    the solve runs on the eager solver, no kernel wrapper is called and
    nothing raises; under 'always' it is the NotImplementedError of a
    problem that mpc_tpu's kernels take (their trust region is a baked-in
    constant of any value) and the port's do not."""
    T = 5
    x0, C, c, _ = _pendulum(T, 2, False)
    cfg = _cfg(3, 1, T, lqr_iter=1, delta_u=0.0)
    args = (torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
            pendulum_from_numpy(PEND.astype(np.float32), device='cpu'))
    calls = _Calls(monkeypatch)
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, *args, u_lower=-2.0, u_upper=2.0,
                           device='cpu')
    assert calls.n == {}
    assert solver.eager_counts['eager_solve'] == 1
    assert torch.isfinite(sol.u).all()
    with pytest.raises(NotImplementedError, match='finite and positive'):
        mt.batched_solve(dataclasses.replace(cfg, use_fused='always'),
                         *args, u_lower=-2.0, u_upper=2.0, device='cpu')


def test_mask_operands_keep_their_layout():
    """A shared mask keeps a batch extent of 1 (batch stride 0 in the
    kernels), a batched one its B; bool or 0/1, cast to the dtype; the
    trust region reaches the kernels as its float32 value."""
    T, B = 4, 3
    cost = quad_cost_from_numpy(np.eye(4), np.zeros(4), 'cpu')
    pend = pendulum_from_numpy(PEND.astype(np.float32), device='cpu')
    x0 = torch.zeros(B, 3)
    cfg = _cfg(3, 1, T, delta_u=0.3)
    shared = fused.k1_operands(cfg, x0, cost, pend, u_lower=-1., u_upper=1.,
                               u_zero_I=torch.tensor([[0], [1], [0], [1]]))
    assert shared['uz'].shape == (T, 1) and shared['uz'].dtype == x0.dtype
    assert shared['uz'][:, 0].tolist() == [0., 1., 0., 1.]
    assert shared['delta_u'] == float(np.float32(0.3))
    batched = fd.k3d_operands(
        _cfg(3, 2, T), x0, quad_cost_from_numpy(np.eye(5), np.zeros(5),
                                                'cpu'),
        lin_dx_from_numpy(np.zeros((T - 1, 3, 5)), None, 'cpu'),
        u_zero_I=torch.ones(T, B, 2, dtype=torch.bool))
    assert batched['uz'].shape == (T, B, 2) and batched['delta_u'] is None
    assert fused.k1_operands(_cfg(3, 1, T), x0, cost, pend)['uz'] is None


# ---------------------------------------------------------------------------
# (5) gradients through the kernel route
# ---------------------------------------------------------------------------

# (case, model, T, B, lqr_iter, eps, the forward and backward that run)
GRADS = {
    'K1_K2_mask': ('pendulum', 6, 4, 10, 1e-3, 'mask', 'fused_ilqr'),
    'K1_K2_delta_u': ('pendulum', 6, 4, 10, 1e-3, 'delta_u', 'fused_ilqr'),
    'dense_mask': ('lindx', 5, 3, 6, 1e-6, 'mask', 'fused_ilqr_dense'),
}


@pytest.mark.parametrize('case', list(GRADS))
def test_kernel_route_gradients_match_jax(case, monkeypatch):
    """d loss / d (x_init, c) of a masked or trust-region differentiable
    solve through the kernel route (the plain K1 then the plain K2; the
    dense forward then the dense backward) against jax.grad of mpc_tpu's
    batched_solve (its jnp path) in float64: phase 2 takes neither the
    mask nor delta_u on either side, so the gradients are those of the
    box's active set at the solution."""
    model, T, B, lqr_iter, eps, opt, kernel = GRADS[case]
    rng = np.random.RandomState(12)
    if model == 'pendulum':
        x0 = _pendulum(T, B, False, np.float64, seed=2)[0]
        q, c0 = (np.asarray(a) for a in JPendulumDx().get_true_obj())
        C, ns, nc = np.diag(q), 3, 1
        jdyn = JPendulumDx(params=jnp.asarray(PEND))
        tdyn = pendulum_from_numpy(PEND, device='cpu')
        box = 2.0
    else:
        F, C, c0, x0 = _lindx(T, B, 3, 2, seed=13)
        ns, nc, box = 3, 2, 0.8
        jdyn = mpc_tpu.LinDx(jnp.asarray(F), None)
        tdyn = lin_dx_from_numpy(F, None, 'cpu')
    uz = rng.rand(T, B, nc) < 0.3 if opt == 'mask' else None
    kw = dict(lqr_iter=lqr_iter, eps=eps, backprop=True,
              delta_u=0.5 if opt == 'delta_u' else None,
              grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    wt = rng.randn(T, B, nc)

    def j_loss(c, x):
        s = j_batched_solve(_cfg(ns, nc, T, port=False, **kw), x,
                            mpc_tpu.QuadCost(jnp.asarray(C), c), jdyn,
                            u_lower=-box, u_upper=box, u_zero_I=_j(uz))
        return jnp.sum(wt * s.u) + 0.5 * jnp.sum(s.x ** 2)
    ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(c0), jnp.asarray(x0))
    c, x = (torch.tensor(a, requires_grad=True) for a in (c0, x0))
    calls = _Calls(monkeypatch)
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(ns, nc, T, **kw), x,
                           mt.QuadCost(torch.tensor(C), c), tdyn,
                           u_lower=-box, u_upper=box, u_zero_I=_t(uz),
                           device='cpu')
    ((sol.u * torch.tensor(wt)).sum() + 0.5 * (sol.x ** 2).sum()).backward()
    assert calls.n == {kernel: 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for name, g, r in zip(('c', 'x_init'), (c.grad, x.grad), ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        _rel(g, r, GRAD_TOL, name)


# ---------------------------------------------------------------------------
# the ops' schemas and the operation counts
# ---------------------------------------------------------------------------

def test_opcheck_forward_ops_with_mask_and_trust_region():
    """The three forward ops with ``uz`` and ``delta_u`` at the end of
    their schemas (fake and CPU implementations agree, the schema holds),
    and without them as before."""
    T, B = 3, 4
    rng = np.random.RandomState(0)
    f32 = (lambda a: torch.tensor(np.asarray(a), dtype=torch.float32))
    th = rng.uniform(-1, 1, B)
    x0 = f32(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1))
    u0, C, c = f32(np.zeros((T, B))), f32(np.tile(np.eye(4), (T, 1, 1, 1))), \
        f32(np.zeros((T, 1, 4)))
    lb, ub = f32(-np.ones((T, 1))), f32(np.ones((T, 1)))
    uz = f32(rng.rand(T, B) < 0.5)
    kw = ([1.0, 0.2], 2, 0.0, 1e-4, 5.0)
    prm = f32(PEND)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k1_solve,
                          (prm, C, c, x0, u0, lb, ub, *kw, None, uz, 0.3))
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3_solve,
                          (prm, None, None, C, c, x0, u0, lb, ub, *kw,
                           0, '', False, None, uz[:, :1].contiguous(),
                           None))
    F = f32(np.tile(np.concatenate([np.eye(3), np.ones((3, 2))], 1),
                    (T - 1, 1, 1, 1)))
    C5, c5 = f32(np.tile(np.eye(5), (T, 1, 1, 1))), f32(np.zeros((T, 1, 5)))
    uz2 = f32(rng.rand(T, B, 2) < 0.5)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3d_solve,
                          (F, None, C5, c5, x0, f32(np.zeros((T, B, 2))),
                           None, None, *kw, 5, '', False, None, None, uz2,
                           None))


def test_mask_and_trust_region_operation_counts():
    """Each kernel's bound counts the trust region's arithmetic, u - delta
    and u + delta in every trial step, and nothing for the mask's selects
    or the trust region's max and min; the dense configuration's masked
    factor drops the jitter; a shared mask's bytes count once."""
    assert fused.trust_ops(1, False) == 0 and fused.trust_ops(2, True) == 4
    base = fused.k1_flops(20, 3, 1, 10, 12, batch=4)
    # per trial: T rollout steps of 2 operations
    assert fused.k1_flops(20, 3, 1, 10, 12, batch=4, delta_u=True) \
        - base == 12 * 20 * 2
    assert fused.k3_flops(20, 3, 1, 10, 12, delta_u=True) \
        - fused.k3_flops(20, 3, 1, 10, 12) == 12 * 20 * 2
    d0 = fd.k3d_flops(20, 3, 4, 10, 12, has_bounds=False)
    # the masked factor drops the jitter's 4 additions a step
    assert d0 - fd.k3d_flops(20, 3, 4, 10, 12, has_bounds=False,
                             uz=True) == 10 * 20 * 4
    for nc in (1, 4):
        for bounds in (True, False):
            assert fd.k3d_flops(20, 3, nc, 10, 12, has_bounds=bounds,
                                uz=nc == 1) == fd.k3d_flops(
                20, 3, nc, 10, 12, has_bounds=bounds)
    assert fd.k3d_flops(20, 3, 4, 10, 12, delta_u=True) \
        - fd.k3d_flops(20, 3, 4, 10, 12) == 12 * 20 * 8
    cost = quad_cost_from_numpy(np.eye(4), np.zeros(4), 'cpu')
    pend = pendulum_from_numpy(PEND.astype(np.float32), device='cpu')
    cfg = _cfg(3, 1, 20)
    x0 = torch.zeros(8, 3)
    plain = fused.k1_bytes(fused.k1_operands(cfg, x0, cost, pend))
    shared = fused.k1_bytes(fused.k1_operands(
        cfg, x0, cost, pend, u_zero_I=torch.zeros(20, 1)))
    batched = fused.k1_bytes(fused.k1_operands(
        cfg, x0, cost, pend, u_zero_I=torch.zeros(20, 8, 1)))
    assert (shared - plain, batched - plain) == (20 * 4, 20 * 8 * 4)
