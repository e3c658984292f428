"""The port's streaming solve (the plain PyTorch version of kernel K3,
which the CPU path runs) and its LinDx front end against the JAX package.

- float64: ``batched_solve(device="cpu")`` against mpc_tpu's jnp solver
  (``use_fused='never'``) on a stable LinDx box problem, F shared or
  batched, with and without f, on x, u, costs, full_du_norm, n_iter and
  n_qp_iter.  Tolerance 1e-8 (measured 1e-14: the problem is linear, so
  the two differ only in the order of their sums); alpha is compared
  where the full step exceeds 1e-6, as in tests/test_torch_fused.py.
  The pendulum past K1's horizon (T = T_MAX + 4) against the same jnp
  path, 1e-6 absolute plus 1e-6 relative (the full-step norms are ~30):
  two unconverged iterations over 260 steps of the pendulum
  amplify the ~1e-15 differences of the two Jacobians (autodiff of the
  atan2 step there, hand-written here) to 3.1e-8 in u, where the short
  horizons of tests/test_torch_fused.py reach 3.2e-9.
- float32: against the streaming Pallas kernel in interpret mode on the
  problem of tests/test_fused_stream.py::test_streamed_cost_lindx_matches_jnp
  (T=140, B=16, per-example cost; the same calls, so the persistent
  compile cache is shared) with that test's tolerances: u atol 5e-5,
  costs rtol 1e-5.
- layouts, batch reversal and a ragged batch on the port alone: examples
  are independent and every leaf is read with its own batch stride, so
  these are bitwise.
- the LinDx pieces of the front end: ``lin_dx_from_numpy``, ``rollout``
  and ``linearize_dynamics`` against mpc_tpu's (1e-12, float64), ``MPC``
  with [T, ...] time dims against ``mpc_tpu.MPC`` (1e-8), the routing
  predicate and the kernels' scope; LinDx problems on the eager solver
  (use_fused='never', with n_ctrl > 1, u_zero_I and delta_u, which the
  kernels take under 'auto'; float64 by both routes) against mpc_tpu's
  jnp path (1e-10).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.ops.fused import fused_batched_solve as j_fused_batched_solve
from mpc_tpu.solver import (linearize_dynamics as j_linearize_dynamics,
                            rollout as j_rollout)

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.solver import linearize_dynamics, rollout
from mpc_tpu_torch.utils.convert import (lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy,
                                         solution_to_numpy)

FIELDS = ('x', 'u', 'costs', 'full_du_norm', 'n_iter', 'n_qp_iter')
PARAMS = np.array([10., 1., 1.])


def _cfg_kw(T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2,
                max_linesearch_iter=3)
    base.update(kw)
    return base


def _lindx_problem(T, B, batched, has_f, seed=5, dtype=np.float64):
    """The long-horizon imitation configuration's system
    (benchmarks/configs.py:341-351: A = I, A[0,1] = 0.01, B = 0.01,
    C = diag(1, 1, 0.1, 0.01)) perturbed so that no entry of F is
    special, a random linear cost term, and f."""
    rng = np.random.RandomState(seed)
    A = np.eye(3)
    A[0, 1] = 0.01
    F = np.tile(np.concatenate([A, 0.01 * np.ones((3, 1))], 1),
                (T - 1, 1, 1)) + 0.05 * rng.randn(T - 1, 3, 4)
    f = 0.05 * rng.randn(T - 1, 3)
    C = np.tile(np.diag([1., 1., 0.1, 0.01]), (T, 1, 1))
    c = 0.3 * rng.randn(T, 4)
    x0 = rng.randn(B, 3)
    if batched:
        F = F[:, None] * (1 + 0.01 * rng.randn(T - 1, B, 3, 4))
        f = np.ascontiguousarray(np.broadcast_to(f[:, None], (T - 1, B, 3)))
    return tuple(None if a is None else a.astype(dtype)
                 for a in (F, f if has_f else None, C, c, x0))


def _port_solve(kw, x0, C, c, dyn, lb=None, ub=None, u_init=None):
    sol = mt.batched_solve(
        mt.MPCConfig(**kw), torch.tensor(x0),
        quad_cost_from_numpy(C, c, 'cpu'), dyn,
        u_init=None if u_init is None else torch.tensor(u_init),
        u_lower=lb if lb is None or np.isscalar(lb) else torch.tensor(lb),
        u_upper=ub if ub is None or np.isscalar(ub) else torch.tensor(ub),
        device='cpu')
    return solution_to_numpy(sol)


def _assert_fields(out, ref, atol, rtol=0):
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name),
                                   np.asarray(getattr(ref, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    real = np.asarray(ref.full_du_norm) > 1e-6
    np.testing.assert_array_equal(out.alpha[real],
                                  np.asarray(ref.alpha)[real])


@pytest.mark.parametrize('has_f', [False, True], ids=['no_f', 'f'])
@pytest.mark.parametrize('batched', [False, True], ids=['shared', 'batched'])
def test_long_plain_f64_matches_jnp_path(batched, has_f):
    T, B = 24, 8
    F, f, C, c, x0 = _lindx_problem(T, B, batched, has_f)
    kw = _cfg_kw(T)
    ref = j_batched_solve(
        mpc_tpu.MPCConfig(**kw, use_fused='never'), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None if f is None else jnp.asarray(f)),
        u_lower=-0.6, u_upper=0.6)
    out = _port_solve(kw, x0, C, c, lin_dx_from_numpy(F, f, 'cpu'), -0.6, 0.6)
    assert (np.abs(out.u) == 0.6).mean() > 0.05     # the box is active
    _assert_fields(out, ref, 1e-8)


def test_long_plain_f64_pendulum_past_t_max():
    """The pendulum one K3 routing step past K1's horizon limit."""
    T, B = fused.T_MAX + 4, 4
    rng = np.random.RandomState(0)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    C, c = np.diag([1., 1., 0.1, 0.001]), np.array([-1., 0., 0., 0.])
    kw = _cfg_kw(T, lqr_iter=2, max_linesearch_iter=2,
                 grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    ref = j_batched_solve(
        mpc_tpu.MPCConfig(**kw, use_fused='never'), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        JPendulumDx(params=jnp.asarray(PARAMS)), u_lower=-2., u_upper=2.)
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    assert fused.routes_long(dx, T)
    out = _port_solve(dict(kw, grad_method=mt.GradMethods.AUTO_DIFF), x0, C,
                      c, dx, -2.0, 2.0)
    _assert_fields(out, ref, 1e-6, rtol=1e-6)


def test_long_plain_f32_matches_pallas_interpret():
    B, T, ns, nc = 16, 140, 3, 1
    rng = np.random.RandomState(0)
    M = rng.randn(ns, ns).astype(np.float32)
    Qo, _ = np.linalg.qr(M)
    F = np.tile(np.concatenate(
        [(0.97 * Qo).astype(np.float32),
         0.3 * rng.randn(ns, nc).astype(np.float32)], 1), (T - 1, 1, 1))
    C = np.tile(np.eye(4, dtype=np.float32), (T, B, 1, 1))
    C[:, :, 3, 3] = (0.1 + rng.rand(B).astype(np.float32))
    c = 0.3 * rng.randn(T, B, 4).astype(np.float32)
    x0 = rng.randn(B, ns).astype(np.float32)
    kw = _cfg_kw(T, lqr_iter=3, grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    ref = j_fused_batched_solve(
        mpc_tpu.MPCConfig(**kw, use_fused='never'), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None), u_lower=jnp.float32(-0.6),
        u_upper=jnp.float32(0.6), interpret=True)
    out = _port_solve(dict(kw, grad_method=mt.GradMethods.AUTO_DIFF), x0, C,
                      c, lin_dx_from_numpy(F, None, 'cpu'), -0.6, 0.6)
    np.testing.assert_allclose(out.u, np.asarray(ref.u), atol=5e-5)
    np.testing.assert_allclose(out.costs, np.asarray(ref.costs), rtol=1e-5)
    np.testing.assert_array_equal(out.n_iter, np.asarray(ref.n_iter))


def _assert_same(a, b):
    for name in FIELDS + ('alpha',):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def _small_f32(T, B):
    F, f, C, c, x0 = _lindx_problem(T, B, False, True, seed=2,
                                    dtype=np.float32)
    return F, f, C, c, x0, _cfg_kw(T, lqr_iter=3)


def test_long_layouts_are_equivalent():
    """Every leaf shared or batched on its own (a shared F beside a
    batched f and the like): the same problem, bitwise the same result."""
    T, B = 12, 8
    F, f, C, c, x0, kw = _small_f32(T, B)

    def bc(a):
        return np.ascontiguousarray(
            np.broadcast_to(a[:, None], (a.shape[0], B) + a.shape[1:]))

    base = _port_solve(kw, x0, C, c, lin_dx_from_numpy(F, f, 'cpu'),
                       -0.6, 0.6)
    lbB = np.full((T, B, 1), -0.6, np.float32)
    for Fi, fi, Ci, ci, lb in ((bc(F), bc(f), C, c, -0.6),
                               (F, bc(f), C, c, -0.6),
                               (bc(F), f, C, c, -0.6),
                               (F, f, bc(C), c, -0.6),
                               (F, f, C, bc(c), lbB),
                               (bc(F), bc(f), bc(C), bc(c), lbB)):
        ub = 0.6 if np.isscalar(lb) else -lb
        _assert_same(_port_solve(kw, x0, Ci, ci,
                                 lin_dx_from_numpy(Fi, fi, 'cpu'), lb, ub),
                     base)


def test_long_batch_reversal_and_ragged_batch():
    """B=70 (two blocks of the card's kernel and a tail): the reversed
    batch, un-reversed, is bitwise the same, and every example equals its
    solve in a small batch."""
    T, B = 10, 70
    F, f, C, c, x0, kw = _small_f32(T, B)
    u_init = (0.2 * np.random.RandomState(3).randn(T, B, 1)).astype(
        np.float32)
    dyn = lin_dx_from_numpy(F, f, 'cpu')
    a = _port_solve(kw, x0, C, c, dyn, -0.6, 0.6, u_init)
    r = _port_solve(kw, x0[::-1].copy(), C, c, dyn, -0.6, 0.6,
                    u_init[:, ::-1].copy())
    idx = np.array([0, 31, 32, 63, 64, 69])
    part = _port_solve(kw, x0[idx], C, c, dyn, -0.6, 0.6,
                       np.ascontiguousarray(u_init[:, idx]))
    for name in FIELDS + ('alpha',):
        v, w = getattr(r, name), getattr(a, name)
        np.testing.assert_array_equal(
            w, v[:, ::-1] if v.ndim == 3 else v[::-1], err_msg=name)
        np.testing.assert_array_equal(
            w[:, idx] if w.ndim == 3 else w[idx], getattr(part, name),
            err_msg=name)


@pytest.mark.parametrize('f_layout', ['none', 'shared', 'batched'])
@pytest.mark.parametrize('F_layout', ['shared', 'batched'])
def test_lindx_conversion_rollout_and_linearisation(F_layout, f_layout):
    """``lin_dx_from_numpy`` carries both layouts and an absent f;
    ``rollout`` matches mpc_tpu's per example, and ``linearize_dynamics``
    hands F and f back as given, whatever the grad_method."""
    T, B = 6, 3
    F, f, _, _, x0 = _lindx_problem(T, B, True, True, seed=1)
    if F_layout == 'shared':
        F = np.ascontiguousarray(F[:, 0])
    if f_layout == 'none':
        f = None
    elif f_layout == 'shared':
        f = np.ascontiguousarray(f[:, 0]) + 0.0
    dyn = lin_dx_from_numpy(F, f, 'cpu')
    assert dyn.F.dtype == torch.float64 and tuple(dyn.F.shape) == F.shape
    assert (dyn.f is None) if f is None else tuple(dyn.f.shape) == f.shape
    u = np.random.RandomState(2).randn(T, B, 1)
    x = rollout(dyn, torch.tensor(x0), torch.tensor(u))
    assert x.shape == (T, B, 3)
    for b in range(B):
        Fb = F if F.ndim == 3 else F[:, b]
        fb = None if f is None else (f if f.ndim == 2 else f[:, b])
        ref = j_rollout(
            mpc_tpu.LinDx(jnp.asarray(Fb),
                          None if fb is None else jnp.asarray(fb)),
            jnp.asarray(x0[b]), jnp.asarray(u[:, b]))
        np.testing.assert_allclose(x[:, b].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
        Fj, fj = j_linearize_dynamics(
            mpc_tpu.LinDx(jnp.asarray(Fb),
                          None if fb is None else jnp.asarray(fb)),
            ref, jnp.asarray(u[:, b]), mpc_tpu.GradMethods.FINITE_DIFF)
        np.testing.assert_array_equal(np.asarray(Fj), Fb)
        assert (fj is None) == (fb is None)
    for method in mt.GradMethods:
        Fl, fl = linearize_dynamics(dyn, x, torch.tensor(u), method)
        assert Fl is dyn.F and fl is dyn.f


def test_mpc_accepts_lindx_with_full_time_dims():
    """``MPC`` takes F [T, ...] and f [T, ...] and drops the last slice
    (mpc_tpu/mpc.py:269-278); against ``mpc_tpu.MPC`` in float64."""
    T, B = 8, 4
    F, f, C, c, x0 = _lindx_problem(T + 1, B, False, True, seed=4)
    C, c = C[:T], c[:T]
    kw = dict(u_lower=-0.6, u_upper=0.6, lqr_iter=4, eps=0.0,
              exit_unconverged=False, backprop=False, linesearch_decay=0.2,
              max_linesearch_iter=3)
    xj, uj, cj = mpc_tpu.MPC(3, 1, T, use_fused='never', **kw)(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), jnp.asarray(f)))
    assert F.shape[0] == T
    x, u, costs = mt.MPC(3, 1, T, device='cpu', **kw)(
        torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
        lin_dx_from_numpy(F, f, 'cpu'))
    for a, b in ((x, xj), (u, uj), (costs, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def _lin(T=5, B=None):
    shape = (T - 1, 3, 4) if B is None else (T - 1, B, 3, 4)
    return lin_dx_from_numpy(np.zeros(shape), None, 'cpu')


ROUTES = {
    # dynamics, T, K3?
    'pendulum_short': (lambda: PendulumDx(device='cpu'), 20, False),
    'pendulum_at_t_max': (lambda: PendulumDx(device='cpu'), fused.T_MAX,
                          False),
    'pendulum_past_t_max': (lambda: PendulumDx(device='cpu'),
                            fused.T_MAX + 1, True),
    'lindx_short_shared': (lambda: _lin(5), 5, True),
    'lindx_short_batched': (lambda: _lin(5, 2), 5, True),
    'lindx_long': (lambda: _lin(160), 160, True),
}


@pytest.mark.parametrize('case', list(ROUTES))
def test_routes_long(case):
    """One predicate says which forward kernel takes a problem, and every
    routed problem is in scope at float32 on the card."""
    make, T, long_route = ROUTES[case]
    dyn = make()
    assert fused.routes_long(dyn, T) is long_route
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T)
    cost = quad_cost_from_numpy(np.eye(4), np.zeros(4), 'cpu')
    assert fused.scope_gap(cfg, cost, dyn, dtype=torch.float32,
                           device=torch.device('cuda')) is None


SCOPE_GAPS = {
    'lindx_bad_F_rank': (dict(), lambda: mt.LinDx(torch.zeros(4, 3)), {},
                         ('ROADMAP', 'K3 configurations')),
    'lindx_bad_f_rank': (dict(), lambda: mt.LinDx(torch.zeros(4, 3, 4),
                                                  torch.zeros(4)), {},
                         ('ROADMAP', 'K3 configurations')),
    # two controls past the dense configuration's 32 lanes (n_state +
    # n_ctrl = 33); at smaller sizes the dense configuration takes them
    'lindx_n_ctrl_2': (dict(n_state=31, n_ctrl=2),
                       lambda: mt.LinDx(torch.zeros(4, 31, 33)), {},
                       ('n_state + n_ctrl = 33', 'jnp path')),
    'lindx_f64_on_card': (dict(), _lin, dict(dtype=torch.float64,
                                             device=torch.device('cuda')),
                          ('ROADMAP', 'float64')),
    # the augmented state is u_{t-1} and the 31 states: 32, with the
    # control 33, past the dense configuration's 32 (a 3-state LinDx
    # augments to 4 states, which it takes)
    'lindx_slew': (dict(n_state=31, slew_rate_penalty=0.1),
                   lambda: mt.LinDx(torch.zeros(4, 31, 32)), {},
                   ('n_state + n_ctrl = 33', 'jnp path')),
}


@pytest.mark.parametrize('case', list(SCOPE_GAPS))
def test_scope_gap_names_what_waits(case):
    """Each refusal names its ROADMAP item where one waits, and past the
    dense gate (33 taus) the eager solver as mpc_tpu's jnp path."""
    cfg_kw, make, kw, needles = SCOPE_GAPS[case]
    cfg = mt.MPCConfig(**dict(dict(n_state=3, n_ctrl=1, T=5), **cfg_kw))
    cost = quad_cost_from_numpy(np.eye(4), np.zeros(4), 'cpu')
    gap = fused.scope_gap(cfg, cost, make(), **kw)
    assert gap is not None and all(n in gap for n in needles), gap
    assert not fused.supports(cfg, cost, make(), **kw)


# problems the refusal table above held until the kernels took them: the
# LinDx of 3 states and 1 control with a mask, and with delta_u and bounds,
# go to K3 (on the card as on the CPU; the 2-control one to the dense
# configuration)
KERNEL_ROUTE = {
    'lindx_u_zero_I': (dict(), 1, dict(u_zero_I=torch.zeros(5, 1))),
    'lindx_delta_u': (dict(delta_u=0.1), 1, dict(u_lower=-1.0)),
    'lindx_n_ctrl_2_delta_u': (dict(delta_u=0.1), 2, dict(u_lower=-1.0)),
}


@pytest.mark.parametrize('case', list(KERNEL_ROUTE))
def test_masks_and_trust_regions_take_the_kernels(case):
    cfg_kw, nc, kw = KERNEL_ROUTE[case]
    cfg = mt.MPCConfig(**dict(dict(n_state=3, n_ctrl=nc, T=5), **cfg_kw))
    cost = quad_cost_from_numpy(np.eye(3 + nc), np.zeros(3 + nc), 'cpu')
    dyn = mt.LinDx(torch.zeros(4, 3, 3 + nc))
    for device in ('cpu', 'cuda'):
        assert fused.scope_gap(cfg, cost, dyn, device=torch.device(device),
                               **kw) is None
    assert fused.routes_dense(dyn, 3, nc) == (nc > 1)
    assert fused.routes_long(dyn, 5)


EAGER_ROUTE = {
    # MPCConfig keywords, n_ctrl, batched_solve keywords; the mask and
    # delta_u go to the kernels under 'auto' (test_torch_uzero.py), so
    # their eager cases, and two controls under delta_u, are pinned to
    # use_fused='never'
    'lindx_n_ctrl_2': (dict(delta_u=0.1, use_fused='never'), 2, {}),
    'lindx_eager': (dict(use_fused='never'), 1, {}),
    # one iteration: the masked solve is exact up to its 1e-11
    # regularisation, and a second step that small ties to round-off in
    # both line searches (compare alpha where the step is real only)
    'lindx_u_zero_I': (dict(lqr_iter=1, use_fused='never'), 1,
                       dict(u_zero_I=True)),
    'lindx_delta_u': (dict(delta_u=0.1, use_fused='never'), 1, {}),
    'lindx_f64': (dict(use_fused='never'), 1, dict(against_kernel=True)),
}


@pytest.mark.parametrize('case', list(EAGER_ROUTE))
def test_kernel_gaps_solve_eagerly(case):
    """LinDx problems on the eager solver (use_fused='never'; the
    kernels take the mask and delta_u under 'auto', test_torch_uzero.py)
    match mpc_tpu's jnp path in float64: x, u and costs within 1e-10
    relative, n_iter and n_qp_iter equal, alpha where the full step is
    real.  'lindx_f64' also holds the eager route against the kernel's
    plain version (the route float64 takes on the CPU) on the same
    problem.  The 4-control case stacks the system's input column with
    three more."""
    cfg_kw, nc, kw = EAGER_ROUTE[case]
    T, B = 8, 6
    F, f, C, c, x0 = _lindx_problem(T, B, False, True)
    if nc > 1:
        rng = np.random.RandomState(1)
        F = np.concatenate([F, 0.02 * rng.randn(T - 1, 3, nc - 1)], -1)
        C = np.stack([np.diag(np.concatenate([np.diag(Ct), [0.02] * (nc - 1)]))
                      for Ct in C])
        c = np.concatenate([c, np.zeros((T, nc - 1))], -1)
    ckw = _cfg_kw(T, **dict(dict(n_ctrl=nc, eps=1e-6, lqr_iter=5), **cfg_kw))
    bk = dict(u_lower=-0.6, u_upper=0.6)
    uz = None
    if kw.get('u_zero_I'):
        # the unconstrained solve pins controls to zero
        uz = np.random.RandomState(2).rand(T, B, nc) < 0.3
        bk = {}
    ref = j_batched_solve(
        mpc_tpu.MPCConfig(**dict(ckw, use_fused='never')), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), jnp.asarray(f)),
        u_zero_I=None if uz is None else jnp.asarray(uz), **bk)
    solver.reset_eager_counts()
    out = solution_to_numpy(mt.batched_solve(
        mt.MPCConfig(**ckw), torch.tensor(x0),
        quad_cost_from_numpy(C, c, 'cpu'), lin_dx_from_numpy(F, f, 'cpu'),
        u_zero_I=None if uz is None else torch.tensor(uz), device='cpu',
        **bk))
    assert solver.eager_counts['eager_solve'] == 1
    for name in ('x', 'u', 'costs'):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max(),
                                   err_msg=name)
    for name in ('n_iter', 'n_qp_iter', 'converged'):
        np.testing.assert_array_equal(getattr(out, name),
                                      np.asarray(getattr(ref, name)))
    real = np.asarray(ref.full_du_norm) > 1e-6
    np.testing.assert_array_equal(out.alpha[real],
                                  np.asarray(ref.alpha)[real])
    if kw.get('against_kernel'):
        plain = _port_solve(dict(ckw, use_fused='auto'), x0, C, c,
                            lin_dx_from_numpy(F, f, 'cpu'), -0.6, 0.6)
        np.testing.assert_allclose(out.u, plain.u, rtol=0, atol=1e-10)


def test_k3_bound_counts():
    """k3_flops/k3_bytes: work grows with the iterations and trials that
    ran; a LinDx Jacobian costs nothing and f three additions a step;
    shared operands count once; the long configuration is
    operation-bound."""
    T, B = 160, 4096
    per_solve = fused.k3_flops(T, 3, 1, lqr_iter=4, n_alpha=6)
    assert fused.k3_flops(T, 3, 1, 8, 12, batch=2) == 2 * per_solve
    assert 1e5 < per_solve < 5e5
    assert fused.k3_flops(T, 3, 1, 4, 6, has_f=True) - per_solve \
        == 3 * (T - 1) * (1 + 6)       # the initial rollout and 6 trials
    assert fused.k3_flops(T, 3, 1, 4, 6, lindx=False) > per_solve
    F, _, C, c, x0 = _lindx_problem(T, B, False, False, dtype=np.float32)
    ops = fused.k3_operands(
        mt.MPCConfig(**_cfg_kw(T)), torch.tensor(x0),
        quad_cost_from_numpy(C, c, 'cpu'), lin_dx_from_numpy(F, None, 'cpu'),
        u_lower=-2.0, u_upper=2.0)
    assert ops['dynamics'] is None and ops['params'] is None
    assert ops['F'].shape == (T - 1, 1, 3, 4) and ops['f'] is None
    nbytes = fused.k3_bytes(ops)
    assert nbytes == 4 * ((T - 1) * 12 + T * 20 + B * 3 + T * B + 2 * T
                          + T * B * 4 + 6 * B)
    assert B * per_solve / 67e12 > nbytes / 3.35e12


def test_k3_wrapper_never_falls_back_off_the_cpu():
    """Only a tensor on the CPU runs the plain version; any other device
    launches the kernel or raises (here: the meta device)."""
    T, B = 3, 4
    dev = torch.device('meta')
    args = (None, None, torch.zeros(T - 1, 1, 3, 4, device=dev), None,
            torch.zeros(T, 1, 4, 4, device=dev),
            torch.zeros(T, 1, 4, device=dev), torch.zeros(B, 3, device=dev),
            torch.zeros(T, B, device=dev), None, None)
    with pytest.raises(NotImplementedError):
        fused.fused_ilqr_long(*args, alphas=[1.0], lqr_iter=1, eps=0.0,
                              best_cost_eps=1e-4, not_improved_lim=5.0)
