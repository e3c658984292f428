"""The port's differentiable solve and imitation training against the JAX
package, on the CPU, end to end in float64.

- gradients of sum(u^2) with respect to c, x_init and the pendulum's
  parameters through ``batched_solve(backprop=True, device="cpu")``
  (phase 1 through the plain K1, phase 2 through the plain K2) against
  ``jax.grad`` through mpc_tpu.learning.batched_solve (its jnp path on
  the CPU), at tests/test_fused_bwd.py's end-to-end sizes.  Tolerance
  1e-7 relative to the largest entry: the two forward solves agree to
  ~1e-9 on these unconverged iterates (tests/test_torch_fused.py), and
  the gradients inherit that; measured 1.4e-8.
- one SGD step of ``make_imitation_train_step`` against mpc_tpu's train
  step with optax.sgd: the same loss and update, 1e-7 as above.
- the ``MPC`` front end: gradients reach c and x_init, and
  ``detach_unconverged`` zeroes those of unconverged examples exactly.
- the layout mixes of the leaves (per-example C and bounds, shared
  time-varying C beside batched c, shared and batched u_init, no bounds,
  LinDx with F and f each shared or batched, no f beside a batched C)
  through the kernels' plain versions and through the eager solver
  against jax.grad (tolerances at test_layout_mix_gradients_match_jax_f64).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mpc_tpu
from mpc_tpu.learning import (TrainState, batched_solve as j_batched_solve,
                              make_imitation_train_step as j_train_step)
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx

B, T = 8, 5
PARAMS = np.array([10., 1., 1.])
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])
TOL = 1e-7


def _x0(n, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)


def _cfg_kw(**kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=True, linesearch_decay=0.2, max_linesearch_iter=2)
    base.update(kw)
    return base


def _assert_rel(name, ref, got, tol=TOL):
    ref, got = np.asarray(ref), np.asarray(got)
    scale = np.abs(ref).max()
    assert np.abs(ref - got).max() <= tol * scale, (name, ref, got)


def test_end_to_end_gradients_match_jax_f64():
    x0 = _x0(B)

    def j_loss(cv, x, prm):
        cfg = mpc_tpu.MPCConfig(
            grad_method=mpc_tpu.GradMethods.AUTO_DIFF, **_cfg_kw())
        sol = j_batched_solve(cfg, x, mpc_tpu.QuadCost(
            jnp.diag(jnp.asarray(Q)), cv), JPendulumDx(params=prm),
            u_lower=-2., u_upper=2.)
        return jnp.sum(sol.u ** 2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(P), jnp.asarray(x0), jnp.asarray(PARAMS))
    cv, xt, prm = (torch.tensor(a, requires_grad=True)
                   for a in (P, x0, PARAMS))
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **_cfg_kw())
    sol = mt.batched_solve(cfg, xt, mt.QuadCost(torch.diag(torch.tensor(Q)),
                                                cv),
                           PendulumDx(params=prm), u_lower=-2., u_upper=2.,
                           device='cpu')
    (sol.u ** 2).sum().backward()
    for name, a, b in zip(('dc', 'dx_init', 'dparams'), ref,
                          (cv.grad, xt.grad, prm.grad)):
        _assert_rel(name, a, b.numpy())


def test_imitation_sgd_step_matches_jax_f64():
    """One step of config 4's train step (mpc_tpu/learning.py:300-324),
    at the small size, with SGD in place of Adam so that the update is
    the gradient itself."""
    x0 = _x0(B, seed=3)
    u_exp = np.clip(np.random.RandomState(4).randn(T, B, 1), -2, 2)
    lr = 0.1
    theta0 = {'q_log': np.log(Q + 1e-3), 'p': P}

    cfg_j = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                              **_cfg_kw())
    opt_j = optax.sgd(lr)
    step_j = j_train_step(
        cfg_j, opt_j, lambda th: mpc_tpu.QuadCost(
            jnp.diag(jnp.exp(th['q_log'])), th['p']),
        lambda th: JPendulumDx(params=jnp.asarray(PARAMS)),
        u_lower=-2., u_upper=2.)
    th_j = {k: jnp.asarray(v) for k, v in theta0.items()}
    state, loss_j = step_j(TrainState(th_j, opt_j.init(th_j),
                                      jnp.asarray(0)),
                           jnp.asarray(x0), jnp.asarray(u_exp))

    theta = {k: torch.nn.Parameter(torch.tensor(v))
             for k, v in theta0.items()}
    dx = PendulumDx(params=torch.tensor(PARAMS))
    step = mt.make_imitation_train_step(
        mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **_cfg_kw()),
        torch.optim.SGD(theta.values(), lr=lr),
        lambda th: mt.QuadCost(torch.diag(torch.exp(th['q_log'])),
                               th['p']),
        lambda th: dx, u_lower=-2., u_upper=2., device='cpu')
    loss = step(theta, torch.tensor(x0), torch.tensor(u_exp))
    _assert_rel('loss', loss_j, loss.numpy())
    for k in theta0:
        _assert_rel(k, np.asarray(state.theta[k]) - theta0[k],
                    theta[k].detach().numpy() - theta0[k])


def _mpc(eps, detach):
    return mt.MPC(3, 1, T, u_lower=-2., u_upper=2., lqr_iter=3, eps=eps,
                  grad_method=mt.GradMethods.AUTO_DIFF,
                  exit_unconverged=False, detach_unconverged=detach,
                  device='cpu')


def test_mpc_gradients_and_detach_unconverged():
    """After three iterations at eps=1e-3 some examples of this batch
    have converged and some have not (step norms 1.2e-3 to 0)."""
    x0 = _x0(B, seed=0)
    w = torch.tensor(np.random.RandomState(1).randn(T, B, 1))
    cost = mt.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    dx = PendulumDx(params=torch.tensor(PARAMS))
    conv = _mpc(1e-3, True).solve(torch.tensor(x0), cost, dx)
    conv = conv.converged.numpy()
    assert 0 < conv.sum() < B
    grads = {}
    for detach in (False, True):
        c = torch.tensor(P, requires_grad=True)
        x = torch.tensor(x0, requires_grad=True)
        _, u, _ = _mpc(1e-3, detach)(x, mt.QuadCost(cost.C, c), dx)
        (w * u).sum().backward()
        assert torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0
        grads[detach] = x.grad.numpy()
    np.testing.assert_array_equal(grads[True][~conv], 0.0)
    np.testing.assert_array_equal(grads[True][conv], grads[False][conv])
    assert np.abs(grads[False][~conv]).sum() > 0


# The layout mixes of the leaves, end to end in float64 through both
# routes against jax.grad through mpc_tpu's jnp path, relative to the
# reference's largest entry.  The eager solver (use_fused='never') is
# held to 1e-10 in u and 1e-8 in every gradient (measured 4e-15).  The
# kernels' plain versions compute in the kernels' order with the
# pendulum's hand-written Jacobian, which these unconverged pendulum
# iterates amplify (measured up to 1.3e-9 in u and 1.6e-8 in a gradient;
# the LinDx mixes 1.4e-11), so that route is held to 1e-8 and TOL.
def _lin_sys(rng, batched_F, f_layout):
    A = np.eye(3)
    A[0, 1] = 0.01
    F = np.tile(np.concatenate([A, 0.3 * np.ones((3, 1))], 1),
                (T - 1, 1, 1)) + 0.05 * rng.randn(T - 1, 3, 4)
    if batched_F:
        F = F[:, None] * (1 + 0.05 * rng.randn(T - 1, B, 3, 4))
    f = {None: None, 'shared': 0.1 * rng.randn(T - 1, 3),
         'batched': 0.1 * rng.randn(T - 1, B, 3)}[f_layout]
    return F, f


def _mix(name):
    """numpy leaves of one mix: x0, C, c, dynamics (pendulum params or
    (F, f)), bounds, u_init."""
    rng = np.random.RandomState(7)
    x0 = _x0(B, seed=5)
    C, c = np.diag(Q), P.copy()
    dyn, lb, ub, u0 = PARAMS.copy(), -2., 2., None
    if name == 'batched_C_batched_bounds':
        C = np.diag(Q) * (1 + 0.1 * rng.rand(T, B, 4, 1) * np.eye(4))
        lb = -1.5 - 0.5 * rng.rand(T, B, 1)
        ub = 1.5 + 0.5 * rng.rand(T, B, 1)
    elif name == 'shared_tv_C_batched_c':
        C = np.diag(Q) * (1 + 0.1 * rng.rand(T, 4, 1) * np.eye(4))
        c = P + 0.1 * rng.randn(T, B, 4)
    elif name == 'shared_u_init':
        u0 = 0.5 * rng.randn(T, 1)
    elif name == 'batched_u_init':
        u0 = 0.5 * rng.randn(T, B, 1)
    elif name == 'unbounded':
        lb = ub = None
        C = np.diag([1., 1., 0.1, 0.1])
    elif name.startswith('lindx'):
        x0 = rng.randn(B, 3)
        C = np.diag([1., 1., 0.1, 0.01])
        c = 0.3 * rng.randn(4)
        lb, ub = -0.6, 0.6
        if name == 'lindx_no_f_batched_C':
            C = C * (1 + 0.1 * rng.rand(T, B, 4, 1) * np.eye(4))
            dyn = _lin_sys(rng, False, None)
        else:
            _, F_l, f_l = name.split('_')
            dyn = _lin_sys(rng, F_l == 'Fbatched',
                           'shared' if f_l == 'fshared' else 'batched')
    return x0, C, c, dyn, lb, ub, u0


MIXES = ['batched_C_batched_bounds', 'shared_tv_C_batched_c',
         'shared_u_init', 'batched_u_init', 'unbounded',
         'lindx_Fshared_fshared', 'lindx_Fshared_fbatched',
         'lindx_Fbatched_fshared', 'lindx_Fbatched_fbatched',
         'lindx_no_f_batched_C']


def _mix_loss(s_u, s_x):
    return (s_u ** 2).sum() + 0.1 * (s_x ** 2).sum()


@functools.lru_cache(maxsize=None)
def _mix_reference(name):
    """u and the gradients of mpc_tpu's jnp path for one mix."""
    x0, C, c, dyn, lb, ub, u0 = _mix(name)
    lin = isinstance(dyn, tuple)
    cfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                            use_fused='never', **_cfg_kw())

    def solve(x, Cv, cv, d):
        dynamics = (mpc_tpu.LinDx(*d) if lin
                    else JPendulumDx(params=d))
        return j_batched_solve(
            cfg, x, mpc_tpu.QuadCost(Cv, cv), dynamics,
            u_init=None if u0 is None else jnp.asarray(u0),
            u_lower=None if lb is None else jnp.asarray(lb),
            u_upper=None if ub is None else jnp.asarray(ub))

    d = (tuple(None if a is None else jnp.asarray(a) for a in dyn) if lin
         else jnp.asarray(dyn))
    args = (jnp.asarray(x0), jnp.asarray(C), jnp.asarray(c), d)
    grads = jax.grad(lambda *a: _mix_loss(solve(*a).u, solve(*a).x),
                     argnums=(0, 1, 2, 3))(*args)
    return np.asarray(solve(*args).u), jax.tree_util.tree_leaves(grads)


@pytest.mark.parametrize('route', ['kernel', 'eager'])
@pytest.mark.parametrize('mix', MIXES)
def test_layout_mix_gradients_match_jax_f64(mix, route):
    from mpc_tpu_torch import solver
    x0, C, c, dyn, lb, ub, u0 = _mix(mix)
    lin = isinstance(dyn, tuple)
    u_ref, g_ref = _mix_reference(mix)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, C, c)]
    if lin:
        dleaves = [None if a is None else torch.tensor(a, requires_grad=True)
                   for a in dyn]
        dynamics = mt.LinDx(*dleaves)
        dleaves = [a for a in dleaves if a is not None]
    else:
        dleaves = [torch.tensor(dyn, requires_grad=True)]
        dynamics = PendulumDx(params=dleaves[0])
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                       use_fused='never' if route == 'eager' else 'auto',
                       **_cfg_kw())
    tb = (lambda b: None if b is None else torch.tensor(np.asarray(b)))
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, leaves[0], mt.QuadCost(leaves[1], leaves[2]),
                           dynamics, u_init=tb(u0), u_lower=tb(lb),
                           u_upper=tb(ub), device='cpu')
    assert solver.eager_counts['eager_solve'] == (route == 'eager')
    u_tol, g_tol = (1e-10, 1e-8) if route == 'eager' else (1e-8, TOL)
    _assert_rel('u', u_ref, sol.u.detach().numpy(), u_tol)
    _mix_loss(sol.u, sol.x).backward()
    got = [a.grad for a in leaves + dleaves]
    assert len(got) == len(g_ref)
    for i, (a, b) in enumerate(zip(g_ref, got)):
        assert b.shape == a.shape, (i, b.shape, a.shape)
        _assert_rel(f'grad {i}', a, b.numpy(), g_tol)
