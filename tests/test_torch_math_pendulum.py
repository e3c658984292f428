"""The port's elementwise helpers, pendulum model and trajectory helpers
against the JAX package, on the CPU in float64.

Inputs are made with numpy from a seed and handed to both packages as
arrays.  Tolerance 1e-12: both sides evaluate the same float64 formulas
(the Jacobian by hand here, by forward-mode autodiff there), so they
differ by a few ulps of O(1)-O(10) values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_tpu import QuadCost as JQuadCost
from mpc_tpu import rollout as j_rollout
from mpc_tpu import trajectory_cost as j_trajectory_cost
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.ops import math as jmath

from mpc_tpu_torch import rollout, trajectory_cost
from mpc_tpu_torch.ops import math as tmath
from mpc_tpu_torch.utils.convert import (pendulum_from_numpy,
                                         quad_cost_from_numpy)

TOL = 1e-12
PARAMS = np.array([10., 1., 1.])


def _states(n, seed=0, unit=True):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    r = 1.0 if unit else 0.5 + rng.rand(n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     2 * rng.randn(n)], 1)


def _controls(n, seed=1):
    """Generic controls, both bounds exactly, and beyond the bounds."""
    rng = np.random.RandomState(seed)
    u = 1.9 * (2 * rng.rand(n) - 1)
    u[:4] = [2.0, -2.0, 2.5, -3.0]
    return u


def test_hard_clip_values_and_gradient():
    """torch.clamp (the port's hard_clip) against mpc_tpu's hand-written
    clip under jax.grad: gradient 1 inside and ON the bound, 0 outside."""
    pts = np.array([-3.0, -2.0, -1.5, 0.0, 1.0, 2.0, 2.5])
    jv = np.asarray(jmath.hard_clip(jnp.asarray(pts), -2.0, 2.0))
    jg = np.asarray(jax.vmap(jax.grad(
        lambda v: jmath.hard_clip(v, -2.0, 2.0)))(jnp.asarray(pts)))
    x = torch.tensor(pts, requires_grad=True)
    tv = tmath.hard_clip(x, -2.0, 2.0)
    tv.sum().backward()
    np.testing.assert_array_equal(tv.detach().numpy(), jv)
    np.testing.assert_array_equal(x.grad.numpy(), jg)
    np.testing.assert_array_equal(jg, [0, 1, 1, 1, 1, 1, 0])


def test_rotate_unit_matches_jax():
    """Off-unit radii (renormalisation) and the (0, 0) convention."""
    xs = _states(64, unit=False)
    xs[0, :2] = 0.0
    delta = np.random.RandomState(2).randn(64)
    jc, js = jmath.rotate_unit(jnp.asarray(xs[:, 0]), jnp.asarray(xs[:, 1]),
                               jnp.asarray(delta))
    tc, ts = tmath.rotate_unit(torch.tensor(xs[:, 0]),
                               torch.tensor(xs[:, 1]), torch.tensor(delta))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=TOL)
    # (0, 0) is angle 0: the result is (cos delta, sin delta)
    np.testing.assert_allclose([tc[0].item(), ts[0].item()],
                               [np.cos(delta[0]), np.sin(delta[0])],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize('simple', [True, False])
def test_forward_matches_jax(simple):
    params = PARAMS if simple else np.array([10., 1., 1., 0.3, 0.2])
    x = _states(64)
    u = _controls(64)[:, None]
    jdx = JPendulumDx(params=jnp.asarray(params), simple=simple)
    tdx = pendulum_from_numpy(params, simple=simple, device='cpu')
    ref = np.asarray(jdx(jnp.asarray(x), jnp.asarray(u)))
    out = tdx(torch.tensor(x), torch.tensor(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_soa_step_matches_jax():
    x = _states(64, unit=False)
    x[0, :2] = 0.0
    u = _controls(64)
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    tdx = pendulum_from_numpy(PARAMS, device='cpu')
    ref = jdx.soa_step(tuple(jnp.asarray(x).T), jnp.asarray(u),
                       tuple(jnp.asarray(PARAMS)))
    out = tdx.soa_step(tuple(torch.tensor(x).unbind(-1)), torch.tensor(u),
                       tdx.soa_params())
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)


def test_step_jacobian_matches_jacfwd():
    """The hand-written Jacobian K1 uses against jax.jacfwd of mpc_tpu's
    soa_step: generic angles, u = +-2 exactly (derivative kept), |u| > 2
    (control column 0), off-unit radii and the (0, 0) state."""
    x = _states(64, unit=False)
    x[:32] = _states(32, seed=3)
    x[5, :2] = 0.0
    u = _controls(64)
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    prm = tuple(jnp.asarray(PARAMS))

    def f(z):
        return jnp.stack(jdx.soa_step(tuple(z[:3]), z[3], prm))

    ref = np.asarray(jax.vmap(jax.jacfwd(f))(
        jnp.asarray(np.concatenate([x, u[:, None]], 1))))
    tdx = pendulum_from_numpy(PARAMS, device='cpu')
    out = tdx.step_jacobian(torch.tensor(x), torch.tensor(u[:, None]))
    assert out.shape == (64, 3, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    # on the bound (examples 0, 1) d newdth / du is the full
    # dt * 3 / (m l^2); beyond it (examples 2, 3) the column is zero
    dn_du = 0.05 * 3.0
    np.testing.assert_allclose(out[:2, 2, 3].numpy(), [dn_du, dn_du],
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(out[2:4, :, 3].numpy(), 0.0)


def test_true_obj_matches_jax():
    q, p = JPendulumDx().get_true_obj()
    tq, tp = pendulum_from_numpy(PARAMS, device='cpu').get_true_obj()
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), rtol=0, atol=TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=0, atol=TOL)


@pytest.mark.parametrize('batched_cost', [False, True])
def test_rollout_and_trajectory_cost_match_jax(batched_cost):
    T, B = 7, 5
    rng = np.random.RandomState(4)
    x0 = _states(B)
    u = rng.randn(T, B, 1)
    C = rng.randn(T, B, 4, 4)
    C = np.einsum('tbij,tbkj->tbik', C, C)
    c = rng.randn(T, B, 4)
    if not batched_cost:
        C, c = C[:, 0], c[:, 0]
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    jx = jax.vmap(lambda a, b: j_rollout(jdx, a, b), in_axes=(0, 1),
                  out_axes=1)(jnp.asarray(x0), jnp.asarray(u))
    cax = 1 if batched_cost else None
    jcost = jax.vmap(
        lambda Ci, ci, xi, ui: j_trajectory_cost(JQuadCost(Ci, ci), xi, ui),
        in_axes=(cax, cax, 1, 1))(jnp.asarray(C), jnp.asarray(c), jx,
                                  jnp.asarray(u))
    tdx = pendulum_from_numpy(PARAMS, device='cpu')
    tx = rollout(tdx, torch.tensor(x0), torch.tensor(u))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    tcost = trajectory_cost(quad_cost_from_numpy(C, c, 'cpu'), tx,
                            torch.tensor(u))
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), rtol=1e-12,
                               atol=TOL)
