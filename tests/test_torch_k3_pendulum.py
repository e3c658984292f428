"""K3's team kernel on the pendulum past its shared-memory horizon: the
launch geometry across the residency edge, and the plain K3 on the damped
pendulum and on the pseudo-Huber cost build at T=200 against the JAX
package, on the CPU.

- ``k3_launch`` for three builds (LinDx with a QuadCost, the damped
  pendulum with one, the simple pendulum's cost build), all with bounds,
  at T = 195, 196, 197, 200, 384 and 4096: shared memory within
  ``SMEM_LIMIT``; the pendulum's team as wide as its step sizes (8 lanes
  for the damped row's 5); each build's copy of the batch-shared
  operands holds what it reads (``MPC_OP_ROW`` 40, 24, 4 floats a step);
  the pendulum's linearisation buffers (two rounds of a team's steps, 3
  float4 a step, 5 in the cost build, one float4 more a team); the state
  resident where it fits beside them and else read through the lanes'
  rings of ``K3_RING`` steps (2 float4 a step and lane); the operands'
  copy staged where it fits beside those too; a LinDx horizon up to
  ``K3_T_RESIDENT`` keeps the 1,184 bytes a step it had.
- The plain K3 (``fused_solve_long_plain``, which the CPU path runs) on
  the damped pendulum at T=200 and on the simple pendulum's pseudo-Huber
  cost at T=200 against ``mpc_tpu.learning.batched_solve(use_fused=
  'never')`` in float64 at B=4 with ``lqr_iter=2``: x and u within 1e-7
  relative, n_iter equal.  That is the tolerance tests/test_torch_soa.py
  and tests/test_torch_huber.py hold the damped pendulum and the cost
  build past T_MAX to: both sides take the true atan2, and two
  unconverged iterations over 200 steps amplify the ~1e-15 differences
  of the two Jacobians (autodiff of the step there, hand-written here).
- The rows the team's lanes form off the sweep's chain are the model's
  ``soa_jacobian`` at each step of a trajectory: held against
  ``jax.jacfwd`` of mpc_tpu's damped step along a T=200 rollout, 1e-12
  relative in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.models import PseudoHuberCost as JHuber

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (pendulum_from_numpy,
                                         pseudo_huber_from_numpy,
                                         quad_cost_from_numpy)

jax.config.update('jax_enable_x64', True)

PEND = np.array([10., 1., 1.])
DAMPED = np.array([10., 1., 1., 0.1, 0.05])
W4 = np.array([1., 1., .1, .1])
GOAL4 = np.array([1., 0., 0., 0.])
DELTA = 0.9
SOLVE_TOL = 1e-7
STEP_TOL = 1e-12

HORIZONS = [195, 196, 197, 200, 384, 4096]
# (lindx, huber, step sizes, team, MPC_OP_ROW, linearisation float4 a
# step): LinDx with a QuadCost (C 16, c 4, F 12, f 4, the bounds 2: 38
# padded to 40) and 3 step sizes; the damped pendulum with a QuadCost (C,
# c and the bounds: 22 to 24; F's three rows) and its 5 step sizes, a team
# of 8 lanes; the simple pendulum's cost build (the bounds: 2 to 4; F's
# rows, H's diagonal and g) and its 3 step sizes, 4 lanes
BUILDS = {'lindx': (True, False, 3, 4, 40, 0),
          'damped': (False, False, 5, 8, 24, 3),
          'cost': (False, True, 3, 4, 4, 5)}


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


@pytest.mark.parametrize('build', list(BUILDS))
@pytest.mark.parametrize('T', HORIZONS)
def test_k3_team_geometry_across_residency(T, build):
    lindx, huber, n_alpha, team, row, lin_rows = BUILDS[build]
    kw = dict(lindx=lindx, huber=huber, has_bounds=True, has_uz=False)
    B = 4096
    geo = fused.k3_launch(T, B, n_alpha, **kw)
    defines = fused.long_kernel_defines(lindx, True, damped=build == 'damped',
                                        huber=huber, n_alpha=n_alpha)
    assert defines['MPC_OP_ROW'] == row
    assert defines['MPC_RING'] == fused.K3_RING
    assert (defines['MPC_TEAM'], defines['MPC_WARPS']) == (
        geo['team'], geo['warps']) == (team, fused.K3_WARPS * team // 4)
    assert geo['examples'] == 32 and geo['blocks'] == B // 32
    lin = 0 if lindx else 32 * (2 * team * lin_rows + 1) * 16
    state = T * 2 * 16 * 32
    ops = T * 4 * row
    # LinDx keeps its state resident only with its operands' copy
    resident = lin + state + (ops if lindx else 0) <= fused.SMEM_LIMIT
    assert geo['resident'] == resident
    assert resident == (T <= fused.k3_t_resident(n_alpha=n_alpha, **kw))
    if not resident:
        # the lanes' rings: K3_RING steps of two float4 a lane
        state = fused.K3_RING * 2 * 16 * 32 * geo['warps']
    staged = lin + state + ops <= fused.SMEM_LIMIT
    assert geo['staged'] == staged
    assert geo['smem_bytes'] == lin + state + (ops if staged else 0)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    assert geo['slots'] == min(n_alpha, team) + (0 if resident else 2)
    assert geo['workspace_bytes'] == T * geo['slots'] * B * 16
    if lindx and T <= fused.K3_T_RESIDENT:
        # the LinDx build keeps its layout: 1,184 bytes a step
        assert geo['smem_bytes'] == 1184 * T
    # the clocked build counts in global memory: the same layout
    assert fused.k3_launch(T, B, n_alpha, clocks=True, **kw) == geo


def test_k3_team_widths_and_resident_horizons():
    """A pendulum's team is as wide as its step sizes, 4 to 8 lanes (5 to
    8 step sizes: one round), LinDx's 4; where each build's state stops
    fitting beside its linearisation buffers (LinDx's with its operands'
    copy), and the pendulum's operands' copy beside both."""
    for n_alpha, team in ((1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (10, 8)):
        assert fused.k3_launch(200, 64, n_alpha, lindx=False)['team'] == team
        assert fused.k3_launch(200, 64, n_alpha)['team'] == fused.TEAM
    assert fused.K3_T_RESIDENT == fused.k3_t_resident() == 196
    assert fused.k3_t_resident(lindx=False) == 214
    assert fused.k3_t_resident(lindx=False, n_alpha=5) == 202
    assert fused.k3_t_resident(lindx=False, huber=True, n_alpha=3) == 206
    # the operands' copy beside the resident state: the damped row's to
    # T = 185, the cost build's to 203
    for T, n_alpha, huber, staged in ((185, 5, False, True),
                                      (186, 5, False, False),
                                      (203, 3, True, True),
                                      (204, 3, True, False)):
        geo = fused.k3_launch(T, 64, n_alpha, lindx=False, huber=huber)
        assert geo['resident'] and geo['staged'] == staged
    assert fused.long_kernel_defines(False, True, has_uz=True)[
        'MPC_OP_ROW'] == 24
    assert fused.long_kernel_defines(True, True, huber=True)[
        'MPC_OP_ROW'] == 20
    assert fused.long_kernel_defines(False, False)['MPC_OP_ROW'] == 20


def _x0(B, seed):
    th = np.pi * (2 * np.random.RandomState(seed).rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def _cfg(T, port=True):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=1e-3,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=5)
    if port:
        return mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **base)
    return mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             use_fused='never', **base)


@pytest.mark.parametrize('case', ['damped', 'cost'])
def test_plain_k3_pendulum_t200_matches_jnp_path(case):
    T, B = 200, 4
    damped = case == 'damped'
    prm = DAMPED if damped else PEND
    jdx = JPendulumDx(params=jnp.asarray(prm), simple=not damped)
    tdx = pendulum_from_numpy(prm, simple=not damped, device='cpu')
    x0 = _x0(B, 11 if damped else 12)
    if damped:
        q, p = (np.asarray(a) for a in jdx.get_true_obj())
        cost = quad_cost_from_numpy(np.diag(q), p, 'cpu')
        jcost = mpc_tpu.QuadCost(jnp.asarray(np.diag(q)), jnp.asarray(p))
    else:
        cost = pseudo_huber_from_numpy(W4, GOAL4, DELTA, device='cpu')
        jcost = JHuber(jnp.asarray(W4), jnp.asarray(GOAL4),
                       jnp.asarray(DELTA))
    cfg = _cfg(T)
    assert fused.routes_long(tdx, T) and not fused.routes_dense(tdx, 3, 1)
    assert fused.scope_gap(cfg, cost, tdx, dtype=torch.float64) is None
    solver.reset_eager_counts()
    got = mt.batched_solve(cfg, torch.tensor(x0), cost, tdx, u_lower=-2.0,
                           u_upper=2.0, device='cpu')
    assert solver.eager_counts['eager_solve'] == 0
    ref = j_batched_solve(_cfg(T, port=False), jnp.asarray(x0), jcost, jdx,
                          u_lower=-2.0, u_upper=2.0)
    _rel(got.x, ref.x, SOLVE_TOL, 'x')
    _rel(got.u, ref.u, SOLVE_TOL, 'u')
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


def test_linearisation_rows_match_jax_along_a_rollout():
    T, B = 200, 6
    jdx = JPendulumDx(params=jnp.asarray(DAMPED), simple=False)
    tdx = pendulum_from_numpy(DAMPED, simple=False, device='cpu')
    rng = np.random.RandomState(3)
    u = rng.uniform(-2.5, 2.5, (T, B))
    x = [_x0(B, 4)]
    for t in range(T - 1):
        x.append(np.asarray(jdx(jnp.asarray(x[t]), jnp.asarray(u[t, :, None]))))
    x = np.stack(x)
    p = tuple(torch.tensor(DAMPED).unbind())
    xs = torch.tensor(x)
    got = tdx.soa_jacobian(tuple(xs[..., i] for i in range(3)),
                           torch.tensor(u), p)
    got = np.stack([np.stack([np.asarray(got[i][j]) for j in range(4)], -1)
                    for i in range(3)], -2)

    def step(tau):
        return jdx(tau[:3][None], tau[3:][None])[0]
    taus = np.concatenate([x, u[..., None]], -1).reshape(-1, 4)
    ref = jax.vmap(jax.jacfwd(step))(jnp.asarray(taus))
    ref = np.asarray(ref).reshape(T, B, 3, 4)
    # the control column is the full derivative inside the torque limit
    # and zero strictly outside, as the kernels take it
    inside = (np.abs(u) <= 2.0)[..., None, None]
    _rel(np.where(inside, got, 0.0)[..., :3],
         np.where(inside, ref, 0.0)[..., :3], STEP_TOL, 'd/dx')
    _rel(np.where(inside, got, 0.0)[..., 3], np.where(inside, ref, 0.0)[..., 3],
         STEP_TOL, 'd/du')
