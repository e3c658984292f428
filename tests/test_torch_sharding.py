"""The port's scale-out over the devices of one process
(mpc_tpu_torch/parallel/mesh.py, learning.make_sharded_train_step) on
the CPU: a mesh of eight CPU devices against the JAX package's sharded
solve on the eight virtual devices that tests/conftest.py sets up, the
cases of tests/test_sharding.py, float64.

- the LinDx problem with four controls, box bounds (test_sharding.py:
  21-36), within 1e-10 of ``mpc_tpu.parallel.solve_sharded``;
- u_zero_I (batched) and prev_ctrl (per example, under a slew penalty)
  passed through the shards, within 1e-10 on the eager route, and on the
  kernel route (the dense configuration's plain version) bitwise the
  unsharded solve;
- the nonlinear pendulum: on the eager route within 1e-10 of the JAX
  package (the same algorithm as its jnp path), and on the kernel route
  (the plain K1) bitwise the unsharded solve, as every example is solved
  alone;
- one SGD step of ``make_sharded_train_step`` against the JAX package's
  (shard_map + pmean) within 1e-10, and its loss and step against the
  unsharded ``make_imitation_train_step`` (the mean of equal shards'
  means is the global mean up to the order of the sums: 1e-12).

Tolerance 1e-10: the eager solver and the jnp path agree to ~1e-15
where they take the same decisions (tests/test_torch_eager_solve.py).
The four-control problem is held against the JAX package at three
iterations, where every example's last step is real (|du| >= 0.1):
past that the converged examples' steps fall to round-off, where the
two PNQPs and line searches rightly part (at 20 iterations one example
ends on a step of 0 here and 9.3e-8 there, 1.4e-8 apart in u); the
sharded solve is held to the unsharded port at 20 iterations, bitwise.
"""

import numpy as np
import numpy.random as npr
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mpc_tpu
from mpc_tpu.learning import (TrainState as JTrainState,
                              make_sharded_train_step as j_sharded_step)
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.parallel import make_mesh as j_make_mesh
from mpc_tpu.parallel import solve_sharded as j_solve_sharded

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.parallel import make_mesh, shard_batch, solve_sharded

jax.config.update('jax_enable_x64', True)

TOL = 1e-10
MESH = ['cpu'] * 8


def _problem(n_batch, seed=1, n_state=3, n_ctrl=4, T=5):
    """tests/test_sharding.py:_problem."""
    npr.seed(seed)
    n_sc = n_state + n_ctrl
    C = npr.randn(T, n_batch, n_sc, n_sc)
    C = np.matmul(C.transpose(0, 1, 3, 2), C)
    c = npr.randn(T, n_batch, n_sc)
    alpha = 0.2
    R = np.tile(np.eye(n_state) + alpha * npr.randn(n_state, n_state),
                (T - 1, n_batch, 1, 1))
    S = np.tile(npr.randn(n_state, n_ctrl), (T - 1, n_batch, 1, 1))
    F = np.concatenate((R, S), axis=3)
    f = np.tile(npr.randn(n_state), (T - 1, n_batch, 1))
    x_init = npr.randn(n_batch, n_state)
    u_lower = -npr.random((T, n_batch, n_ctrl))
    u_upper = npr.random((T, n_batch, n_ctrl))
    return C, c, F, f, x_init, u_lower, u_upper


def _both(arrays):
    return ([torch.tensor(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_make_mesh():
    assert make_mesh(MESH) == (torch.device('cpu'),) * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no card'):
            make_mesh()


def test_shard_batch_splits_on_the_batch_axis():
    x = torch.arange(16.).reshape(8, 2)
    u = torch.arange(48.).reshape(3, 8, 2)
    shards = shard_batch({'x': x, 'u': u, 'n': 3}, make_mesh(['cpu'] * 4))
    assert len(shards) == 4
    assert torch.equal(torch.cat([s['x'] for s in shards]), x)
    assert torch.equal(torch.cat([s['u'] for s in shards], 1), u)
    assert all(s['n'] == 3 and s['u'].shape == (3, 2, 2) for s in shards)
    with pytest.raises(ValueError, match='evenly'):
        shard_batch(torch.zeros(6, 2), make_mesh(['cpu'] * 4))


def test_sharded_solve_matches_jax():
    (C, c, F, f, x0, lb, ub), jx = _both(_problem(16))
    # the eager route on both sides, as against mpc_tpu's jnp path (the
    # dense kernel configuration's own sharded case is below)
    kw = dict(n_state=3, n_ctrl=4, T=5, lqr_iter=3, exit_unconverged=False,
              use_fused='never')
    sol = solve_sharded(mt.MPCConfig(**kw), make_mesh(MESH), x0,
                        mt.QuadCost(C, c), mt.LinDx(F, f), u_lower=lb,
                        u_upper=ub)
    jC, jc, jF, jf, jx0, jlb, jub = jx
    ref = j_solve_sharded(mpc_tpu.MPCConfig(**kw), j_make_mesh(), jx0,
                          mpc_tpu.QuadCost(jC, jc), mpc_tpu.LinDx(jF, jf),
                          u_lower=jlb, u_upper=jub)
    assert len(jax.devices()) == 8
    _close(sol.u, ref.u)
    _close(sol.costs, ref.costs)
    assert sol.iter_stats is None and sol.u.shape == (5, 16, 4)
    # the unsharded port at 20 iterations: every example is solved alone
    cfg = mt.MPCConfig(**dict(kw, lqr_iter=20))
    sol = solve_sharded(cfg, make_mesh(MESH), x0, mt.QuadCost(C, c),
                        mt.LinDx(F, f), u_lower=lb, u_upper=ub)
    one = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), mt.LinDx(F, f),
                           u_lower=lb, u_upper=ub, device='cpu')
    for a, b in zip(sol[:8], one[:8]):
        assert torch.equal(a, b)


def test_sharded_dense_kernel_route_is_the_unsharded_one():
    """The same problem on the kernels' route (K3's dense configuration,
    its plain version here): every shard solved alone gives the unsharded
    solve's bits, at 20 iterations."""
    (C, c, F, f, x0, lb, ub), _ = _both(_problem(16))
    cfg = mt.MPCConfig(n_state=3, n_ctrl=4, T=5, lqr_iter=20,
                       exit_unconverged=False)
    solver.reset_eager_counts()
    sol = solve_sharded(cfg, make_mesh(MESH), x0, mt.QuadCost(C, c),
                        mt.LinDx(F, f), u_lower=lb, u_upper=ub)
    one = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), mt.LinDx(F, f),
                           u_lower=lb, u_upper=ub, device='cpu')
    assert solver.eager_counts['eager_solve'] == 0
    for a, b in zip(sol[:8], one[:8]):
        assert torch.equal(a, b)


def _u_zero_prev_ctrl_problem():
    (C, c, F, f, x0, lb, ub), jx = _both(_problem(16, seed=7))
    npr.seed(11)
    uz = npr.rand(5, 16, 4) < 0.3
    pc = npr.randn(16, 4)
    kw = dict(n_state=3, n_ctrl=4, T=5, lqr_iter=6, exit_unconverged=False,
              detach_unconverged=False, backprop=False,
              slew_rate_penalty=0.1)
    return (C, c, F, f, x0, lb, ub), jx, uz, pc, kw


def test_sharded_u_zero_prev_ctrl_passthrough():
    """The mask and prev_ctrl reach every shard, against mpc_tpu's jnp
    path on the port's eager route (use_fused='never': under 'auto' the
    masked slew problem goes to the dense kernel, whose box QP parts from
    the jnp path's at round-off ties, as PR 10 found for
    test_sharded_solve_matches_jax; its own sharded check is below)."""
    (C, c, F, f, x0, lb, ub), jx, uz, pc, kw = _u_zero_prev_ctrl_problem()
    sol = solve_sharded(mt.MPCConfig(**kw, use_fused='never'),
                        make_mesh(MESH), x0,
                        mt.QuadCost(C, c), mt.LinDx(F, f), u_lower=lb,
                        u_upper=ub, u_zero_I=torch.tensor(uz),
                        prev_ctrl=torch.tensor(pc))
    jC, jc, jF, jf, jx0, jlb, jub = jx
    ref = j_solve_sharded(mpc_tpu.MPCConfig(**kw), j_make_mesh(), jx0,
                          mpc_tpu.QuadCost(jC, jc), mpc_tpu.LinDx(jF, jf),
                          u_lower=jlb, u_upper=jub,
                          u_zero_I=jnp.asarray(uz),
                          prev_ctrl=jnp.asarray(pc))
    _close(sol.u, ref.u)
    assert float(sol.u[torch.tensor(uz)].abs().max()) == 0.0


def test_sharded_u_zero_kernel_route_is_the_unsharded_one():
    """The same masked slew problem on the kernels' route (K3's dense
    configuration through the slew passthrough, its plain version here):
    the sharded solve gives the unsharded solve's bits, the pinned
    controls exactly 0.0, and no eager solve."""
    (C, c, F, f, x0, lb, ub), _, uz, pc, kw = _u_zero_prev_ctrl_problem()
    args = (x0, mt.QuadCost(C, c), mt.LinDx(F, f))
    bk = dict(u_lower=lb, u_upper=ub, u_zero_I=torch.tensor(uz),
              prev_ctrl=torch.tensor(pc))
    solver.reset_eager_counts()
    sol = solve_sharded(mt.MPCConfig(**kw), make_mesh(MESH), *args, **bk)
    one = mt.batched_solve(mt.MPCConfig(**kw), *args, device='cpu', **bk)
    assert solver.eager_counts['eager_solve'] == 0
    for a, b in zip(sol[:8], one[:8]):
        assert torch.equal(a, b)
    assert float(sol.u[torch.tensor(uz)].abs().max()) == 0.0


def _pendulum_problem(n_batch=16, T=10):
    npr.seed(5)
    th = np.pi * (2 * npr.random(n_batch) - 1) * 0.9
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(n_batch)], axis=1)
    q = np.array([1., 1., 0.1, 0.001])
    p = np.array([-1., 0., 0., 0.])
    C = np.tile(np.diag(q), (T, n_batch, 1, 1))
    c = np.tile(p, (T, n_batch, 1))
    lb = np.full((T, n_batch, 1), -2.0)
    return x0, C, c, lb, -lb


@pytest.mark.parametrize('use_fused', ['never', 'auto'])
def test_sharded_nonlinear_solve(use_fused):
    """The pendulum (test_sharding.py:test_sharded_nonlinear_solve): on
    the eager route against the JAX package; on the kernel route (the
    plain K1 on the CPU) bitwise the unsharded solve."""
    (x0, C, c, lb, ub), (jx0, jC, jc, jlb, jub) = _both(_pendulum_problem())
    kw = dict(n_state=3, n_ctrl=1, T=10, lqr_iter=10,
              exit_unconverged=False, detach_unconverged=False, eps=1e-4,
              linesearch_decay=0.2, max_linesearch_iter=5)
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                       use_fused=use_fused, **kw)
    dx = PendulumDx(device='cpu', dtype=torch.float64)
    sol = solve_sharded(cfg, make_mesh(MESH), x0, mt.QuadCost(C, c), dx,
                        u_lower=lb, u_upper=ub)
    one = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), dx, u_lower=lb,
                           u_upper=ub, device='cpu')
    if use_fused == 'auto':
        for a, b in zip(sol[:8], one[:8]):
            assert torch.equal(a, b)
        return
    ref = j_solve_sharded(
        mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF, **kw),
        j_make_mesh(), jx0, mpc_tpu.QuadCost(jC, jc), JPendulumDx(),
        u_lower=jlb, u_upper=jub)
    _close(sol.u, ref.u)


def test_sharded_train_step_matches_jax():
    """One SGD step of the sharded train step over eight CPU devices
    against mpc_tpu's over its eight virtual devices (the pendulum, a
    learned batch-shared cost, the eager route both sides), and against
    the port's unsharded step."""
    n_batch, T = 16, 5
    npr.seed(7)
    th = np.pi * (2 * npr.random(n_batch) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(n_batch)], 1)
    u_expert = npr.randn(T, n_batch, 1)
    q = np.array([1., 1., 0.1, 0.001])
    p = np.array([-1., 0., 0., 0.])
    kw = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              linesearch_decay=0.2, max_linesearch_iter=3)
    lr = 0.1

    # the JAX package's sharded step, SGD
    jcfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF, **kw)
    jtheta = {'q_log': jnp.log(jnp.asarray(q) + 0.5), 'p': jnp.asarray(p)}
    opt = optax.sgd(lr)
    jdx = JPendulumDx()
    mesh = j_make_mesh()
    jstep = j_sharded_step(
        jcfg, mesh, opt,
        lambda t: mpc_tpu.QuadCost(jnp.diag(jnp.exp(t['q_log'])), t['p']),
        lambda t: jdx, u_lower=-2.0, u_upper=2.0)
    with mesh:
        js, jloss = jstep(JTrainState(jtheta, opt.init(jtheta),
                                      jnp.asarray(0)),
                          jnp.asarray(x0), jnp.asarray(u_expert))

    # the port's, eager route (the jnp path's algorithm)
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                       use_fused='never', **kw)
    dx = PendulumDx(device='cpu', dtype=torch.float64)

    def make_cost(t):
        return mt.QuadCost(torch.diag(torch.exp(t['q_log'])), t['p'])

    def run(step_of):
        theta = {'q_log': torch.log(torch.tensor(q) + 0.5).requires_grad_(),
                 'p': torch.tensor(p).requires_grad_()}
        sgd = torch.optim.SGD(list(theta.values()), lr=lr)
        loss = step_of(sgd)(theta, torch.tensor(x0), torch.tensor(u_expert))
        return loss, theta

    loss, theta = run(lambda o: mt.make_sharded_train_step(
        cfg, make_mesh(MESH), o, make_cost, lambda t: dx, u_lower=-2.0,
        u_upper=2.0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=TOL)
    for k in theta:
        _close(theta[k].detach(), js.theta[k])
    loss1, theta1 = run(lambda o: mt.make_imitation_train_step(
        cfg, o, make_cost, lambda t: dx, u_lower=-2.0, u_upper=2.0,
        device='cpu'))
    assert abs(float(loss) - float(loss1)) <= 1e-12 * abs(float(loss1))
    for k in theta:
        assert float((theta[k] - theta1[k]).detach().abs().max()) <= 1e-12
