"""Learned MLP dynamics through the port's solve, on the CPU, against the
JAX package: the plain PyTorch version of kernel K3's streamed-weights
configuration (MPC_DYN=2, csrc/nn.cuh), the eager route, the routing and
the gradients to the MLP's weights.

- float64, against ``mpc_tpu.learning.batched_solve(use_fused='never')``
  (its jnp path): the port's kernel route (the plain K3 with the MLP's
  stream step and Jacobian) and its eager route, each on x and u, at
  H = 8 and H = 100, with bounds and without: 1e-10.  The eager route
  follows the jnp path (measured <= 1.2e-14).  The kernel route solves
  the 1-D box QP in closed form where the jnp path runs PNQP, whose
  solves add 1e-11 to the diagonal (mpc_tpu/ops/lqr.py:143,
  mpc_tpu/ops/linalg.py:155-173): where a free control's Quu is small
  that moves the jnp iterates, by 8.3e-11 in the H = 8 box case
  (measured; the free cases and H = 100 ~1e-15).  A two-layer MLP
  through the eager route and the plain dense configuration's MLP build
  (csrc/nn_dense.cuh; tests/test_torch_mlp_dense.py holds it further).
- float32, at H = 8 (67 weights: the JAX package streams it too), B = 8,
  T = 5: the port's plain K3 against
  ``mpc_tpu.ops.fused.fused_batched_solve(..., interpret=True)`` on the
  problem of tests/test_fused_nn.py, within that test's 5e-4.
- routing: ``scope_gap`` admits the JAX package's ``bench_nn_dynamics``
  MLP (K3), a two-layer MLP and one of 4 states (the dense
  configuration's MLP build), and refuses a width past
  ``K3_NN_MAX_HIDDEN``, whose arithmetic is pinned; ``routes_long``
  sends the one-hidden-layer 3s1c MLP to K3; ``k3_launch`` with
  ``nn_hidden`` (a warp an example, the weights in shared memory always,
  each example's slots resident where they fit); the nvcc defines;
  ``use_fused='always'`` raises NotImplementedError for an MLP past the
  dense gate and ValueError for an affine model, and solves a two-layer
  MLP with the pseudo-Huber cost.
- gradients of an imitation loss with respect to the MLP's weights,
  x_init and c, against ``jax.grad`` through mpc_tpu's jnp path, in
  float64: through the kernel route (the plain K3, then the plain K2 on
  the MLP's per-example linearisation) and through the eager route:
  1e-8 relative to each gradient's largest entry.  The eager route
  follows the jnp fixed point (measured ~1e-15).  The kernel route
  measures 9.2e-9: the jnp fixed point, like the port's eager one, adds
  1e-11 to the free block's diagonal in its masked control solve
  (mpc_tpu/ops/linalg.py:155-173), and this MLP's Quu is small; on the
  same primal with that regularisation taken out, the plain K2 and the
  eager fixed point agree to 1e-13 (measured 4e-16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import AffineDynamics as JAffine, NNDynamics as JNN
from mpc_tpu.ops.fused import fused_batched_solve as j_fused_batched_solve

import mpc_tpu_torch as mt
from mpc_tpu_torch import learning, solver
from mpc_tpu_torch.ops import fused, fused_bwd, linalg
from mpc_tpu_torch.ops.diff import make_lqr_fixed_point
from mpc_tpu_torch.utils.convert import (affine_from_numpy,
                                         nn_dynamics_from_numpy,
                                         pseudo_huber_from_numpy,
                                         solution_to_numpy)

from test_torch_models import both_mlps, mlp_params

# the pendulum's swing-up objective, as bench_nn_dynamics uses it
# (benchmarks/configs.py:647-678)
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])
TOL = 1e-10
GRAD_TOL = 1e-8


def _x0(n, seed=4):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    return np.stack([np.cos(th), np.sin(th), 0.5 * rng.randn(n)], 1)


def _cfg_kw(T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=3,
                grad_method=mpc_tpu.GradMethods.AUTO_DIFF)
    base.update(kw)
    return base


def _port_cfg(**kw):
    kw['grad_method'] = mt.GradMethods[kw['grad_method'].name]
    return mt.MPCConfig(**kw)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('bound', [0.6, None], ids=['box', 'free'])
@pytest.mark.parametrize('hidden', [(8,), (100,), (6, 5)],
                         ids=['H8', 'H100', 'two_layers'])
def test_nn_solve_f64_matches_jnp_path(hidden, bound):
    T, B = 5, 6
    params = mlp_params(hidden, seed=2)
    jm, tm = both_mlps(params, 'sigmoid')
    x0 = _x0(B)
    kw = _cfg_kw(T)
    lim = {} if bound is None else dict(u_lower=-bound, u_upper=bound)
    ref = j_batched_solve(mpc_tpu.MPCConfig(**kw, use_fused='never'),
                          jnp.asarray(x0), mpc_tpu.QuadCost(
                              jnp.diag(jnp.asarray(Q)), jnp.asarray(P)),
                          jm, **lim)
    cost = mt.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    routes = {'eager': mt.batched_solve(
        _port_cfg(**kw, use_fused='never'), torch.tensor(x0), cost, tm,
        device='cpu', **lim)}
    assert fused.scope_gap(_port_cfg(**kw), cost, tm,
                           dtype=torch.float64) is None
    # K3's MLP configuration, or the dense one's MLP build for two layers
    dense = fused.routes_dense(tm, 3, 1)
    assert dense == (len(hidden) > 1)
    routes['plain dense' if dense else 'plain K3'] = \
        fused.fused_batched_solve(_port_cfg(**kw), torch.tensor(x0), cost,
                                  tm, **lim)
    if bound is not None:
        assert (np.abs(np.asarray(ref.u)) == bound).mean() > 0.05
    for name, sol in routes.items():
        out = solution_to_numpy(sol)
        assert _rel(out.u, ref.u) <= TOL, (name, _rel(out.u, ref.u))
        assert _rel(out.x, ref.x) <= TOL, (name, _rel(out.x, ref.x))
        np.testing.assert_array_equal(out.n_iter, np.asarray(ref.n_iter))


def test_nn_plain_k3_f32_matches_interpret_kernel():
    """tests/test_fused_nn.py::test_fused_nn_bounded's problem and call:
    hidden = 8 (67 weights, which the JAX package streams too), B = 8,
    T = 5, bounds +-1."""
    T = 5
    jm = JNN.init(jax.random.PRNGKey(0), 3, 1, hidden_sizes=(8,),
                  activation='sigmoid', dtype=jnp.float32)
    rng = np.random.RandomState(0)
    x0 = jnp.asarray(rng.randn(8, 3).astype(np.float32))
    C = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (T, 4, 4))
    c = jnp.zeros((T, 4), jnp.float32)
    lb = jnp.full((T, 8, 1), -1.0, jnp.float32)
    kw = _cfg_kw(T, lqr_iter=2, max_linesearch_iter=2)
    ref = j_fused_batched_solve(mpc_tpu.MPCConfig(**kw, use_fused='never'),
                                x0, mpc_tpu.QuadCost(C, c), jm, u_lower=lb,
                                u_upper=-lb, interpret=True)
    tm = nn_dynamics_from_numpy([(np.asarray(W), np.asarray(b))
                                 for W, b in jm.params], device='cpu')
    assert fused.routes_long(tm, T)
    out = solution_to_numpy(fused.fused_batched_solve(
        _port_cfg(**kw), torch.tensor(np.asarray(x0)),
        mt.QuadCost(torch.tensor(np.asarray(C)), torch.tensor(np.asarray(c))),
        tm, u_lower=torch.tensor(np.asarray(lb)),
        u_upper=torch.tensor(-np.asarray(lb))))
    for name in ('u', 'x', 'costs'):
        np.testing.assert_allclose(getattr(out, name),
                                   np.asarray(getattr(ref, name)), atol=5e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# routing, gate and launch geometry
# ---------------------------------------------------------------------------

def _mlp(hidden, ns=3, nc=1, act='sigmoid'):
    return mt.NNDynamics.init(ns, nc, hidden, act, generator=torch.Generator(
        ).manual_seed(0), device='cpu')


def test_scope_gap_admits_the_bench_mlp_and_refuses_the_rest():
    bench = mt.MPCConfig(**_cfg_kw(20, lqr_iter=10))
    cost = mt.QuadCost(torch.diag(torch.tensor(Q, dtype=torch.float32)),
                       torch.tensor(P, dtype=torch.float32))
    for act in fused.NN_ACTIVATIONS:
        assert fused.scope_gap(bench, cost, _mlp((100,), act=act)) is None
    assert fused.routes_long(_mlp((100,)), 2)
    # a deeper MLP and other sizes: the dense configuration's MLP build
    assert fused.scope_gap(bench, cost, _mlp((16, 16))) is None
    assert fused.routes_dense(_mlp((16, 16)), 3, 1)
    four = mt.MPCConfig(**dict(_cfg_kw(20), n_state=4))
    four_cost = mt.QuadCost(torch.eye(5), torch.zeros(5))
    assert fused.scope_gap(four, four_cost, _mlp((8,), ns=4)) is None
    assert fused.routes_dense(_mlp((8,), ns=4), 4, 1)
    wide = _mlp((fused.K3_NN_MAX_HIDDEN + 1,))
    assert 'shared memory' in fused.scope_gap(bench, cost, wide)
    assert fused.scope_gap(bench, cost, _mlp((fused.K3_NN_MAX_HIDDEN,))) \
        is None
    # the pseudo-Huber cost: K3's MLP build takes it (its cost build), and
    # so does the dense configuration's with a deeper MLP
    huber = pseudo_huber_from_numpy(np.ones(4), np.zeros(4), device='cpu')
    assert fused.scope_gap(bench, huber, _mlp((100,))) is None
    assert fused.scope_gap(bench, huber, _mlp((16, 16))) is None
    # five hidden layers: past the MLP build's layout
    assert 'hidden layers' in fused.scope_gap(bench, cost,
                                              _mlp((4,) * 5))
    # the solver's wants_grad finds the MLP's parameters
    assert solver.wants_grad(mt.MPCConfig(**_cfg_kw(20, backprop=True)),
                             _mlp((8,)))


def test_nn_gate_is_what_shared_memory_holds():
    H = fused.K3_NN_MAX_HIDDEN
    assert H == 7263
    assert fused._nn_weight_bytes(H) == 16 * (2 * H + 1) <= fused.SMEM_LIMIT
    assert fused._nn_weight_bytes(H + 1) > fused.SMEM_LIMIT
    assert _mlp((100,)).soa_param_count() == 8 * 100 + 3 == 803


@pytest.mark.parametrize('B', [1, 33, 2048, 2050])
@pytest.mark.parametrize('T', [2, 20, 84, 85, 600])
@pytest.mark.parametrize('H', [8, 100])
def test_k3_launch_geometry_for_the_mlp(H, T, B):
    """A warp an example (fused.k3_nn_launch): the weights always in
    shared memory, each example's NN_SLOTS float4 a step and the block's
    copy of the shared operands beside them while an SM still holds its
    4 blocks, else the slots in the workspace; 16 warps an SM by
    registers."""
    geo = fused.k3_launch(T, B, 3, H)
    weights = 16 * (2 * H + 1)
    per_step = geo['warps'] * fused.NN_SLOTS * 16 + 4 * 40
    # resident while an SM still holds 4 blocks by shared memory (228 KB,
    # 1 KB reserved a block)
    resident = 4 * (weights + T * per_step + 1024) <= 233472
    assert geo['warps'] == fused.K3_NN_WARPS
    assert geo['team'] == 32 and geo['examples'] == geo['warps']
    assert geo['blocks'] == -(-B // geo['examples'])
    assert geo['min_blocks'] * geo['warps'] == 16
    assert geo['smem_bytes'] == (weights + T * per_step if resident
                                 else weights) <= fused.SMEM_LIMIT
    assert geo['slots'] == (0 if resident else fused.NN_SLOTS)
    assert geo['workspace_bytes'] == T * geo['slots'] * B * 16
    if H == 100:
        assert resident == (T <= 99)


def test_nn_main_path_geometry_and_defines():
    assert fused.k3_launch(20, 2048, 3, 100) == dict(
        team=32, warps=4, examples=4, blocks=512, min_blocks=4, slots=0,
        smem_bytes=3216 + 20 * (4 * 6 * 16 + 160), workspace_bytes=0)
    # without an MLP nothing changes
    assert fused.k3_launch(160, 4096, 3) == fused.k3_launch(160, 4096, 3, 0)
    assert fused.long_kernel_defines(False, True, 'sigmoid') == dict(
        MPC_DYN=2, MPC_ACT=0, MPC_HAS_BOUNDS=1, MPC_TEAM=32,
        MPC_WARPS=fused.K3_NN_WARPS, MPC_MIN_BLOCKS=4, MPC_OP_ROW=40)
    assert fused.long_kernel_defines(False, False, 'elu')['MPC_ACT'] == 2
    assert fused.long_kernel_defines(True, True)['MPC_DYN'] == 0


def test_nn_operation_counts():
    step, jac = fused.nn_op_counts(100, 'sigmoid', True)
    assert (step, jac) == (100 * 18 + 6, 100 * 41 + 3)
    assert fused.nn_op_counts(100, 'relu', False) == (100 * 14 + 3,
                                                       100 * 35)
    pend = fused.k3_flops(20, 3, 1, 10, 15, lindx=False)
    nn = fused.k3_flops(20, 3, 1, 10, 15, lindx=False, nn_ops=(step, jac))
    # per solve: 19 steps of the initial rollout, then per iteration 19
    # Jacobians in the sweep and 19 steps of each trial rollout
    assert nn - pend == (19 * (step - fused._STEP_OPS)
                         + 10 * 19 * (jac - fused._JAC_OPS)
                         + 15 * 19 * (step - fused._STEP_OPS))


def test_always_names_the_kernel_configuration_that_waits():
    cfg = mt.MPCConfig(**_cfg_kw(5, use_fused='always'))
    x0 = torch.tensor(_x0(2), dtype=torch.float32)
    cost = mt.QuadCost(torch.diag(torch.tensor(Q, dtype=torch.float32)),
                       torch.tensor(P, dtype=torch.float32))
    with pytest.raises(NotImplementedError, match='hidden layers'):
        mt.batched_solve(cfg, x0, cost, _mlp((4,) * 5), device='cpu')
    huber = pseudo_huber_from_numpy(np.ones(4, np.float32),
                                    np.zeros(4, np.float32), device='cpu')
    with pytest.raises(NotImplementedError, match='hidden layers'):
        mt.batched_solve(cfg, x0, huber, _mlp((4,) * 5), device='cpu')
    # a two-layer MLP, refused here before the dense configuration's MLP
    # build, now solves under 'always' with either cost (the plain dense
    # version on the CPU)
    solver.reset_eager_counts()
    for c_ in (cost, huber):
        sol = mt.batched_solve(cfg, x0, c_, _mlp((6, 5)), device='cpu')
        assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 0
    # the pseudo-Huber cost with a one-hidden-layer MLP, refused here
    # before K3's cost build, now solves (the plain K3 on the CPU)
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, huber, _mlp((8,)), device='cpu')
    assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 0
    affine = affine_from_numpy(np.eye(3, dtype=np.float32),
                               np.ones((3, 1), np.float32), device='cpu')
    with pytest.raises(ValueError):
        mt.batched_solve(cfg, x0, cost, affine, device='cpu')
    # mpc_tpu refuses the affine model too
    with pytest.raises(ValueError):
        j_batched_solve(mpc_tpu.MPCConfig(**_cfg_kw(5, use_fused='always')),
                        jnp.asarray(x0.numpy()), mpc_tpu.QuadCost(
                            jnp.diag(jnp.asarray(Q, jnp.float32)),
                            jnp.asarray(P, jnp.float32)),
                        JAffine(jnp.eye(3, dtype=jnp.float32),
                                jnp.ones((3, 1), jnp.float32)))


# ---------------------------------------------------------------------------
# gradients to the MLP's weights
# ---------------------------------------------------------------------------

def test_nn_gradients_match_jax_f64():
    T, B = 5, 6
    params = mlp_params((16,), seed=3)
    x0 = _x0(B, seed=5)
    u_exp = 0.3 * np.random.RandomState(6).randn(T, B, 1)
    kw = _cfg_kw(T, lqr_iter=6, backprop=True)

    def j_loss(prm, x, cv):
        sol = j_batched_solve(
            mpc_tpu.MPCConfig(**kw), x,
            mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)), cv),
            JNN(prm, 'sigmoid', True, 3, 1), u_lower=-0.6, u_upper=0.6)
        return jnp.mean((sol.u - u_exp) ** 2) + 0.1 * jnp.mean(sol.x ** 2)

    jparams = [(jnp.asarray(W), jnp.asarray(b)) for W, b in params]
    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jparams, jnp.asarray(x0),
                                              jnp.asarray(P))
    ref_w = [np.asarray(a) for Wb in ref[0] for a in Wb]
    for route in ('auto', 'never'):
        tm = nn_dynamics_from_numpy(params, device='cpu')
        x = torch.tensor(x0, requires_grad=True)
        cv = torch.tensor(P, requires_grad=True)
        sol = mt.batched_solve(
            _port_cfg(**kw, use_fused=route), x,
            mt.QuadCost(torch.diag(torch.tensor(Q)), cv), tm, u_lower=-0.6,
            u_upper=0.6, device='cpu')
        loss = ((sol.u - torch.tensor(u_exp)) ** 2).mean() \
            + 0.1 * (sol.x ** 2).mean()
        loss.backward()
        got_w = [p.grad.numpy() for p in tm.parameters()]
        for name, g, r in zip(('W1', 'b1', 'W2', 'b2'), got_w, ref_w):
            assert _rel(g, r) <= GRAD_TOL, (route, name, _rel(g, r))
        assert _rel(x.grad.numpy(), ref[1]) <= GRAD_TOL, route
        assert _rel(cv.grad.numpy(), ref[2]) <= GRAD_TOL, route
        assert float(np.abs(got_w[0]).max()) > 0


def test_nn_plain_k2_is_the_exact_fixed_point(monkeypatch):
    """Same primal: the plain K2 on the MLP's per-example linearisation
    against the eager fixed point with its 1e-11 regularisation of the
    masked control solve taken out (the one difference between them)."""
    T, B = 5, 6
    tm = nn_dynamics_from_numpy(mlp_params((16,), seed=3), device='cpu')
    cfg = _port_cfg(**_cfg_kw(T, lqr_iter=6, backprop=True))
    cost = mt.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    x = torch.tensor(_x0(B, seed=5))
    with torch.no_grad():
        sol = fused.fused_batched_solve(cfg, x, cost, tm, u_lower=-0.6,
                                        u_upper=0.6)
    F, f = solver.linearize_dynamics(tm, sol.x, sol.u, cfg.grad_method)
    C, c = cost.C.expand(T, 4, 4), cost.c.expand(T, 4)
    lb = torch.tensor(-0.6, dtype=torch.float64).expand(T, 1, 1)
    u_exp = torch.tensor(0.3 * np.random.RandomState(6).randn(T, B, 1))
    exact = linalg.masked_free_matrix
    monkeypatch.setattr(linalg, 'masked_free_matrix',
                        lambda H, free, clamped_diag=1.0, reg=0.0: exact(
                            H, free, clamped_diag, 0.0))
    grads = []
    for fp, CC, cc in ((fused_bwd.make_batched_fixed_point(3, True, True),
                        C, c),
                       (make_lqr_fixed_point(3, True, True),
                        C.unsqueeze(1), c.unsqueeze(1))):
        leaves = [t.detach().clone().requires_grad_() for t in (x, F, f)]
        xs, us = fp.apply(leaves[0], CC, cc, leaves[1], leaves[2], lb, -lb,
                          sol.x, sol.u)
        (((us - u_exp) ** 2).mean() + 0.1 * (xs ** 2).mean()).backward()
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(('x_init', 'F', 'f'), *grads):
        assert _rel(a.numpy(), b.numpy()) <= 1e-13, (name, _rel(a, b))
