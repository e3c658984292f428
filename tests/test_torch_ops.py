"""The four kernels' ``torch.library`` ops (mpc_tpu_torch/ops/custom.py)
on the CPU, where each runs its kernel's plain version.

- ``torch.library.opcheck`` on each op at small shapes: the schema, the
  fake (meta) version against the real one (shapes, dtypes, strides),
  the autograd registration and AOT dispatch with dynamic shapes, for
  bounds, f and the active set present and absent, shared and batched
  leaves;
- the wrappers (``fused.fused_ilqr``, ``fused_ilqr_long``,
  ``fused_bwd.fused_kkt_backward``, ``fused_kkt_backward_long``) give
  the plain versions' bits: they call nothing but the op;
- the serving process: importing ``mpc_tpu_torch.ops.custom`` registers
  the ops and loads none of the solver's modules (checked in a
  subprocess).

This file imports nothing of JAX.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from mpc_tpu_torch.models import CartpoleDx, NNDynamics, PendulumDx
from mpc_tpu_torch.ops import custom, fused, fused_bwd

T, B = 4, 3
ALPHAS = [1.0, 0.2]
SOLVER_MODULES = ('mpc_tpu_torch.solver', 'mpc_tpu_torch.learning',
                  'mpc_tpu_torch.mpc', 'mpc_tpu_torch.closed_loop',
                  'mpc_tpu_torch.ops.lqr', 'mpc_tpu_torch.ops.pnqp',
                  'mpc_tpu_torch.ops.diff', 'mpc_tpu_torch.ops.pscan',
                  'mpc_tpu_torch.utils.export')


def _rng(seed=0):
    return np.random.RandomState(seed)


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def _cost(rng, shared):
    n = 1 if shared else B
    q = rng.uniform(0.5, 1.5, (T, n, 4))
    C = np.zeros((T, n, 4, 4))
    for i in range(4):
        C[..., i, i] = q[..., i]
    return _t(C), _t(rng.randn(T, n, 4))


def _solve_args(rng, shared, bounds):
    C, c = _cost(rng, shared)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = _t(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1))
    lb = ub = None
    if bounds:
        lb = _t(np.full((T, 1 if shared else B), -1.5))
        ub = -lb
    return C, c, x0, torch.zeros(T, B, dtype=torch.float64), lb, ub


TAIL = (ALPHAS, 3, 0.0, 1e-4, 5.0)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('bounds', [True, False])
def test_opcheck_k1(shared, bounds):
    C, c, x0, u0, lb, ub = _solve_args(_rng(1), shared, bounds)
    params = _t([10., 1., 1.])
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k1_solve,
                          (params, C, c, x0, u0, lb, ub, *TAIL))


@pytest.mark.parametrize('model', ['lindx', 'lindx-f', 'pendulum', 'mlp'])
@pytest.mark.parametrize('bounds', [True, False])
def test_opcheck_k3(model, bounds):
    rng = _rng(2)
    C, c, x0, u0, lb, ub = _solve_args(rng, False, bounds)
    params = F = f = None
    nn_kw = (0, '', False)
    if model.startswith('lindx'):
        F = _t(np.concatenate([np.eye(3) + 0.1 * rng.randn(T - 1, 1, 3, 3),
                               rng.randn(T - 1, 1, 3, 1)], -1))
        if model == 'lindx-f':
            f = _t(0.1 * rng.randn(T - 1, B, 3))
    elif model == 'pendulum':
        params = _t([10., 1., 1.])
    else:
        dx = NNDynamics.init(3, 1, (5,), 'elu',
                             generator=torch.Generator().manual_seed(0),
                             device='cpu', dtype=torch.float64)
        params = dx.kernel_params().detach()
        nn_kw = (5, 'elu', True)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3_solve,
                          (params, F, f, C, c, x0, u0, lb, ub, *TAIL,
                           *nn_kw))


def _bwd_args(rng, cost_shared, dyn_shared, mask):
    C, c = _cost(rng, cost_shared)
    F = _t(rng.uniform(-0.5, 0.5, (T - 1, 1 if dyn_shared else B, 3, 4)))
    x_star = _t(rng.randn(T, B, 3))
    u_star = _t(rng.randn(T, B, 1))
    I_mask = _t((rng.rand(T, B, 1) < 0.3).astype(float)) if mask else None
    return (C, c, F, x_star, u_star, _t(rng.randn(T, B, 3)),
            _t(rng.randn(T, B, 1)), I_mask)


@pytest.mark.parametrize('cost_shared', [True, False])
@pytest.mark.parametrize('mask', [True, False])
@pytest.mark.parametrize('has_f', [True, False])
def test_opcheck_k2(cost_shared, mask, has_f):
    args = _bwd_args(_rng(3), cost_shared, False, mask)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k2_backward,
                          (*args, has_f))


@pytest.mark.parametrize('cost_shared', [True, False])
@pytest.mark.parametrize('dyn_shared', [True, False])
@pytest.mark.parametrize('has_f', [True, False])
def test_opcheck_k4(cost_shared, dyn_shared, has_f):
    args = _bwd_args(_rng(4), cost_shared, dyn_shared, True)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k4_backward,
                          (*args, has_f))


def test_wrappers_are_the_plain_versions():
    """The wrappers run the op, which runs the plain version on the CPU:
    the same bits as calling the plain versions directly."""
    rng = _rng(5)
    C, c, x0, u0, lb, ub = _solve_args(rng, True, True)
    kw = dict(alphas=ALPHAS, lqr_iter=3, eps=0.0, best_cost_eps=1e-4,
              not_improved_lim=5.0)
    dx = PendulumDx(device='cpu', dtype=torch.float64)
    ops = dict(dynamics=dx, params=dx.params, C=C, c=c, x0=x0, u0=u0, lb=lb,
               ub=ub, **kw)
    for a, b in zip(fused.fused_ilqr(**ops), fused.fused_solve_plain(**ops)):
        assert torch.equal(a, b)
    ops = dict(ops, F=None, f=None)
    for a, b in zip(fused.fused_ilqr_long(**ops),
                    fused.fused_solve_long_plain(**ops)):
        assert torch.equal(a, b)
    args = _bwd_args(rng, True, True, True)
    for has_f in (True, False):
        got = fused_bwd.fused_kkt_backward_long(*args, has_f=has_f)
        ref = fused_bwd.fused_kkt_backward_long_plain(*args, has_f=has_f)
        assert (got[4] is None) == (not has_f)
        for a, b in zip(got, ref):
            assert (a is None and b is None) or torch.equal(a, b)
    args = _bwd_args(rng, False, False, False)
    for a, b in zip(fused_bwd.fused_kkt_backward(*args),
                    fused_bwd.fused_kkt_backward_plain(*args)):
        assert torch.equal(a, b)


def test_k1_wrapper_refuses_another_model():
    """K1's source is the pendulum (simple or damped): the wrapper refuses
    any other model rather than run the pendulum in its place, and the op
    refuses a parameter vector of neither pendulum."""
    C, c, x0, u0, lb, ub = _solve_args(_rng(6), True, True)
    kw = dict(alphas=ALPHAS, lqr_iter=1, eps=0.0, best_cost_eps=1e-4,
              not_improved_lim=5.0)
    cart = CartpoleDx(device='cpu', dtype=torch.float64)
    with pytest.raises(ValueError, match='pendulum'):
        fused.fused_ilqr(cart, _t([10., 1., 1.]), C, c, x0, u0, lb, ub, **kw)
    damped = PendulumDx(simple=False, device='cpu', dtype=torch.float64)
    fused.fused_ilqr(damped, _t([10., 1., 1., 0.1, 0.2]), C, c, x0, u0, lb,
                     ub, **kw)
    with pytest.raises(ValueError, match='params'):
        custom._check_pendulum_params('K1', _t([1., 2.]))


def test_ops_import_without_the_solver():
    """A serving process imports the ops and none of the solver."""
    code = ('import sys, torch, mpc_tpu_torch.ops.custom\n'
            'assert hasattr(torch.ops.mpc_tpu_torch, "k4_backward")\n'
            f'print(sorted(m for m in {SOLVER_MODULES!r} '
            'if m in sys.modules))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]', out.stdout
