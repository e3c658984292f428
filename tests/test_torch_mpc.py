"""The port's MPC front end and dispatch, on the CPU.

- a few receding-horizon swing-up steps of mpc_tpu_torch.MPC against
  mpc_tpu.MPC in float64 (tolerance 1e-8: each solve agrees to ~1e-12 and
  the closed loop carries the states on; see test_torch_fused.py);
- the reference's exit semantics, the slice's NotImplementedError for
  every input outside it, gradients through backprop=True, the default
  device, and an import of the port that brings in nothing of JAX or
  mpc_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (lin_dx_from_numpy,
                                         pendulum_from_numpy,
                                         quad_cost_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = np.array([10., 1., 1.])
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _x0(B, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    return np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)


def test_swingup_steps_match_jax_mpc():
    """The pendulum's receding-horizon swing-up loop, shortened to three
    steps, through both MPC classes."""
    B, T = 4, 20
    kw = dict(u_lower=-2., u_upper=2., lqr_iter=50, n_batch=B,
              grad_method=mpc_tpu.GradMethods.AUTO_DIFF, eps=1e-2,
              exit_unconverged=False, backprop=False,
              linesearch_decay=0.2, max_linesearch_iter=5)
    jdx = JPendulumDx(params=jnp.asarray(PARAMS))
    tdx = pendulum_from_numpy(PARAMS, device='cpu')
    jcost = mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)), jnp.asarray(P))
    tcost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    jx = jnp.asarray(_x0(B))
    tx = torch.tensor(_x0(B))
    ju = tu = None
    for _ in range(3):
        jxs, jus, jcs = mpc_tpu.MPC(3, 1, T, u_init=ju, **kw)(jx, jcost, jdx)
        txs, tus, tcs = mt.MPC(3, 1, T, u_init=tu, device='cpu',
                               **kw)(tx, tcost, tdx)
        for a, b in ((txs, jxs), (tus, jus), (tcs, jcs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8)
        jx = jdx(jx, jus[0])
        tx = tdx(tx, tus[0])
        ju = jnp.concatenate([jus[1:], jnp.zeros((1, B, 1))], 0)
        tu = torch.cat([tus[1:], torch.zeros(1, B, 1, dtype=tus.dtype)], 0)


def _one_solve(T=5, **kw):
    """A generic-angle (th = 2.0) pendulum solve through the port."""
    x0 = torch.tensor([[np.cos(2.0), np.sin(2.0), 0.0]])
    ctrl = mt.MPC(3, 1, T, device='cpu', **kw)
    return ctrl(x0, quad_cost_from_numpy(np.diag(Q), P, 'cpu'),
                pendulum_from_numpy(PARAMS, device='cpu'))


def test_exit_unconverged_raises():
    with pytest.raises(AssertionError, match='did not converge'):
        _one_solve(u_lower=-2., u_upper=2., lqr_iter=1, eps=1e-9,
                   backprop=False)
    # converged (or not asked to check): returns the reference's triple
    x, u, costs = _one_solve(u_lower=-2., u_upper=2., lqr_iter=1,
                             eps=1e-9, backprop=False,
                             exit_unconverged=False,
                             detach_unconverged=False)
    assert x.shape == (5, 1, 3) and u.shape == (5, 1, 1)
    assert costs.shape == (1,)


OUT_OF_SCOPE = {
    'u_zero_I': dict(u_zero_I=torch.zeros(5, 1, dtype=torch.bool)),
    'delta_u': dict(u_lower=-2., u_upper=2., delta_u=0.5),
    'slew': dict(slew_rate_penalty=0.1),
    'prev_ctrl': dict(prev_ctrl=torch.zeros(1)),
    'verbose': dict(verbose=1),
    'analytic_check': dict(grad_method=mt.GradMethods.ANALYTIC_CHECK),
    'eager_solver': dict(use_fused='never'),
}


@pytest.mark.parametrize('case', list(OUT_OF_SCOPE))
def test_out_of_scope_knobs_raise(case):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        _one_solve(backprop=False, exit_unconverged=False,
                   **OUT_OF_SCOPE[case])


def _solve_long_horizon():
    """The pendulum one step past K1's horizon limit: the streaming
    solve (K3's plain version here) takes it."""
    T = fused.T_MAX + 1
    x, u, costs = _one_solve(T=T, u_lower=-2., u_upper=2., lqr_iter=1,
                             backprop=False, exit_unconverged=False)
    return T, 1, x, u, costs


def _solve_lindx():
    """A LinDx with F and f, handed to ``batched_solve``."""
    T, B = 5, 2
    rng = np.random.RandomState(0)
    F = np.tile(np.concatenate([0.9 * np.eye(3), 0.3 * np.ones((3, 1))], 1),
                (T - 1, 1, 1))
    sol = mt.batched_solve(
        _cfg(lqr_iter=2, exit_unconverged=False), torch.tensor(_x0(B)),
        quad_cost_from_numpy(np.diag(Q), P, 'cpu'),
        lin_dx_from_numpy(F, 0.1 * rng.randn(T - 1, 3), 'cpu'),
        u_lower=-2., u_upper=2., device='cpu')
    return T, B, sol.x, sol.u, sol.costs


@pytest.mark.parametrize('solve', [_solve_long_horizon, _solve_lindx],
                         ids=['long_horizon', 'lindx'])
def test_streaming_route_problems_solve(solve):
    """Problems that route to the streaming solve (K3's plain version
    here): finite values of the expected shapes inside the box."""
    T, B, x, u, costs = solve()
    assert x.shape == (T, B, 3) and u.shape == (T, B, 1)
    assert costs.shape == (B,)
    for a in (x, u, costs):
        assert torch.isfinite(a).all()
    assert float(u.abs().max()) <= 2.0


def _cfg(**kw):
    base = dict(n_state=3, n_ctrl=1, T=5, backprop=False)
    base.update(kw)
    return mt.MPCConfig(**base)


def test_out_of_scope_problems_raise():
    T = 5
    x0 = torch.tensor(_x0(2))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    cases = [
        (_cfg(), cost, lin_dx_from_numpy(np.zeros((T - 1, 2, 3, 4, 1)),
                                         None, 'cpu')),
        (_cfg(), cost, PendulumDx(simple=False, device='cpu',
                                  dtype=torch.float64)),
        (_cfg(n_ctrl=2), quad_cost_from_numpy(np.eye(5), np.zeros(5),
                                              'cpu'), dx),
        (_cfg(), lambda tau: (tau * tau).sum(), dx),
    ]
    for cfg, cst, dyn in cases:
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            mt.batched_solve(cfg, x0, cst, dyn, device='cpu')
    # float64 on the card: refused before anything touches a card
    assert 'float64' in fused.scope_gap(_cfg(), cost, dx,
                                        dtype=torch.float64,
                                        device=torch.device('cuda'))
    assert fused.supports(_cfg(), cost, dx, dtype=torch.float64)
    with pytest.raises(ValueError, match='both'):
        mt.batched_solve(_cfg(), x0, cost, dx, u_lower=-2., device='cpu')


def test_backprop_guard():
    """backprop=True (the default) runs the forward solve with the same
    values as backprop=False; with an input that requires grad, x and u
    now carry gradients back to it (they once raised here); under
    torch.no_grad() the solve returns plain values."""
    x0 = torch.tensor(_x0(3))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    a = mt.batched_solve(_cfg(backprop=True), x0, cost, dx, u_lower=-2., u_upper=2.,
                         device='cpu')
    b = mt.batched_solve(_cfg(), x0, cost, dx, u_lower=-2., u_upper=2., device='cpu')
    np.testing.assert_array_equal(a.u.numpy(), b.u.numpy())
    xg = x0.clone().requires_grad_()
    s = mt.batched_solve(_cfg(backprop=True), xg, cost, dx, u_lower=-2., u_upper=2.,
                         device='cpu')
    np.testing.assert_array_equal(s.u.detach().numpy(), b.u.numpy())
    (s.u.sum() + s.x.sum()).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    Cg = cost.C.clone().requires_grad_()
    s = mt.batched_solve(_cfg(backprop=True), x0, mt.QuadCost(Cg, cost.c),
                         dx, u_lower=-2., u_upper=2., device='cpu')
    s.u.sum().backward()
    assert torch.isfinite(Cg.grad).all() and Cg.grad.abs().sum() > 0
    # bounds alone requiring grad: the reference's zero gradient
    lb = torch.tensor(-2., dtype=x0.dtype, requires_grad=True)
    s = mt.batched_solve(_cfg(backprop=True), x0, cost, dx, u_lower=lb,
                         u_upper=2., device='cpu')
    np.testing.assert_array_equal(s.u.detach().numpy(), b.u.numpy())
    s.u.sum().backward()
    assert lb.grad is not None and float(lb.grad) == 0.0
    with torch.no_grad():
        c = mt.batched_solve(_cfg(backprop=True), xg, cost, dx, u_lower=-2., u_upper=2.,
                             device='cpu')
    assert c.u.grad_fn is None
    np.testing.assert_array_equal(c.u.numpy(), b.u.numpy())


def test_default_device_is_the_card(monkeypatch):
    """With no card, an entry point left at its default device raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x0 = torch.tensor(_x0(2))
    cost = quad_cost_from_numpy(np.diag(Q), P, 'cpu')
    dx = pendulum_from_numpy(PARAMS, device='cpu')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.batched_solve(_cfg(), x0, cost, dx)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.MPC(3, 1, 5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PendulumDx()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        quad_cost_from_numpy(np.diag(Q), P)


def test_port_imports_nothing_of_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest), the
    port's modules and chip_smoke.py import neither jax nor mpc_tpu."""
    code = (
        'import sys, importlib\n'
        'for m in ("mpc_tpu_torch", "mpc_tpu_torch.ops.fused",\n'
        '          "mpc_tpu_torch.ops._build", "mpc_tpu_torch.mpc",\n'
        '          "mpc_tpu_torch.learning", "mpc_tpu_torch.solver",\n'
        '          "mpc_tpu_torch.utils.convert", "mpc_tpu_torch.ops.fused_bwd",\n'
        '          "mpc_tpu_torch.ops.diff", "mpc_tpu_torch.utils.fd",\n'
        '          "mpc_tpu_torch.types", "mpc_tpu_torch.models.pendulum",\n'
        '          "chip_smoke"):\n'
        '    importlib.import_module(m)\n'
        'bad = [n for n in sys.modules if n in ("jax", "mpc_tpu")\n'
        '       or n.startswith(("jax.", "mpc_tpu."))]\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == '[]'
