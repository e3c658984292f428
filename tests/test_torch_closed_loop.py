"""The port's closed loop (mpc_tpu_torch/closed_loop.py) on the CPU: the
six cases of tests/test_closed_loop.py.

- against the port's own host loop with the same protocol (solve, apply
  u[0], shift the warm start left with a zero tail), bitwise: the loop
  is the same calls;
- against ``mpc_tpu.make_closed_loop`` in float64, x and u within 1e-10
  relative at its sizes (B=4, T=8, 6 steps), on the eager route (the
  jnp path's algorithm; the kernel route's plain K1 takes other
  line-search decisions at round-off ties, see tests/test_torch_fused.py);
- the 100-step swing-up at B=4, T=20 through the kernel route (the plain
  K1 on the CPU): every pendulum within 0.1 of cos th = 1;
- a controller model that differs from the environment's; slew-rate
  penalties with the last applied control threaded as prev_ctrl (against
  a host loop bitwise and against mpc_tpu within 1e-10 on the eager
  route, 1e-8 on the kernel route); a callable and a LinDx environment.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.models import PendulumDx as JPendulumDx

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused

jax.config.update('jax_enable_x64', True)

TOL = 1e-10
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _setup(B=4, T=8, port=True, **kw):
    rng = np.random.RandomState(0)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=3)
    base.update(kw)
    if port:
        return (PendulumDx(device='cpu', dtype=torch.float64),
                torch.tensor(x0),
                mt.QuadCost(torch.tensor(np.diag(Q)), torch.tensor(P)),
                mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **base))
    return (JPendulumDx(), jnp.asarray(x0),
            mpc_tpu.QuadCost(jnp.asarray(np.diag(Q)), jnp.asarray(P)),
            mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                              **base))


def _host_loop(cfg, x0, cost, dx, n_steps, env=None, slew=False):
    """The receding-horizon loop of examples/control.py with the port's
    batched_solve, on the CPU."""
    env = env or dx
    x = x0
    u_warm = torch.zeros(cfg.T, x0.shape[0], 1, dtype=x0.dtype)
    prev = torch.zeros(x0.shape[0], 1, dtype=x0.dtype)
    xs, us, costs = [x], [], []
    for _ in range(n_steps):
        sol = mt.batched_solve(cfg, x, cost, dx, u_init=u_warm,
                               u_lower=-2.0, u_upper=2.0,
                               prev_ctrl=prev if slew else None,
                               device='cpu')
        u0 = sol.u[0]
        x = env(x, u0)
        prev = u0
        u_warm = torch.cat([sol.u[1:], torch.zeros_like(sol.u[:1])])
        xs.append(x)
        us.append(u0)
        costs.append(sol.costs)
    return torch.stack(xs), torch.stack(us), torch.stack(costs)


def _same(out, ref):
    for name, r in zip(('xs', 'us', 'costs'), ref):
        assert torch.equal(out[name], r), name


def _near_jax(out, ref, tol=TOL):
    for name in ('xs', 'us', 'costs'):
        a, b = out[name].numpy(), np.asarray(ref[name])
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), (
            name, np.abs(a - b).max())


def test_closed_loop_matches_host_loop():
    """The kernel route (plain K1 on the CPU) against the port's host
    loop, bitwise, one K1 solve a step; the eager route against
    mpc_tpu.make_closed_loop within 1e-10."""
    n_steps = 6
    dx, x0, cost, cfg = _setup()
    roll = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                               device='cpu')
    out = roll(x0, n_steps)
    assert out['xs'].shape == (n_steps + 1, 4, 3)
    assert out['us'].shape == (n_steps, 4, 1)
    assert out['costs'].shape == (n_steps, 4)
    _same(out, _host_loop(cfg, x0, cost, dx, n_steps))
    eager = dataclasses.replace(cfg, use_fused='never')
    out_e = mt.make_closed_loop(eager, cost, dx, u_lower=-2.0, u_upper=2.0,
                                device='cpu')(x0, n_steps)
    jdx, jx0, jcost, jcfg = _setup(port=False)
    ref = mpc_tpu.make_closed_loop(jcfg, jcost, jdx, u_lower=-2.0,
                                   u_upper=2.0)(jx0, n_steps)
    _near_jax(out_e, ref)


def test_closed_loop_swings_up():
    """100 steps stabilise the pendulum (the product demo)."""
    dx, x0, cost, cfg = _setup(B=4, T=20)
    assert fused.scope_gap(cfg, cost, dx) is None
    out = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                              device='cpu')(x0, 100)
    cos_th = out['xs'][-1][:, 0]
    assert bool((cos_th > 0.9).all()), cos_th


def test_closed_loop_model_mismatch():
    """The environment follows env_dynamics, not the controller's model."""
    dx, x0, cost, cfg = _setup()
    wrong = PendulumDx(params=torch.tensor([10.0, 1.2, 1.0],
                                           dtype=torch.float64))
    out = mt.make_closed_loop(cfg, cost, wrong, env_dynamics=dx,
                              u_lower=-2.0, u_upper=2.0, device='cpu')(x0, 4)
    assert torch.equal(out['xs'][1], dx(x0, out['us'][0]))
    _same(out, _host_loop(cfg, x0, cost, wrong, 4, env=dx))


def _slew_loop(route):
    """The pendulum's closed loop under slew 0.5 on ``route``, against a
    host loop doing the same bitwise and against one that does not thread
    prev_ctrl; returns (the loop's output, mpc_tpu's)."""
    n_steps = 4
    dx, x0, cost, cfg = _setup(slew_rate_penalty=0.5, use_fused=route)
    out = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                              device='cpu')(x0, n_steps)
    _same(out, _host_loop(cfg, x0, cost, dx, n_steps, slew=True))
    # without threading the controls differ
    plain = _host_loop(cfg, x0, cost, dx, n_steps)
    assert not torch.equal(out['us'], plain[1])
    jdx, jx0, jcost, jcfg = _setup(port=False, slew_rate_penalty=0.5)
    ref = mpc_tpu.make_closed_loop(jcfg, jcost, jdx, u_lower=-2.0,
                                   u_upper=2.0)(jx0, n_steps)
    return out, ref


def test_closed_loop_slew_threads_prev_ctrl():
    """Under a slew penalty each solve sees the last applied control as
    prev_ctrl: a host loop doing the same, bitwise, and mpc_tpu within
    1e-10 on the eager route (use_fused='never')."""
    out, ref = _slew_loop('never')
    _near_jax(out, ref)


def test_closed_loop_slew_kernel_route():
    """The same loop on the kernel route (the augmented pendulum in the
    dense configuration's model-step build, its plain version on the
    CPU): bitwise the host loop, and mpc_tpu within 1e-8 relative, the
    kernel route's closed-form 1-D box QP against the jnp path's PNQP
    (1e-11 on its control block), over 4 warm-started steps of 4
    iterations at eps = 0 (measured 2.9e-9)."""
    out, ref = _slew_loop('auto')
    _near_jax(out, ref, tol=1e-8)


def test_closed_loop_callable_env():
    """A callable environment with the port's batched contract,
    x [B, 3], u [B, 1] -> [B, 3]."""
    dx, x0, cost, cfg = _setup()
    A = torch.tensor(np.diag([0.9, 0.9, 0.8]))
    Bm = torch.tensor([[0.0], [0.1], [0.5]], dtype=torch.float64)

    def env(x, u):
        return x @ A.T + u @ Bm.T

    out = mt.make_closed_loop(cfg, cost, dx, env_dynamics=env, u_lower=-2.0,
                              u_upper=2.0, device='cpu')(x0, 3)
    _same(out, _host_loop(cfg, x0, cost, dx, 3, env=env))
    for i in range(3):
        assert torch.equal(out['xs'][i + 1], env(out['xs'][i], out['us'][i]))


def test_closed_loop_lindx_env():
    """A LinDx environment steps with its first-step system
    x' = F_0 [x; u] + f_0."""
    dx, x0, cost, cfg = _setup()
    rng = np.random.RandomState(5)
    F = torch.tensor(rng.uniform(-0.4, 0.4, (cfg.T - 1, 3, 4)))
    f = torch.tensor(0.05 * rng.randn(cfg.T - 1, 3))
    out = mt.make_closed_loop(cfg, cost, dx, env_dynamics=mt.LinDx(F, f),
                              u_lower=-2.0, u_upper=2.0, device='cpu')(x0, 2)
    sol = mt.batched_solve(cfg, x0, cost, dx,
                           u_init=torch.zeros(cfg.T, 4, 1,
                                              dtype=torch.float64),
                           u_lower=-2.0, u_upper=2.0, device='cpu')
    expect = torch.cat([x0, sol.u[0]], 1) @ F[0].T + f[0]
    torch.testing.assert_close(out['xs'][1], expect, rtol=0, atol=1e-14)
