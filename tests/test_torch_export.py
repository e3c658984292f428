"""Serving artifacts of the port (mpc_tpu_torch/utils/export.py) on the
CPU: the counterparts of tests/test_export.py, float64.

- the batched solve with array bounds on the eager route (the LinDx of
  ``_lin_setup``, two controls): the artifact gives the live port's bits,
  on the example and on fresh data, and lies within 1e-10 of the JAX
  package's artifact on the same data (the eager solver and the jnp path
  are one algorithm; they agree to ~1e-15 where they take the same
  decisions);
- while exporting, the eager solver runs every iteration where the live
  solve stops early (solver.py), with the same bits;
- scalar bounds baked in; a batch-polymorphic artifact and a padded one
  (``max_batch``) on the kernel route, which keep the K1 op and give the
  live bits at every batch;
- gradient programs: ``torch.autograd.grad`` through the eager fixed
  point (the JAX test's problem), through the dense forward and K2 and
  K4's dense configuration (a 4-state, 2-control LinDx; the live bits)
  and through K1 and K2 (the pendulum),
  each bitwise the live gradient and within 1e-8 of ``jax.grad`` (relative
  to the largest entry; the two forward solves are converged, so their
  gradients differ by the jnp path's 1e-11 regularisation of the control
  block at most);
- a learned cost's gradient program (config 4's diag(exp(q_log)), the
  exp written to save its input, which torch.export needs);
- the closed loop, one K1 op a step; the one-sided bounds error; the
  route decided for the artifact's device; a forced kernel outside the
  kernels' scope refused;
- an artifact answered by a process that imports ``torch`` and
  ``mpc_tpu_torch.ops.custom`` only, with none of the solver's modules
  loaded.

The eager route unrolls every iteration, line-search step and PNQP trip
into the graph (thousands of nodes an iteration), so its cases run small
configurations; the kernel route is one node of its op.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.utils import export as j_export

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.utils import export as ex

jax.config.update('jax_enable_x64', True)

TOL = 1e-10
GRAD_TOL = 1e-8
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])
# the eager cases: _lin_setup's problem at T=3 with two iterations (one
# for the gradient program, whose backward is traced too), two step
# sizes and three PNQP trips, so that the unrolled graph exports in
# seconds
# the eager route's export (two controls went there until the kernels'
# dense configuration took them; 'never' keeps these cases on it)
EAGER = dict(lqr_iter=2, max_linesearch_iter=2, pnqp_iter=3,
             use_fused='never')
EAGER_GRAD = dict(EAGER, lqr_iter=1)


def _lin_setup(B=3, T=3, ns=3, nc=2):
    """tests/test_export.py:_lin_setup as numpy arrays."""
    rng = np.random.RandomState(7)
    ntau = ns + nc
    F = rng.uniform(-0.6, 0.6, (T - 1, B, ns, ntau))
    f = 0.1 * rng.randn(T - 1, B, ns)
    Cq = rng.randn(T, B, ntau, ntau)
    C = np.matmul(Cq, Cq.transpose(0, 1, 3, 2)) / 2 + 0.5 * np.eye(ntau)
    c = rng.randn(T, B, ntau)
    x0 = rng.randn(B, ns)
    lb = np.full((T, B, nc), -0.7)
    return dict(x0=x0, C=C, c=c, F=F, f=f, lb=lb, ub=-lb)


def _cfg_kw(T=3, nc=2, **kw):
    base = dict(n_state=3, n_ctrl=nc, T=T, eps=0.0, exit_unconverged=False,
                detach_unconverged=False, backprop=False)
    base.update(kw)
    return base


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _pendulum(B=8, T=5, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1))
    return (x0, PendulumDx(device='cpu', dtype=torch.float64),
            mt.QuadCost(torch.tensor(np.diag(Q)), torch.tensor(P)),
            mt.MPCConfig(**_cfg_kw(T=T, nc=1, lqr_iter=4,
                                   linesearch_decay=0.2,
                                   max_linesearch_iter=3)))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _eager_artifact():
    d = _t(_lin_setup())
    cfg = mt.MPCConfig(**_cfg_kw(**EAGER))
    data = ex.export_solve(cfg, mt.LinDx(d['F'], d['f']),
                           mt.QuadCost(d['C'], d['c']), d['x0'],
                           u_lower=d['lb'], u_upper=d['ub'], device='cpu')
    return cfg, d, data


def test_solve_roundtrip_array_bounds():
    cfg, d, data = _eager_artifact()
    assert ex.kernel_nodes(data) == {}          # the eager route
    fn = ex.load_fn(data)
    args = [d[k] for k in ('x0', 'C', 'c', 'F', 'f', 'lb', 'ub')]

    def live(c):
        sol = mt.batched_solve(cfg, d['x0'], mt.QuadCost(d['C'], c),
                               mt.LinDx(d['F'], d['f']), u_lower=d['lb'],
                               u_upper=d['ub'], device='cpu')
        return sol.x, sol.u, sol.costs

    out = fn(*args)
    assert _equal(out, live(d['c']))
    # fresh cost data through the same artifact (the serving shape)
    c2 = d['c'] * 0.5
    assert _equal(fn(*args[:2], c2, *args[3:]), live(c2))
    # the JAX package's artifact of the same solve
    jd = {k: jnp.asarray(v) for k, v in _lin_setup().items()}
    jcfg = mpc_tpu.MPCConfig(**_cfg_kw(**EAGER))
    jdata = j_export.export_solve(
        jcfg, mpc_tpu.LinDx(jd['F'], jd['f']),
        mpc_tpu.QuadCost(jd['C'], jd['c']), jd['x0'], u_lower=jd['lb'],
        u_upper=jd['ub'])
    jout = j_export.load_fn(jdata)(*(jd[k] for k in
                                     ('x0', 'C', 'c', 'F', 'f', 'lb', 'ub')))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_export_runs_every_eager_iteration():
    """The live eager solve stops when no example is left (one read of
    the device an iteration); the exported one runs all lqr_iter
    iterations, and a finished example's state is frozen, so both give
    the same bits.  An unconstrained LinDx: exact after one iteration,
    so every example stops at the second."""
    d = _t(_lin_setup())
    cfg = mt.MPCConfig(**_cfg_kw(lqr_iter=3, eps=1e-8))
    cost, dyn = mt.QuadCost(d['C'], d['c']), mt.LinDx(d['F'], d['f'])
    live = mt.batched_solve(cfg, d['x0'], cost, dyn, device='cpu')
    assert int(live.n_iter.max()) < cfg.lqr_iter
    fn = ex.load_fn(ex.export_solve(cfg, dyn, cost, d['x0'], device='cpu'))
    assert _equal(fn(d['x0'], d['C'], d['c'], d['F'], d['f']),
                  (live.x, live.u, live.costs))


def test_solve_scalar_bounds_baked():
    """Python-float bounds are baked in: the artifact takes (x_init, C,
    c) alone."""
    x0, dx, cost, cfg = _pendulum()
    data = ex.export_solve(cfg, dx, cost, x0, u_lower=-0.7, u_upper=0.7,
                           device='cpu')
    assert ex.kernel_nodes(data) == {'k1_solve': 1}
    out = ex.load_fn(data)(x0, cost.C, cost.c)
    live = mt.batched_solve(cfg, x0, cost, dx, u_lower=-0.7, u_upper=0.7,
                            device='cpu')
    assert _equal(out, (live.x, live.u, live.costs))
    assert float(out[1].abs().max()) <= 0.7


@pytest.mark.parametrize('batched_cost', [False, True])
def test_solve_polymorphic_batch(batched_cost):
    """One artifact serves every batch size, on the kernel route (the op
    takes any batch), batch-shared and batched cost leaves alike."""
    x0, dx, cost, cfg = _pendulum(B=4)
    T = cfg.T

    def cost_at(b):
        if not batched_cost:
            return cost
        return mt.QuadCost(cost.C.expand(T, b, 4, 4).contiguous(),
                           cost.c.expand(T, b, 4).contiguous())

    data = ex.export_solve(cfg, dx, cost_at(4), x0, u_lower=-2.0,
                           u_upper=2.0, polymorphic_batch=True, device='cpu')
    assert ex.kernel_nodes(data) == {'k1_solve': 1}
    fn = ex.load_fn(data)
    for b in (1, 3, 11):
        xb = _pendulum(B=b, seed=b)[0]
        cb = cost_at(b)
        live = mt.batched_solve(cfg, xb, cb, dx, u_lower=-2.0, u_upper=2.0,
                                device='cpu')
        assert _equal(fn(xb, cb.C, cb.c), (live.x, live.u, live.costs))


def test_solve_flexible_batch_keeps_the_op():
    """polymorphic_batch + max_batch: any b <= max_batch is padded with
    copies of example 0 to max_batch, solved by the one K1 op of the
    graph and cut back to b; the first b rows are the live solve at b,
    bitwise, and a batch past max_batch is refused."""
    x0, dx, cost, cfg = _pendulum(B=8)
    data = ex.export_solve(cfg, dx, cost, x0, u_lower=-2.0, u_upper=2.0,
                           polymorphic_batch=True, max_batch=8,
                           device='cpu')
    ep = ex.load_program(data)
    assert ex.kernel_nodes(ep) == {'k1_solve': 1}
    (rng,) = ep.range_constraints.values()
    assert (rng.lower, rng.upper) == (1, 8)
    fn = ep.module()
    for b in (1, 3, 8):
        live = mt.batched_solve(cfg, x0[:b], cost, dx, u_lower=-2.0,
                                u_upper=2.0, device='cpu')
        out = fn(x0[:b], cost.C, cost.c)
        assert out[1].shape == (cfg.T, b, 1)
        assert _equal(out, (live.x, live.u, live.costs))
    with pytest.raises(Exception):
        fn(_pendulum(B=9)[0], cost.C, cost.c)
    with pytest.raises(ValueError, match='polymorphic_batch'):
        ex.export_solve(cfg, dx, cost, x0, max_batch=8, device='cpu')


def _jax_lin_grad(jd, jcfg):
    lb = jnp.full((jcfg.T, 3, 2), -50.0)

    def loss(c):
        sol = j_batched_solve(jcfg, jd['x0'], mpc_tpu.QuadCost(jd['C'], c),
                              mpc_tpu.LinDx(jd['F'], jd['f']),
                              u_lower=lb, u_upper=-lb)
        return (sol.u ** 2).sum()

    return np.asarray(jax.grad(loss)(jd['c']))


def _assert_grad(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= GRAD_TOL * scale


def test_exported_gradient_program():
    """torch.autograd.grad through the eager fixed point, exported: the
    artifact computes the differentiable-MPC backward by itself (the JAX
    test's problem, wide bounds)."""
    d = _t(_lin_setup())
    cfg = mt.MPCConfig(**_cfg_kw(backprop=True, **EAGER_GRAD))
    lb = torch.full((cfg.T, 3, 2), -50.0, dtype=torch.float64)

    def grad(c):
        c = c.detach().requires_grad_(True)
        sol = mt.batched_solve(cfg, d['x0'], mt.QuadCost(d['C'], c),
                               mt.LinDx(d['F'], d['f']), u_lower=lb,
                               u_upper=-lb, device='cpu')
        return torch.autograd.grad((sol.u ** 2).sum(), c)[0]

    data = ex.export_fn(grad, d['c'])
    assert ex.kernel_nodes(data) == {}
    g = ex.load_fn(data)(d['c'])
    assert torch.equal(g, grad(d['c']))
    jd = {k: jnp.asarray(v) for k, v in _lin_setup().items()}
    _assert_grad(g.numpy(),
                 _jax_lin_grad(jd, mpc_tpu.MPCConfig(**_cfg_kw(
                     backprop=True, **EAGER_GRAD))))


def test_exported_gradient_program_through_k2():
    """The pendulum's gradient of sum(u^2) to c, exported: phase 1 is the
    K1 op, the backward the K2 op, one node each; the artifact gives the
    live gradient's bits and lies within 1e-8 of jax.grad on a converged
    solve."""
    x0, dx, cost, _ = _pendulum(B=4)
    kw = _cfg_kw(T=5, nc=1, lqr_iter=30, eps=1e-10, backprop=True,
                 linesearch_decay=0.2, max_linesearch_iter=5)
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **kw)

    def grad(c):
        c = c.detach().requires_grad_(True)
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), dx,
                               u_lower=-2.0, u_upper=2.0, device='cpu')
        return torch.autograd.grad((sol.u ** 2).sum(), c)[0]

    data = ex.export_fn(grad, cost.c)
    assert ex.kernel_nodes(data) == {'k1_solve': 1, 'k2_backward': 1}
    g = ex.load_fn(data)(cost.c)
    assert torch.equal(g, grad(cost.c))
    jcfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF, **kw)

    def j_loss(c):
        sol = j_batched_solve(jcfg, jnp.asarray(x0.numpy()), mpc_tpu.QuadCost(
            jnp.asarray(np.diag(Q)), c), JPendulumDx(), u_lower=-2.0,
            u_upper=2.0)
        return (sol.u ** 2).sum()

    _assert_grad(g.numpy(), np.asarray(jax.grad(j_loss)(jnp.asarray(P))))


def test_exported_gradient_program_through_dense_backward():
    """A LinDx of 4 states and 2 controls with a box: the gradient of
    sum(u^2) to c and F, exported, holds one node of the dense forward's
    op and one of the dense backward's (K2 and K4's dense configuration,
    ``k4d_backward``), and gives the live gradients' bits."""
    T, B, ns, nc = 4, 3, 4, 2
    rng = np.random.RandomState(9)
    A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
    F0 = torch.tensor(np.tile(np.concatenate([A, 0.5 * rng.randn(ns, nc)],
                                             1)[None], (T - 1, 1, 1)))
    C = torch.tensor(np.diag(np.r_[np.ones(ns), 0.1 * np.ones(nc)]))
    c0 = torch.tensor(0.3 * rng.randn(T, ns + nc))
    x0 = torch.tensor(rng.randn(B, ns))
    cfg = mt.MPCConfig(**_cfg_kw(T=T, nc=nc, n_state=ns, lqr_iter=4,
                                 backprop=True, max_linesearch_iter=2))

    def grad(c, F):
        c = c.detach().requires_grad_(True)
        F = F.detach().requires_grad_(True)
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), mt.LinDx(F),
                               u_lower=-0.5, u_upper=0.5, device='cpu')
        return torch.autograd.grad((sol.u ** 2).sum(), (c, F))

    data = ex.export_fn(grad, c0, F0)
    assert ex.kernel_nodes(data) == {'k3d_solve': 1, 'k4d_backward': 1}
    got = ex.load_fn(data)(c0, F0)
    live = grad(c0, F0)
    assert all(g.abs().max() > 0 for g in live)
    for a, b in zip(got, live):
        assert torch.equal(a, b)


class _Exp(torch.autograd.Function):
    """exp whose backward recomputes exp from its saved input: what a
    gradient program needs in place of torch.exp, whose saved output
    torch.export cannot trace (ROADMAP section 3)."""

    @staticmethod
    def forward(ctx, q):
        ctx.save_for_backward(q)
        return torch.exp(q)

    @staticmethod
    def backward(ctx, g):
        (q,) = ctx.saved_tensors
        return g * torch.exp(q)


def test_gradient_program_of_a_learned_cost():
    """Config 4's imitation loss and its gradients to a learned cost
    diag(exp(q_log)), p (the exp saving its input), exported: the live
    gradients' bits, torch.exp and all, through one K1 and one K2 op."""
    x0, dx, cost, _ = _pendulum(B=4, T=5)
    u_exp = torch.tensor(np.random.RandomState(3).randn(5, 4, 1))
    cfg = mt.MPCConfig(**_cfg_kw(T=5, nc=1, lqr_iter=3, backprop=True,
                                 linesearch_decay=0.2,
                                 max_linesearch_iter=3))

    def grad(q_log, p, exp=_Exp.apply):
        th = {'q_log': q_log.detach().requires_grad_(),
              'p': p.detach().requires_grad_()}
        loss = mt.imitation_loss(
            th, cfg, x0, u_exp,
            lambda t: mt.QuadCost(torch.diag(exp(t['q_log'])), t['p']),
            lambda t: dx, u_lower=-2.0, u_upper=2.0, device='cpu')
        return (loss.detach(),
                *torch.autograd.grad(loss, [th['q_log'], th['p']]))

    args = (torch.log(torch.tensor(Q) + 1e-3), torch.tensor(P))
    data = ex.export_fn(grad, *args)
    assert ex.kernel_nodes(data) == {'k1_solve': 1, 'k2_backward': 1}
    assert _equal(ex.load_fn(data)(*args), grad(*args, exp=torch.exp))


def test_closed_loop_roundtrip():
    """The receding-horizon rollout exports as one artifact, one K1 op a
    step, and reproduces the live closed loop bitwise."""
    x0, dx, cost, cfg = _pendulum(B=2, T=6)
    cfg = dataclasses.replace(cfg, lqr_iter=2, max_linesearch_iter=2)
    data = ex.export_closed_loop(cfg, cost, dx, x0, 3, u_lower=-2.0,
                                 u_upper=2.0, device='cpu')
    assert ex.kernel_nodes(data) == {'k1_solve': 3}
    out = ex.load_fn(data)(x0)
    ref = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                              device='cpu')(x0, 3)
    assert set(out) == {'xs', 'us', 'costs'}
    for k in ref:
        assert torch.equal(out[k], ref[k])


def test_bounds_none_mismatch_raises():
    """One-sided bounds are refused by the export as by batched_solve;
    so are an array bound beside a scalar one."""
    x0, dx, cost, cfg = _pendulum()
    with pytest.raises(ValueError, match='both'):
        ex.export_solve(cfg, dx, cost, x0, u_lower=-0.7, u_upper=None,
                        device='cpu')
    with pytest.raises(ValueError, match='both'):
        mt.batched_solve(cfg, x0, cost, dx, u_lower=-0.7, device='cpu')
    lb = torch.full((cfg.T, 8, 1), -0.7, dtype=torch.float64)
    with pytest.raises(ValueError, match='arrays'):
        ex.export_solve(cfg, dx, cost, x0, u_lower=lb, u_upper=0.7,
                        device='cpu')


def test_route_is_decided_for_the_artifact_device():
    """The counterpart of exporting a TPU artifact from a CPU host: the
    route is the one the artifact's device takes, not the tracing
    device's.  float32 takes the kernels on both; float64 takes their
    plain versions on the CPU but the eager solver on the card."""
    x0, dx, cost, cfg = _pendulum()
    cpu, card = torch.device('cpu'), torch.device('cuda')
    for dtype, want in ((torch.float32, ('always', 'always')),
                        (torch.float64, ('always', 'never'))):
        got = tuple(ex._route_for(cfg, cost, dx, dtype, dev).use_fused
                    for dev in (cpu, card))
        assert got == want
    data = ex.export_solve(cfg, dx.to(torch.float32),
                           mt.QuadCost(cost.C.float(), cost.c.float()),
                           x0.float(), u_lower=-2.0, u_upper=2.0,
                           device='cpu')
    assert ex.kernel_nodes(data) == {'k1_solve': 1}


def test_forced_kernel_outside_its_scope_raises():
    """use_fused='always' on a problem the kernels do not take (delta_u
    without bounds) is an error at export, not an artifact of another
    route."""
    d = _t(_lin_setup())
    cfg = mt.MPCConfig(**_cfg_kw(**dict(EAGER, use_fused='always',
                                        delta_u=0.1)))
    with pytest.raises(ValueError, match='always'):
        ex.export_solve(cfg, mt.LinDx(d['F'], d['f']),
                        mt.QuadCost(d['C'], d['c']), d['x0'], device='cpu')


def test_serving_process_without_the_solver(tmp_path):
    """An artifact answered by a fresh process that imports torch and
    mpc_tpu_torch.ops.custom: the same bits as the live solve, and none
    of the solver's modules loaded there."""
    x0, dx, cost, cfg = _pendulum()
    path = tmp_path / 'ctrl.pt2'
    path.write_bytes(ex.export_solve(cfg, dx, cost, x0, u_lower=-2.0,
                                     u_upper=2.0, device='cpu'))
    torch.save({'x0': x0, 'C': cost.C, 'c': cost.c}, tmp_path / 'req.pt')
    code = (
        'import io, sys, torch\n'
        'import mpc_tpu_torch.ops.custom\n'
        'req = torch.load(sys.argv[2])\n'
        'ep = torch.export.load(sys.argv[1])\n'
        'x, u, costs = ep.module()(req["x0"], req["C"], req["c"])\n'
        'torch.save({"x": x, "u": u, "costs": costs}, sys.argv[3])\n'
        'print(sorted(m for m in sys.modules if m.startswith("mpc_tpu")))\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-c', code, str(path), str(tmp_path / 'req.pt'),
         str(tmp_path / 'out.pt')], capture_output=True, text=True,
        timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    loaded = eval(out.stdout.strip().splitlines()[-1])
    for name in ('mpc_tpu_torch.solver', 'mpc_tpu_torch.learning',
                 'mpc_tpu_torch.ops.lqr', 'mpc_tpu_torch.ops.pnqp',
                 'mpc_tpu_torch.ops.diff', 'mpc_tpu_torch.ops.pscan',
                 'mpc_tpu_torch.utils.export'):
        assert name not in loaded
    assert 'mpc_tpu' not in loaded
    got = torch.load(tmp_path / 'out.pt')
    live = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0,
                            device='cpu')
    assert _equal((got['x'], got['u'], got['costs']),
                  (live.x, live.u, live.costs))
