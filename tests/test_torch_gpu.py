"""Kernels K1 to K4 on the card against their plain PyTorch versions.

Needs a CUDA card (and nvcc); skips without one.  tests/conftest.py
imports JAX, which the card's machine does not have, so run this file
there without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: the float32 bang-bang tail of tests/test_fused_fulltile.py
(mean |du| < 1e-4, under 0.5% of entries off by more than 1e-3): nvcc's
FMA contraction is the only arithmetic difference, and it flips a few
switch steps.  Over a long horizon (T = T_MAX) two float32 solves of
the pendulum drift further apart, so there each is held against the
float64 plain run instead:
the kernel may sit at most twice as far from it as the plain float32
run does.

K2 (the KKT backward) is held to its plain version on the same random
problem: the largest |difference| of each gradient over its largest
entry below 1e-4 (nvcc's FMA contraction is the only difference; K2 has
no branch that rounding can flip, as the active set is an input), and
the kernel's mean distance to a float64 plain run at most twice the
plain float32 run's.  Both also give an example's outputs bitwise
whatever batch it sits in (B = 1, 7 and 33 alone against the same
examples in a batch of 2050), and the same bits at a second launch,
reduced gradients included.

K3 (the streaming solve) is held on a stable LinDx box problem, where
two float32 runs part only in the few examples whose line search ties to
round-off (measured at B=1024: max |du| 2.3e-3 in such an example):
mean |du| < 1e-5 and under 0.1% of entries off by more than 5e-5, the
tolerance tests/test_fused_stream.py holds every entry of the TPU kernel
to at B=16; and on the pendulum past K1's horizon against the float64
plain run, as K1 at T_MAX.  K4 (the streaming KKT backward) is held as K2 is, for the four
mixes of shared and batched cost and dynamics, with and without f, and
past K2's horizon.

K3's MLP configuration (MPC_DYN=2, the bench_nn_dynamics problem's
one-hidden-layer MLP of 100 units, sigmoid, relu or elu) is held to its
plain version in the same float32 tail and, with bounds, no further from
the float64 plain run than twice the plain float32 run; at B = 2050 and
past the horizon whose state and Jacobian rows stay in shared memory; on
the reversed batch and small batches bitwise; and a launch with weights
that are not float32 on the card raises instead of falling back.

K3's dense configuration (csrc/fused_ilqr_dense.cu, a LinDx of any
admitted size) is held to its plain version in the same float32 tail and
no further from the float64 plain run than twice the plain float32 run,
at config 1's layout (every operand per example, unbounded), at 24 and 28
states with 4 bounded controls, at 5 states and 1 control and at 2
states and 2 controls with per-example bounds and f, and past 8 controls
(the control solve on the warp's tiles) at 3s9c and 23s9c with the box
and 2s16c without, and at the gate's corners 1s31c and 4s28c (T=3); on
the reversed batch, small batches and a second launch bitwise (at 16s4c
and at 3s9c); the entry points
launch it once a request, a differentiable solve runs it and the dense
backward, and with its library broken a request raises instead of
falling back.

K2 and K4's dense configuration (csrc/fused_kkt_bwd_dense.cu, the
backward at any other admitted size) is held as K2 is, at the medium
rows' sizes, 16 states and 4 controls with every leaf per example and f,
TVLQR's size without an active set, 5 states and 1 control, the gate's
corners, a long horizon, 4s12c with and without the active set and the
corners past 8 controls (1s31c, 4s28c); per-example outputs are bitwise whatever
batch an example sits in and every output at a second launch; a
differentiable solve launches the dense forward and backward once each,
float64 on the card takes the eager fixed point, and with its library
broken the backward raises instead of falling back.

The nonlinear models (the dense configuration's model-step build: the
cartpole, the slew passthrough over the simple and damped pendulum and
the cartpole; K1 and K3 on the damped pendulum) are each held to their
plain version at B=2050, one case a process under
CUDA_LAUNCH_BLOCKING=1, the cartpole's controls in units of its +-100
box scaled to the pendulum's +-2; reversed, sliced and repeated
launches bitwise; with the example's workspace in global and in shared
memory (forced) at config 3's shapes and at B=2050, each layout against
the plain version, the reversed batch bitwise and the two layouts
bitwise equal; the entry points launch each kernel once a request, a
differentiable cartpole solve the dense forward and backward once each,
and a broken library raises.

The dense configuration's MLP build (an MLP of 1 to 4 hidden layers at
any admitted size, under slew too) is held at B=2050 against float64,
one define set a process under CUDA_LAUNCH_BLOCKING=1, the reversed batch
bitwise; the entry points launch it once a request, a differentiable
8-state solve the dense forward and backward once each, and a broken
library raises.

The pseudo-Huber cost in the kernels' cost build (K1, K3 on the
pendulum, a LinDx and the MLP, the dense LinDx and model-step builds) is
held to its plain version at B=2050, one case a process under
CUDA_LAUNCH_BLOCKING=1, in the float32 tail with n_iter equal and no
further from float64 than twice the plain float32 run (the pendulum at
T=200 and the cartpole by that alone); K1's build is bitwise the same in
any batch, the entry points launch it once a request, a differentiable
solve launches K1 and K2 once each, and a broken library raises.

Controls pinned to zero (each kernel's MPC_HAS_UZ build) and the trust
region delta_u (K1 on the pendulum, K3 on a batched LinDx, the pendulum
at T=200 and the MLP, the dense configuration at 3 states and 4
controls unbounded, at hw_sweep's 3 states and 2 controls, on the
cartpole and under slew) are held to their plain version at B=2050, one
case a process under CUDA_LAUNCH_BLOCKING=1: pinned controls exactly
0.0, n_iter equal in 99% of the examples, no further from float64 than
twice the plain float32 run; masked K1 and dense builds are bitwise the
same in any batch, batched_solve and MPC launch K1 once a request, and
a broken library raises.

The closed loop (make_closed_loop) launches K1 once a step and runs its
steps without a synchronising call (torch.cuda.set_sync_debug_mode
'error' after a first rollout); without a card and without a device it
raises.  A slew request on a double integrator (a LinDx of three
augmented states) launches K3 once, within the LinDx tail of the plain
K3, and with the library broken raises instead of falling back.

K1 and K3 give each example a team of lanes, so both are also run with
fewer, as many and more step sizes than a team has lanes, with eps > 0
(the examples of one warp then stop at different iterations), at B = 1
and at batches that do not fill a block (bitwise equal to the same
examples inside a large batch), and on the reversed batch (bitwise).
The kernels' ops carry the artifacts and the sharded paths: a solve
exported on the card, one traced on CPU tensors and moved there, and one
padded to max_batch each launch K1 once a call with the live solve's
bits; an exported gradient launches K1 and K2 once each; four shards of
a batch on the one card are bitwise the unsharded solve; a checkpoint
loads onto the card.
This file imports nothing of JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import (_build, fused, fused_bwd, fused_bwd_dense,
                               fused_dense)
from mpc_tpu_torch.utils.problems import hw_sweep_delta_u

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _problem(device, B, T, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      dtype=torch.float32, device=device)
    dx = PendulumDx(device=device)
    q, p = dx.get_true_obj()
    return x0, dx, mt.QuadCost(torch.diag(q), p)


def _cfg(T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=0.0,
                backprop=False, max_linesearch_iter=5)
    base.update(kw)
    return mt.MPCConfig(**base)


def _assert_tail(u, ref):
    d = (u - ref).abs()
    assert float(d.mean()) < 1e-4
    assert float((d > 1e-3).double().mean()) < 0.005


@pytest.mark.parametrize('T,B,bounded', [(5, 1024, True), (4, 1024, False),
                                         (20, 2050, True),
                                         (fused.T_MAX, 128, True)])
def test_k1_matches_plain(cuda, T, B, bounded):
    x0, dx, cost = _problem(cuda, B, T)
    bounds = dict(u_lower=-2.0, u_upper=2.0) if bounded else {}
    ops = fused.k1_operands(_cfg(T), x0, cost, dx, **bounds)
    xk, uk, sk = fused.fused_ilqr(**ops)
    xp, up, sp = fused.fused_solve_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if T < fused.T_MAX:
        _assert_tail(uk, up)
    else:
        dx64 = PendulumDx(device=cuda, dtype=torch.float64)
        cost64 = mt.QuadCost(cost.C.double(), cost.c.double())
        _, u64, _ = fused.fused_solve_plain(**fused.k1_operands(
            _cfg(T), x0.double(), cost64, dx64, **bounds))
        k_far = float((uk.double() - u64).abs().mean())
        p_far = float((up.double() - u64).abs().mean())
        assert k_far <= 2 * p_far + 1e-6, (k_far, p_far)
    assert torch.equal(sk[2], sp[2])          # n_iter
    assert torch.equal(sk[3], sp[3])          # n_qp_iter


def _assert_near_f64(uk, up, u64):
    """Where two float32 solves part, the kernel may sit at most twice
    as far from the float64 plain run as the plain float32 run does."""
    k_far = float((uk.double() - u64).abs().mean())
    p_far = float((up.double() - u64).abs().mean())
    assert k_far <= 2 * p_far + 1e-6, (k_far, p_far)


def _assert_counts(sk, sp, mixed, need_real=True):
    """n_iter equals the plain run's in 99% of the examples (a full-step
    norm within round-off of eps may fall on the other side), and so
    does the summed selected index + 1 among the examples whose steps
    are real.  Near convergence (a full-step norm under 1e-2 in float32)
    a trial cost ties the current one to round-off and either step size
    is right, so those examples are left out; with eps = 0 some examples
    must remain (``need_real``), with eps > 0 every example may have
    converged."""
    assert float((sk[2] == sp[2]).double().mean()) >= 0.99
    real = (sk[1] > 1e-2) & (sp[1] > 1e-2)
    assert bool(real.any()) or not need_real
    if bool(real.any()):
        same = (sk[5] == sp[5])[real]
        assert float(same.double().mean()) >= 0.98
    if mixed:
        assert float(sk[2].min()) < float(sk[2].max())


def _batch_map(ops, x0_fn, batched_fn):
    """``ops`` with x0 [B, 3] through ``x0_fn`` and every other operand
    with a batch extent [T', B, ...] through ``batched_fn``."""
    B = ops['x0'].shape[0]
    out = dict(ops, x0=x0_fn(ops['x0']).contiguous())
    for k, v in ops.items():
        if k != 'x0' and torch.is_tensor(v) and v.dim() >= 2 \
                and v.shape[1] == B:
            out[k] = batched_fn(v).contiguous()
    return out


def _assert_position_free(kernel, ops, full):
    """Small batches alone and the reversed batch give, bitwise, what
    the same examples give inside the full batch."""
    for n in (1, 7, 33):
        alone = kernel(**_batch_map(ops, lambda a: a[:n], lambda a: a[:, :n]))
        for a, b in zip(alone, full):
            assert torch.equal(a, b[:, :n])
    back = kernel(**_batch_map(ops, lambda a: a.flip(0), lambda a: a.flip(1)))
    for a, b in zip(back, full):
        assert torch.equal(a.flip(1), b)


@pytest.mark.parametrize('eps', [0.0, 1e-2])
@pytest.mark.parametrize('n_alpha', [1, 3, 5, 6])
def test_k1_teams(cuda, n_alpha, eps):
    T, B = 10, 2050
    x0, dx, cost = _problem(cuda, B, T)
    cfg = _cfg(T, lqr_iter=12 if eps > 0 else 3, eps=eps,
               linesearch_decay=0.5, max_linesearch_iter=n_alpha)
    ops = fused.k1_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    full = fused.fused_ilqr(**ops)
    _, up, sp = fused.fused_solve_plain(**ops)
    assert all(torch.isfinite(a).all() for a in full)
    if eps > 0:
        # examples that stop an iteration apart part two float32 solves
        dx64 = PendulumDx(device=cuda, dtype=torch.float64)
        _, u64, _ = fused.fused_solve_plain(**fused.k1_operands(
            cfg, x0.double(), mt.QuadCost(cost.C.double(), cost.c.double()),
            dx64, u_lower=-2.0, u_upper=2.0))
        _assert_near_f64(full[1], up, u64)
    else:
        _assert_tail(full[1], up)
    _assert_counts(full[2], sp, mixed=eps > 0, need_real=eps == 0)
    _assert_position_free(fused.fused_ilqr, ops, full)


@pytest.mark.parametrize('name,T', [('K1', 20), ('K3', 40)])
def test_line_search_past_the_team(cuda, name, T):
    """Cheap control and wide bounds on the pendulum: from the second
    iteration on the full step overshoots, so the search goes past the
    team's width into a second round (K1's 4 lanes with 6 step sizes;
    K3's pendulum, whose team is as wide as its search up to 8 lanes,
    with 10).  The kernel is judged against the float64 plain run."""
    operands, kernel, plain, n_alpha = {
        'K1': (fused.k1_operands, fused.fused_ilqr, fused.fused_solve_plain,
               6),
        'K3': (fused.k3_operands, fused.fused_ilqr_long,
               fused.fused_solve_long_plain, 10)}[name]
    width = fused.TEAM if name == 'K1' else fused.k3_launch(
        T, 1, n_alpha, lindx=False)['team']
    B = 1024
    x0, dx, cost = _problem(cuda, B, T)
    scale = torch.tensor([1.0, 1.0, 0.1, 0.1], device=cuda)
    cost = mt.QuadCost(cost.C * scale, cost.c)
    cfg = _cfg(T, lqr_iter=3, linesearch_decay=0.5,
               max_linesearch_iter=n_alpha)
    ops = operands(cfg, x0, cost, dx, u_lower=-20.0, u_upper=20.0)
    _, uk, sk = kernel(**ops)
    _, up, sp = plain(**ops)
    # the count of one iteration is the difference of two solves that
    # differ by that iteration
    upto = [kernel(**dict(ops, lqr_iter=i))[2][5] for i in (1, 2)]
    per_iteration = torch.stack([upto[1] - upto[0], sk[5] - upto[1]])
    assert bool((per_iteration > width).any())
    _assert_counts(sk, sp, mixed=False)
    dx64 = PendulumDx(device=cuda, dtype=torch.float64)
    _, u64, _ = plain(**operands(
        cfg, x0.double(), mt.QuadCost(cost.C.double(), cost.c.double()),
        dx64, u_lower=-20.0, u_upper=20.0))
    _assert_near_f64(uk, up, u64)


def test_k1_matches_plain_on_the_training_path(cuda):
    """K1 at config 4's shapes (T=10, lqr_iter=5, max_linesearch_iter=3,
    B=1024) under the learned cost's first value, exp(log(q + 1e-3))."""
    T, B = 10, 1024
    x0, dx, cost = _problem(cuda, B, T)
    q, p = dx.get_true_obj()
    cost = mt.QuadCost(torch.diag(torch.exp(torch.log(q + 1e-3))), p)
    cfg = _cfg(T, lqr_iter=5, max_linesearch_iter=3, linesearch_decay=0.2)
    ops = fused.k1_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    xk, uk, sk = fused.fused_ilqr(**ops)
    xp, up, sp = fused.fused_solve_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_tail(uk, up)
    assert torch.equal(sk[2], sp[2])          # n_iter


def test_entry_point_launches_k1_on_the_default_device(cuda):
    T, B = 20, 256
    x0, dx, cost = _problem(cuda, B, T)
    before = fused.launch_counts['fused_ilqr']
    sol = mt.batched_solve(_cfg(T), x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert fused.launch_counts['fused_ilqr'] == before + 1
    assert sol.u.device.type == 'cuda'
    assert float(sol.u.abs().max()) <= 2.0
    # float64 takes the eager route on the card: no K1 launch, and the
    # CPU's float64 eager result (use_fused='never': on the CPU 'auto'
    # sends float64 to the kernels' plain versions) within CARD_CPU_F64
    before = fused.launch_counts['fused_ilqr']
    solver.reset_eager_counts()
    s64 = mt.batched_solve(_cfg(T), x0.double(), cost, dx, u_lower=-2.0,
                           u_upper=2.0)
    assert fused.launch_counts['fused_ilqr'] == before
    assert solver.eager_counts['eager_solve'] == 1
    assert s64.u.device.type == 'cuda' and s64.u.dtype == torch.float64
    cpu = mt.batched_solve(_cfg(T, use_fused='never'), x0.double().cpu(),
                           mt.QuadCost(cost.C.cpu(), cost.c.cpu()),
                           PendulumDx(params=dx.params.cpu()), u_lower=-2.0,
                           u_upper=2.0, device='cpu')
    assert (s64.u.cpu() - cpu.u).abs().max() <= \
        CARD_CPU_F64 * cpu.u.abs().max()


# The card's float64 eager solve against the CPU's float64 eager solve,
# relative to the largest |u|: the two differ only in the order of their
# small sums and in the last bit of sin, cos and atan2.
CARD_CPU_F64 = 1e-10


def _eager_problems(device):
    """Problems the kernels do not take, in float64: (cfg keywords,
    x0, cost, dynamics, batched_solve keywords)."""
    import numpy as np
    from mpc_tpu_torch.models import CartpoleDx
    B, T = 64, 10
    rng = np.random.RandomState(0)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      device=device)
    kw = dict(dtype=torch.float64, device=device)
    dx = PendulumDx(**kw)
    q, p = dx.get_true_obj()
    cost = mt.QuadCost(torch.diag(q), p)
    box = dict(u_lower=-2.0, u_upper=2.0)
    cart = CartpoleDx(**kw)
    qc, pc = cart.get_true_obj()
    xc = torch.zeros(B, 5, **kw)
    xc[:, 2], xc[:, 3] = torch.cos(x0[:, 1] / 4), torch.sin(x0[:, 1] / 4)
    F = torch.tensor(np.concatenate([np.eye(3) + 0.05 * rng.randn(3, 3),
                                     0.3 * rng.randn(3, 2)], 1), **kw)
    lin2 = mt.LinDx(F.expand(T - 1, 3, 5))
    cost2 = mt.QuadCost(torch.diag(torch.tensor([1., 1., 1., .1, .1], **kw)),
                        torch.tensor(rng.randn(5), **kw))
    return {
        'float64': (dict(T=T), x0, cost, dx, box),
        'n_ctrl_2': (dict(T=T, n_ctrl=2), x0, cost2, lin2,
                     dict(u_lower=-0.5, u_upper=0.5)),
        'callable_cost': (dict(T=T), x0,
                          lambda tau: (q * (tau - p) ** 2).sum(-1), dx, box),
        'cartpole': (dict(T=T, n_state=5, grad_method=mt.GradMethods.AUTO_DIFF),
                     xc, mt.QuadCost(torch.diag(qc), pc), cart,
                     dict(u_lower=-100.0, u_upper=100.0)),
        'damped_pendulum': (dict(T=T), x0, cost,
                            PendulumDx(simple=False, **kw), box),
        # a mask and a trust region are kernel configurations in float32
        # (test_uz_matches_plain); in float64 the card's route is eager
        'u_zero_I': (dict(T=T), x0, cost, dx, dict(u_zero_I=torch.tensor(
            rng.rand(T, B, 1) < 0.3, device=device))),
        'delta_u': (dict(T=T, delta_u=0.3), x0, cost, dx, box),
    }


@pytest.mark.parametrize('case', ['float64', 'n_ctrl_2', 'callable_cost',
                                  'cartpole', 'damped_pendulum', 'u_zero_I',
                                  'delta_u'])
def test_eager_route_runs_on_the_card(cuda, case):
    """Every problem the kernels do not take runs on the card by default
    through the eager route (one eager solve, no kernel launch) and equals
    the same float64 solve on the CPU's eager route (CARD_CPU_F64)."""
    cfg_kw, x0, cost, dyn, kw = _eager_problems(cuda)[case]
    cfg = _cfg(**dict(dict(lqr_iter=4, eps=1e-3), **cfg_kw))
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, dyn, **kw)
    assert not any(fused.launch_counts.values())
    assert solver.eager_counts == {'eager_solve': 1, 'eager_fixed_point': 0}
    assert sol.u.device == x0.device
    cfg_kw, x0, cost, dyn, kw = _eager_problems(torch.device('cpu'))[case]
    # use_fused='never': on the CPU 'auto' sends the 'float64' case to the
    # kernels' plain versions
    ref = mt.batched_solve(dataclasses.replace(cfg, use_fused='never'), x0,
                           cost, dyn, device='cpu', **kw)
    assert (sol.u.cpu() - ref.u).abs().max() <= \
        CARD_CPU_F64 * ref.u.abs().max()
    assert torch.equal(sol.n_iter.cpu(), ref.n_iter)


BWD_SHAPES = [(10, 1024), (20, 2050), (fused_bwd.T_MAX_BWD, 128)]


@pytest.fixture(scope='module')
def k2_built():
    """Every K2 build these tests launch, compiled in parallel."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _build.build([('fused_kkt_bwd',
                   fused_bwd.kernel_defines(T, has_I, cost_shared))
                  for T, _ in BWD_SHAPES for has_I in (False, True)
                  for cost_shared in (False, True)])


def _bwd_problem(device, T, B, cost_shared, has_I, seed=0):
    """A random SPD problem with contractive dynamics (so the costate
    stays finite in float32 at T_MAX_BWD), ~30% of the controls on a
    bound."""
    rng = np.random.RandomState(seed)
    nb = 1 if cost_shared else B
    Cr = rng.randn(T, nb, 4, 4)
    C = np.einsum('tbij,tbkj->tbik', Cr, Cr) + np.eye(4)
    F = 0.05 * rng.randn(T - 1, B, 3, 4)
    F[..., :3] += 0.9 * np.eye(3)
    us = rng.randn(T, B, 1)
    pinned = rng.rand(T, B, 1) < 0.3
    us = np.where(pinned, np.sign(us), us)
    arrays = dict(C=C, c=rng.randn(T, nb, 4), F=F,
                  x_star=rng.randn(T, B, 3), u_star=us,
                  dl_dx=rng.randn(T, B, 3), dl_du=rng.randn(T, B, 1),
                  I_mask=pinned.astype(np.float64) if has_I else None)
    return {k: None if v is None else torch.tensor(
        v, dtype=torch.float32, device=device) for k, v in arrays.items()}


@pytest.mark.parametrize('cost_shared', [True, False])
@pytest.mark.parametrize('has_I', [True, False])
@pytest.mark.parametrize('T,B', BWD_SHAPES)
def test_k2_matches_plain(cuda, k2_built, T, B, has_I, cost_shared):
    ops = _bwd_problem(cuda, T, B, cost_shared, has_I)
    got = fused_bwd.fused_kkt_backward(**ops)
    ref = fused_bwd.fused_kkt_backward_plain(**ops)
    ops64 = {k: None if v is None else v.double() for k, v in ops.items()}
    ref64 = fused_bwd.fused_kkt_backward_plain(**ops64)
    for a, b, r in zip(got, ref, ref64):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
        k_far = float((a.double() - r).abs().mean())
        p_far = float((b.double() - r).abs().mean())
        assert k_far <= 2 * p_far + 1e-7 * scale, (k_far, p_far)


def test_differentiable_solve_launches_k1_and_k2(cuda):
    """On the default device a differentiable solve runs K1 forward and
    K2 once per backward."""
    T, B = 10, 256
    x0, dx, cost = _problem(cuda, B, T)
    cfg = _cfg(T, backprop=True, detach_unconverged=False)
    c = cost.c.clone().requires_grad_()
    k1 = fused.launch_counts['fused_ilqr']
    k2 = fused_bwd.launch_counts['fused_kkt_bwd']
    sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), dx,
                           u_lower=-2.0, u_upper=2.0)
    assert fused.launch_counts['fused_ilqr'] == k1 + 1
    assert fused_bwd.launch_counts['fused_kkt_bwd'] == k2
    (sol.u ** 2).sum().backward()
    assert fused_bwd.launch_counts['fused_kkt_bwd'] == k2 + 1
    assert torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the streaming kernels K3 and K4
# ---------------------------------------------------------------------------

def _lindx_problem(device, T, B, batched, has_f, seed=0,
                   dtype=torch.float32):
    """A stable rotation-like system (0.97 x an orthogonal matrix) with a
    random input column, per-example costs, as
    tests/test_fused_stream.py's LinDx problems."""
    rng = np.random.RandomState(seed)
    Qo, _ = np.linalg.qr(rng.randn(3, 3))
    F = np.tile(np.concatenate([0.97 * Qo, 0.3 * rng.randn(3, 1)], 1),
                (T - 1, 1, 1))
    f = 0.05 * rng.randn(T - 1, 3) if has_f else None
    if batched:
        F = F[:, None] + 0.01 * rng.randn(T - 1, B, 3, 4)
    C = np.tile(np.eye(4), (T, B, 1, 1))
    C[:, :, 3, 3] = 0.1 + rng.rand(B)
    c = 0.3 * rng.randn(T, B, 4)

    def t(a):
        return None if a is None else torch.tensor(
            a, dtype=dtype, device=device)
    return t(rng.randn(B, 3)), mt.LinDx(t(F), t(f)), mt.QuadCost(t(C), t(c))


@pytest.mark.parametrize('T,B,batched,has_f', [
    (140, 1024, False, False), (140, 2050, True, True),
    (600, 128, False, True)])
def test_k3_matches_plain_lindx(cuda, T, B, batched, has_f):
    x0, dyn, cost = _lindx_problem(cuda, T, B, batched, has_f)
    cfg = _cfg(T, lqr_iter=3, max_linesearch_iter=3, linesearch_decay=0.2)
    ops = fused.k3_operands(cfg, x0, cost, dyn, u_lower=-0.6, u_upper=0.6)
    xk, uk, sk = fused.fused_ilqr_long(**ops)
    xp, up, sp = fused.fused_solve_long_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    for a, b in ((uk, up), (xk, xp)):
        d = (a - b).abs()
        assert float(d.mean()) < 1e-5, float(d.mean())
        assert float((d > 5e-5).double().mean()) < 1e-3
    assert torch.equal(sk[2], sp[2])          # n_iter
    assert torch.equal(sk[3], sp[3])          # n_qp_iter


@pytest.mark.parametrize('eps', [0.0, 1e-2])
@pytest.mark.parametrize('n_alpha', [1, 3, 5, 6])
def test_k3_teams(cuda, n_alpha, eps):
    T, B = 60, 2050
    x0, dyn, cost = _lindx_problem(cuda, T, B, False, True)
    cfg = _cfg(T, lqr_iter=8 if eps > 0 else 3, eps=eps,
               linesearch_decay=0.5, max_linesearch_iter=n_alpha)
    ops = fused.k3_operands(cfg, x0, cost, dyn, u_lower=-0.6, u_upper=0.6)
    full = fused.fused_ilqr_long(**ops)
    _, up, sp = fused.fused_solve_long_plain(**ops)
    assert all(torch.isfinite(a).all() for a in full)
    if eps > 0:
        # more iterations, examples that stop an iteration apart, ties
        # near convergence: judged against the float64 plain run
        x64, dyn64, cost64 = _lindx_problem(cuda, T, B, False, True,
                                            dtype=torch.float64)
        _, u64, _ = fused.fused_solve_long_plain(**fused.k3_operands(
            cfg, x64, cost64, dyn64, u_lower=-0.6, u_upper=0.6))
        _assert_near_f64(full[1], up, u64)
    else:
        d = (full[1] - up).abs()
        assert float(d.mean()) < 1e-5, float(d.mean())
        assert float((d > 5e-5).double().mean()) < 1e-3
    _assert_counts(full[2], sp, mixed=False, need_real=eps == 0)
    _assert_position_free(fused.fused_ilqr_long, ops, full)


def test_k3_matches_plain_pendulum_past_t_max(cuda):
    T, B = 300, 256
    x0, dx, cost = _problem(cuda, B, T)
    cfg = _cfg(T, lqr_iter=2, max_linesearch_iter=2, linesearch_decay=0.2)
    ops = fused.k3_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    xk, uk, sk = fused.fused_ilqr_long(**ops)
    _, up, sp = fused.fused_solve_long_plain(**ops)
    dx64 = PendulumDx(device=cuda, dtype=torch.float64)
    cost64 = mt.QuadCost(cost.C.double(), cost.c.double())
    _, u64, _ = fused.fused_solve_long_plain(**fused.k3_operands(
        cfg, x0.double(), cost64, dx64, u_lower=-2.0, u_upper=2.0))
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    k_far = float((uk.double() - u64).abs().mean())
    p_far = float((up.double() - u64).abs().mean())
    assert k_far <= 2 * p_far + 1e-6, (k_far, p_far)
    assert torch.equal(sk[2], sp[2])


@pytest.mark.parametrize('has_f', [True, False])
@pytest.mark.parametrize('dyn_shared', [True, False])
@pytest.mark.parametrize('cost_shared', [True, False])
@pytest.mark.parametrize('T,B', [
    (160, 2050), (fused_bwd.T_MAX_BWD + 88, 128),
    (fused_bwd.K4_T_RESIDENT, 300), (fused_bwd.K4_T_RESIDENT + 1, 300)])
def test_k4_matches_plain(cuda, T, B, cost_shared, dyn_shared, has_f):
    ops = _bwd_problem(cuda, T, B, cost_shared, True)
    if dyn_shared:
        ops['F'] = ops['F'][:, :1].contiguous()
    got = fused_bwd.fused_kkt_backward_long(**ops, has_f=has_f)
    ref = fused_bwd.fused_kkt_backward_long_plain(**ops, has_f=has_f)
    ops64 = {k: None if v is None else v.double() for k, v in ops.items()}
    ref64 = fused_bwd.fused_kkt_backward_long_plain(**ops64, has_f=has_f)
    assert (got[4] is None) == (not has_f)
    for a, b, r in zip(got, ref, ref64):
        if a is None:
            continue
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
        k_far = float((a.double() - r).abs().mean())
        p_far = float((b.double() - r).abs().mean())
        assert k_far <= 2 * p_far + 1e-7 * scale, (k_far, p_far)


@pytest.mark.parametrize('cost_shared', [True, False])
@pytest.mark.parametrize('name,T', [
    ('K2', fused_bwd.T_MAX_BWD), ('K4', 160),
    ('K4', fused_bwd.K4_T_RESIDENT + 1)])
def test_bwd_position_free_and_repeatable(cuda, k2_built, name, T,
                                          cost_shared):
    """B = 1, 7 and 33 alone give the per-example outputs that the same
    examples give inside B = 2050, bitwise; a second launch gives every
    output bitwise again, the block-order sums of the shared leaves
    included.  K4 runs batch-shared dynamics (dF, df reduced)."""
    B = 2050
    ops = _bwd_problem(cuda, T, B, cost_shared, True)
    if name == 'K2':
        kernel = fused_bwd.fused_kkt_backward
    else:
        kernel = fused_bwd.fused_kkt_backward_long
        ops['F'] = ops['F'][:, :1].contiguous()
    full = kernel(**ops)
    for n in (1, 7, 33):
        alone = kernel(**{k: v[:, :n].contiguous()
                          if v is not None and v.shape[1] == B else v
                          for k, v in ops.items()})
        assert torch.equal(alone[0], full[0][:n])
        for a, f in zip(alone[1:], full[1:]):
            if f.dim() >= 3 and f.shape[1] == B:
                # one example of a batched leaf comes back reduced
                assert torch.equal(a.reshape(f[:, :n].shape), f[:, :n])
    again = kernel(**ops)
    for a, f in zip(again, full):
        assert torch.equal(a, f)


def test_differentiable_lindx_solve_launches_k3_and_k4(cuda):
    """On the default device a differentiable solve of a shared LinDx
    runs K3 forward and K4 once per backward, and gradients reach c, F
    and f."""
    T, B = 160, 256
    x0, dyn, cost = _lindx_problem(cuda, T, B, False, True)
    cfg = _cfg(T, backprop=True, detach_unconverged=False,
               max_linesearch_iter=3, linesearch_decay=0.2)
    c, F, f = (a.clone().requires_grad_() for a in (cost.c, dyn.F, dyn.f))
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), mt.LinDx(F, f),
                           u_lower=-0.6, u_upper=0.6)
    assert fused.launch_counts == {'fused_ilqr': 0, 'fused_ilqr_long': 1,
                                   'fused_ilqr_dense': 0}
    (sol.u ** 2).sum().backward()
    assert fused_bwd.launch_counts == {'fused_kkt_bwd': 0,
                                       'fused_kkt_bwd_long': 1,
                                       'fused_kkt_bwd_dense': 0}
    for g, leaf in ((c.grad, c), (F.grad, F), (f.grad, f)):
        assert g.shape == leaf.shape
        assert torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# K3's MLP configuration (MPC_DYN=2)
# ---------------------------------------------------------------------------

def _nn_problem(device, B, T, act='sigmoid', dtype=torch.float32, seed=4,
                hidden=100):
    """The bench_nn_dynamics problem (benchmarks/configs.py:647-678): an
    MLP of 100 units (or ``hidden``) drawn from a seeded generator in
    float32 (and cast for float64), pendulum starts and the swing-up
    cost."""
    model = mt.NNDynamics.init(3, 1, (hidden,), act, generator=torch.Generator(
        ).manual_seed(0), device=device).to(dtype)
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      dtype=dtype, device=device)
    q, p = PendulumDx(device=device, dtype=dtype).get_true_obj()
    return x0, model, mt.QuadCost(torch.diag(q), p)


@pytest.mark.parametrize('act,T,B,bound,H', [
    ('sigmoid', 20, 1024, 2.0, 100), ('sigmoid', 20, 2050, 2.0, 100),
    ('relu', 10, 1024, None, 100), ('elu', 20, 256, 2.0, 100),
    ('sigmoid', 90, 256, 2.0, 100), ('sigmoid', 20, 256, 2.0, 7000),
    ('sigmoid', 430, 256, 2.0, 100)])
def test_k3_nn_matches_plain(cuda, act, T, B, bound, H):
    """Two rows put the examples' slots in the workspace
    (fused.k3_nn_launch): H = 7000 fills the block's shared memory with
    its weights, and its units run past the 4 a lane keeps in registers;
    T = 430 is past the 99 steps a block of 100 units holds while an SM
    keeps its 4 blocks.  (Over long
    horizons the elu and relu MLPs with passthrough blow the state up,
    |x| to ~1e4, and any two float32 solves part; the sigmoid's stays
    bounded.)"""
    x0, dx, cost = _nn_problem(cuda, B, T, act, hidden=H)
    lim = {} if bound is None else dict(u_lower=-bound, u_upper=bound)
    cfg = _cfg(T, lqr_iter=5, max_linesearch_iter=3, linesearch_decay=0.2)
    ops = fused.k3_operands(cfg, x0, cost, dx, **lim)
    assert (fused.k3_launch(T, B, 3, H)['slots'] == 0) == (H == 100
                                                           and T <= 99)
    full = fused.fused_ilqr_long(**ops)
    _, up, sp = fused.fused_solve_long_plain(**ops)
    assert all(torch.isfinite(a).all() for a in full)
    # over 430 steps any two float32 solves of this problem part (the
    # plain float32 run from float64 as the kernel does, PERF.md section
    # 6), so there the float64 rule below holds the kernel, not the tail
    if T < 430:
        _assert_tail(full[1], up)
    x64, dx64, cost64 = _nn_problem(cuda, B, T, act, torch.float64,
                                    hidden=H)
    _, u64, _ = fused.fused_solve_long_plain(**fused.k3_operands(
        cfg, x64, cost64, dx64, **lim))
    # unbounded relu: a few examples part at round-off ties (max |du|
    # 1.3e-2) while the plain float32 run sits 4e-7 from float64 in the
    # mean, so there the tail alone holds the kernel
    if bound is not None:
        _assert_near_f64(full[1], up, u64)
    assert float((full[2][2] == sp[2]).double().mean()) >= 0.99
    _assert_position_free(fused.fused_ilqr_long, ops, full)


def test_k3_nn_raises_rather_than_falls_back(cuda):
    x0, dx, cost = _nn_problem(cuda, 64, 20)
    ops = fused.k3_operands(_cfg(20), x0, cost, dx, u_lower=-2.0,
                            u_upper=2.0)
    fused.reset_launch_counts()
    for params in (ops['params'].double(), ops['params'].cpu()):
        with pytest.raises(ValueError):
            fused.fused_ilqr_long(**dict(ops, params=params))
    with pytest.raises(ValueError):
        fused.fused_ilqr_long(**dict(ops, params=ops['params'][:-1]))
    assert fused.launch_counts['fused_ilqr_long'] == 0


def test_differentiable_nn_solve_launches_k3_and_k2(cuda):
    """A differentiable solve of the MLP on the default device: K3
    forward, K2 once per backward (per-example F from the MLP's
    linearisation), no eager solve, and gradients reach the weights."""
    T, B = 20, 256
    x0, dx, cost = _nn_problem(cuda, B, T)
    cfg = _cfg(T, backprop=True, detach_unconverged=False, lqr_iter=5,
               max_linesearch_iter=3, linesearch_decay=0.2,
               grad_method=mt.GradMethods.AUTO_DIFF)
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert fused.launch_counts == {'fused_ilqr': 0, 'fused_ilqr_long': 1,
                                   'fused_ilqr_dense': 0}
    (sol.u ** 2).sum().backward()
    assert fused_bwd.launch_counts == {'fused_kkt_bwd': 1,
                                       'fused_kkt_bwd_long': 0,
                                       'fused_kkt_bwd_dense': 0}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for p in dx.parameters():
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the closed loop and slew penalties on the card
# ---------------------------------------------------------------------------

def _closed_loop(device, B=64, T=20, **kw):
    x0, dx, cost = _problem(device, B, T)
    cfg = _cfg(T, lqr_iter=10, linesearch_decay=0.2, **kw)
    lim = torch.tensor(2.0, device=device)
    return mt.make_closed_loop(cfg, cost, dx, u_lower=-lim, u_upper=lim,
                               device=device), x0, cfg, dx, cost


def test_closed_loop_launches_k1_once_a_step(cuda):
    roll, x0, cfg, dx, cost = _closed_loop(cuda)
    roll(x0, 1)
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    out = roll(x0, 7)
    assert fused.launch_counts == {'fused_ilqr': 7, 'fused_ilqr_long': 0,
                                   'fused_ilqr_dense': 0}
    assert solver.eager_counts['eager_solve'] == 0
    assert out['xs'].shape == (8, 64, 3) and torch.isfinite(out['xs']).all()


def test_closed_loop_steps_never_synchronise(cuda):
    """After a first rollout (which loads the library), a rollout of the
    kernel route runs with no synchronising call: the host queues every
    step without reading the card."""
    roll, x0, cfg, dx, cost = _closed_loop(cuda)
    roll(x0, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = roll(x0, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out['us']).all()


def test_closed_loop_without_a_card_raises(monkeypatch):
    """The closed loop runs on the card unless asked for the CPU: with no
    card and no device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    dx = PendulumDx(device='cpu')
    q, p = dx.get_true_obj()
    with pytest.raises(RuntimeError, match='no card'):
        mt.make_closed_loop(_cfg(5), mt.QuadCost(torch.diag(q), p), dx)


def _slew_lindx(device, B=256, T=40):
    rng = np.random.RandomState(2)
    dt = 0.05
    F = torch.tensor([[1., dt, 0.], [0., 1., dt]], device=device)
    F = F.expand(T - 1, 2, 3).contiguous()
    C = torch.diag(torch.tensor([1., 0.1, 0.01], device=device))
    c = torch.zeros(T, B, 3, device=device)
    c[..., 0] = -torch.tensor(rng.uniform(-1, 1, B), dtype=torch.float32,
                              device=device)
    x0 = torch.tensor(0.5 * rng.randn(B, 2), dtype=torch.float32,
                      device=device)
    pc = torch.tensor(rng.uniform(-1, 1, (B, 1)), dtype=torch.float32,
                      device=device)
    cfg = _cfg(T, n_state=2, lqr_iter=4, max_linesearch_iter=3,
               linesearch_decay=0.2, slew_rate_penalty=0.5)
    return cfg, x0, mt.QuadCost(C, c), mt.LinDx(F, None), pc


def test_slew_request_launches_k3_and_raises_rather_than_falls_back(
        cuda, monkeypatch):
    """A slew request on the double integrator (the augmented LinDx of
    three states) launches K3 once, matches the plain K3 on the same
    augmented problem within the LinDx tail; with the library broken it
    raises and neither falls back to the plain version nor to the eager
    solver."""
    cfg, x0, cost, dyn, pc = _slew_lindx(cuda)
    kw = dict(u_lower=-2.0, u_upper=2.0, prev_ctrl=pc)
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, dyn, **kw)
    assert fused.launch_counts == {'fused_ilqr': 0, 'fused_ilqr_long': 1,
                                   'fused_ilqr_dense': 0}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    ref = mt.batched_solve(cfg, x0.cpu(), mt.QuadCost(*(a.cpu() for a in cost)),
                           mt.LinDx(dyn.F.cpu(), None), u_lower=-2.0,
                           u_upper=2.0, prev_ctrl=pc.cpu(), device='cpu')
    d = (sol.u.cpu() - ref.u).abs()
    assert float(d.mean()) < 1e-5 and float((d > 5e-5).double().mean()) < 1e-3
    assert sol.x.shape == (cfg.T, 256, 2)

    def broken(*a, **k):
        raise RuntimeError('the K3 library is broken')

    monkeypatch.setattr(fused, '_kernel_lib_long', broken)
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(cfg, x0, cost, dyn, **kw)
    assert fused.launch_counts == {'fused_ilqr': 0, 'fused_ilqr_long': 0,
                                   'fused_ilqr_dense': 0}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}


def _dense_problem(device, B, ns, nc, T=20, bounded=True, layout='shared',
                   dtype=torch.float32, seed=0):
    """A stable LinDx of ns states and nc controls: 'shared' (F, C, c
    shared, as the medium-state rows), 'tvlqr' (every operand per
    example, C = R R^T) or 'mixed' (shared F with per-example f and
    bounds)."""
    rng = np.random.RandomState(seed)
    nt = ns + nc
    per = layout == 'tvlqr'
    shape = (T - 1, B) if per else (T - 1,)
    F = np.concatenate([np.eye(ns) + 0.05 * rng.randn(*shape, ns, ns),
                        0.3 * rng.randn(*shape, ns, nc)], -1)
    if per:
        R = rng.randn(T, B, nt, nt)
        C = np.einsum('tbij,tbkj->tbik', R, R)
        c = rng.randn(T, B, nt)
    else:
        C = np.diag(np.r_[np.ones(ns), 0.1 * np.ones(nc)])
        c = 0.3 * rng.randn(T, nt)
    f = (0.1 * rng.randn(T - 1, B, ns) if layout in ('tvlqr', 'mixed')
         else None)
    t = (lambda a: None if a is None else torch.tensor(a, dtype=dtype,
                                                      device=device))
    bk = {}
    if bounded:
        lo = -0.2 - rng.rand(T, B, nc) if layout == 'mixed' else -1.0
        bk = dict(u_lower=t(lo) if layout == 'mixed' else lo,
                  u_upper=t(-lo) if layout == 'mixed' else 1.0)
    cfg = _cfg(T, n_state=ns, n_ctrl=nc, lqr_iter=6,
               max_linesearch_iter=10)
    return cfg, t(rng.randn(B, ns)), mt.QuadCost(t(C), t(c)), \
        mt.LinDx(t(F), t(f)), bk


@pytest.mark.parametrize('ns,nc,B,bounded,layout', [
    (3, 4, 128, False, 'tvlqr'), (24, 4, 256, True, 'shared'),
    (28, 4, 64, True, 'shared'), (5, 1, 2050, True, 'shared'),
    (2, 2, 300, True, 'mixed'),
    # past 8 controls: the control solve on the warp's tiles
    (3, 9, 256, True, 'shared'), (2, 16, 256, False, 'shared'),
    (23, 9, 64, True, 'shared')])
def test_dense_matches_plain(cuda, ns, nc, B, bounded, layout):
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, B, ns, nc, bounded=bounded,
                                            layout=layout)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    fused.reset_launch_counts()
    xk, uk, sk = fused_dense.fused_ilqr_dense(**ops)
    assert fused.launch_counts['fused_ilqr_dense'] == 1
    xp, up, sp = fused_dense.fused_solve_dense_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_tail(uk, up)
    assert torch.equal(sk[2], sp[2])          # n_iter
    cfg64, x64, cost64, dyn64, bk64 = _dense_problem(
        cuda, B, ns, nc, bounded=bounded, layout=layout, dtype=torch.float64)
    _, u64, _ = fused_dense.fused_solve_dense_plain(
        **fused_dense.k3d_operands(cfg64, x64, cost64, dyn64, **bk64))
    _assert_near_f64(uk, up, u64)


def test_dense_position_free_and_repeatable(cuda):
    """An example's outputs are bitwise the same whatever batch it sits
    in (reversed, alone, in small batches, past a block) and at a second
    launch."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 2050, 16, 4)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    full = fused_dense.fused_ilqr_dense(**ops)
    again = fused_dense.fused_ilqr_dense(**ops)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    rev = fused_dense.fused_ilqr_dense(**dict(
        ops, x0=ops['x0'].flip(0).contiguous(),
        u0=ops['u0'].flip(1).contiguous()))
    assert all(torch.equal(a.flip(1), b) for a, b in zip(rev, full))
    for n in (1, 7, 33):
        part = fused_dense.fused_ilqr_dense(**dict(
            ops, x0=ops['x0'][:n].contiguous(),
            u0=ops['u0'][:, :n].contiguous()))
        assert all(torch.equal(a, b[:, :n]) for a, b in zip(part, full))


@pytest.mark.parametrize('ns,nc,bounded', [(1, 31, True), (4, 28, True),
                                            (1, 31, False)])
def test_dense_gate_corners_match_plain(cuda, ns, nc, bounded):
    """The gate's corners past 8 controls (n_state + n_ctrl = 32) against
    the plain version at T=3, two iterations (its box QP at 28-31
    controls is thousands of small kernels a trip): the float32 tail, n_iter
    equal, and no further from the float64 plain run than twice the plain
    float32 run."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 33, ns, nc, T=3,
                                            bounded=bounded)
    cfg = dataclasses.replace(cfg, lqr_iter=2)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    xk, uk, sk = fused_dense.fused_ilqr_dense(**ops)
    xp, up, sp = fused_dense.fused_solve_dense_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_tail(uk, up)
    assert torch.equal(sk[2], sp[2])
    cfg64, x64, cost64, dyn64, bk64 = _dense_problem(
        cuda, 33, ns, nc, T=3, bounded=bounded, dtype=torch.float64)
    _, u64, _ = fused_dense.fused_solve_dense_plain(
        **fused_dense.k3d_operands(dataclasses.replace(cfg64, lqr_iter=2),
                                   x64, cost64, dyn64, **bk64))
    _assert_near_f64(uk, up, u64)


def test_wide_dense_position_free_and_repeatable(cuda):
    """Past 8 controls too (the box QP on the warp's tiles): an example's
    outputs are bitwise the same reversed, alone, in small batches and at
    a second launch."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 2050, 3, 9)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    full = fused_dense.fused_ilqr_dense(**ops)
    again = fused_dense.fused_ilqr_dense(**ops)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    rev = fused_dense.fused_ilqr_dense(**dict(
        ops, x0=ops['x0'].flip(0).contiguous(),
        u0=ops['u0'].flip(1).contiguous()))
    assert all(torch.equal(a.flip(1), b) for a, b in zip(rev, full))
    for n in (1, 7, 33):
        part = fused_dense.fused_ilqr_dense(**dict(
            ops, x0=ops['x0'][:n].contiguous(),
            u0=ops['u0'][:, :n].contiguous()))
        assert all(torch.equal(a, b[:, :n]) for a, b in zip(part, full))


# the redesigned dense kernels' builds (csrc/riccati_dense.cuh: the
# products as register tiles of every shape, the prefetching and the
# one-set layouts; csrc/box_qp_smem.cuh: the control solve across the
# lanes past 8 controls) at the gate's corners and the rows the phase
# account reads, each against its plain version
REDESIGNED = [(1, 9, True), (1, 31, True), (4, 28, True), (23, 9, True),
              (24, 4, True), (20, 4, True), (16, 4, True), (4, 12, True),
              (3, 9, False), (2, 16, False), (5, 1, True), (8, 4, True)]


@pytest.mark.parametrize('ns,nc,bounded', REDESIGNED)
def test_redesigned_dense_builds_match_plain(cuda, ns, nc, bounded):
    """T=4, B=66 (more than a block, a partial one), two iterations (the
    plain box QP past 20 controls is thousands of small kernels a trip):
    the float32 tail, n_iter equal, no further from the float64 plain run
    than twice the plain float32 run, and the reversed batch bitwise."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 66, ns, nc, T=4,
                                            bounded=bounded)
    cfg = dataclasses.replace(cfg, lqr_iter=2)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    xk, uk, sk = fused_dense.fused_ilqr_dense(**ops)
    xp, up, sp = fused_dense.fused_solve_dense_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_tail(uk, up)
    assert torch.equal(sk[2], sp[2])
    cfg64, x64, cost64, dyn64, bk64 = _dense_problem(
        cuda, 66, ns, nc, T=4, bounded=bounded, dtype=torch.float64)
    _, u64, _ = fused_dense.fused_solve_dense_plain(
        **fused_dense.k3d_operands(dataclasses.replace(cfg64, lqr_iter=2),
                                   x64, cost64, dyn64, **bk64))
    _assert_near_f64(uk, up, u64)
    rev = fused_dense.fused_ilqr_dense(**dict(
        ops, x0=ops['x0'].flip(0).contiguous(),
        u0=ops['u0'].flip(1).contiguous()))
    assert all(torch.equal(a.flip(1), b) for a, b in zip(rev, (xk, uk, sk)))


@pytest.mark.parametrize('ns,nc,bounded', REDESIGNED)
def test_redesigned_dense_backward_matches_plain(cuda, ns, nc, bounded):
    """The dense backward's redesigned chains at the same sizes (T=4,
    B=66, the active set where the forward has a box): every gradient
    within 1e-4 of the plain version relative to its largest entry, and
    repeated bitwise."""
    ops = _bwd_dense_problem(cuda, ns, nc, 4, 66, True, True,
                             has_I=bounded, has_f=not bounded)
    got = fused_bwd_dense.fused_kkt_backward_dense(**ops)
    again = fused_bwd_dense.fused_kkt_backward_dense(**ops)
    ref = fused_bwd_dense.fused_kkt_backward_dense_plain(**ops)
    for a, b, c in zip(got, ref, again):
        if b is None:
            assert a is None
            continue
        assert torch.isfinite(a).all() and torch.equal(a, c)
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_dense_entry_points_launch_it_once(cuda):
    """batched_solve and MPC launch the dense kernel once a request and
    nothing else; a differentiable 5-state solve runs it and the dense
    backward once each (no eager fixed point) and returns finite
    gradients."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 512, 24, 4)
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, dyn, **bk)
    _, u, _ = mt.MPC(24, 4, cfg.T, lqr_iter=cfg.lqr_iter, eps=0.0,
                     exit_unconverged=False, backprop=False, **bk)(
        x0, cost, dyn)
    assert torch.equal(u, sol.u)
    assert fused.launch_counts == {'fused_ilqr': 0, 'fused_ilqr_long': 0,
                                   'fused_ilqr_dense': 2}
    assert solver.eager_counts['eager_solve'] == 0
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 256, 5, 1)
    c = cost.c.clone().requires_grad_(True)
    solver.reset_eager_counts()
    fused.reset_launch_counts()
    sol = mt.batched_solve(dataclasses.replace(cfg, backprop=True,
                                               detach_unconverged=False), x0,
                           mt.QuadCost(cost.C, c), dyn, **bk)
    (sol.u ** 2).sum().backward()
    assert fused.launch_counts['fused_ilqr_dense'] == 1
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    assert fused_bwd.launch_counts == {'fused_kkt_bwd': 0,
                                       'fused_kkt_bwd_long': 0,
                                       'fused_kkt_bwd_dense': 1}
    assert torch.isfinite(c.grad).all() and c.grad.abs().max() > 0


def test_dense_raises_rather_than_falls_back(cuda, monkeypatch):
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 64, 6, 2)
    ops = fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)
    fused.reset_launch_counts()
    with pytest.raises(ValueError):
        fused_dense.fused_ilqr_dense(**dict(ops, C=ops['C'].double()))

    def broken(*a, **k):
        raise RuntimeError('the dense library is broken')

    monkeypatch.setattr(fused_dense, 'kernel_lib', broken)
    solver.reset_eager_counts()
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(cfg, x0, cost, dyn, **bk)
    assert fused.launch_counts['fused_ilqr_dense'] == 0
    assert solver.eager_counts['eager_solve'] == 0


# ---------------------------------------------------------------------------
# K2 and K4's dense configuration (csrc/fused_kkt_bwd_dense.cu)
# ---------------------------------------------------------------------------

def _bwd_dense_problem(device, ns, nc, T, B, cost_shared, dyn_shared,
                       has_I=True, has_f=True, seed=0, dtype=torch.float32):
    """A random converged-LQR backward problem at any size: C = R R^T /
    ntau + I, F = 0.9 I + 0.3 / sqrt(ns) N (the costate stays finite in
    float32), ~30% of the controls on a bound; the dense backward's
    operands (shared leaves with a batch extent of 1)."""
    rng = np.random.RandomState(seed)
    nt = ns + nc
    nb, nf = 1 if cost_shared else B, 1 if dyn_shared else B
    Cr = rng.randn(T, nb, nt, nt)
    C = np.einsum('tbij,tbkj->tbik', Cr, Cr) / nt + np.eye(nt)
    F = 0.3 / np.sqrt(ns) * rng.randn(T - 1, nf, ns, nt)
    F[..., :ns] += 0.9 * np.eye(ns)
    us = rng.randn(T, B, nc)
    pinned = rng.rand(T, B, nc) < 0.3
    us = np.where(pinned, np.sign(us), us)
    arrays = dict(C=C, c=rng.randn(T, nb, nt), F=F,
                  x_star=rng.randn(T, B, ns), u_star=us,
                  dl_dx=rng.randn(T, B, ns), dl_du=rng.randn(T, B, nc),
                  I_mask=pinned.astype(np.float64) if has_I else None)
    ops = {k: None if v is None else torch.tensor(v, dtype=dtype,
                                                  device=device)
           for k, v in arrays.items()}
    return dict(ops, has_f=has_f, f_shared=dyn_shared)


@pytest.mark.parametrize('ns,nc,T,B,cost_shared,dyn_shared,has_I,has_f', [
    (20, 4, 20, 1024, True, True, True, False),
    (24, 4, 20, 1030, True, True, True, True),
    (16, 4, 20, 300, False, False, True, True),
    (3, 4, 5, 128, False, False, False, True),
    (5, 1, 20, 2050, True, False, True, False),
    (28, 4, 7, 100, False, True, True, True),
    (24, 8, 7, 100, True, False, True, False),
    (2, 2, 200, 70, True, True, True, True),
    # past 8 controls: the factor on the warp's tiles, and the gate's
    # corners
    (4, 12, 20, 1024, True, True, True, False),
    (4, 12, 20, 256, False, False, False, True),
    (1, 31, 4, 64, True, False, True, True),
    (4, 28, 4, 64, False, True, False, False)])
def test_bwd_dense_matches_plain(cuda, ns, nc, T, B, cost_shared, dyn_shared,
                                 has_I, has_f):
    """Every gradient within 1e-4 of the plain version relative to its
    largest entry, and no further from a float64 plain run than twice
    the plain float32 run (the batch sums take another order)."""
    ops = _bwd_dense_problem(cuda, ns, nc, T, B, cost_shared, dyn_shared,
                             has_I, has_f)
    fused_bwd.reset_launch_counts()
    got = fused_bwd_dense.fused_kkt_backward_dense(**ops)
    assert fused_bwd.launch_counts['fused_kkt_bwd_dense'] == 1
    ref = fused_bwd_dense.fused_kkt_backward_dense_plain(**ops)
    ref64 = fused_bwd_dense.fused_kkt_backward_dense_plain(**{
        k: v.double() if isinstance(v, torch.Tensor) else v
        for k, v in ops.items()})
    for a, b, r in zip(got, ref, ref64):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
        k_far = float((a.double() - r).abs().mean())
        p_far = float((b.double() - r).abs().mean())
        assert k_far <= 2 * p_far + 1e-7 * scale, (k_far, p_far)


def test_bwd_dense_position_free_and_repeatable(cuda):
    """Per-example outputs are bitwise the same whatever batch an example
    sits in (reversed, alone, a partial chunk, B+2), and a second launch
    repeats every output, the batch sums included."""
    ops = _bwd_dense_problem(cuda, 16, 4, 20, 1030, False, False)
    full = fused_bwd_dense.fused_kkt_backward_dense(**ops)
    again = fused_bwd_dense.fused_kkt_backward_dense(**ops)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    per = ('C', 'c', 'F', 'x_star', 'u_star', 'dl_dx', 'dl_du', 'I_mask')
    rev = fused_bwd_dense.fused_kkt_backward_dense(**dict(
        ops, **{k: ops[k].flip(1).contiguous() for k in per}))
    assert torch.equal(rev[0].flip(0), full[0])
    assert all(torch.equal(a.flip(1), b) for a, b in zip(rev[1:], full[1:]))
    for n in (1, 7, 33, 65):
        part = fused_bwd_dense.fused_kkt_backward_dense(**dict(
            ops, **{k: ops[k][:, :n].contiguous() for k in per}))
        assert torch.equal(part[0], full[0][:n])
        # a batch of one has leaves of extent 1, which the backward reads
        # as shared ones: their gradient is the one example's, unbatched
        assert all(torch.equal(a.reshape(b[:, :n].shape), b[:, :n])
                   for a, b in zip(part[1:], full[1:]))
    shared = _bwd_dense_problem(cuda, 20, 4, 20, 1024, True, True)
    one = fused_bwd_dense.fused_kkt_backward_dense(**shared)
    two = fused_bwd_dense.fused_kkt_backward_dense(**shared)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    idx = torch.cat([torch.arange(1024), torch.arange(2)]).to(cuda)
    more = fused_bwd_dense.fused_kkt_backward_dense(**dict(
        shared, **{k: shared[k][:, idx].contiguous() for k in per[3:]}))
    assert torch.equal(more[0][:1024], one[0])


def test_bwd_dense_differentiable_solve_launches_once(cuda):
    """A differentiable 6-state, 2-control solve on the default device
    launches the dense forward and the dense backward once each, no eager
    solve or fixed point; float64 on the card takes the eager fixed
    point."""
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 256, 6, 2)
    cfg = dataclasses.replace(cfg, backprop=True, detach_unconverged=False)
    c = cost.c.clone().requires_grad_(True)
    F = dyn.F.clone().requires_grad_(True)
    out, launched = _launched(lambda: mt.batched_solve(
        cfg, x0, mt.QuadCost(cost.C, c), mt.LinDx(F, dyn.f), **bk))
    assert launched == {'fused_ilqr_dense': 1}
    solver.reset_eager_counts()
    _, launched = _launched(lambda: (out.u ** 2).sum().backward())
    assert launched == {'fused_kkt_bwd_dense': 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    assert torch.isfinite(c.grad).all() and c.grad.abs().max() > 0
    assert torch.isfinite(F.grad).all() and F.grad.abs().max() > 0
    cfg64, x64, cost64, dyn64, bk64 = _dense_problem(cuda, 16, 6, 2,
                                                     dtype=torch.float64)
    c64 = cost64.c.clone().requires_grad_(True)
    solver.reset_eager_counts()
    sol = mt.batched_solve(dataclasses.replace(cfg64, backprop=True),
                           x64, mt.QuadCost(cost64.C, c64), dyn64, **bk64)
    _, launched = _launched(lambda: (sol.u ** 2).sum().backward())
    assert launched == {}
    assert solver.eager_counts['eager_fixed_point'] == 1


def test_bwd_dense_raises_rather_than_falls_back(cuda, monkeypatch):
    ops = _bwd_dense_problem(cuda, 6, 2, 5, 64, True, True)
    with pytest.raises(ValueError):
        fused_bwd_dense.fused_kkt_backward_dense(**dict(
            ops, C=ops['C'].double()))

    def broken(*a, **k):
        raise RuntimeError('the dense backward library is broken')

    monkeypatch.setattr(fused_bwd_dense, 'kernel_lib', broken)
    fused_bwd.reset_launch_counts()
    with pytest.raises(RuntimeError, match='broken'):
        fused_bwd_dense.fused_kkt_backward_dense(**ops)
    cfg, x0, cost, dyn, bk = _dense_problem(cuda, 64, 6, 2)
    c = cost.c.clone().requires_grad_(True)
    sol = mt.batched_solve(dataclasses.replace(cfg, backprop=True), x0,
                           mt.QuadCost(cost.C, c), dyn, **bk)
    solver.reset_eager_counts()
    with pytest.raises(RuntimeError, match='broken'):
        (sol.u ** 2).sum().backward()
    assert fused_bwd.launch_counts['fused_kkt_bwd_dense'] == 0
    assert solver.eager_counts['eager_fixed_point'] == 0


def _counts():
    return dict(fused.launch_counts, **fused_bwd.launch_counts)


def _launched(fn):
    """fn's result and the kernels it launched (every count set to 0
    before it)."""
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    out = fn()
    return out, {k: v for k, v in _counts().items() if v}


def test_exported_solve_launches_k1_bitwise_live(cuda):
    """A solve exported on the card holds one k1_solve node; each call
    of the artifact launches K1 once and gives the live solve's bits; so
    does an artifact traced on CPU tensors and moved to the card
    (move_to_device_pass), and one padded to max_batch at b < max_batch."""
    from mpc_tpu_torch.utils import export as ex
    x0, dx, cost = _problem(cuda, 256, 20)
    cfg = _cfg(20)
    kw = dict(u_lower=-2.0, u_upper=2.0)
    live = mt.batched_solve(cfg, x0, cost, dx, **kw)
    on_card = ex.export_solve(cfg, dx, cost, x0, device=cuda, **kw)
    from_cpu = ex.export_solve(
        cfg, PendulumDx(device='cpu'),
        mt.QuadCost(cost.C.cpu(), cost.c.cpu()), x0.cpu(), device=cuda,
        **kw)
    padded = ex.export_solve(cfg, dx, cost, x0, polymorphic_batch=True,
                             max_batch=512, device=cuda, **kw)
    for data in (on_card, from_cpu, padded):
        assert ex.kernel_nodes(data) == {'k1_solve': 1}
        out, launched = _launched(lambda: ex.load_fn(data)(x0, cost.C,
                                                           cost.c))
        assert launched == {'fused_ilqr': 1}
        for a, b in zip(out, (live.x, live.u, live.costs)):
            assert torch.equal(a, b)


def test_exported_gradient_launches_k1_and_k2(cuda):
    """The gradient of sum(u^2) to c, exported on the card: one node of
    K1's and K2's ops each, one launch each a call, the live gradient's
    bits."""
    from mpc_tpu_torch.utils import export as ex
    x0, dx, cost = _problem(cuda, 1024, 10)
    cfg = _cfg(10, backprop=True, max_linesearch_iter=3)

    def grad(c):
        c = c.detach().requires_grad_()
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), dx,
                               u_lower=-2.0, u_upper=2.0)
        return torch.autograd.grad((sol.u ** 2).sum(), c)[0]

    data = ex.export_fn(grad, cost.c)
    assert ex.kernel_nodes(data) == {'k1_solve': 1, 'k2_backward': 1}
    g, launched = _launched(lambda: ex.load_fn(data)(cost.c))
    assert launched == {'fused_ilqr': 1, 'fused_kkt_bwd': 1}
    assert torch.equal(g, grad(cost.c))


def test_solve_sharded_on_one_card_is_bitwise_unsharded(cuda):
    """Four shards on the one card: four K1 launches, every output the
    unsharded solve's bits (K1 solves each example alone)."""
    from mpc_tpu_torch.parallel import make_mesh, solve_sharded
    x0, dx, cost = _problem(cuda, 1024, 20)
    cfg = _cfg(20)
    sol, launched = _launched(lambda: solve_sharded(
        cfg, make_mesh([cuda] * 4), x0, cost, dx, u_lower=-2.0,
        u_upper=2.0))
    assert launched == {'fused_ilqr': 4}
    one = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    for a, b in zip(sol[:8], one[:8]):
        assert torch.equal(a, b)


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    """load_checkpoint puts a state on the card by default."""
    from mpc_tpu_torch.utils import load_checkpoint, save_checkpoint
    state = mt.TrainState({'c': torch.arange(4.)}, {'lr': 0.1}, 3)
    path = save_checkpoint(str(tmp_path / 'ckpt.pt'), state)
    got = load_checkpoint(path, like=state._replace(
        theta={'c': torch.zeros(4)}))
    assert got.theta['c'].device.type == 'cuda' and got.step == 3
    assert torch.equal(got.theta['c'].cpu(), state.theta['c'])


# ---------------------------------------------------------------------------
# The nonlinear models: the dense configuration's model-step build (the
# cartpole, the slew passthrough over each model) and K1 and K3 on the
# damped pendulum
# ---------------------------------------------------------------------------

# each define set of this slice: (model, slew, kernel, T)
SOA_CASES = {
    'cartpole': ('cartpole', False, 'dense', 25),
    'cartpole_long': ('cartpole', False, 'dense', 200),
    'slew_pendulum': ('pendulum', True, 'dense', 20),
    'slew_damped': ('damped_pendulum', True, 'dense', 20),
    'slew_cartpole': ('cartpole', True, 'dense', 25),
    'damped_k1': ('damped_pendulum', False, 'K1', 20),
    'damped_k3': ('damped_pendulum', False, 'K3', 200),
}
SOA_DAMPED = (10.0, 1.0, 1.0, 0.1, 0.05)


def _soa_problem(device, case, B, dtype=torch.float32, seed=0):
    """(ops, kernel, plain, control scale) of a SOA_CASES case at B."""
    from mpc_tpu_torch.models import CartpoleDx
    model, slew, kernel, T = SOA_CASES[case]
    rng = np.random.RandomState(seed)
    if model == 'cartpole':
        th = 0.5 * (2 * rng.rand(B) - 1)
        z = np.zeros(B)
        x0 = np.stack([z, z, np.cos(th), np.sin(th), z], 1)
        dx = CartpoleDx(device=device, dtype=dtype)
        box = 100.0
        cfg = _cfg(T, n_state=5, lqr_iter=10, linesearch_decay=0.5,
                   max_linesearch_iter=2)
    else:
        th = np.pi * (2 * rng.rand(B) - 1)
        x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
        prm = SOA_DAMPED if model == 'damped_pendulum' else (10., 1., 1.)
        dx = PendulumDx(params=torch.tensor(prm, dtype=dtype, device=device),
                        simple=model == 'pendulum')
        box = 2.0
        cfg = _cfg(T, lqr_iter=10, linesearch_decay=0.2)
    q, p = dx.get_true_obj()
    cost = mt.QuadCost(torch.diag(q), p)
    x0 = torch.tensor(x0, dtype=dtype, device=device)
    bk = dict(u_lower=-box, u_upper=box)
    if slew:
        cfg = dataclasses.replace(cfg, slew_rate_penalty=0.5)
        prev = torch.tensor(rng.uniform(-1, 1, (B, 1)), dtype=dtype,
                            device=device)
        cfg, x0, cost, dx = fused.slew_problem(cfg, x0, cost, dx, prev)
    if kernel == 'dense':
        return (fused_dense.k3d_operands(cfg, x0, cost, dx, **bk),
                fused_dense.fused_ilqr_dense,
                fused_dense.fused_solve_dense_plain, box / 2.0)
    if kernel == 'K1':
        return (fused.k1_operands(cfg, x0, cost, dx, **bk), fused.fused_ilqr,
                fused.fused_solve_plain, 1.0)
    return (fused.k3_operands(cfg, x0, cost, dx, **bk), fused.fused_ilqr_long,
            fused.fused_solve_long_plain, 1.0)


def soa_case_main(case):
    """One case against its plain version at B=2050 (more than a block's
    examples, a ragged tail), run alone in a process under
    CUDA_LAUNCH_BLOCKING=1 by test_soa_matches_plain: a fault is reported
    at the launch that made it.  The controls are held in units of
    ``scale`` (the cartpole's +-100 box as the pendulum's +-2) to the
    float32 tail, n_iter equal, no further from float64 than twice the
    plain float32 run."""
    device = torch.device('cuda')
    ops, kernel, plain, scale = _soa_problem(device, case, 2050)
    ops64, _, _, _ = _soa_problem(device, case, 2050, torch.float64)
    fused.reset_launch_counts()
    xk, uk, sk = kernel(**ops)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts.values()) == 1
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    long_pendulum = case == 'damped_k3'
    if not long_pendulum:
        _assert_tail(uk / scale, up / scale)
        assert torch.equal(sk[2], sp[2])
    _assert_near_f64(uk / scale, up / scale, u64 / scale)
    print('ok', case, float((uk - up).abs().max()))


@pytest.mark.parametrize('case', list(SOA_CASES))
def test_soa_matches_plain(cuda, case):
    """Each define set of the nonlinear models against its plain version
    at B=2050, one case a process under CUDA_LAUNCH_BLOCKING=1 (a load
    the compiler hoists through an absent operand's null pointer faults
    at its own launch there).  The damped
    pendulum at T=200 is held against float64 alone (two float32 solves
    of the pendulum drift apart over long horizons)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_soa_position_free_and_repeatable(cuda):
    """The cartpole's and the slew pendulum's outputs are bitwise the same
    whatever batch an example sits in (reversed, alone, past a block) and
    at a second launch: the model's step in every lane gives every lane
    the same bits."""
    for case in ('cartpole', 'slew_pendulum'):
        ops, kernel, _, _ = _soa_problem(cuda, case, 2050)
        full = kernel(**ops)
        assert all(torch.equal(a, b) for a, b in zip(full, kernel(**ops)))
        rev = kernel(**dict(ops, x0=ops['x0'].flip(0).contiguous(),
                            u0=ops['u0'].flip(1).contiguous()))
        assert all(torch.equal(a.flip(1), b) for a, b in zip(rev, full))
        for n in (1, 7, 33):
            part = kernel(**dict(ops, x0=ops['x0'][:n].contiguous(),
                                 u0=ops['u0'][:, :n].contiguous()))
            assert all(torch.equal(a, b[:, :n]) for a, b in zip(part, full))


def test_soa_entry_points_launch_once(cuda):
    """Config 3 through batched_solve and MPC, the slew pendulum and the
    damped pendulum (T=20 and T=200) through batched_solve: one launch of
    their kernel a request and no eager solve; a differentiable cartpole
    solve launches the dense forward and the dense backward once each and
    returns finite gradients to its parameters."""
    from mpc_tpu_torch.models import CartpoleDx
    B = 512
    rng = np.random.RandomState(3)
    th = 0.5 * (2 * rng.rand(B) - 1)
    z = np.zeros(B)
    x0 = torch.tensor(np.stack([z, z, np.cos(th), np.sin(th), z], 1),
                      dtype=torch.float32, device=cuda)
    cart = CartpoleDx(device=cuda)
    q, p = cart.get_true_obj()
    cost = mt.QuadCost(torch.diag(q), p)
    cfg = _cfg(25, n_state=5, lqr_iter=10, linesearch_decay=0.5,
               max_linesearch_iter=2)
    bk = dict(u_lower=-100.0, u_upper=100.0)
    (sol, u), launched = _launched(lambda: (
        mt.batched_solve(cfg, x0, cost, cart, **bk),
        mt.MPC(5, 1, 25, lqr_iter=10, eps=0.0, linesearch_decay=0.5,
               max_linesearch_iter=2, exit_unconverged=False,
               backprop=False, **bk)(x0, cost, cart)[1]))
    assert launched == {'fused_ilqr_dense': 2} and torch.equal(u, sol.u)
    x3, dx3, cost3 = _problem(cuda, 1024, 20)
    for kw, dyn, want in (
            (dict(slew_rate_penalty=0.5), dx3, 'fused_ilqr_dense'),
            ({}, PendulumDx(simple=False, device=cuda), 'fused_ilqr'),
            (dict(T=200), PendulumDx(simple=False, device=cuda),
             'fused_ilqr_long')):
        c = _cfg(kw.pop('T', 20), **kw)
        solver.reset_eager_counts()
        s, launched = _launched(lambda: mt.batched_solve(
            c, x3, cost3, dyn, u_lower=-2.0, u_upper=2.0))
        assert launched == {want: 1} and torch.isfinite(s.u).all()
        assert solver.eager_counts['eager_solve'] == 0
    prm = cart.params.clone().requires_grad_(True)
    solver.reset_eager_counts()
    sol, launched = _launched(lambda: mt.batched_solve(
        dataclasses.replace(cfg, backprop=True, detach_unconverged=False,
                            grad_method=mt.GradMethods.AUTO_DIFF), x0, cost,
        CartpoleDx(params=prm), **bk))
    (_, launched_bwd) = _launched(lambda: (sol.u ** 2).mean().backward())
    assert launched == {'fused_ilqr_dense': 1}
    assert launched_bwd == {'fused_kkt_bwd_dense': 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    assert torch.isfinite(prm.grad).all() and prm.grad.abs().max() > 0


def test_soa_raises_rather_than_falls_back(cuda, monkeypatch):
    """With the dense library or K1's broken, a cartpole or damped
    pendulum request raises: no plain version, no eager solve."""
    ops, kernel, _, _ = _soa_problem(cuda, 'cartpole', 64)
    with pytest.raises(ValueError):
        kernel(**dict(ops, params=ops['params'][:3].contiguous()))

    def broken(*a, **k):
        raise RuntimeError('the library is broken')

    monkeypatch.setattr(fused_dense, 'kernel_lib', broken)
    monkeypatch.setattr(fused, '_kernel_lib', broken)
    from mpc_tpu_torch.models import CartpoleDx
    cart = CartpoleDx(device=cuda)
    q, p = cart.get_true_obj()
    x0, dx, cost = _problem(cuda, 64, 20)
    solver.reset_eager_counts()
    fused.reset_launch_counts()
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(_cfg(25, n_state=5), torch.zeros(
            64, 5, device=cuda), mt.QuadCost(torch.diag(q), p), cart,
            u_lower=-100.0, u_upper=100.0)
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(_cfg(20), x0, cost,
                         PendulumDx(simple=False, device=cuda),
                         u_lower=-2.0, u_upper=2.0)
    assert not any(fused.launch_counts.values())
    assert solver.eager_counts['eager_solve'] == 0


@pytest.mark.parametrize('B', [512, 2050])
@pytest.mark.parametrize('case', ['cartpole', 'slew_pendulum'])
def test_soa_workspace_layouts_match_plain_and_each_other(cuda, monkeypatch,
                                                          case, B):
    """The model-step build with its workspace in global and in shared
    memory (each forced by replacing fused_dense.dense_ws_shared) at
    config 3's shapes (B=512) and at B=2050: one launch, the float32 tail
    of the plain version with n_iter equal, the reversed batch bitwise,
    and the two layouts bitwise equal."""
    ops, kernel, plain, scale = _soa_problem(cuda, case, B)
    _, up, sp = plain(**ops)
    T, _, nc = ops['u0'].shape
    outs = {}
    for shared in (False, True):
        monkeypatch.setattr(fused_dense, 'dense_ws_shared',
                            lambda *a, s=shared: s)
        geo = fused_dense.k3d_launch(T, B, ops['x0'].shape[1], nc, 5, True)
        assert geo['ws_shared'] is shared
        assert (geo['workspace_bytes'] == 0) is shared
        fused.reset_launch_counts()
        full = kernel(**ops)
        torch.cuda.synchronize()
        assert fused.launch_counts['fused_ilqr_dense'] == 1
        assert torch.isfinite(full[0]).all() and torch.isfinite(full[1]).all()
        _assert_tail(full[1] / scale, up / scale)
        assert torch.equal(full[2][2], sp[2])
        back = kernel(**_batch_map(ops, lambda a: a.flip(0),
                                   lambda a: a.flip(1)))
        assert all(torch.equal(a.flip(1), b) for a, b in zip(back, full))
        outs[shared] = full
    assert all(torch.equal(a, b) for a, b in zip(outs[False], outs[True]))


# ---------------------------------------------------------------------------
# the pseudo-Huber cost in the kernels' cost build (MPC_COST = 1)
# ---------------------------------------------------------------------------

# each define set of the cost build: (dynamics, kernel, T, n_state, n_ctrl)
HUBER_CASES = {
    'huber_k1': ('pendulum', 'K1', 20, 3, 1),
    'huber_k3_pendulum': ('pendulum', 'K3', 200, 3, 1),
    'huber_k3_lindx': ('lindx', 'K3', 40, 3, 1),
    'huber_k3_mlp': ('mlp', 'K3', 20, 3, 1),
    'huber_dense_lindx': ('lindx', 'dense', 20, 5, 2),
    'huber_dense_cartpole': ('cartpole', 'dense', 25, 5, 1),
    # from starts near the goal: no control on the box and H_uu near w_u,
    # so the model-step cost build's H and g are held to the float32 tail
    'huber_dense_cartpole_near': ('cartpole_near', 'dense', 25, 5, 1),
}


def _huber_problem(device, case, B, dtype=torch.float32, seed=0):
    """(ops, kernel, plain) of a HUBER_CASES case at B: the pseudo-Huber
    cost with w the diagonal of the problem's QuadCost, goal its target
    and delta 0.9, the serving row's solver settings (6 iterations, 3
    step sizes), box bounds."""
    from mpc_tpu_torch.models import CartpoleDx, PseudoHuberCost
    dyn, kernel, T, ns, nc = HUBER_CASES[case]
    rng = np.random.RandomState(seed)
    t = (lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device))
    cfg = _cfg(T, n_state=ns, n_ctrl=nc, lqr_iter=6, linesearch_decay=0.2,
               max_linesearch_iter=3)
    box = 2.0
    if dyn in ('cartpole', 'cartpole_near'):
        th = (0.05 if dyn == 'cartpole_near' else 0.5) * (2 * rng.rand(B) - 1)
        z = np.zeros(B)
        x0 = np.stack([z, z, np.cos(th), np.sin(th), z], 1)
        model = CartpoleDx(device=device, dtype=dtype)
        box = 100.0
        w = model.get_true_obj()[0].cpu().numpy()
        goal = list(model.goal_state) + [0.0]
    elif dyn == 'lindx':
        A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
        A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
        F = np.tile(np.concatenate([A, 0.5 * rng.randn(ns, nc)], 1)[None],
                    (T - 1, 1, 1))
        model = mt.LinDx(t(F))
        x0 = rng.randn(B, ns)
        w = np.r_[np.ones(ns), 0.1 * np.ones(nc)]
        goal = np.r_[0.5 * rng.randn(ns), np.zeros(nc)]
    else:
        th = np.pi * (2 * rng.rand(B) - 1)
        x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
        model = PendulumDx(device=device, dtype=dtype) if dyn == 'pendulum' \
            else mt.NNDynamics.init(3, 1, (100,), 'sigmoid',
                                    generator=torch.Generator().manual_seed(0),
                                    device=device).to(dtype)
        w = PendulumDx(device=device, dtype=dtype).get_true_obj()[0]
        w = w.cpu().numpy()
        goal = [1.0, 0.0, 0.0, 0.0]
    cost = PseudoHuberCost(t(w), t(goal), t(0.9))
    x0 = t(x0)
    bk = dict(u_lower=-box, u_upper=box)
    if kernel == 'dense':
        return (fused_dense.k3d_operands(cfg, x0, cost, model, **bk),
                fused_dense.fused_ilqr_dense,
                fused_dense.fused_solve_dense_plain)
    if kernel == 'K1':
        return (fused.k1_operands(cfg, x0, cost, model, **bk),
                fused.fused_ilqr, fused.fused_solve_plain)
    return (fused.k3_operands(cfg, x0, cost, model, **bk),
            fused.fused_ilqr_long, fused.fused_solve_long_plain)


def huber_case_main(case):
    """One case of the cost build against its plain version at B=2050,
    run alone in a process under CUDA_LAUNCH_BLOCKING=1 by
    test_huber_matches_plain: one launch, finite, the float32 tail, n_iter
    equal and no further from float64 than twice the plain float32 run.
    The pendulum at T=200 and the cartpole are held against float64
    alone: two float32 solves of them part (the pendulum over its long
    horizon; the cartpole, whose control weight 0.001 leaves the cost's
    linear tails almost no curvature, at round-off ties of its bang-bang
    controls, where the plain float32 run itself sits ~1e-3 of the box
    from float64)."""
    device = torch.device('cuda')
    ops, kernel, plain = _huber_problem(device, case, 2050)
    ops64, _, _ = _huber_problem(device, case, 2050, torch.float64)
    assert ops['C'] is None and ops['c'] is None
    fused.reset_launch_counts()
    xk, uk, sk = kernel(**ops)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts.values()) == 1
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if case not in ('huber_k3_pendulum', 'huber_dense_cartpole'):
        _assert_tail(uk, up)
        assert torch.equal(sk[2], sp[2])
    _assert_near_f64(uk, up, u64)
    print('ok', case, float((uk - up).abs().max()))


@pytest.mark.parametrize('case', list(HUBER_CASES))
def test_huber_matches_plain(cuda, case):
    """Each define set of the cost build (K1, K3 with each MPC_DYN, the
    dense LinDx and model-step builds) against its plain version at
    B=2050, one case a process under CUDA_LAUNCH_BLOCKING=1: a load
    through the absent C or c would fault at its own launch there."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_huber_position_free_and_entry_points(cuda, monkeypatch):
    """The serving row's K1 cost build gives an example's bits whatever
    batch it sits in; batched_solve launches it once a request with no
    eager solve; a differentiable solve launches K1 and K2 once each and
    gives finite gradients to w, goal and delta; with K1's library broken
    a request raises."""
    from mpc_tpu_torch.models import PseudoHuberCost
    ops, kernel, _ = _huber_problem(cuda, 'huber_k1', 2050)
    full = kernel(**ops)
    assert all(torch.equal(a, b) for a, b in zip(full, kernel(**ops)))
    for n in (1, 7, 33):
        part = kernel(**dict(ops, x0=ops['x0'][:n].contiguous(),
                             u0=ops['u0'][:, :n].contiguous()))
        assert all(torch.equal(a, b[:, :n]) for a, b in zip(part, full))
    x0, dx, _ = _problem(cuda, 256, 8)
    w = torch.tensor([1., 1., .1, .1], device=cuda, requires_grad=True)
    goal = torch.tensor([1., 0., 0., 0.], device=cuda, requires_grad=True)
    delta = torch.tensor(0.9, device=cuda, requires_grad=True)
    cost = PseudoHuberCost(w, goal, delta)
    cfg = _cfg(8, lqr_iter=12, max_linesearch_iter=3)
    solver.reset_eager_counts()
    sol, launched = _launched(lambda: mt.batched_solve(
        cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0))
    assert launched == {'fused_ilqr': 1}
    solver.reset_eager_counts()
    sol, launched = _launched(lambda: mt.batched_solve(
        dataclasses.replace(cfg, backprop=True, detach_unconverged=False),
        x0, cost, dx, u_lower=-2.0, u_upper=2.0))
    (_, launched_bwd) = _launched(lambda: (sol.u ** 2).sum().backward())
    assert launched == {'fused_ilqr': 1}
    assert launched_bwd == {'fused_kkt_bwd': 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    for g in (w.grad, goal.grad, delta.grad):
        assert torch.isfinite(g).all() and g.abs().max() > 0

    def broken(*a, **k):
        raise RuntimeError('the library is broken')

    monkeypatch.setattr(fused, '_kernel_lib', broken)
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(cfg, x0, PseudoHuberCost(w.detach(), goal.detach(),
                                                  0.9),
                         dx, u_lower=-2.0, u_upper=2.0)
    assert solver.eager_counts['eager_solve'] == 0


# ---------------------------------------------------------------------------
# controls pinned to zero (MPC_HAS_UZ) and the trust region delta_u
# ---------------------------------------------------------------------------

# each new define set and the trust region in each kernel: (problem,
# mask, bounded, delta_u); 'shared' pins every example's controls at t =
# 3..5 (benchmarks/hw_sweep.py:68-80), 'batched' 15% of them at random
UZ_CASES = {
    'uz_k1_shared_box': ('K1', 'shared', True, None),
    'uz_k1_batched_unbounded': ('K1', 'batched', False, None),
    'delta_k1': ('K1', None, True, 0.3),
    'uz_k3_lindx_delta': ('K3 lindx', 'batched', True, 0.3),
    'uz_k3_pendulum_long': ('K3 pendulum', 'shared', True, None),
    'uz_k3_mlp': ('K3 mlp', 'shared', True, None),
    'uz_dense_unbounded': ('dense 3s4c', 'batched', False, None),
    'delta_dense_box': ('dense 3s2c', None, True, 0.3),
    'uz_dense_cartpole_delta': ('dense cartpole', 'batched', True, 10.0),
    'uz_dense_slew': ('dense slew', 'shared', True, None),
}


def _uz_problem(device, case, B, dtype=torch.float32, seed=0):
    """(ops, kernel, plain) of a UZ_CASES case at B: the problem's
    operands with its mask and trust region."""
    from mpc_tpu_torch.models import CartpoleDx
    prob, mask, bounded, delta = UZ_CASES[case]
    rng = np.random.RandomState(seed)
    t = (lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device))
    box, nc = 2.0, 1
    if prob == 'K1' or prob == 'dense slew':
        T = 20
        x0, dx, cost = _problem(device, B, T, seed)
        cfg = _cfg(T, lqr_iter=6, linesearch_decay=0.2,
                   max_linesearch_iter=3)
    elif prob == 'K3 lindx':
        T = 40
        x0, dx, cost = _lindx_problem(device, T, B, True, False, seed,
                                      dtype)
        cfg, box = _cfg(T, lqr_iter=4, linesearch_decay=0.2,
                        max_linesearch_iter=3), 0.6
    elif prob == 'K3 pendulum':
        T = 200
        x0, dx, cost = _problem(device, B, T, seed)
        cfg = _cfg(T, lqr_iter=3, linesearch_decay=0.2)
    elif prob == 'K3 mlp':
        T = 20
        x0, dx, cost = _nn_problem(device, B, T, dtype=dtype)
        cfg = _cfg(T, lqr_iter=6, linesearch_decay=0.2,
                   max_linesearch_iter=3)
    elif prob == 'dense 3s4c':
        cfg, x0, cost, dx, _ = _dense_problem(device, B, 3, 4, T=5,
                                              bounded=False, layout='tvlqr',
                                              dtype=dtype, seed=seed)
        T, nc = 5, 4
    elif prob == 'dense 3s2c':
        T, nc = 8, 2
        F, C, c, x0, lb, ub = hw_sweep_delta_u(T, B)
        cost, dx = mt.QuadCost(t(C), t(c)), mt.LinDx(t(F))
        x0, box = t(x0), (t(lb), t(ub))
        cfg = _cfg(T, n_state=3, n_ctrl=nc, lqr_iter=8, pnqp_iter=20,
                   linesearch_decay=0.2, max_linesearch_iter=3)
    else:
        T = 25
        th = 0.5 * (2 * rng.rand(B) - 1)
        z = np.zeros(B)
        x0 = t(np.stack([z, z, np.cos(th), np.sin(th), z], 1))
        dx = CartpoleDx(device=device, dtype=dtype)
        q, p = dx.get_true_obj()
        cost, box = mt.QuadCost(torch.diag(q), p), 100.0
        cfg = _cfg(T, n_state=5, lqr_iter=10, linesearch_decay=0.5,
                   max_linesearch_iter=2)
    x0, cost = x0.to(dtype), mt.QuadCost(cost.C.to(dtype), cost.c.to(dtype))
    if isinstance(dx, PendulumDx):
        dx = PendulumDx(device=device, dtype=dtype)
    cfg = dataclasses.replace(cfg, delta_u=delta)
    uz = None
    if mask == 'shared':
        uz = np.zeros((T, nc), bool)
        uz[3:6] = True
    elif mask == 'batched':
        uz = np.random.RandomState(seed + 1).rand(T, B, nc) < 0.15
    bk = dict(u_zero_I=None if uz is None else torch.tensor(uz,
                                                            device=device))
    if bounded:
        lo, hi = box if isinstance(box, tuple) else (-box, box)
        bk.update(u_lower=lo, u_upper=hi)
    if prob == 'dense slew':
        cfg = dataclasses.replace(cfg, slew_rate_penalty=0.5)
        prev = t(rng.uniform(-1, 1, (B, 1)))
        cfg, x0, cost, dx = fused.slew_problem(cfg, x0, cost, dx, prev)
    if prob.startswith('dense'):
        return (fused_dense.k3d_operands(cfg, x0, cost, dx, **bk),
                fused_dense.fused_ilqr_dense,
                fused_dense.fused_solve_dense_plain)
    if prob == 'K1':
        return (fused.k1_operands(cfg, x0, cost, dx, **bk), fused.fused_ilqr,
                fused.fused_solve_plain)
    return (fused.k3_operands(cfg, x0, cost, dx, **bk),
            fused.fused_ilqr_long, fused.fused_solve_long_plain)


def uz_case_main(case):
    """One case against its plain version at B=2050, run alone in a
    process under CUDA_LAUNCH_BLOCKING=1 by test_uz_matches_plain: one
    launch, finite, pinned controls exactly 0.0, no control step past
    delta_u in the first iteration's box, n_iter equal in 99% of the
    examples, and no further from float64 than twice the plain float32
    run (the kinks of a mask amplify the float32 iterate divergence,
    benchmarks/hw_sweep.py:42-56, so float64 is the yardstick here; the
    tail is printed)."""
    device = torch.device('cuda')
    ops, kernel, plain = _uz_problem(device, case, 2050)
    ops64, _, _ = _uz_problem(device, case, 2050, torch.float64)
    fused.reset_launch_counts()
    xk, uk, sk = kernel(**ops)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts.values()) == 1
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if ops['uz'] is not None:
        pinned = (ops['uz'] > 0.5).expand_as(
            uk if uk.dim() == ops['uz'].dim() else uk[..., 0])
        assert float(uk.reshape(pinned.shape)[pinned].abs().max()) == 0.0
    assert float((sk[2] == sp[2]).double().mean()) >= 0.99
    _assert_near_f64(uk, up, u64)
    d = (uk - up).abs()
    print('ok', case, float(d.max()), float(d.mean()))


@pytest.mark.parametrize('case', list(UZ_CASES))
def test_uz_matches_plain(cuda, case):
    """Each MPC_HAS_UZ define set and the trust region in each kernel
    against the plain version at B=2050, one case a process under
    CUDA_LAUNCH_BLOCKING=1: a load through an absent operand would fault
    at its own launch there."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_uz_position_free_and_entry_points(cuda, monkeypatch):
    """A masked K1 and a masked dense solve give an example's bits
    whatever batch it sits in; batched_solve launches K1 once for a masked
    request and MPC once under delta_u, with no eager solve; delta_u
    without bounds under 'always' raises; with the mask build's library
    broken a request raises rather than falls back."""
    for case in ('uz_k1_shared_box', 'uz_dense_unbounded'):
        ops, kernel, _ = _uz_problem(cuda, case, 2050)
        full = kernel(**ops)
        assert all(torch.equal(a, b) for a, b in zip(full, kernel(**ops)))
        _assert_position_free(kernel, ops, full)
    x0, dx, cost = _problem(cuda, 256, 20)
    uz = torch.rand(20, 256, 1, device=cuda) < 0.2
    cfg = _cfg(20, lqr_iter=6)
    solver.reset_eager_counts()
    sol, launched = _launched(lambda: mt.batched_solve(
        cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0, u_zero_I=uz))
    assert launched == {'fused_ilqr': 1}
    assert float(sol.u[uz].abs().max()) == 0.0
    ctrl = mt.MPC(3, 1, 20, u_lower=-2.0, u_upper=2.0, lqr_iter=6,
                  delta_u=0.3, exit_unconverged=False, backprop=False)
    _, launched = _launched(lambda: ctrl(x0, cost, dx))
    assert launched == {'fused_ilqr': 1}
    assert solver.eager_counts['eager_solve'] == 0
    with pytest.raises(ValueError, match='always'):
        mt.batched_solve(dataclasses.replace(cfg, delta_u=0.3,
                                             use_fused='always'),
                         x0, cost, dx)

    def broken(*a, **k):
        raise RuntimeError('the library is broken')

    monkeypatch.setattr(fused, '_kernel_lib', broken)
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(cfg, x0, cost, dx, u_zero_I=uz)
    assert solver.eager_counts['eager_solve'] == 0


# ---------------------------------------------------------------------------
# learned dynamics at any size: the dense configuration's MLP build
# (MPC_MODEL 4, csrc/nn_dense.cuh)
# ---------------------------------------------------------------------------

# (row of utils/problems.MLP_ROWS, hidden widths, bounds, activation,
# passthrough): each define set the MLP build takes at B=2050 with T cut
# to 8: the slew row, the deep row, two and three hidden layers of other
# activations without the passthrough, the 8-state row with and without
# a box
MLP_CASES = {
    'mlp_slew': ('mlp-slew', None, True, 'sigmoid', True),
    'mlp_deep': ('mlp-deep', None, True, 'sigmoid', True),
    'mlp_deep_relu': ('mlp-deep', (24, 16), False, 'relu', False),
    'mlp_three_elu': ('mlp-multictrl', (20, 12, 9), True, 'elu', False),
    'mlp_multictrl': ('mlp-multictrl', None, True, 'sigmoid', True),
    'mlp_multictrl_free': ('mlp-multictrl', None, False, 'sigmoid', True),
}


def _mlp_problem(device, case, B, dtype=torch.float32):
    """(ops, cfg, x0, cost, model, bounds, prev) of an MLP_CASES case."""
    from mpc_tpu_torch.utils.convert import nn_dynamics_from_numpy
    from mpc_tpu_torch.utils.problems import mlp_row
    row, hidden, bounded, act, passthrough = MLP_CASES[case]
    r = mlp_row(row, B, T=8, hidden=hidden, bounded=bounded)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    cfg = _cfg(8, n_state=r['n_state'], n_ctrl=r['n_ctrl'], **r['cfg'])
    model = nn_dynamics_from_numpy(r['weights'], act, passthrough,
                                   device=device).to(dtype)
    x0, cost = t(r['x0']), mt.QuadCost(t(r['C']), t(r['c']))
    bk = {} if r['u_lower'] is None else dict(u_lower=r['u_lower'],
                                              u_upper=r['u_upper'])
    prev = None if r['prev_ctrl'] is None else t(r['prev_ctrl'])
    c, x, co, dyn = cfg, x0, cost, model
    if prev is not None:
        c, x, co, dyn = fused.slew_problem(cfg, x0, cost, model, prev)
    return (fused_dense.k3d_operands(c, x, co, dyn, **bk), cfg, x0, cost,
            model, bk, prev)


def mlp_case_main(case):
    """One case against its plain version at B=2050, run alone in a
    process under CUDA_LAUNCH_BLOCKING=1 by test_mlp_matches_plain: one
    launch, finite, no further from float64 than twice the plain float32
    run (two float32 solves of a stiff MLP part beyond the tail, PERF.md
    section 6), the reversed batch bitwise."""
    device = torch.device('cuda')
    ops = _mlp_problem(device, case, 2050)[0]
    ops64 = _mlp_problem(device, case, 2050, torch.float64)[0]
    kernel, plain = fused_dense.fused_ilqr_dense, \
        fused_dense.fused_solve_dense_plain
    fused.reset_launch_counts()
    xk, uk, sk = kernel(**ops)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts.values()) == 1
    _, up, _ = plain(**ops)
    _, u64, _ = plain(**ops64)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_near_f64(uk, up, u64)
    back = kernel(**_batch_map(ops, lambda a: a.flip(0), lambda a: a.flip(1)))
    assert all(torch.equal(a.flip(1), b) for a, b in zip(back, (xk, uk, sk)))
    print('ok', case, float((uk - up).abs().max()))


@pytest.mark.parametrize('case', list(MLP_CASES))
def test_mlp_matches_plain(cuda, case):
    """Each define set of the MLP build against its plain version at
    B=2050, one case a process under CUDA_LAUNCH_BLOCKING=1."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


# (n_state, n_ctrl, hidden widths, activation, T, slew penalty): the
# MLP build's Jacobian pass over a chunk of steps at awkward sizes, each
# at B=2050 with a box of +-1: widths 7, 33, 100 and 225, one to four
# hidden layers, T - 1 not a multiple of the chunk (the last chunk
# shorter), T = 2 (one step), and a slew penalty at 2 controls
CHUNK_CASES = {
    'chunk_w7': (2, 1, (7,), 'sigmoid', 7, None),
    'chunk_w33_d2': (3, 2, (33, 33), 'elu', 6, None),
    'chunk_w100_d3': (4, 1, (100, 7, 100), 'relu', 8, None),
    'chunk_w225_d4': (2, 1, (225, 33, 7, 225), 'sigmoid', 6, None),
    'chunk_T2': (2, 1, (64, 64), 'sigmoid', 2, None),
    'chunk_slew_2c': (2, 2, (33,), 'sigmoid', 7, 0.5),
}


def _chunk_problem(device, case, B, dtype=torch.float32):
    """A CHUNK_CASES case's dense-kernel operands, from a numpy seed."""
    from mpc_tpu_torch.utils.convert import nn_dynamics_from_numpy
    from mpc_tpu_torch.utils.problems import mlp_weights
    ns, nc, hid, act, T, slew = CHUNK_CASES[case]
    rng = np.random.RandomState(len(hid) + ns)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    model = nn_dynamics_from_numpy(
        mlp_weights((ns + nc,) + hid + (ns,), seed=len(hid)), act, True,
        device=device).to(dtype)
    cfg = _cfg(T, n_state=ns, n_ctrl=nc, lqr_iter=4,
               slew_rate_penalty=slew)
    x0 = t(rng.randn(B, ns))
    nt = ns + nc
    cost = mt.QuadCost(t(np.eye(nt)), t(0.1 * rng.randn(nt)))
    if slew is not None:
        cfg, x0, cost, model = fused.slew_problem(
            cfg, x0, cost, model, t(rng.uniform(-1, 1, (B, nc))))
    return fused_dense.k3d_operands(cfg, x0, cost, model, u_lower=-1.0,
                                    u_upper=1.0)


def chunk_case_main(case):
    """One CHUNK_CASES case against its plain version at B=2050, run alone
    in a process under CUDA_LAUNCH_BLOCKING=1 by
    test_mlp_chunked_jacobians_match_plain: one launch, finite, no further
    from the float64 plain run than twice the plain float32 run (two
    float32 solves of an MLP part beyond the tail, PERF.md section 6), the
    reversed batch bitwise."""
    device = torch.device('cuda')
    ops = _chunk_problem(device, case, 2050)
    ops64 = _chunk_problem(device, case, 2050, torch.float64)
    sizes = fused_dense.mlp_spec(ops['model'])[0]
    T, _, nc = ops['u0'].shape
    chunk = fused_dense.k3d_launch(T, 2050, ops['x0'].shape[1], nc, 5, True,
                                   sizes)['chunk']
    fused.reset_launch_counts()
    xk, uk, sk = fused_dense.fused_ilqr_dense(**ops)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts.values()) == 1
    _, up, _ = fused_dense.fused_solve_dense_plain(**ops)
    _, u64, _ = fused_dense.fused_solve_dense_plain(**ops64)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    _assert_near_f64(uk, up, u64)
    back = fused_dense.fused_ilqr_dense(**_batch_map(
        ops, lambda a: a.flip(0), lambda a: a.flip(1)))
    assert all(torch.equal(a.flip(1), b) for a, b in zip(back, (xk, uk, sk)))
    print('ok', case, 'chunk', chunk, float((uk - up).abs().max()))


@pytest.mark.parametrize('case', list(CHUNK_CASES))
def test_mlp_chunked_jacobians_match_plain(cuda, case):
    """The MLP build's Jacobian pass over a chunk of steps against the
    plain version at awkward widths, depths and horizons, one case a
    process under CUDA_LAUNCH_BLOCKING=1."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_mlp_entry_points_launch_once_and_never_fall_back(cuda,
                                                          monkeypatch):
    """The slew row and the deep row through batched_solve and MPC: one
    dense launch a request, no eager solve; a differentiable 8-state solve
    launches the dense forward and the dense backward once each with
    finite gradients to the weights; with the dense library broken a
    request raises."""
    _, cfg, x0, cost, model, bk, prev = _mlp_problem(cuda, 'mlp_slew', 512)
    solver.reset_eager_counts()
    (sol, u), launched = _launched(lambda: (
        mt.batched_solve(cfg, x0, cost, model, prev_ctrl=prev, **bk),
        mt.MPC(3, 1, 8, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
               linesearch_decay=cfg.linesearch_decay,
               max_linesearch_iter=cfg.max_linesearch_iter,
               slew_rate_penalty=0.5, prev_ctrl=prev,
               exit_unconverged=False, backprop=False, **bk)(
                   x0, cost, model)[1]))
    assert launched == {'fused_ilqr_dense': 2} and torch.equal(u, sol.u)
    _, cfg, x0, cost, model, bk, _ = _mlp_problem(cuda, 'mlp_deep', 1)
    s, launched = _launched(lambda: mt.batched_solve(cfg, x0, cost, model,
                                                     **bk))
    assert launched == {'fused_ilqr_dense': 1} and torch.isfinite(s.u).all()
    _, cfg, x0, cost, model, bk, _ = _mlp_problem(cuda, 'mlp_multictrl', 256)
    sol, launched = _launched(lambda: mt.batched_solve(
        dataclasses.replace(cfg, backprop=True, detach_unconverged=False),
        x0, cost, model, **bk))
    (_, launched_bwd) = _launched(lambda: (sol.u ** 2).mean().backward())
    assert launched == {'fused_ilqr_dense': 1}
    assert launched_bwd == {'fused_kkt_bwd_dense': 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    w = model.layers[0].weight.grad
    assert torch.isfinite(w).all() and w.abs().max() > 0

    def broken(*a, **k):
        raise RuntimeError('the library is broken')

    monkeypatch.setattr(fused_dense, 'kernel_lib', broken)
    with pytest.raises(RuntimeError, match='broken'):
        mt.batched_solve(cfg, x0, cost, model, **bk)
    assert solver.eager_counts['eager_solve'] == 0


# ---------------------------------------------------------------------------
# K3's team kernel on the pendulum across its shared-memory horizon
# ---------------------------------------------------------------------------

# each define set: the damped pendulum with a QuadCost, the simple
# pendulum's pseudo-Huber cost build; each at T = 196 and 200 (the state
# resident in shared memory: up to T = 202 and 206, fused.k3_t_resident)
# and 384 (past it, read through the lanes' rings)
K3_PENDULUM_CASES = {'k3_pendulum_damped': 'damped',
                     'k3_pendulum_cost': 'cost'}
K3_PENDULUM_T = (196, 200, 384)


def _k3_pendulum_problem(device, build, T, B, dtype=torch.float32, seed=0):
    """K3's operands of the damped pendulum (SOA_DAMPED, its QuadCost, 10
    iterations, 5 step sizes) or of the simple pendulum's pseudo-Huber
    cost (w the QuadCost's diagonal, goal upright, delta 0.9; 6
    iterations, 3 step sizes) from +-pi starts, box +-2."""
    from mpc_tpu_torch.models import PseudoHuberCost
    th = np.pi * (2 * np.random.RandomState(seed).rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      dtype=dtype, device=device)
    if build == 'damped':
        dx = PendulumDx(params=torch.tensor(SOA_DAMPED, dtype=dtype,
                                            device=device), simple=False)
        q, p = dx.get_true_obj()
        cost = mt.QuadCost(torch.diag(q), p)
        cfg = _cfg(T, lqr_iter=10, linesearch_decay=0.2)
    else:
        dx = PendulumDx(device=device, dtype=dtype)
        t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
        cost = PseudoHuberCost(dx.get_true_obj()[0], t([1., 0., 0., 0.]),
                               t(0.9))
        cfg = _cfg(T, lqr_iter=6, linesearch_decay=0.2,
                   max_linesearch_iter=3)
    return fused.k3_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)


def k3_pendulum_case_main(case):
    """A define set at each K3_PENDULUM_T, B=2050 (a ragged block), run
    in a process under CUDA_LAUNCH_BLOCKING=1 by
    test_k3_pendulum_matches_plain_across_residency: one launch a solve,
    finite, no further from the float64 plain run than twice the plain
    float32 run (two float32 solves of the pendulum part over long
    horizons), n_iter equal to the plain run's in 99% of the examples,
    the reversed batch and the first 1, 7 and 33 examples alone bitwise
    what they give inside the batch."""
    device = torch.device('cuda')
    build = K3_PENDULUM_CASES[case]
    for T in K3_PENDULUM_T:
        ops = _k3_pendulum_problem(device, build, T, 2050)
        ops64 = _k3_pendulum_problem(device, build, T, 2050, torch.float64)
        geo = fused.k3_launch(T, 2050, len(ops['alphas']), lindx=False,
                              huber=build == 'cost')
        fused.reset_launch_counts()
        full = fused.fused_ilqr_long(**ops)
        torch.cuda.synchronize()
        assert fused.launch_counts['fused_ilqr_long'] == 1
        xk, uk, sk = full
        assert all(torch.isfinite(a).all() for a in full)
        _, up, sp = fused.fused_solve_long_plain(**ops)
        _, u64, _ = fused.fused_solve_long_plain(**ops64)
        _assert_near_f64(uk, up, u64)
        assert float((sk[2] == sp[2]).double().mean()) >= 0.99
        _assert_position_free(fused.fused_ilqr_long, ops, full)
        print('ok', case, T, 'resident' if geo['resident'] else 'ring',
              float((uk - up).abs().mean()))
    print(f'ok {case}')


@pytest.mark.parametrize('case', list(K3_PENDULUM_CASES))
def test_k3_pendulum_matches_plain_across_residency(cuda, case):
    """Each define set of K3's team kernel on the pendulum, one process
    under CUDA_LAUNCH_BLOCKING=1 (a fault is reported at the launch that
    made it), at T = 196, 200 and 384: resident and through the rings."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING='1',
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0 and f'ok {case}' in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_k3_pendulum_past_residency_raises_rather_than_falls_back(
        cuda, monkeypatch):
    """Past the resident horizon the pendulum runs the rings' layout or
    raises: the geometry says the ring, and with the library broken the
    solve raises and launches nothing."""
    T = fused.k3_t_resident(lindx=False, n_alpha=5) + 1
    ops = _k3_pendulum_problem(cuda, 'damped', T, 64)
    assert not fused.k3_launch(T, 64, 5, lindx=False)['resident']

    def broken(*a, **k):
        raise RuntimeError('the K3 library is broken')
    monkeypatch.setattr(fused, '_kernel_lib_long', broken)
    fused.reset_launch_counts()
    with pytest.raises(RuntimeError, match='broken'):
        fused.fused_ilqr_long(**ops)
    assert fused.launch_counts['fused_ilqr_long'] == 0


if __name__ == '__main__':
    import sys
    if sys.argv[1] in HUBER_CASES:
        huber_case_main(sys.argv[1])
    elif sys.argv[1] in UZ_CASES:
        uz_case_main(sys.argv[1])
    elif sys.argv[1] in MLP_CASES:
        mlp_case_main(sys.argv[1])
    elif sys.argv[1] in CHUNK_CASES:
        chunk_case_main(sys.argv[1])
    elif sys.argv[1] in K3_PENDULUM_CASES:
        k3_pendulum_case_main(sys.argv[1])
    else:
        soa_case_main(sys.argv[1])
