"""The plain version of kernel K4 (the port's streaming KKT backward) and
the long-horizon imitation slice as a whole against the JAX package, on
the CPU.

Backward comparisons are same-primal (both sides get the same x*, u* and
cotangents), as in tests/test_torch_bwd.py:

- float64: ``fused_kkt_backward_long`` (the plain K4 on the CPU) against
  ``jax.vjp`` of the vmapped ``make_lqr_fixed_point`` for the four mixes
  of shared/batched cost and shared/batched dynamics, bounded with f and
  unbounded without.  Tolerance 1e-10 relative to each gradient's
  largest entry: the same recursion in another order; a batch-shared
  leaf gets its gradient summed over the batch, and an absent f gets
  None, not zeros.
- float32: against the streaming Pallas kernel
  ``make_batched_fixed_point(..., interpret=True)`` at
  tests/test_fused_bwd.py::test_bwd_long_all_shared's problem (T=130,
  B=16, all shared; the same calls, so the persistent compile cache is
  shared) with its tolerance, 5e-4 relative to scale.
- the fixed point's dispatch: each leaf of a LinDx gets its gradient in
  its own layout (shared F beside batched f and the reverse), 1e-12
  against the all-batched run summed.
- the slice as a whole, float64: the long-horizon imitation
  configuration (benchmarks/configs.py:325-372) cut to T=24, B=8: the
  loss and d loss / d c against ``jax.value_and_grad`` through
  mpc_tpu.learning.batched_solve, one SGD step against mpc_tpu's train
  step, and gradients to a shared F and f through ``MPC``.  Tolerance
  1e-7 relative to the largest entry, as tests/test_torch_train.py holds
  the pendulum; measured 1.0e-9.
- the backward's routing predicate, its bound counts, and the wrapper's
  refusal to fall back off the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mpc_tpu
from mpc_tpu.learning import (TrainState, batched_solve as j_batched_solve,
                              make_imitation_train_step as j_train_step)
from mpc_tpu.ops.diff import make_lqr_fixed_point
from mpc_tpu.ops.fused_bwd import (make_batched_fixed_point as
                                   j_make_batched_fixed_point)

import mpc_tpu_torch as mt
from mpc_tpu_torch.ops import fused_bwd

NAMES = ('dx_init', 'dC', 'dc', 'dF', 'df')
TOL = 1e-7


def _problem(T, B, cost_shared, dyn_shared, has_bounds, seed):
    """tests/test_fused_bwd.py:_vjp_case_long's arrays (the same draws in
    the same order), n_state = 3, n_ctrl = 1, float32."""
    ns, nc, nt = 3, 1, 4
    rng = np.random.RandomState(seed)
    csh = (T,) if cost_shared else (T, B)
    dsh = (T - 1,) if dyn_shared else (T - 1, B)
    Cr = rng.randn(*csh, nt, nt).astype(np.float32)
    C = np.einsum('...ij,...kj->...ik', Cr, Cr) + np.eye(nt, dtype=np.float32)
    c = rng.randn(*csh, nt).astype(np.float32)
    F = 0.35 * rng.randn(*dsh, ns, nt).astype(np.float32)
    F[..., :, :ns] += 0.8 * np.eye(ns, dtype=np.float32)
    f = 0.1 * rng.randn(*dsh, ns).astype(np.float32)
    xs = rng.randn(T, B, ns).astype(np.float32)
    us = rng.randn(T, B, nc).astype(np.float32)
    if has_bounds:
        m = rng.rand(T, B, nc) < 0.3      # ~30% exactly on a bound
        us = np.where(m, np.sign(us), us).astype(np.float32)
    lb = np.full((T, B, nc), -1.0, np.float32)
    ub = np.full((T, B, nc), 1.0, np.float32)
    gx = rng.randn(T, B, ns).astype(np.float32)
    gu = rng.randn(T, B, nc).astype(np.float32)
    return dict(C=C, c=c, F=F, f=f, xs=xs, us=us, lb=lb, ub=ub, gx=gx,
                gu=gu)


def _port(p, cost_shared, dyn_shared, has_bounds, has_f, dtype):
    """The plain K4 through the wrapper, on the CPU, on K4's operands."""
    t = {k: torch.tensor(v.astype(dtype)) for k, v in p.items()}
    C, c, F = t['C'], t['c'], t['F']
    if cost_shared:
        C, c = C.unsqueeze(1), c.unsqueeze(1)
    if dyn_shared:
        F = F.unsqueeze(1)
    I = (fused_bwd.active_set(t['us'], t['lb'], t['ub']) if has_bounds
         else None)
    return fused_bwd.fused_kkt_backward_long(
        C, c, F, t['xs'], t['us'], t['gx'], t['gu'], I, has_f=has_f)


def _jax_args(p, dtype):
    B = p['xs'].shape[1]
    return [jnp.asarray(a, dtype) for a in (
        np.zeros((B, 3)), p['C'], p['c'], p['F'], p['f'], p['lb'],
        p['ub'], p['xs'], p['us'])], (jnp.asarray(p['gx'], dtype),
                                       jnp.asarray(p['gu'], dtype))


def _assert_rel(ref, got, tol, has_f=True):
    for name, a, b in zip(NAMES, ref, got):
        if name == 'df' and not has_f:
            assert b is None          # an absent f has no gradient
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / scale < tol, \
            (name, np.abs(a - b).max(), scale)


@pytest.mark.parametrize('has_bounds,has_f', [(True, True), (False, False),
                                              (True, False)],
                         ids=['bounds_f', 'free_no_f', 'bounds_no_f'])
@pytest.mark.parametrize('dyn_shared', [True, False],
                         ids=['dyn_shared', 'dyn_batched'])
@pytest.mark.parametrize('cost_shared', [True, False],
                         ids=['cost_shared', 'cost_batched'])
def test_plain_k4_matches_jax_vjp_f64(cost_shared, dyn_shared, has_bounds,
                                      has_f):
    p = _problem(9, 16, cost_shared, dyn_shared, has_bounds, seed=0)
    args, cot = _jax_args(p, jnp.float64)
    ca = None if cost_shared else 1
    da = None if dyn_shared else 1
    fp = make_lqr_fixed_point(3, has_bounds, has_f)
    _, vjp = jax.vjp(jax.vmap(fp, in_axes=(0, ca, ca, da, da, 1, 1, 1, 1),
                              out_axes=(1, 1)), *args)
    ref = vjp(cot)[:5]
    got = _port(p, cost_shared, dyn_shared, has_bounds, has_f, np.float64)
    _assert_rel(ref, [None if g is None else g.numpy() for g in got],
                1e-10, has_f)


def test_plain_k4_matches_pallas_k4_f32():
    p = _problem(130, 16, True, True, True, seed=0)
    args, cot = _jax_args(p, jnp.float32)
    fp_k = j_make_batched_fixed_point(3, True, True, interpret=True)
    _, vjp_k = jax.vjp(fp_k, *args)
    ref = [np.asarray(a) for a in vjp_k(cot)[:5]]
    got = _port(p, True, True, True, True, np.float32)
    _assert_rel(ref, [g.numpy() for g in got], 5e-4)


def test_plain_k4_reversed_batch():
    """B=70 (two blocks of the card's kernel and a tail): per-example
    outputs of the reversed batch are bitwise equal; the batch-reduced
    dC, dc, dF, df sum in another order, 1e-5 relative (float32)."""
    p = _problem(7, 70, True, True, True, seed=6)
    got = _port(p, True, True, True, True, np.float32)
    rev = dict(p)
    for k in ('xs', 'us', 'lb', 'ub', 'gx', 'gu'):
        rev[k] = np.ascontiguousarray(p[k][:, ::-1])
    back = _port(rev, True, True, True, True, np.float32)
    np.testing.assert_array_equal(back[0].numpy()[::-1], got[0].numpy())
    for a, b in zip(back[1:], got[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def _fixed_point_grads(t, F, f):
    """Gradients of <gx, x> + <gu, u> through the fixed point with respect
    to (x_init, C, c, F, f), on the float64 problem ``t``."""
    B = t['xs'].shape[1]
    leaves = [torch.zeros(B, 3, dtype=torch.float64), t['C'], t['c'], F, f]
    leaves = [a.clone().requires_grad_() for a in leaves]
    fp = fused_bwd.make_batched_fixed_point(3, True, True)
    x, u = fp.apply(*leaves, t['lb'], t['ub'], t['xs'], t['us'])
    ((t['gx'] * x).sum() + (t['gu'] * u).sum()).backward()
    return [a.grad for a in leaves]


@pytest.mark.parametrize('layout', ['shared_F_batched_f',
                                    'batched_F_shared_f', 'all_shared'])
def test_fixed_point_dynamics_gradient_layouts(layout):
    """Each leaf of a LinDx gets its gradient in its own layout: a shared
    leaf the per-example gradient summed over the batch, whichever kernel
    its pair's layout routes the backward to."""
    T, B = 5, 4
    p = _problem(T, B, True, False, True, seed=5)
    t = {k: torch.tensor(v.astype(np.float64)) for k, v in p.items()}
    # the same values in every example, so shared and batched leaves agree
    Fb = t['F'][:, :1].expand(T - 1, B, 3, 4).contiguous()
    fb = t['f'][:, :1].expand(T - 1, B, 3).contiguous()
    ref = _fixed_point_grads(t, Fb, fb)
    F = Fb if layout == 'batched_F_shared_f' else Fb[:, 0]
    f = fb if layout == 'shared_F_batched_f' else fb[:, 0]
    got = _fixed_point_grads(t, F, f)
    if F.dim() == 3:
        ref[3] = ref[3].sum(1)
    if f.dim() == 2:
        ref[4] = ref[4].sum(1)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the slice as a whole: the long-horizon imitation configuration, cut
# ---------------------------------------------------------------------------

T_E2E, B_E2E = 24, 8


def _long_config(T=T_E2E, B=B_E2E):
    """benchmarks/configs.py:341-351 at T, B: the shared F and C, x0 and
    the expert's controls from one RandomState(5), float64."""
    rng = np.random.RandomState(5)
    A = np.eye(3)
    A[0, 1] = 0.01
    F = np.tile(np.concatenate([A, 0.01 * np.ones((3, 1))], 1),
                (T - 1, 1, 1))
    C = np.tile(np.diag([1., 1., 0.1, 0.01]), (T, 1, 1))
    x0 = rng.randn(B, 3)
    u_exp = 0.1 * rng.randn(T, B, 1)
    return F, C, x0, u_exp


def _cfg_kw(T=T_E2E):
    return dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=True, linesearch_decay=0.2, max_linesearch_iter=3)


def _assert_close(name, ref, got, tol=TOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, name
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max(), (name, ref,
                                                                got)


def test_long_imitation_loss_and_gradient_match_jax_f64():
    F, C, x0, u_exp = _long_config()
    c0 = 0.05 * np.random.RandomState(6).randn(T_E2E, 4)

    def j_loss(cv, Fv):
        cfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.ANALYTIC,
                                **_cfg_kw())
        sol = j_batched_solve(cfg, jnp.asarray(x0),
                              mpc_tpu.QuadCost(jnp.asarray(C), cv),
                              mpc_tpu.LinDx(Fv, None), u_lower=-2.,
                              u_upper=2.)
        return jnp.mean((sol.u - jnp.asarray(u_exp)) ** 2)

    loss_j, (gc, gF) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(c0), jnp.asarray(F))
    theta = {'c': torch.tensor(c0, requires_grad=True),
             'F': torch.tensor(F, requires_grad=True)}
    loss = mt.imitation_loss(
        theta, mt.MPCConfig(grad_method=mt.GradMethods.ANALYTIC,
                            **_cfg_kw()),
        torch.tensor(x0), torch.tensor(u_exp),
        lambda th: mt.QuadCost(torch.tensor(C), th['c']),
        lambda th: mt.LinDx(th['F'], None), u_lower=-2., u_upper=2.,
        device='cpu')
    loss.backward()
    _assert_close('loss', loss_j, loss.detach().numpy())
    _assert_close('dc', gc, theta['c'].grad.numpy())
    _assert_close('dF', gF, theta['F'].grad.numpy())


def test_long_imitation_sgd_step_matches_jax_f64():
    """One step of the long configuration's train step, with SGD in place
    of Adam so that the update is the gradient itself."""
    F, C, x0, u_exp = _long_config()
    lr = 0.5
    cfg_j = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.ANALYTIC,
                              **_cfg_kw())
    opt_j = optax.sgd(lr)
    step_j = j_train_step(
        cfg_j, opt_j, lambda th: mpc_tpu.QuadCost(jnp.asarray(C), th['c']),
        lambda th: mpc_tpu.LinDx(jnp.asarray(F), None), u_lower=-2.,
        u_upper=2.)
    th_j = {'c': jnp.zeros((T_E2E, 4))}
    state, loss_j = step_j(TrainState(th_j, opt_j.init(th_j),
                                      jnp.asarray(0)),
                           jnp.asarray(x0), jnp.asarray(u_exp))

    theta = {'c': torch.nn.Parameter(torch.zeros(T_E2E, 4,
                                                 dtype=torch.float64))}
    dyn = mt.LinDx(torch.tensor(F), None)
    step = mt.make_imitation_train_step(
        mt.MPCConfig(grad_method=mt.GradMethods.ANALYTIC, **_cfg_kw()),
        torch.optim.SGD(theta.values(), lr=lr),
        lambda th: mt.QuadCost(torch.tensor(C), th['c']), lambda th: dyn,
        u_lower=-2., u_upper=2., device='cpu')
    loss = step(theta, torch.tensor(x0), torch.tensor(u_exp))
    _assert_close('loss', loss_j, loss.numpy())
    update = np.asarray(state.theta['c'])
    assert np.abs(update).max() > 0
    _assert_close('c', update, theta['c'].detach().numpy())


def test_mpc_gradients_reach_shared_F_and_f():
    """Through ``MPC``: a loss of x and u differentiated with respect to a
    batch-shared F and f (and x_init), against ``jax.grad`` through
    mpc_tpu.learning.batched_solve."""
    T, B = 12, 6
    F, C, x0, _ = _long_config(T, B)
    rng = np.random.RandomState(7)
    F = F + 0.05 * rng.randn(T - 1, 3, 4)
    f = 0.05 * rng.randn(T - 1, 3)
    c = 0.3 * rng.randn(T, 4)
    wx, wu = rng.randn(T, B, 3), rng.randn(T, B, 1)

    def j_loss(Fv, fv, xv):
        cfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.ANALYTIC,
                                **_cfg_kw(T))
        sol = j_batched_solve(cfg, xv, mpc_tpu.QuadCost(jnp.asarray(C),
                                                        jnp.asarray(c)),
                              mpc_tpu.LinDx(Fv, fv), u_lower=-0.6,
                              u_upper=0.6)
        return jnp.sum(wx * sol.x) + jnp.sum(wu * sol.u)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(F), jnp.asarray(f), jnp.asarray(x0))
    Fv, fv, xv = (torch.tensor(a, requires_grad=True) for a in (F, f, x0))
    ctrl = mt.MPC(3, 1, T, u_lower=-0.6, u_upper=0.6, lqr_iter=4, eps=0.0,
                  grad_method=mt.GradMethods.ANALYTIC,
                  exit_unconverged=False, detach_unconverged=False,
                  linesearch_decay=0.2, max_linesearch_iter=3, device='cpu')
    x, u, _ = ctrl(xv, mt.QuadCost(torch.tensor(C), torch.tensor(c)),
                   mt.LinDx(Fv, fv))
    ((torch.tensor(wx) * x).sum() + (torch.tensor(wu) * u).sum()).backward()
    assert (u.detach().abs() == 0.6).double().mean() > 0.05
    for name, a, b in zip(('dF', 'df', 'dx_init'), ref,
                          (Fv.grad, fv.grad, xv.grad)):
        _assert_close(name, a, b.numpy())


# ---------------------------------------------------------------------------
# routing, bound counts, no fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('T,dyn_shared,long_route', [
    (10, False, False), (fused_bwd.T_MAX_BWD, False, False),
    (fused_bwd.T_MAX_BWD + 1, False, True), (10, True, True),
    (160, True, True), (2000, False, True)])
def test_bwd_routes_long(T, dyn_shared, long_route):
    """One predicate says which backward kernel runs; no horizon is out of
    scope (n_ctrl > 1 takes the dense configuration at every T), and a
    size past the dense gate says it takes the eager fixed point, as
    mpc_tpu's jnp path; float64 on the card and a slew penalty stay on the
    eager fixed point."""
    assert fused_bwd.bwd_routes_long(T, dyn_shared) is long_route
    assert fused_bwd.supports_bwd(T)
    assert fused_bwd.scope_gap_bwd(T, dtype=torch.float32,
                                   device=torch.device('cuda')) is None
    assert fused_bwd.scope_gap_bwd(T, n_ctrl=2) is None
    assert fused_bwd.bwd_routes_dense(3, 2)
    gap = fused_bwd.scope_gap_bwd(T, n_ctrl=2, n_state=31)
    assert 'n_state + n_ctrl = 33' in gap and 'jnp path' in gap
    assert 'slew' in fused_bwd.scope_gap_bwd(T, slew=True)
    assert 'float64' in fused_bwd.scope_gap_bwd(
        T, dtype=torch.float64, device=torch.device('cuda'))


def test_k4_bound_counts():
    """k4_flops/k4_bytes at the long configuration: shared operands and
    reduced gradients count once, an absent f has no df, and the kernel
    is bound by bytes."""
    T, B = 160, 4096
    z = torch.zeros
    C, c, F = z(T, 1, 4, 4), z(T, 1, 4), z(T - 1, 1, 3, 4)
    xs, I = z(T, B, 3), z(T, B, 1)
    nbytes = fused_bwd.k4_bytes(C, c, F, xs, I, has_f=False)
    assert nbytes == 4 * (T * 20 + (T - 1) * 12 + T * B * 9 + B * 3
                          + T * 20 + (T - 1) * 12)
    assert fused_bwd.k4_bytes(C, c, F, xs, I, has_f=True) - nbytes \
        == 4 * 3 * (T - 1)
    batched = fused_bwd.k4_bytes(C, c, F.expand(T - 1, B, 3, 4), xs, I,
                                 has_f=True)
    assert batched - nbytes == 4 * (B - 1) * (T - 1) * (12 + 12 + 3) \
        + 4 * 3 * (T - 1)
    flops = fused_bwd.k4_flops(T, B, True, True, has_f=False)
    assert flops == fused_bwd.k2_flops(T, B, True, dyn_shared=True,
                                       has_f=False)
    assert flops > fused_bwd.k4_flops(T, B, True, False, has_f=False)
    assert 300 < flops / (T * B) < 600
    assert nbytes / 3.35e12 > flops / 67e12


def test_k4_wrapper_never_falls_back_off_the_cpu():
    T, B = 3, 4
    dev = torch.device('meta')
    z = lambda *s: torch.zeros(*s, device=dev)
    with pytest.raises(NotImplementedError):
        fused_bwd.fused_kkt_backward_long(
            z(T, 1, 4, 4), z(T, 1, 4), z(T - 1, 1, 3, 4), z(T, B, 3),
            z(T, B, 1), z(T, B, 3), z(T, B, 1), None, has_f=False)
