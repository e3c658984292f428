"""K2 and K4's dense configuration (the port's KKT backward at any
admitted n_state and n_ctrl) and the medium imitation slice against the
JAX package, on the CPU, through the plain version that the CPU path
runs.

Backward comparisons are same-primal (both sides get the same x*, u* and
cotangents), as in tests/test_torch_bwd.py and test_torch_bwd_long.py:

- float64: ``fused_kkt_backward_dense`` (the plain version on the CPU)
  against ``jax.vjp`` of the vmapped ``make_lqr_fixed_point``
  (mpc_tpu/ops/diff.py, the plain reference of the Pallas kernels) at
  4 states and 2 controls with a box, 5 and 1 with a box and f, 3 and 4
  unbounded with f (TVLQR's size) and 6 and 2 with a box and f, T from 2
  to 9, in each of the four mixes of shared and batched cost and
  dynamics.  Tolerance 1e-10 relative to each gradient's largest entry:
  the same recursion in another order (the jnp path's masked solve adds
  1e-11 to the control block, its unbounded solve is the
  pseudo-inverse); measured up to ~7e-12.  An absent f has no gradient
  (None).
- float32: against the Pallas kernel ``make_batched_fixed_point(...,
  interpret=True)`` on tests/test_fused_bwd.py::
  test_bwd_long_batched_medium_equivalence's problem (6 states, 2
  controls, T=20, B=24, the same draws, so the persistent compile cache
  is shared), with its tolerance, 5e-4 relative to scale.
- the slice as a whole, float64: the medium imitation step (the medium
  rows' system, benchmarks/configs.py:141-151, box +-1, lqr_iter=10, a
  learned batch-shared diagonal cost, Adam) cut to 6 states, 2 controls,
  T=5, B=8: the loss, d loss / d theta and one Adam step's theta against
  mpc_tpu's ``make_imitation_train_step`` (jnp path), 1e-7 relative to
  the largest entry, as tests/test_torch_train.py holds its slice; the
  port's step runs the dense forward's and the dense backward's plain
  versions once each and no eager solve or eager fixed point.
- the fixed point's dispatch: each leaf of a LinDx and of the cost gets
  its gradient in its own layout (a shared leaf the per-example gradients
  summed), 1e-12 against the all-batched run summed; the reversed batch;
  the routing predicate and the gate's corners; ``k4d_launch``,
  ``k4d_flops`` and ``k4d_bytes``; the op (``torch.library.opcheck``);
  and the wrapper's refusal to fall back off the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mpc_tpu
from mpc_tpu.learning import (TrainState,
                              make_imitation_train_step as j_train_step)
from mpc_tpu.ops.diff import make_lqr_fixed_point
from mpc_tpu.ops.fused_bwd import (make_batched_fixed_point as
                                   j_make_batched_fixed_point)

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import (custom, fused, fused_bwd, fused_bwd_dense as
                               fbd, fused_dense)

NAMES = ('dx_init', 'dC', 'dc', 'dF', 'df')
TOL_F64 = 1e-10
TOL_SLICE = 1e-7


def _problem(ns, nc, T, B, cost_shared, dyn_shared, has_bounds, seed,
             f_shared=None):
    """A random converged-LQR backward problem in the layout of
    tests/test_fused_bwd.py's cases: C = R R^T + I, F = (0.8 I | 0) +
    0.35 N, ~30% of the controls exactly on a bound of +-1, random
    cotangents; shared leaves without the batch axis."""
    f_shared = dyn_shared if f_shared is None else f_shared
    nt = ns + nc
    rng = np.random.RandomState(seed)
    csh = (T,) if cost_shared else (T, B)
    Cr = rng.randn(*csh, nt, nt)
    C = np.einsum('...ij,...kj->...ik', Cr, Cr) + np.eye(nt)
    c = rng.randn(*csh, nt)
    F = 0.35 * rng.randn(*((T - 1,) if dyn_shared else (T - 1, B)), ns, nt)
    F[..., :ns] += 0.8 * np.eye(ns)
    f = 0.1 * rng.randn(*((T - 1,) if f_shared else (T - 1, B)), ns)
    xs, us = rng.randn(T, B, ns), rng.randn(T, B, nc)
    if has_bounds:
        pinned = rng.rand(T, B, nc) < 0.3
        us = np.where(pinned, np.sign(us), us)
    return dict(C=C, c=c, F=F, f=f, xs=xs, us=us,
                lb=np.full((T, B, nc), -1.0), ub=np.full((T, B, nc), 1.0),
                gx=rng.randn(T, B, ns), gu=rng.randn(T, B, nc))


def _port(p, has_bounds, has_f, dtype=torch.float64):
    """The plain dense backward through the wrapper, on its operands."""
    t = {k: torch.tensor(v, dtype=dtype) for k, v in p.items()}
    C = t['C'] if t['C'].dim() == 4 else t['C'].unsqueeze(1)
    c = t['c'] if t['c'].dim() == 3 else t['c'].unsqueeze(1)
    F = t['F'] if t['F'].dim() == 4 else t['F'].unsqueeze(1)
    I = (fused_bwd.active_set(t['us'], t['lb'], t['ub']) if has_bounds
         else None)
    assert I is None or I.shape == t['us'].shape
    return fbd.fused_kkt_backward_dense(
        C, c, F, t['xs'], t['us'], t['gx'], t['gu'], I, has_f=has_f,
        f_shared=t['f'].dim() == 2)


def _jax_vjp(p, has_bounds, has_f):
    B, ns = p['xs'].shape[1:]
    axis = {k: None if p[k].ndim == {'C': 3, 'c': 2, 'F': 3, 'f': 2}[k]
            else 1 for k in 'CcFf'}
    fp = make_lqr_fixed_point(ns, has_bounds, has_f)
    args = [jnp.asarray(a) for a in (
        np.zeros((B, ns)), p['C'], p['c'], p['F'], p['f'], p['lb'],
        p['ub'], p['xs'], p['us'])]
    _, vjp = jax.vjp(jax.vmap(fp, in_axes=(0, axis['C'], axis['c'],
                                           axis['F'], axis['f'], 1, 1, 1,
                                           1), out_axes=(1, 1)), *args)
    return [np.asarray(a) for a in
            vjp((jnp.asarray(p['gx']), jnp.asarray(p['gu'])))[:5]]


def _assert_rel(ref, got, tol, has_f=True):
    for name, a, b in zip(NAMES, ref, got):
        if name == 'df' and not has_f:
            assert b is None          # an absent f has no gradient
            continue
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / scale < tol, \
            (name, np.abs(a - b).max(), scale)


# (ns, nc, T, bounds, f): 4s2c box, 5s1c box with f, TVLQR's size
# unbounded with f, 6s2c box with f; past 8 controls (the factor on the
# warp's tiles in the kernel) 4s12c with the active set and without it
SIZES = {'4s2c': (4, 2, 5, True, False), '5s1c': (5, 1, 9, True, True),
         '3s4c': (3, 4, 2, False, True), '6s2c': (6, 2, 7, True, True),
         '4s12c': (4, 12, 3, True, False),
         '4s12c_free': (4, 12, 3, False, True)}


@pytest.mark.parametrize('dyn_shared', [True, False],
                         ids=['dyn_shared', 'dyn_batched'])
@pytest.mark.parametrize('cost_shared', [True, False],
                         ids=['cost_shared', 'cost_batched'])
@pytest.mark.parametrize('size', list(SIZES))
def test_plain_dense_backward_matches_jax_vjp_f64(size, cost_shared,
                                                  dyn_shared):
    ns, nc, T, has_bounds, has_f = SIZES[size]
    p = _problem(ns, nc, T, 5, cost_shared, dyn_shared, has_bounds,
                 seed=ns + 7 * nc)
    _assert_rel(_jax_vjp(p, has_bounds, has_f),
                _port(p, has_bounds, has_f), TOL_F64, has_f)


def test_plain_dense_backward_matches_pallas_f32():
    """tests/test_fused_bwd.py::_vjp_case(6, 2, 20, 24, has_bounds=True,
    has_f=True, seed=11)'s arrays, float32, every leaf batched, against
    the Pallas kernel in interpret mode."""
    ns, nc, T, B = 6, 2, 20, 24
    nt = ns + nc
    rng = np.random.RandomState(11)
    f32 = np.float32
    Cr = rng.randn(T, B, nt, nt).astype(f32)
    C = np.einsum('tbij,tbkj->tbik', Cr, Cr) + np.eye(nt, dtype=f32)
    c = rng.randn(T, B, nt).astype(f32)
    F = 0.4 * rng.randn(T - 1, B, ns, nt).astype(f32)
    F[:, :, :, :ns] += np.eye(ns, dtype=f32)
    f = 0.1 * rng.randn(T - 1, B, ns).astype(f32)
    xs = rng.randn(T, B, ns).astype(f32)
    us = rng.randn(T, B, nc).astype(f32)
    m = rng.rand(T, B, nc) < 0.3
    us = np.where(m, np.sign(us), us).astype(f32)
    lb = np.full((T, B, nc), -1.0, f32)
    ub = np.full((T, B, nc), 1.0, f32)
    gx = rng.randn(T, B, ns).astype(f32)
    gu = rng.randn(T, B, nc).astype(f32)
    args = [jnp.asarray(a) for a in (np.zeros((B, ns), f32), C, c, F, f, lb,
                                     ub, xs, us)]
    fp_k = j_make_batched_fixed_point(ns, True, True, interpret=True)
    _, vjp_k = jax.vjp(fp_k, *args)
    ref = [np.asarray(a) for a in vjp_k((jnp.asarray(gx),
                                         jnp.asarray(gu)))[:5]]
    p = dict(C=C, c=c, F=F, f=f, xs=xs, us=us, lb=lb, ub=ub, gx=gx, gu=gu)
    got = _port(p, True, True, torch.float32)
    assert got[1].dtype == torch.float32
    _assert_rel(ref, got, 5e-4)


def test_plain_dense_backward_reversed_batch():
    """B=70 (two chunks of the card's gradient pass, the second partial):
    the per-example outputs of the reversed batch are bitwise equal; the
    batch-reduced gradients sum in another order, 1e-5 relative
    (float32)."""
    p = _problem(5, 3, 6, 70, True, True, True, seed=6)
    got = _port(p, True, True, torch.float32)
    rev = dict(p)
    for k in ('xs', 'us', 'lb', 'ub', 'gx', 'gu'):
        rev[k] = np.ascontiguousarray(p[k][:, ::-1])
    back = _port(rev, True, True, torch.float32)
    np.testing.assert_array_equal(back[0].numpy()[::-1], got[0].numpy())
    for a, b in zip(back[1:], got[1:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    # every leaf batched: every output is per example
    pb = _problem(5, 3, 6, 70, False, False, True, seed=6)
    got = _port(pb, True, True, torch.float32)
    back = _port({k: np.ascontiguousarray(v[:, ::-1]) for k, v in
                  pb.items()}, True, True, torch.float32)
    np.testing.assert_array_equal(back[0].numpy()[::-1], got[0].numpy())
    for a, b in zip(back[1:], got[1:]):
        np.testing.assert_array_equal(a.flip(1).numpy(), b.numpy())


def _fixed_point_grads(t, C, c, F, f, nc):
    """Gradients of <gx, x> + <gu, u> through the port's fixed point with
    respect to (x_init, C, c, F, f), on the float64 problem ``t``."""
    B, ns = t['xs'].shape[1:]
    leaves = [torch.zeros(B, ns, dtype=torch.float64), C, c, F, f]
    leaves = [a.clone().requires_grad_() for a in leaves]
    fp = fused_bwd.make_batched_fixed_point(ns, True, True, nc)
    x, u = fp.apply(*leaves, t['lb'], t['ub'], t['xs'], t['us'])
    ((t['gx'] * x).sum() + (t['gu'] * u).sum()).backward()
    return [a.grad for a in leaves]


@pytest.mark.parametrize('layout', ['shared_F_batched_f',
                                    'batched_F_shared_f', 'all_shared',
                                    'shared_C_batched_c'])
def test_fixed_point_gradient_layouts(layout):
    """Each leaf gets its gradient in its own layout: a shared leaf the
    per-example gradients summed over the batch, reduced by the dense
    backward itself (a leaf at a time, whatever its pair's layout)."""
    T, B, ns, nc = 5, 4, 4, 2
    p = _problem(ns, nc, T, B, False, False, True, seed=5, f_shared=False)
    t = {k: torch.tensor(v) for k, v in p.items()}
    # the same values in every example, so shared and batched leaves agree
    full = {k: t[k][:, :1].expand_as(t[k]).contiguous() for k in 'CcFf'}
    ref = _fixed_point_grads(t, *(full[k] for k in 'CcFf'), nc)
    shared = {'shared_F_batched_f': 'F', 'batched_F_shared_f': 'f',
              'all_shared': 'CcFf', 'shared_C_batched_c': 'C'}[layout]
    got = _fixed_point_grads(t, *(full[k][:, 0] if k in shared else full[k]
                                  for k in 'CcFf'), nc)
    for i, k in enumerate('CcFf', 1):
        if k in shared:
            ref[i] = ref[i].sum(1)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the slice as a whole: the medium imitation step, cut
# ---------------------------------------------------------------------------

NS_E2E, NC_E2E, T_E2E, B_E2E = 6, 2, 5, 8


def _medium(ns=NS_E2E, nc=NC_E2E, T=T_E2E, B=B_E2E, seed=3):
    """The medium rows' system (benchmarks/configs.py:141-151) at these
    sizes: a batch-shared F of a stable A, float64."""
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.01 * rng.randn(ns, ns)
    A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    Bm = 0.1 * rng.randn(ns, nc)
    F = np.tile(np.concatenate([A, Bm], 1)[None], (T - 1, 1, 1))
    return F, rng.randn(B, ns)


def _cfg_kw():
    return dict(n_state=NS_E2E, n_ctrl=NC_E2E, T=T_E2E, lqr_iter=10,
                eps=0.0, exit_unconverged=False, detach_unconverged=False,
                backprop=True)


def _theta0():
    """The learner's start: the true diagonal (1 on the states, 0.1 on the
    controls) perturbed in log, and a small linear term."""
    nt = NS_E2E + NC_E2E
    rng = np.random.RandomState(12)
    q = np.r_[np.ones(NS_E2E), 0.1 * np.ones(NC_E2E)]
    return np.log(q) + 0.5 * rng.randn(nt), 0.3 * rng.randn(nt)


def _expert(F, x0):
    """The expert's controls: the port's float64 solve of the true cost
    (C = diag(1.., 0.1..), c = 0)."""
    nt = NS_E2E + NC_E2E
    C = np.diag(np.r_[np.ones(NS_E2E), 0.1 * np.ones(NC_E2E)])
    cfg = mt.MPCConfig(**dict(_cfg_kw(), backprop=False))
    sol = mt.batched_solve(cfg, torch.tensor(x0),
                           mt.QuadCost(torch.tensor(C), torch.zeros(
                               nt, dtype=torch.float64)),
                           mt.LinDx(torch.tensor(F)), u_lower=-1.0,
                           u_upper=1.0, device='cpu')
    return sol.u.numpy()


def _assert_close(name, ref, got, tol=TOL_SLICE):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, name
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max(), (name, ref,
                                                                got)


def test_medium_imitation_step_matches_jax_f64(monkeypatch):
    """One Adam(1e-2) step of the medium imitation configuration, cut: the
    loss, d loss / d (q_log, p) and the updated theta against mpc_tpu's
    jitted train step; the port's step runs the dense forward and the
    dense backward (their plain versions, once each) and nothing eager."""
    F, x0 = _medium()
    u_exp = _expert(F, x0)
    q0, p0 = _theta0()
    lr = 1e-2

    def j_cost(th):
        return mpc_tpu.QuadCost(jnp.diag(jnp.exp(th['q_log'])), th['p'])

    cfg_j = mpc_tpu.MPCConfig(**_cfg_kw())
    opt_j = optax.adam(lr)
    th_j = {'q_log': jnp.asarray(q0), 'p': jnp.asarray(p0)}
    loss_j, g_j = jax.value_and_grad(mpc_tpu.learning.imitation_loss)(
        th_j, cfg_j, jnp.asarray(x0), jnp.asarray(u_exp), j_cost,
        lambda th: mpc_tpu.LinDx(jnp.asarray(F), None), u_lower=-1.0,
        u_upper=1.0)
    step_j = j_train_step(cfg_j, opt_j, j_cost,
                          lambda th: mpc_tpu.LinDx(jnp.asarray(F), None),
                          u_lower=-1.0, u_upper=1.0)
    state, loss_js = step_j(TrainState(th_j, opt_j.init(th_j),
                                       jnp.asarray(0)),
                            jnp.asarray(x0), jnp.asarray(u_exp))

    calls = {'forward': 0, 'backward': 0}
    fwd, bwd = (fused_dense.fused_solve_dense_plain,
                fbd.fused_kkt_backward_dense_plain)

    def count(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(fused_dense, 'fused_solve_dense_plain',
                        count('forward', fwd))
    monkeypatch.setattr(fbd, 'fused_kkt_backward_dense_plain',
                        count('backward', bwd))
    theta = {'q_log': torch.nn.Parameter(torch.tensor(q0)),
             'p': torch.nn.Parameter(torch.tensor(p0))}
    dyn = mt.LinDx(torch.tensor(F), None)
    opt = torch.optim.Adam(theta.values(), lr=lr)
    step = mt.make_imitation_train_step(
        mt.MPCConfig(**_cfg_kw()), opt,
        lambda th: mt.QuadCost(torch.diag(torch.exp(th['q_log'])), th['p']),
        lambda th: dyn, u_lower=-1.0, u_upper=1.0, device='cpu')
    solver.reset_eager_counts()
    # the gradients of the step, read before Adam moves theta
    grads = {}
    orig_step = opt.step

    def read_then_step(*a, **kw):
        grads.update({k: v.grad.detach().clone() for k, v in theta.items()})
        return orig_step(*a, **kw)
    monkeypatch.setattr(opt, 'step', read_then_step)
    loss = step(theta, torch.tensor(x0), torch.tensor(u_exp))
    assert calls == {'forward': 1, 'backward': 1}
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    _assert_close('loss', loss_j, loss.numpy())
    _assert_close('loss (train step)', loss_js, loss.numpy())
    for k in ('q_log', 'p'):
        assert np.abs(np.asarray(g_j[k])).max() > 0
        _assert_close(f'd loss / d {k}', g_j[k], grads[k].numpy())
        _assert_close(k, state.theta[k], theta[k].detach().numpy())


# ---------------------------------------------------------------------------
# routing, gate, geometry, bound counts, the op, no fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ns,nc,dense', [
    (3, 1, False), (3, 2, True), (2, 1, True), (20, 4, True), (24, 4, True),
    (31, 1, True), (24, 8, True), (28, 4, True)])
def test_bwd_routes_dense(ns, nc, dense):
    """One predicate says whether the dense backward runs; 3 states and
    1 control stay on K2 and K4, every other admitted size is in scope at
    any T, on the card in float32."""
    assert fused_bwd.bwd_routes_dense(ns, nc) is dense
    cuda = torch.device('cuda')
    for T in (2, 20, fused_bwd.T_MAX_BWD + 1):
        assert fused_bwd.scope_gap_bwd(T, nc, torch.float32, cuda, ns) \
            is None
        assert fused_bwd.supports_bwd(T, nc, n_state=ns)
    fp = fused_bwd.make_batched_fixed_point(ns, True, False, nc)
    assert issubclass(fp, torch.autograd.Function)


@pytest.mark.parametrize('ns,nc,what', [
    (29, 4, 'n_state + n_ctrl = 33'), (31, 2, 'n_state + n_ctrl = 33'),
    (24, 9, 'n_state + n_ctrl = 33')])
def test_dense_gate_corners_refuse(ns, nc, what):
    """Past the gate (32 taus: a warp an example, at any n_ctrl) the
    backward takes the eager fixed point, as mpc_tpu takes its jnp path;
    float64 on the card and a slew penalty stay eager at every size, as in
    mpc_tpu."""
    gap = fused_bwd.scope_gap_bwd(20, nc, n_state=ns)
    assert what in gap and 'jnp path' in gap and 'ROADMAP' not in gap
    with pytest.raises(NotImplementedError, match='eager fixed point'):
        fused_bwd.make_batched_fixed_point(ns, True, False, nc)
    assert 'float64' in fused_bwd.scope_gap_bwd(
        20, 4, torch.float64, torch.device('cuda'), 20)
    assert 'slew' in fused_bwd.scope_gap_bwd(20, 4, n_state=20, slew=True)
    assert fused_bwd.scope_gap_bwd(20, 4, torch.float64, n_state=20) is None


def test_k4d_launch_geometry():
    """A warp an example, 4 examples a block of the chains; the gradient
    pass's chunks of 64 examples; the workspace holds the gains, dtau,
    lam and dlam of every step and example."""
    geo = fbd.k4d_launch(20, 1024, 20, 4)
    assert (geo['team'], geo['warps'], geo['examples']) == (32, 4, 4)
    assert geo['blocks'] == 256 and geo['chunks'] == 16
    assert geo['workspace_bytes'] == 4 * 20 * 1024 * (4 * 21 + 24 + 40)
    assert geo['grad_smem_bytes'] == 4 * 64 * (48 + 40) <= 48 * 1024
    assert fbd.k4d_launch(20, 1030, 20, 4)['chunks'] == 17
    # the gate's corners fit a block of 4 warps in the card's 227 KB
    for ns, nc in ((28, 4), (24, 8), (31, 1), (1, 8)):
        g = fbd.k4d_launch(7, 100, ns, nc)
        assert g['smem_bytes'] <= fused.SMEM_LIMIT // 3
        assert g['grad_smem_bytes'] <= 48 * 1024
    assert fbd.bwd_dense_kernel_defines(20, 4, True, False) == {
        'MPC_NS': 20, 'MPC_NC': 4, 'MPC_HAS_I': 1, 'MPC_HAS_F': 0,
        'MPC_WARPS': 4, 'MPC_CHUNK': 64, 'MPC_GRAD_THREADS': 256,
        'MPC_PREFETCH': 1}


def test_k4d_bound_counts():
    """k4d_flops at the medium imitation row (~0.9 M operations an
    example, bound by operations), 3 states and 1 control beside K4's
    count, and k4d_bytes: shared operands and reduced gradients once."""
    T, B, ns, nc = 20, 1024, 20, 4
    nt = ns + nc
    flops = fbd.k4d_flops(T, B, ns, nc, has_f=False,
                          reduced=('C', 'c', 'F'))
    assert 0.7e6 < flops / B < 1.0e6
    assert fbd.k4d_flops(T, B, ns, nc, has_f=False) < flops
    small = fbd.k4d_flops(10, 1, 3, 1, has_f=True)
    assert 0.7 < small / fused_bwd.k2_flops(10, 1, False) < 1.3
    z = torch.zeros
    C, c, F = z(T, 1, nt, nt), z(T, 1, nt), z(T - 1, 1, ns, nt)
    xs, us, I = z(T, B, ns), z(T, B, nc), z(T, B, nc)
    nbytes = fbd.k4d_bytes(C, c, F, xs, us, I, has_f=False)
    assert nbytes == 4 * (2 * (T * nt * nt + T * nt + (T - 1) * ns * nt)
                          + T * B * (2 * nt + nc) + B * ns)
    assert fbd.k4d_bytes(C, c, F, xs, us, I, has_f=True) - nbytes \
        == 4 * (T - 1) * ns
    assert nbytes / 3.35e12 < flops / 67e12


def test_k4d_op_opcheck():
    """The op's CPU and fake versions agree on shapes, and its schema
    holds (torch.library.opcheck), with and without f, shared and batched
    leaves, at 2 controls and at 9."""
    for nc, cost_shared, dyn_shared, has_f in ((2, True, True, False),
                                               (2, False, False, True),
                                               (2, True, False, True),
                                               (9, False, True, True)):
        p = _problem(4, nc, 4, 3, cost_shared, dyn_shared, True, seed=1)
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
        C = t['C'] if t['C'].dim() == 4 else t['C'].unsqueeze(1)
        c = t['c'] if t['c'].dim() == 3 else t['c'].unsqueeze(1)
        F = t['F'] if t['F'].dim() == 4 else t['F'].unsqueeze(1)
        I = fused_bwd.active_set(t['us'], t['lb'], t['ub'])
        torch.library.opcheck(custom.k4d_backward, (
            C, c, F, t['xs'], t['us'], t['gx'], t['gu'], I, has_f,
            dyn_shared))


def test_dense_wrapper_never_falls_back_off_the_cpu():
    T, B, ns, nc = 3, 4, 4, 2
    nt = ns + nc
    dev = torch.device('meta')
    z = lambda *s: torch.zeros(*s, device=dev)
    with pytest.raises(NotImplementedError):
        fbd.fused_kkt_backward_dense(
            z(T, 1, nt, nt), z(T, 1, nt), z(T - 1, 1, ns, nt), z(T, B, ns),
            z(T, B, nc), z(T, B, ns), z(T, B, nc), None, has_f=False)
