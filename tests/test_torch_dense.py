"""K3's dense configuration: its plain PyTorch version (which the CPU path
runs) against the JAX package, its routing, gate and geometry.

- float64: ``batched_solve(device='cpu')``, which sends a LinDx of any
  admitted size other than 3 states and 1 control to
  ``fused_dense.fused_solve_dense_plain``, against mpc_tpu's jnp solver
  (``use_fused='never'``) on the same numpy inputs: 4 states and 2
  controls with a box and a shared F; config 1's layout (3 states, 4
  controls, unbounded, every leaf batched); 5 states and 1 control with
  a box and a batched C; a mixed layout.  Tolerance 1e-8 relative on x
  and u, n_iter and n_qp_iter equal.  Measured: 5.3e-11 with the box (the
  jnp path's solves add 1e-11 to the control block), 1.6e-16 unbounded
  (the kernel's 1e-11 jitter moves one Newton step by ~1e-12, which the
  next iteration takes back), ~1e-13 for one control.
- float32 against the Pallas kernel in interpret mode at the smallest
  box problem with several controls (2 states, 2 controls, T=3,
  lqr_iter=2): u and x within 1e-5, n_iter and n_qp_iter equal; and on
  an unbounded problem whose control block is only semidefinite, where
  the kernel route takes the jittered Cholesky (as the Pallas kernel)
  and the eager route the pseudo-inverse (as the jnp path).
- the kernel's helpers against the JAX kernel's own (``_cholesky``,
  ``_chol_solve``, ``_masked_free_chol``, ``_pnqp_kernel``) on the same
  inputs, float64, 1e-12; the lane sum's order against a butterfly of 32
  lanes, bitwise.
- gradients: a differentiable solve of a 5-state, 1-control and of a
  4-state, 2-control LinDx runs the dense forward and the dense backward
  (``fused_bwd.bwd_routes_dense``; the eager fixed point stays for
  float64 on the card, a slew penalty and n_state + n_ctrl > 32),
  against ``jax.grad`` of the jnp path, float64, 1e-7.
- a slew penalty on LinDx problems of other sizes reaches the dense
  configuration (``fused.slew_problem``) and matches mpc_tpu's slew
  solve in float64 (1e-8).
- routing: ``routes_dense``, the gate's limits and refusals, the JAX
  package's benchmark rows admitted, ``k3d_launch``'s geometry, the op
  (``torch.library.opcheck``), export, and no fallback off the CPU.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused, fused_bwd, fused_bwd_dense, fused_dense as fd
from mpc_tpu_torch.utils import export as ex
from mpc_tpu_torch.utils.convert import (lin_dx_from_numpy,
                                         quad_cost_from_numpy,
                                         solution_to_numpy)
from mpc_tpu_torch.utils.problems import wide_row

TOL = 1e-8
GRAD_TOL = 1e-7


def _problem(T, B, ns, nc, seed, *, F_batched=False, C_batched=False,
             c_batched=False, f=None, dtype=np.float64):
    """A stable LinDx with a positive definite cost: F = (I + 0.1 N |
    0.5 N), shared [T-1, ns, ntau] or batched; C = R R^T + I batched, or
    the medium-state rows' diag(1, .., 0.1, ..) shared; c shared or
    batched; f None, 'shared' or 'batched'."""
    rng = np.random.RandomState(seed)
    nt = ns + nc
    shape = (T - 1, B) if F_batched else (T - 1,)
    F = np.concatenate([np.eye(ns) + 0.1 * rng.randn(*shape, ns, ns),
                        0.5 * rng.randn(*shape, ns, nc)], -1)
    if C_batched:
        R = rng.randn(T, B, nt, nt)
        C = np.einsum('tbij,tbkj->tbik', R, R) + np.eye(nt)
    else:
        C = np.tile(np.diag(np.r_[np.ones(ns), 0.1 * np.ones(nc)]),
                    (T, 1, 1))
    c = rng.randn(*((T, B, nt) if c_batched else (T, nt)))
    ff = None
    if f is not None:
        ff = 0.1 * rng.randn(*((T - 1, B, ns) if f == 'batched'
                               else (T - 1, ns)))
    x0 = rng.randn(B, ns)
    return [None if a is None else a.astype(dtype)
            for a in (F, ff, C, c, x0)]


def _cfg(T, ns, nc, **kw):
    base = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=6, eps=1e-6,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False)
    base.update(kw)
    return base


def _jax_solve(cfg, F, f, C, c, x0, **bk):
    return j_batched_solve(
        mpc_tpu.MPCConfig(**dict(cfg, use_fused='never')), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None if f is None else jnp.asarray(f)),
        **{k: jnp.asarray(v) for k, v in bk.items()})


def _port_solve(cfg, F, f, C, c, x0, **bk):
    return mt.batched_solve(
        mt.MPCConfig(**cfg), torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
        lin_dx_from_numpy(F, f, 'cpu'), device='cpu',
        **{k: torch.tensor(v) for k, v in bk.items()})


def _rel(got, ref, tol, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()
    assert err <= tol, f'{what}: {err:.3e}'


BOX = dict(u_lower=-0.5, u_upper=0.5)
CASES = {
    # ns, nc, T, B, problem keywords, bounds
    'box_4s2c_shared_F': (4, 2, 6, 8, dict(), BOX),
    'tvlqr_layout_3s4c': (3, 4, 5, 8, dict(F_batched=True, C_batched=True,
                                           c_batched=True, f='batched'), {}),
    'box_5s1c_batched_C': (5, 1, 6, 8, dict(C_batched=True), BOX),
    # shared C beside batched c, batched F beside shared f, per-example
    # bounds [T, B, nc] and a shared u_init
    'mixed_6s3c': (6, 3, 5, 7, dict(F_batched=True, c_batched=True,
                                    f='shared'), 'mixed'),
    # past 8 controls: the control solve on the warp's tiles
    # (csrc/box_qp_smem.cuh), the plain version unchanged
    'box_3s9c': (3, 9, 5, 6, dict(), BOX),
    'box_4s12c_batched_C': (4, 12, 4, 4, dict(C_batched=True), BOX),
    'free_2s16c': (2, 16, 4, 4, dict(), {}),
    # a batched u_zero_I [T, B, nc] and the trust region delta_u
    'uz_delta_3s9c': (3, 9, 4, 5, dict(), 'uz_delta'),
}
# MPCConfig fields of a case beyond ``_cfg``'s.  box_4s12c_batched_C stops
# after two iterations: from the third on its box QP's trip counts part
# from the jnp path's at a round-off tie (a free set decided on a gradient
# zero at a bound; the jnp path adds 1e-11 to the masked block, the kernel
# route does not), as tests/test_torch_uzero.py cuts hw_sweep's delta_u
# row.  Measured with the lanes' solve past 8 controls (the back
# substitution k descending, a product with the diagonal's reciprocal,
# fused_dense._chol_solve_lanes): at lqr_iter=3 n_qp_iter 38 against 36
# and 34 against 37 in two examples, u 1.4e-8 apart relative; at 6 the
# iterations part too (4 against 3 in one example); 3.1e-12 at 2
# iterations.  (With the column-by-column solve before it: 37 against 34
# in one example at lqr_iter=6, u 1.4e-8.)
CASE_CFG = {'box_4s12c_batched_C': dict(lqr_iter=2)}


@pytest.mark.parametrize('label', ['wide-3s9c', 'wide-4s12c', 'wide-2s16c'])
def test_wide_rows_match_jnp_path_f64(label):
    """The card's rows past 8 controls (utils/problems.WIDE_ROWS, which
    chip_smoke.py drives at T=20, B=2048) cut to T=4, B=3: the kernel
    route's plain version against the jnp path, float64."""
    r = wide_row(label, B=3, T=4)
    ns, nc, T = r['n_state'], r['n_ctrl'], r['T']
    cfg = _cfg(T, ns, nc, **r['cfg'])
    bk = {} if r['u_lower'] is None else dict(u_lower=r['u_lower'],
                                              u_upper=r['u_upper'])
    ref = _jax_solve(cfg, r['F'], None, r['C'], r['c'], r['x0'], **bk)
    solver.reset_eager_counts()
    got = solution_to_numpy(_port_solve(cfg, r['F'], None, r['C'], r['c'],
                                        r['x0'], **bk))
    assert solver.eager_counts['eager_solve'] == 0
    for name in ('x', 'u', 'costs'):
        _rel(getattr(got, name), getattr(ref, name), TOL, name)
    for name in ('n_iter', 'n_qp_iter'):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize('case', list(CASES))
def test_plain_matches_jnp_path_f64(case):
    ns, nc, T, B, pkw, bk = CASES[case]
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=len(case), **pkw)
    cfg = _cfg(T, ns, nc, **CASE_CFG.get(case, {}))
    kw = dict(bk) if isinstance(bk, dict) else {}
    if bk == 'mixed':
        rng = np.random.RandomState(3)
        kw = dict(u_lower=-0.3 - rng.rand(T, B, nc),
                  u_upper=0.3 + rng.rand(T, B, nc),
                  u_init=0.1 * rng.randn(T, nc))
    elif bk == 'uz_delta':
        rng = np.random.RandomState(4)
        cfg = _cfg(T, ns, nc, delta_u=0.3)
        kw = dict(BOX, u_zero_I=(rng.rand(T, B, nc) < 0.3).astype(float))
    ref = _jax_solve(cfg, F, f, C, c, x0, **kw)
    assert fused.routes_dense(mt.LinDx(F, f), ns, nc)
    solver.reset_eager_counts()
    got = solution_to_numpy(_port_solve(cfg, F, f, C, c, x0, **kw))
    assert solver.eager_counts['eager_solve'] == 0   # the plain kernel
    for name in ('x', 'u'):
        _rel(getattr(got, name), getattr(ref, name), TOL, name)
    _rel(got.costs, ref.costs, TOL, 'costs')
    for name in ('n_iter', 'n_qp_iter', 'converged'):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)), name)
    if bk:
        # the box is active where the case has one
        lo = -0.5 if bk == BOX else None
        if lo is not None:
            assert (np.abs(got.u) >= 0.5 - 1e-12).mean() > 0.05


def test_plain_matches_pallas_kernel_f32():
    """The smallest box problem with several controls through mpc_tpu's
    Pallas kernel in interpret mode (K1 there: T * ntau^3 is small) and
    through the plain version, float32: u and x within 1e-5 (the two
    differ in the order of a few sums), the counts equal."""
    T, B, ns, nc = 3, 4, 2, 2
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=11, C_batched=True,
                              dtype=np.float32)
    kw = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=2, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              backprop=False, linesearch_decay=0.2, max_linesearch_iter=3)
    ref = jfused.fused_batched_solve(
        mpc_tpu.MPCConfig(**kw), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None), u_lower=jnp.float32(-0.4),
        u_upper=jnp.float32(0.4), interpret=True)
    got = _port_solve(kw, F, None, C, c, x0, u_lower=np.float32(-0.4),
                      u_upper=np.float32(0.4))
    assert got.u.dtype == torch.float32
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-5)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    np.testing.assert_array_equal(got.n_qp_iter.numpy(),
                                  np.asarray(ref.n_qp_iter))
    assert (got.u.abs() == 0.4).any()


def _semidef_lindx(T, B, ns, nc, seed=0):
    """tests/test_torch_eager_solve.py:_lindx(semidef=True): no weight on
    the last control at the last two steps, so Quu is only semidefinite
    there."""
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.1 * rng.randn(ns, ns)
    A /= max(1.0, np.abs(np.linalg.eigvals(A)).max())
    F = np.tile(np.concatenate([A, 0.5 * rng.randn(ns, nc)], 1)[None],
                (T - 1, 1, 1))
    C = np.tile(np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)])),
                (T, 1, 1))
    C[-2:, -1, -1] = 0.0
    c = 0.3 * rng.randn(T, ns + nc)
    return F, C, c, rng.randn(B, ns)


def test_semidefinite_unbounded_route_matches_pallas_f32():
    """The route difference of an unbounded LinDx whose control block is
    only semidefinite: the kernel route (use_fused='auto', the dense
    configuration's plain version here) takes the Cholesky with a 1e-11
    jitter, as mpc_tpu's kernel does (mpc_tpu/ops/fused.py:908-920), and
    matches the interpret-mode Pallas kernel (|u| reaches ~5e8) within
    1e-5 of the largest |u|; the eager route (use_fused='never') takes
    the pseudo-inverse, as mpc_tpu's jnp path does
    (mpc_tpu/ops/lqr.py:117-120), and stays small.  float32, T=3, 2
    states, 2 controls, B=4."""
    T, B, ns, nc = 3, 4, 2, 2
    F, C, c, x0 = (a.astype(np.float32) for a in _semidef_lindx(T, B, ns,
                                                                 nc, seed=2))
    kw = _cfg(T, ns, nc)
    ref = jfused.fused_batched_solve(
        mpc_tpu.MPCConfig(**kw), jnp.asarray(x0),
        mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), None), interpret=True)
    got = _port_solve(dict(kw, use_fused='auto'), F, None, C, c, x0)
    u_ref = np.asarray(ref.u)
    assert got.u.dtype == torch.float32 and np.abs(u_ref).max() > 1e6
    _rel(got.u.numpy(), u_ref, 1e-5, 'u (kernel route)')
    eager = _port_solve(dict(kw, use_fused='never'), F, None, C, c, x0)
    assert float(eager.u.abs().max()) < 10.0


# ---------------------------------------------------------------------------
# the helpers against the JAX kernel's own
# ---------------------------------------------------------------------------

def _spd(rng, n, B):
    R = rng.randn(B, n, n)
    return np.einsum('bij,bkj->bik', R, R) + 0.5 * np.eye(n)


def _lists(A):
    """[B, n, n] -> lists of [B] arrays (both packages' kernel form)."""
    return [[A[:, i, j] for j in range(A.shape[2])]
            for i in range(A.shape[1])]


@pytest.mark.parametrize('n', [2, 4, 8, 9, 16, 28])
def test_cholesky_and_solve_match_jax_kernel(n):
    rng = np.random.RandomState(n)
    A, b = _spd(rng, n, 6), rng.randn(6, n)
    free = rng.rand(6, n) < 0.7
    Lt = fd._cholesky(_lists(torch.tensor(A)), fd.CHOL_JITTER)
    Lj = jfused._cholesky(_lists(jnp.asarray(A)), n, jitter=1e-11)
    xt = fd._chol_solve(Lt, list(torch.tensor(b).unbind(1)))
    xj = jfused._chol_solve(Lj, [jnp.asarray(b[:, i]) for i in range(n)], n)
    Mt = fd._masked_free_chol(_lists(torch.tensor(A)),
                              list(torch.tensor(free).unbind(1)))
    Mj = jfused._masked_free_chol(_lists(jnp.asarray(A)),
                                  [jnp.asarray(free[:, i]) for i in range(n)],
                                  n)
    for i in range(n):
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj[i]),
                                   rtol=1e-12, atol=1e-12)
        for j in range(i + 1):
            np.testing.assert_allclose(Lt[i][j].numpy(), np.asarray(Lj[i][j]),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(Mt[i][j].numpy(), np.asarray(Mj[i][j]),
                                       rtol=1e-12, atol=1e-12)
    # the factor solves the system
    x = np.stack([v.numpy() for v in xt], 1)
    np.testing.assert_allclose(np.einsum('bij,bj->bi', A, x), b, atol=1e-8)


@pytest.mark.parametrize('n', [2, 3, 4, 9, 16])
@pytest.mark.parametrize('n_iter', [1, 3, 20])
def test_pnqp_matches_jax_kernel(n, n_iter):
    """The projected-Newton box QP: x, the last trip's factor and free
    set, and the trips, against ``_pnqp_kernel`` on the same inputs."""
    B = 16
    rng = np.random.RandomState(10 * n + n_iter)
    H, q = _spd(rng, n, B), 3 * rng.randn(B, n)
    lo, hi = -rng.rand(B, n), rng.rand(B, n)
    x0 = rng.randn(B, n)

    def cols(a, lib):
        return [lib.asarray(a[:, i]) if lib is jnp else torch.tensor(a[:, i])
                for i in range(n)]

    xt, Lt, ft, it = fd._pnqp(_lists(torch.tensor(H)), cols(q, torch),
                              cols(lo, torch), cols(hi, torch),
                              cols(x0, torch), n_iter)
    xj, Lj, fj, ij = jfused._pnqp_kernel(
        _lists(jnp.asarray(H)), cols(q, jnp), cols(lo, jnp), cols(hi, jnp),
        cols(x0, jnp), n, n_iter)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for i in range(n):
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj[i]),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(ft[i].numpy(), np.asarray(fj[i]))
        for j in range(i + 1):
            np.testing.assert_allclose(Lt[i][j].numpy(), np.asarray(Lj[i][j]),
                                       rtol=1e-12, atol=1e-12)
    if n_iter == 20:
        assert (it < 20).all()          # every example converged
        x = np.stack([v.numpy() for v in xt], 1)
        assert ((x >= lo) & (x <= hi)).all()


@pytest.mark.parametrize('n', [1, 5, 28, 32])
def test_lane_sum_is_the_warp_butterfly(n):
    """``_lane_sum`` adds in the order of the kernel's xor-butterfly of
    shuffles: 32 lanes (those past n hold 0), lane i adding lane i ^ o
    for o = 16, 8, 4, 2, 1; every lane ends with lane 0's bits."""
    v = torch.tensor(np.random.RandomState(n).randn(3, n) * 10.0 ** (
        np.arange(n) % 7), dtype=torch.float32)
    lanes = [v[:, i] if i < n else torch.zeros(3) for i in range(32)]
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    assert all(torch.equal(lanes[i], lanes[0]) for i in range(32))
    assert torch.equal(fd._lane_sum(v), lanes[0])


# ---------------------------------------------------------------------------
# gradients, slew
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ns,nc', [(5, 1), (4, 2), (3, 9)])
def test_gradients_through_dense_forward_match_jax(ns, nc):
    """The dense forward and the dense backward (their plain versions
    here; no eager fixed point): gradients to C, c, F, f and x_init
    against jax.grad of the jnp path."""
    T, B = 5, 4
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=ns + nc, c_batched=True,
                              f='shared')
    w = np.random.RandomState(9).randn(T, B, nc)
    cfg = _cfg(T, ns, nc, lqr_iter=8, backprop=True)
    bk = dict(u_lower=-0.6, u_upper=0.6)

    def j_loss(C, c, F, f, x0):
        s = j_batched_solve(mpc_tpu.MPCConfig(**dict(cfg, use_fused='never')),
                            x0, mpc_tpu.QuadCost(C, c), mpc_tpu.LinDx(F, f),
                            **bk)
        return jnp.sum(s.u * w) + 0.5 * jnp.sum(s.x ** 2)

    args = (C, c, F, f, x0)
    ref = jax.grad(j_loss, argnums=range(5))(*map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    assert fused_bwd.scope_gap_bwd(T, nc, n_state=ns) is None
    assert fused_bwd.bwd_routes_dense(ns, nc)
    solver.reset_eager_counts()
    sol = mt.batched_solve(mt.MPCConfig(**cfg), leaves[4],
                           mt.QuadCost(leaves[0], leaves[1]),
                           mt.LinDx(leaves[2], leaves[3]), device='cpu', **bk)
    ((sol.u * torch.tensor(w)).sum() + 0.5 * (sol.x ** 2).sum()).backward()
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}
    assert sol.converged.all() and (sol.u.detach().abs() == 0.6).any()
    for name, t, r in zip('C c F f x_init'.split(), leaves, ref):
        assert t.grad.shape == r.shape, name
        _rel(t.grad.numpy(), r, GRAD_TOL, name)


def test_scope_gap_bwd_judges_n_state():
    """K2 and K4 hold 3 states and 1 control; every other n_state up to
    the dense gate takes their dense configuration, whose fixed point
    make_batched_fixed_point builds.  What still refuses, and takes the
    eager fixed point: float64 on the card, a slew penalty, and
    n_state + n_ctrl > 32, as mpc_tpu's jnp path."""
    cuda = torch.device('cuda')
    assert fused_bwd.scope_gap_bwd(10) is None
    assert fused_bwd.scope_gap_bwd(10, 1, n_state=5) is None
    assert fused_bwd.bwd_routes_dense(5, 1)
    assert not fused_bwd.bwd_routes_dense(3, 1)
    assert fused_bwd.supports_bwd(10, n_state=4)
    fused_bwd.make_batched_fixed_point(5, True, False)
    assert 'float64' in fused_bwd.scope_gap_bwd(10, 1, torch.float64, cuda,
                                                5)
    assert 'slew' in fused_bwd.scope_gap_bwd(10, 1, n_state=5, slew=True)
    gap = fused_bwd.scope_gap_bwd(10, 1, n_state=32)
    assert 'n_state + n_ctrl = 33' in gap and 'jnp path' in gap
    with pytest.raises(NotImplementedError):
        fused_bwd.make_batched_fixed_point(32, True, False)


@pytest.mark.parametrize('ns,nc', [(3, 1), (2, 2), (2, 9)])
def test_slew_lindx_reaches_dense_and_matches_jax(ns, nc):
    """A slew penalty augments the state with the previous control: a
    3-state, 1-control LinDx becomes 4 states, a 2-state, 2-control one 4
    states and 2 controls and a 2-state, 9-control one 11 states and 9
    controls, all in the dense configuration; the
    solve matches mpc_tpu's slew solve (jnp path) in float64."""
    T, B = 6, 5
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=20 + ns, f='shared')
    pc = np.random.RandomState(21).randn(B, nc)
    cfg = _cfg(T, ns, nc, slew_rate_penalty=0.3)
    gap = fused.scope_gap(mt.MPCConfig(**cfg), quad_cost_from_numpy(C, c,
                                                                    'cpu'),
                          lin_dx_from_numpy(F, f, 'cpu'))
    assert gap is None
    assert fused.routes_dense(mt.LinDx(F, f), ns + nc, nc)
    ref = _jax_solve(cfg, F, f, C, c, x0, prev_ctrl=pc, **BOX)
    solver.reset_eager_counts()
    got = _port_solve(cfg, F, f, C, c, x0, prev_ctrl=pc, **BOX)
    assert solver.eager_counts['eager_solve'] == 0
    assert got.x.shape == (T, B, ns)
    for name in ('x', 'u'):
        _rel(getattr(got, name).numpy(), getattr(ref, name), TOL, name)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))


# ---------------------------------------------------------------------------
# routing, gate, geometry, op
# ---------------------------------------------------------------------------

def _lin(ns, nc, T=5):
    return mt.LinDx(torch.zeros(T - 1, ns, ns + nc))


# the JAX package's rows (benchmarks/configs.py:49-171) and the cartpole's
# size: (n_state, n_ctrl, B)
JAX_ROWS = [(3, 4, 128), (16, 4, 2048), (19, 4, 1024), (19, 4, 2048),
            (24, 4, 1024), (24, 4, 2048), (5, 1, 512),
            # past 8 controls, where mpc_tpu's own gate admits its kernels
            # at T=20 (utils/problems.WIDE_ROWS)
            (3, 9, 2048), (4, 12, 2048), (2, 16, 2048)]


@pytest.mark.parametrize('ns,nc,B', JAX_ROWS)
def test_gate_admits_the_jax_rows(ns, nc, B):
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=20)
    cost = mt.QuadCost(torch.eye(ns + nc), torch.zeros(ns + nc))
    for dev in ('cpu', 'cuda'):
        assert fused.scope_gap(cfg, cost, _lin(ns, nc, 20),
                               device=torch.device(dev)) is None
    assert fused.routes_dense(_lin(ns, nc), ns, nc)
    geo = fd.k3d_launch(20, B, ns, nc, 10)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    assert geo['blocks'] * geo['examples'] >= B


GATE_REFUSALS = {
    'ntau_33': (31, 2, 'n_state + n_ctrl = 33'),
    # past 8 controls the gate is the warp's lanes alone: 24s9c is 33
    'n_ctrl_9': (24, 9, 'n_state + n_ctrl = 33'),
}


@pytest.mark.parametrize('case', list(GATE_REFUSALS))
def test_gate_refuses_past_its_limits(case):
    ns, nc, needle = GATE_REFUSALS[case]
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=5)
    cost = mt.QuadCost(torch.eye(ns + nc), torch.zeros(ns + nc))
    gap = fused.scope_gap(cfg, cost, _lin(ns, nc))
    assert needle in gap and 'jnp path' in gap and 'eager' in gap
    assert 'ROADMAP' not in gap
    # 'always' raises, 'auto' solves eagerly
    x0 = torch.zeros(2, ns, dtype=torch.float64)
    cost64 = mt.QuadCost(torch.eye(ns + nc, dtype=torch.float64),
                         torch.zeros(ns + nc, dtype=torch.float64))
    lin = mt.LinDx(torch.zeros(4, ns, ns + nc, dtype=torch.float64))
    with pytest.raises((NotImplementedError, ValueError),
                       match=re.escape(needle)):
        mt.batched_solve(mt.MPCConfig(n_state=ns, n_ctrl=nc, T=5,
                                      use_fused='always'), x0, cost64, lin,
                         device='cpu')
    solver.reset_eager_counts()
    mt.batched_solve(mt.MPCConfig(n_state=ns, n_ctrl=nc, T=5, lqr_iter=1,
                                  exit_unconverged=False), x0, cost64, lin,
                     device='cpu')
    assert solver.eager_counts['eager_solve'] == 1


def test_gate_limits_fit_the_card():
    """Every admitted size fits a block's shared memory, forward and
    backward, at every n_ctrl up to nt - 1; the limit sits at the warp's
    32 lanes alone, so 24s9c (33 taus) is refused."""
    assert fused.DENSE_MAX_TAU == 32 and not hasattr(fused, 'DENSE_MAX_CTRL')
    for nt in range(2, 33):
        for nc in range(1, nt):
            assert fd.k3d_launch(1, 1, nt - nc, nc, 1)['smem_bytes'] \
                <= fused.SMEM_LIMIT
            assert fused_bwd_dense.k4d_launch(1, 1, nt - nc, nc)[
                'smem_bytes'] <= fused.SMEM_LIMIT
            assert fused.dense_gap(nt - nc, nc) is None
    assert 'n_state + n_ctrl = 33' in fused.dense_gap(24, 9)
    assert fused.dense_gap(30, 3) is not None


ROUTES = {
    # dynamics, ns, nc: dense?
    'lindx_3s1c_stays_on_k3': (lambda: _lin(3, 1), 3, 1, False),
    'lindx_5s1c': (lambda: _lin(5, 1), 5, 1, True),
    'lindx_3s4c': (lambda: _lin(3, 4), 3, 4, True),
    'lindx_2s1c': (lambda: _lin(2, 1), 2, 1, True),
    'lindx_3s9c': (lambda: _lin(3, 9), 3, 9, True),
    'lindx_2s16c': (lambda: _lin(2, 16), 2, 16, True),
    'pendulum': (lambda: mt.models.PendulumDx(device='cpu'), 3, 1, False),
}


@pytest.mark.parametrize('case', list(ROUTES))
def test_routes_dense(case):
    make, ns, nc, dense = ROUTES[case]
    assert fused.routes_dense(make(), ns, nc) is dense


def test_use_fused_always_runs_the_dense_configuration():
    T, B, ns, nc = 4, 3, 4, 2
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=4)
    cfg = _cfg(T, ns, nc, use_fused='always', lqr_iter=2)
    solver.reset_eager_counts()
    a = _port_solve(cfg, F, f, C, c, x0, **BOX)
    b = _port_solve(dict(cfg, use_fused='auto'), F, f, C, c, x0, **BOX)
    assert solver.eager_counts['eager_solve'] == 0
    assert torch.equal(a.u, b.u) and torch.equal(a.x, b.x)


@pytest.mark.parametrize('T,B,ns,nc', [(1, 1, 1, 1), (20, 2048, 24, 4),
                                       (5, 130, 3, 4), (7, 9, 28, 4)])
def test_k3d_launch_geometry(T, B, ns, nc):
    geo = fd.k3d_launch(T, B, ns, nc, 5)
    assert geo['team'] == 32 and geo['warps'] == geo['examples'] \
        == fd.DENSE_WARPS
    assert geo['blocks'] == -(-B // fd.DENSE_WARPS)
    assert geo['smem_bytes'] == 16 * fd.DENSE_WARPS * (
        -(-fd._warp_floats(ns, nc) // 4))
    nt = ns + nc
    assert geo['workspace_bytes'] == 4 * B * T * (2 * nt + nc * (ns + 1))
    with pytest.raises(ValueError):
        fd.k3d_launch(T, B, ns, nc, fused.MAX_ALPHA + 1)


def test_warp_tiles_at_24_states():
    """The tiles of an example at 24 states and 4 controls (the odd row
    strides included): 3108 floats, 12,432 bytes; a block of four
    49,728."""
    assert fd._warp_floats(24, 4) == fd._warp_floats(24, 4, False) == 3108
    assert fd.k3d_launch(20, 2048, 24, 4, 10)['smem_bytes'] == 49728
    # the prefetch's second set (4,572 floats, 73,152 bytes a block) would
    # leave three blocks an SM: 24s4c keeps one set
    assert fd._warp_floats(24, 4, True) == 4572
    assert fd.dense_kernel_defines(24, 4, True, False) == {
        'MPC_NS': 24, 'MPC_NC': 4, 'MPC_HAS_BOUNDS': 1, 'MPC_HAS_F': 0,
        'MPC_WARPS': 4, 'MPC_PREFETCH': 0}


def test_warp_tiles_past_8_controls():
    """Past ``REG_CTRL_MAX`` controls (csrc/box_qp_smem.cuh:kRegCtrlMax,
    the same number) a warp's tiles add the control solve's: the factor
    [nc][odd], its diagonal's reciprocals and the box QP's four rows in the
    forward (x, dx, lo, hi), the factor and the reciprocals in the
    backward; at 4 states and 28 controls (one set of tiles: two would
    leave three blocks an SM) 2,644 and 2,536 floats (1,692 and 1,696
    without them), a block of four 42,304 and 40,576 bytes.  At 8 controls
    nothing is added."""
    src = (fd.__file__.rsplit('/ops/', 1)[0] + '/csrc/box_qp_smem.cuh')
    m = re.search(r'constexpr int kRegCtrlMax = (\d+);', open(src).read())
    assert int(m.group(1)) == fd.REG_CTRL_MAX == 8
    assert fd._warp_floats(4, 28) == 1692 + 28 * 29 + 5 * 28 == 2644
    assert fused_bwd_dense._warp_floats(4, 28) == 1696 + 28 * 29 + 28 \
        == 2536
    assert fd.k3d_launch(20, 2048, 4, 28, 10)['smem_bytes'] == 42304
    assert fused_bwd_dense.k4d_launch(20, 1024, 4, 28)['smem_bytes'] \
        == 40576
    assert fd._ctrl_tile_floats(8, 5) == 0
    assert fd._ctrl_tile_floats(9, 4) == 9 * 9 + 5 * 9


def test_k3d_bound_counts():
    """The work grows with the iterations, trials and QP trips that ran;
    shared operands count once; the medium-state row is bound by
    operations."""
    T, B, ns, nc = 20, 2048, 24, 4
    one = fd.k3d_flops(T, ns, nc, 10, 10, n_qp=200)
    assert fd.k3d_flops(T, ns, nc, 20, 20, batch=2, n_qp=400) == 2 * one
    assert fd.k3d_flops(T, ns, nc, 10, 11, n_qp=200) > one
    assert fd.k3d_flops(T, ns, nc, 10, 10, n_qp=201) > one
    assert fd.k3d_flops(T, ns, nc, 10, 10, has_f=True, n_qp=200) > one
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=1, dtype=np.float32)
    ops = fd.k3d_operands(mt.MPCConfig(**_cfg(T, ns, nc)), torch.tensor(x0),
                          quad_cost_from_numpy(C, c, 'cpu'),
                          lin_dx_from_numpy(F, None, 'cpu'), u_lower=-1.0,
                          u_upper=1.0)
    nt = ns + nc
    assert fd.k3d_bytes(ops) == 4 * ((T - 1) * ns * nt + T * nt * nt
                                     + T * nt + B * ns + T * B * nc
                                     + 2 * T * nc + T * B * nt + 6 * B)
    assert B * one / 67e12 > fd.k3d_bytes(ops) / 3.35e12


def _op_args(rng, T, B, ns, nc, bounds, f):
    t = (lambda a: torch.tensor(a))
    nt = ns + nc
    F = t(np.concatenate([np.eye(ns) + 0.1 * rng.randn(T - 1, 1, ns, ns),
                          rng.randn(T - 1, 1, ns, nc)], -1))
    R = rng.randn(T, B, nt, nt)
    C = t(np.einsum('tbij,tbkj->tbik', R, R) + np.eye(nt))
    lb = t(np.full((T, 1, nc), -0.7)) if bounds else None
    return (F, t(0.1 * rng.randn(T - 1, B, ns)) if f else None, C,
            t(rng.randn(T, 1, nt)), t(rng.randn(B, ns)), t(np.zeros((T, B, nc))),
            lb, None if lb is None else -lb)


@pytest.mark.parametrize('nc', [1, 3, 9])
@pytest.mark.parametrize('bounds', [True, False])
@pytest.mark.parametrize('f', [True, False])
def test_opcheck_k3d(nc, bounds, f):
    args = _op_args(np.random.RandomState(nc), 3, 2, 3, nc, bounds, f)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3d_solve,
                          (*args, [1.0, 0.2, 0.04], 3, 0.0, 1e-4, 5.0, 20))


def test_dense_solve_exports_as_one_node():
    """The op's fake registration: a dense solve exports with one
    k3d_solve node and the artifact gives the live path's bits."""
    T, B, ns, nc = 3, 2, 4, 2
    F, f, C, c, x0 = (torch.tensor(a) for a in _problem(T, B, ns, nc, seed=2,
                                                         f='batched'))
    cfg = mt.MPCConfig(**_cfg(T, ns, nc, lqr_iter=2))
    data = ex.export_solve(cfg, mt.LinDx(F, f), mt.QuadCost(C, c), x0,
                           u_lower=-0.5, u_upper=0.5, device='cpu')
    assert ex.kernel_nodes(data) == {'k3d_solve': 1}
    out = ex.load_fn(data)(x0, C, c, F, f)
    live = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), mt.LinDx(F, f),
                            u_lower=-0.5, u_upper=0.5, device='cpu')
    assert all(torch.equal(a, b) for a, b in
               zip(out, (live.x, live.u, live.costs)))


def test_wrapper_never_falls_back_off_the_cpu():
    """Only a tensor on the CPU runs the plain version; any other device
    launches the kernel or raises (here: the meta device)."""
    dev = torch.device('meta')
    T, B, ns, nc = 3, 2, 4, 2
    args = [torch.zeros(s, device=dev, dtype=torch.float32) for s in (
        (T - 1, 1, ns, ns + nc), (T, 1, ns + nc, ns + nc), (T, 1, ns + nc),
        (B, ns), (T, B, nc))]
    with pytest.raises(NotImplementedError):
        fd.fused_ilqr_dense(args[0], None, *args[1:], None, None,
                            alphas=[1.0], lqr_iter=1, eps=0.0,
                            best_cost_eps=1e-4, not_improved_lim=5.0,
                            pnqp_iter=20)


def test_mpc_front_end_runs_the_dense_configuration():
    """``MPC`` with a [T, ...] LinDx of 4 states and 2 controls: the
    dense route, and mpc_tpu.MPC's answer in float64."""
    T, B, ns, nc = 5, 3, 4, 2
    F, f, C, c, x0 = _problem(T, B, ns, nc, seed=8, f='shared')
    kw = dict(u_lower=-0.5, u_upper=0.5, lqr_iter=6, eps=1e-6,
              exit_unconverged=False, backprop=False)
    jx, ju, _ = mpc_tpu.MPC(ns, nc, T, **kw)(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(c)),
        mpc_tpu.LinDx(jnp.asarray(F), jnp.asarray(f)))
    solver.reset_eager_counts()
    tx, tu, _ = mt.MPC(ns, nc, T, device='cpu', **kw)(
        torch.tensor(x0), quad_cost_from_numpy(C, c, 'cpu'),
        lin_dx_from_numpy(F, f, 'cpu'))
    assert solver.eager_counts['eager_solve'] == 0
    _rel(tu.numpy(), ju, TOL, 'u')
    _rel(tx.numpy(), jx, TOL, 'x')
