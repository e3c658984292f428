"""The plain version of kernel K2 (the port's fused KKT backward) against
the JAX package, same-primal, on the CPU.

Both sides get the same x*, u* and cotangents (a tiny primal difference
flips active-set lanes, so backward implementations are never compared
end to end here):

- float64: against ``jax.vjp`` of the vmapped ``make_lqr_fixed_point``
  (mpc_tpu/ops/diff.py) on random SPD problems with n_ctrl = 1, batched
  and batch-shared cost, bounded with f and unbounded without.  Tolerance
  1e-10 relative to each gradient's largest entry: the two compute the
  same recursion in another order (the JAX side through its projected
  Newton box QP); measured up to 4.2e-12.
- float32: against the Pallas kernel ``make_batched_fixed_point(...,
  interpret=True)`` at the shapes of tests/test_fused_bwd.py's
  test_bwd_kernel_bounded and test_bwd_kernel_shared_cost_dyn (so the
  persistent compile cache is shared), with their tolerance, 5e-4
  relative to scale.  The port takes F per example, so the shared case
  hands it the shared F broadcast and compares its per-example dF, df
  summed over the batch.
- batch reversal at B=2050: examples are independent, so per-example
  gradients are bitwise equal; the batch-reduced dC, dc sum in another
  order and are held to 1e-5 relative (float32).
- the pendulum Jacobian's derivatives with respect to the model's
  parameters, which carry dF to them: float64 against ``jax.jacfwd`` of
  ``jax.jacrev`` of mpc_tpu's atan2 step, 1e-12.
- the fixed point's gradients against central differences of an exact
  dense LQR solve (numpy) on an interior problem with wide bounds, in
  float64: 1e-6 relative.  dC only along symmetric directions.
- phase 2's linearisation (F, f) against mpc_tpu's in float64: 1e-12
  for the exact Jacobian; 1e-9 for central differences, which both take
  with the same step (they round differently, by ~1e-16 / 1e-4).
- the backward's scope, and the finite-difference utilities against
  mpc_tpu's (the same arithmetic, so equal bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_tpu import GradMethods as JGradMethods
from mpc_tpu.models import PendulumDx as JPendulumDx
from mpc_tpu.ops.diff import make_lqr_fixed_point
from mpc_tpu.ops.fused_bwd import (make_batched_fixed_point as
                                   j_make_batched_fixed_point)
from mpc_tpu.solver import linearize_dynamics as j_linearize_dynamics
from mpc_tpu.utils import fd as j_fd

from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused, fused_bwd
from mpc_tpu_torch.solver import linearize_dynamics
from mpc_tpu_torch.types import GradMethods
from mpc_tpu_torch.utils import fd
from mpc_tpu_torch.utils.fd import fd_grad

NAMES = ('dx_init', 'dC', 'dc', 'dF', 'df')
PARAMS64 = np.array([10., 1., 1.3])


def _problem(T, B, cost_shared, has_bounds, seed, dyn_shared=False):
    """Random residuals in the layout of tests/test_fused_bwd.py:
    _vjp_case (batched) and _vjp_case_shared (shared cost and dynamics),
    float32 as there; n_state = 3, n_ctrl = 1."""
    ns, nc, nt = 3, 1, 4
    rng = np.random.RandomState(seed)
    csh = (T,) if cost_shared else (T, B)
    dsh = (T - 1,) if dyn_shared else (T - 1, B)
    Cr = rng.randn(*csh, nt, nt).astype(np.float32)
    C = np.einsum('...ij,...kj->...ik', Cr, Cr) + np.eye(nt, dtype=np.float32)
    c = rng.randn(*csh, nt).astype(np.float32)
    F = 0.4 * rng.randn(*dsh, ns, nt).astype(np.float32)
    F[..., :ns] += np.eye(ns, dtype=np.float32)
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


def _port(p, cost_shared, has_bounds, has_f, dtype):
    """The plain K2 through the wrapper, on the CPU."""
    t = {k: torch.tensor(v.astype(dtype)) for k, v in p.items()}
    B = t['xs'].shape[1]
    F = t['F']
    if F.dim() == 3:                       # shared dynamics: broadcast
        F = F.unsqueeze(1).expand(-1, B, -1, -1).contiguous()
    C, c = t['C'], t['c']
    if cost_shared:
        C, c = C.unsqueeze(1), c.unsqueeze(1)
    I = (fused_bwd.active_set(t['us'], t['lb'], t['ub']) if has_bounds
         else None)
    return [g.numpy() for g in fused_bwd.fused_kkt_backward(
        C, c, F, t['xs'], t['us'], t['gx'], t['gu'], I, has_f=has_f)]


def _jax_args(p, dtype):
    B = p['xs'].shape[1]
    return [jnp.asarray(a, dtype) for a in (
        np.zeros((B, 3)), p['C'], p['c'], p['F'], p['f'], p['lb'],
        p['ub'], p['xs'], p['us'])], (jnp.asarray(p['gx'], dtype),
                                       jnp.asarray(p['gu'], dtype))


def _assert_rel(ref, got, tol):
    for name, a, b in zip(NAMES, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / scale < tol, \
            (name, np.abs(a - b).max(), scale)


@pytest.mark.parametrize('cost_shared', [False, True])
@pytest.mark.parametrize('has_bounds,has_f', [(True, True), (False, False)])
def test_plain_k2_matches_jax_vjp_f64(cost_shared, has_bounds, has_f):
    p = _problem(6, 16, cost_shared, has_bounds, seed=0)
    args, cot = _jax_args(p, jnp.float64)
    ax = None if cost_shared else 1
    fp = make_lqr_fixed_point(3, has_bounds, has_f)
    _, vjp = jax.vjp(jax.vmap(fp, in_axes=(0, ax, ax, 1, 1, 1, 1, 1, 1),
                              out_axes=(1, 1)), *args)
    ref = vjp(cot)[:5]
    got = _port(p, cost_shared, has_bounds, has_f, np.float64)
    _assert_rel(ref, got, 1e-10)


@pytest.mark.parametrize('shared', [False, True])
def test_plain_k2_matches_pallas_k2_f32(shared):
    if shared:      # test_bwd_kernel_shared_cost_dyn's problem
        p = _problem(6, 16, True, True, seed=3, dyn_shared=True)
    else:           # test_bwd_kernel_bounded's problem
        p = _problem(6, 16, False, True, seed=0)
    args, cot = _jax_args(p, jnp.float32)
    fp_k = j_make_batched_fixed_point(3, True, True, interpret=True)
    _, vjp_k = jax.vjp(fp_k, *args)
    ref = [np.asarray(a) for a in vjp_k(cot)[:5]]
    got = _port(p, shared, True, True, np.float32)
    if shared:      # per-example dF, df of the broadcast F, summed
        got[3], got[4] = got[3].sum(1), got[4].sum(1)
    _assert_rel(ref, got, 5e-4)


@pytest.mark.parametrize('cost_shared', [False, True])
def test_plain_k2_reversed_batch(cost_shared):
    """B=2050: the reversed batch, un-reversed, gives the same bits on
    per-example gradients (round 2's lane bug class)."""
    p = _problem(5, 2050, cost_shared, True, seed=6)
    got = _port(p, cost_shared, True, True, np.float32)
    batched = ['xs', 'us', 'lb', 'ub', 'gx', 'gu', 'F', 'f']
    if not cost_shared:
        batched += ['C', 'c']
    rev = dict(p)
    for k in batched:
        rev[k] = np.ascontiguousarray(p[k][:, ::-1])
    back = _port(rev, cost_shared, True, True, np.float32)
    np.testing.assert_array_equal(back[0][::-1], got[0])
    for i in (3, 4):
        np.testing.assert_array_equal(back[i][:, ::-1], got[i])
    for i in (1, 2):
        if cost_shared:
            np.testing.assert_allclose(back[i], got[i], rtol=0,
                                       atol=1e-5 * np.abs(got[i]).max())
        else:
            np.testing.assert_array_equal(back[i][:, ::-1], got[i])


@pytest.mark.parametrize('u', [0.7, -2.0, 2.0])
def test_step_jacobian_parameter_derivatives(u):
    """d step_jacobian / d params, the path by which dF reaches the
    model's parameters, against the second derivative of mpc_tpu's atan2
    step: angle addition and atan2 are one function for r > 0."""
    th = np.array([2.0, -0.7, 0.3])
    x = np.stack([np.cos(th), np.sin(th), np.array([0.5, -1.2, 3.0])], 1)
    params = PARAMS64

    def jac_j(prm, xb):
        dyn = JPendulumDx(params=prm)
        R, S = jax.jacrev(dyn, argnums=(0, 1))(xb, jnp.array([u]))
        return jnp.concatenate([R, S], 1)

    for b in range(len(th)):
        ref = np.asarray(jax.jacfwd(jac_j)(jnp.asarray(params),
                                           jnp.asarray(x[b])))
        got = torch.autograd.functional.jacobian(
            lambda prm: PendulumDx(params=prm).step_jacobian(
                torch.tensor(x[b:b + 1]),
                torch.tensor([[u]], dtype=torch.float64))[0],
            torch.tensor(params))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def _dense_lqr(C, c, F, f, x0):
    """Exact solution of the unconstrained LQR problem of one example by
    eliminating the states: x = M u + m, then the normal equations."""
    T = c.shape[0]
    ns = x0.shape[0]
    M = np.zeros((T, ns, T))
    m = np.zeros((T, ns))
    m[0] = x0
    for t in range(T - 1):
        Fx, Fu = F[t][:, :ns], F[t][:, ns:]
        M[t + 1] = Fx @ M[t]
        M[t + 1][:, t] += Fu[:, 0]
        m[t + 1] = Fx @ m[t] + f[t]
    H = np.zeros((T, T))
    g = np.zeros(T)
    for t in range(T):
        A = np.zeros((ns + 1, T))
        A[:ns] = M[t]
        A[ns, t] = 1.0
        a0 = np.concatenate([m[t], [0.0]])
        H += A.T @ C[t] @ A
        g += A.T @ (C[t] @ a0 + c[t])
    u = np.linalg.solve(H, -g)
    x = np.einsum('tij,j->ti', M, u) + m
    return x, u[:, None]


def test_fixed_point_matches_finite_differences():
    """Interior solution (bounds +-100, far away): the fixed point's
    gradients are the exact derivatives of the LQR solution map, so
    central differences of the dense solve are an independent oracle.
    Shared C, c (batch-reduced gradient) with per-example F, f."""
    T, B, ns = 4, 2, 3
    rng = np.random.RandomState(7)
    Cr = rng.randn(T, 4, 4)
    C = np.einsum('tij,tkj->tik', Cr, Cr) + np.eye(4)
    c = rng.randn(T, 4)
    F = 0.4 * rng.randn(T - 1, B, ns, 4)
    F[..., :ns] += np.eye(ns)
    f = 0.1 * rng.randn(T - 1, B, ns)
    x0 = rng.randn(B, ns)
    gx = rng.randn(T, B, ns)
    gu = rng.randn(T, B, 1)

    def solve(C, c, F, f, x0):
        sols = [_dense_lqr(C, c, F[:, b], f[:, b], x0[b]) for b in range(B)]
        return (np.stack([s[0] for s in sols], 1),
                np.stack([s[1] for s in sols], 1))

    def loss(C, c, F, f, x0):
        x, u = solve(C, c, F, f, x0)
        return float((gx * x).sum() + (gu * u).sum())

    xs, us = solve(C, c, F, f, x0)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, C, c, F, f)]
    fp = fused_bwd.make_batched_fixed_point(3, True, True)
    bound = torch.tensor(100.0, dtype=torch.float64)
    x, u = fp.apply(*leaves, -bound, bound, torch.tensor(xs),
                    torch.tensor(us))
    ((torch.tensor(gx) * x).sum() + (torch.tensor(gu) * u).sum()).backward()
    grads = {k: v.grad.numpy() for k, v in zip(('x0', 'C', 'c', 'F', 'f'),
                                               leaves)}
    prim = dict(C=C, c=c, F=F, f=f, x0=x0)
    for k in ('x0', 'c', 'F', 'f'):
        def fk(z, k=k):
            return loss(**{**prim, k: z})
        g = fd_grad(fk, prim[k], eps=1e-6)
        assert np.abs(g - grads[k]).max() <= 1e-6 * np.abs(g).max(), k
    for _ in range(3):      # C only along symmetric directions
        E = rng.randn(T, 4, 4)
        E = E + np.swapaxes(E, 1, 2)
        d = fd_grad(lambda s: loss(**{**prim, 'C': C + s[0] * E}),
                    np.zeros(1), eps=1e-6)[0]
        assert abs(d - (grads['C'] * E).sum()) <= 1e-6 * abs(d)


def _fixed_point_grads(t, C, c):
    """Gradients of <gx, x> + <gu, u> through the fixed point with respect
    to (x_init, C, c, F, f), on the float64 problem ``t``."""
    B = t['xs'].shape[1]
    leaves = [torch.zeros(B, 3, dtype=torch.float64), C, c, t['F'], t['f']]
    leaves = [a.clone().requires_grad_() for a in leaves]
    fp = fused_bwd.make_batched_fixed_point(3, True, True)
    x, u = fp.apply(*leaves, t['lb'], t['ub'], t['xs'], t['us'])
    ((t['gx'] * x).sum() + (t['gu'] * u).sum()).backward()
    return [a.grad for a in leaves]


@pytest.mark.parametrize('layout', ['batch_of_one', 'shared_C_batched_c'])
def test_fixed_point_cost_gradient_layouts(layout):
    """Each cost leaf gets its gradient in its own layout.  A batch of one
    (K2 then reduces it as a shared cost) matches the same example twice
    in a batch of two; a shared C beside a batched c gets the
    per-example gradient summed over the batch, as for C broadcast to a
    batched leaf.  Both sides run the same float64 arithmetic: 1e-12."""
    p = _problem(4, 2, False, True, seed=5)
    if layout == 'batch_of_one':
        p = {k: np.ascontiguousarray(v[:, :1]) for k, v in p.items()}
        two = {k: np.concatenate([v, v], 1) for k, v in p.items()}
    t = {k: torch.tensor(v.astype(np.float64)) for k, v in p.items()}
    got = _fixed_point_grads(t, t['C'], t['c'])
    if layout == 'batch_of_one':
        t2 = {k: torch.tensor(v.astype(np.float64)) for k, v in two.items()}
        ref = [g[:1] if i == 0 else g[:, :1]
               for i, g in enumerate(_fixed_point_grads(t2, t2['C'],
                                                        t2['c']))]
    else:
        got = _fixed_point_grads(t, t['C'][:, 0], t['c'])
        ref = _fixed_point_grads(t, t['C'][:, :1].expand_as(t['C']),
                                 t['c'])
        ref[1] = ref[1].sum(1)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize('method', ['AUTO_DIFF', 'FINITE_DIFF'])
def test_linearize_dynamics_matches_jax(method):
    rng = np.random.RandomState(2)
    T, B = 4, 3
    th = rng.uniform(-np.pi, np.pi, (T, B))
    x = np.stack([np.cos(th), np.sin(th), rng.randn(T, B)], -1)
    u = np.clip(2.5 * rng.randn(T, B, 1), -3, 3)   # some outside +-2
    u[0, 0, 0], u[1, 1, 0] = 2.0, -2.0             # on the bounds
    F, f = linearize_dynamics(PendulumDx(params=torch.tensor(PARAMS64)),
                              torch.tensor(x), torch.tensor(u),
                              getattr(GradMethods, method))
    dyn = JPendulumDx(params=jnp.asarray(PARAMS64))
    for b in range(B):
        Fj, fj = j_linearize_dynamics(dyn, jnp.asarray(x[:, b]),
                                      jnp.asarray(u[:, b]),
                                      getattr(JGradMethods, method))
        tol = 1e-12 if method == 'AUTO_DIFF' else 1e-9
        np.testing.assert_allclose(F[:, b].numpy(), np.asarray(Fj),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(f[:, b].numpy(), np.asarray(fj),
                                   rtol=0, atol=tol)


def test_scope_gap_bwd():
    cuda = torch.device('cuda')
    assert fused_bwd.supports_bwd(10)
    assert fused_bwd.supports_bwd(fused_bwd.T_MAX_BWD, dtype=torch.float64)
    # past K2's horizon the backward is K4's
    assert fused_bwd.supports_bwd(fused_bwd.T_MAX_BWD + 1)
    assert fused_bwd.bwd_routes_long(fused_bwd.T_MAX_BWD + 1, False)
    assert not fused_bwd.bwd_routes_long(fused_bwd.T_MAX_BWD, False)
    # n_ctrl > 1 takes K2 and K4's dense configuration; float64 on the
    # card, a slew penalty and n_state + n_ctrl > 32 stay on the eager
    # fixed point
    assert fused_bwd.scope_gap_bwd(10, n_ctrl=2) is None
    assert fused_bwd.bwd_routes_dense(3, 2)
    assert not fused_bwd.bwd_routes_dense(3, 1)
    assert 'float64' in fused_bwd.scope_gap_bwd(10, dtype=torch.float64,
                                                device=cuda)
    assert 'slew' in fused_bwd.scope_gap_bwd(10, slew=True)
    gap = fused_bwd.scope_gap_bwd(10, n_ctrl=2, n_state=31)
    assert 'n_state + n_ctrl = 33' in gap and 'jnp path' in gap
    assert fused_bwd.T_MAX_BWD >= fused.T_MAX    # every K1 horizon


def test_fd_utilities_match_mpc_tpu():
    def f(z):
        return np.sin(z) * z ** 2 + z[::-1]

    def g(z):
        return float((np.cos(z) * z).sum() + z[0] * z[-1])

    z = np.array([0.3, -1.2, 2.0])
    np.testing.assert_array_equal(fd.fd_jacobian(f, z),
                                  j_fd.fd_jacobian(f, z))
    np.testing.assert_array_equal(fd.fd_grad(g, z), j_fd.fd_grad(g, z))
    np.testing.assert_array_equal(fd.fd_hess(g, z), j_fd.fd_hess(g, z))
