"""The port's learned, affine and passthrough dynamics and its
pseudo-Huber cost (mpc_tpu_torch/models/dynamics.py, models/cost.py)
against the JAX package's, on the CPU in float64, with the same numpy
weights carried by mpc_tpu_torch/utils/convert.py.

- ``NNDynamics``: forward and the analytic ``grad_input`` for each
  activation with one and two hidden layers, and ``grad_input`` against
  ``jax.jacfwd`` of mpc_tpu's model (which is what lets the port's
  AUTO_DIFF linearisation use it): 1e-12 relative.  The flat weight
  vector against ``soa_params_flat``: exact.  The stream form that
  kernel K3 runs (``soa_stream_step``, ``soa_stream_jac``) against
  mpc_tpu's with a ``pread`` into the same vector: 1e-12.  A saturated
  sigmoid (pre-activations near +-100) keeps the stream Jacobian
  finite, in float32 as the kernel runs it.  ``init`` draws from its
  generator alone, within torch.nn.Linear's bounds.
- ``AffineDynamics``, ``CtrlPassthroughDynamics`` and
  ``PseudoHuberCost``: values and derivatives (``jax.jacfwd``,
  ``jax.grad``, ``jax.hessian`` against ``torch.func``): 1e-12.
- solves of an affine model and of a pseudo-Huber cost through ``MPC``
  against ``mpc_tpu.MPC`` with ``use_fused='never'``: 1e-10 on x and u
  (both run the eager solver; the port's scope sends the affine model
  there), and the pseudo-Huber solve on the kernel route (the plain K1's
  cost build) against the same reference, 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.models import (AffineDynamics as JAffine,
                            CtrlPassthroughDynamics as JPassthrough,
                            NNDynamics as JNN, PendulumDx as JPendulumDx,
                            PseudoHuberCost as JPseudoHuber)

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.models import (AffineDynamics, CtrlPassthroughDynamics,
                                  NNDynamics, PseudoHuberCost)
from mpc_tpu_torch.ops import fused
from mpc_tpu_torch.utils.convert import (affine_from_numpy,
                                         nn_dynamics_from_numpy,
                                         pseudo_huber_from_numpy)

TOL = 1e-12
ACTIVATIONS = ('sigmoid', 'relu', 'elu')


def _close(got, ref, tol=TOL, name=''):
    got, ref = (a.detach().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a) for a in (got, ref))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale, (
        name, np.abs(got - ref).max() / scale)


def mlp_params(hidden, ns=3, nc=1, seed=0, scale=1.0):
    """Weights as torch.nn.Linear draws them (uniform(+-1/sqrt(fan_in))),
    made with numpy: a list of (W [n_out, n_in], b [n_out])."""
    rng = np.random.RandomState(seed)
    sizes = [ns + nc] + list(hidden) + [ns]
    out = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        bound = scale / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_out, n_in)),
                    rng.uniform(-bound, bound, n_out)))
    return out


def both_mlps(params, act, passthrough=True):
    jm = JNN([(jnp.asarray(W), jnp.asarray(b)) for W, b in params], act,
             passthrough, 3, 1)
    tm = nn_dynamics_from_numpy(params, act, passthrough, 3, 1,
                                device='cpu')
    return jm, tm


def _xu(n, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3), rng.randn(n, 1)


# ---------------------------------------------------------------------------
# NNDynamics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('passthrough', [True, False])
@pytest.mark.parametrize('hidden', [(8,), (6, 5)], ids=['one', 'two'])
@pytest.mark.parametrize('act', ACTIVATIONS)
def test_nn_forward_and_grad_input_match_jax(act, hidden, passthrough):
    jm, tm = both_mlps(mlp_params(hidden), act, passthrough)
    x, u = _xu(16)
    _close(tm(torch.tensor(x), torch.tensor(u)),
           jm(jnp.asarray(x), jnp.asarray(u)), name='forward')
    R, S = tm.grad_input(torch.tensor(x), torch.tensor(u))
    jR, jS = jax.vmap(jm.grad_input)(jnp.asarray(x), jnp.asarray(u))
    _close(R, jR, name='R')
    _close(S, jS, name='S')
    # the analytic Jacobian is the exact one: against jax.jacfwd of
    # mpc_tpu's model
    fR, fS = jax.vmap(jax.jacfwd(jm, argnums=(0, 1)))(jnp.asarray(x),
                                                      jnp.asarray(u))
    _close(R, fR, name='R vs jacfwd')
    _close(S, fS, name='S vs jacfwd')
    # batched on two leading axes, as the solver calls it
    R2, _ = tm.grad_input(torch.tensor(x).view(4, 4, 3),
                          torch.tensor(u).view(4, 4, 1))
    _close(R2.reshape(16, 3, 3), jR, name='R [T, B]')


def test_nn_flat_weights_are_soa_params_flat():
    params = mlp_params((7, 5))
    jm, tm = both_mlps(params, 'sigmoid')
    np.testing.assert_array_equal(tm.kernel_params().detach().numpy(),
                                  np.asarray(jm.soa_params_flat()))
    assert tm.soa_param_count() == jm.soa_param_count() == \
        tm.kernel_params().numel()
    assert not tm.streams and both_mlps(mlp_params((7,)), 'relu')[1].streams


@pytest.mark.parametrize('passthrough', [True, False])
@pytest.mark.parametrize('act', ACTIVATIONS)
def test_nn_stream_step_and_jacobian_match_jax(act, passthrough):
    jm, tm = both_mlps(mlp_params((12,)), act, passthrough)
    x, u = _xu(10)
    flat = jm.soa_params_flat()

    def pread(i):
        return flat[i]

    xs = tuple(jnp.asarray(x[:, i]) for i in range(3))
    ref_step = jm.soa_stream_step(xs, jnp.asarray(u[:, 0]), pread)
    ref_jac = jm.soa_stream_jac(xs, jnp.asarray(u[:, 0]), pread)
    w = tm.kernel_params().detach()
    txs = tuple(torch.tensor(x[:, i]) for i in range(3))
    step = tm.soa_stream_step(txs, torch.tensor(u[:, 0]), w)
    jac = tm.soa_stream_jac(txs, torch.tensor(u[:, 0]), w)
    for j in range(3):
        _close(step[j], ref_step[j], name=f'step {j}')
        for i in range(4):
            _close(jac[j][i], ref_jac[j][i], name=f'jac {j} {i}')
    # the stream form is the model's own step and Jacobian
    R, S = tm.grad_input(torch.tensor(x), torch.tensor(u))
    F = torch.cat([R, S], -1)
    _close(torch.stack(step, -1), tm(torch.tensor(x), torch.tensor(u)),
           name='stream vs forward')
    _close(torch.stack([torch.stack(r, -1) for r in jac], -2), F,
           name='stream jac vs grad_input')


def test_nn_saturated_sigmoid_keeps_the_jacobian_finite():
    """Pre-activations near +-100 (a first layer scaled 500x and shifted):
    the tanh form of the sigmoid and its derivative stay finite in
    float32, where 1 / (1 + exp(-v)) overflows (as
    tests/test_fused_nn.py::test_soa_sigmoid_jvp_stable_when_saturated
    holds mpc_tpu's)."""
    (W0, b0), last = mlp_params((4,), seed=1)
    params = [(W0 * 500.0, b0 - 200.0), last]
    _, tm = both_mlps(params, 'sigmoid')
    tm = tm.float()
    w = tm.kernel_params().detach()
    x = torch.tensor([[1.0, -1.0, 2.0], [-1.0, 1.0, -2.0]])
    v = tm._stream_pre(list(x.unbind(-1)) + [torch.full((2,), 0.3)],
                       *tm._stream_weights(w)[:2])
    assert float(v.abs().max()) > 80.0
    jac = tm.soa_stream_jac(tuple(x.unbind(-1)), torch.full((2,), 0.3), w)
    step = tm.soa_stream_step(tuple(x.unbind(-1)), torch.full((2,), 0.3), w)
    assert all(torch.isfinite(e).all() for row in jac for e in row)
    assert all(torch.isfinite(e).all() for e in step)


def test_nn_init_draws_from_its_generator():
    def make(seed):
        return NNDynamics.init(3, 1, (100,), generator=torch.Generator(
            ).manual_seed(seed), device='cpu', dtype=torch.float64)
    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.kernel_params(), b.kernel_params())
    assert not torch.equal(a.kernel_params(), c.kernel_params())
    for lin, fan_in in zip(a.layers, (4, 100)):
        assert lin.weight.shape == (lin.out_features, fan_in)
        for p in (lin.weight, lin.bias):
            assert float(p.detach().abs().max()) <= 1 / fan_in ** 0.5
            assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert (a.n_state, a.n_ctrl, a.hidden, a.activation) == (
        3, 1, 100, 'sigmoid')
    with pytest.raises(ValueError):
        NNDynamics(a.layers, 'tanh')


# ---------------------------------------------------------------------------
# AffineDynamics, CtrlPassthroughDynamics, PseudoHuberCost
# ---------------------------------------------------------------------------

def _affine_arrays(ns=3, nc=2, seed=3):
    rng = np.random.RandomState(seed)
    return (np.eye(ns) + 0.1 * rng.randn(ns, ns), 0.2 * rng.randn(ns, nc),
            0.1 * rng.randn(ns))


@pytest.mark.parametrize('has_c', [True, False])
def test_affine_matches_jax(has_c):
    A, Bm, c = _affine_arrays()
    c = c if has_c else None
    jm = JAffine(jnp.asarray(A), jnp.asarray(Bm),
                 None if c is None else jnp.asarray(c))
    tm = affine_from_numpy(A, Bm, c, device='cpu')
    assert isinstance(tm, AffineDynamics)
    rng = np.random.RandomState(4)
    x, u = rng.randn(5, 6, 3), rng.randn(5, 6, 2)
    _close(tm(torch.tensor(x), torch.tensor(u)),
           jm(jnp.asarray(x), jnp.asarray(u)))
    R, S = tm.grad_input(torch.tensor(x), torch.tensor(u))
    assert R.shape == (5, 6, 3, 3) and S.shape == (5, 6, 3, 2)
    fR, fS = jax.jacfwd(jm, argnums=(0, 1))(jnp.asarray(x[0, 0]),
                                            jnp.asarray(u[0, 0]))
    _close(R[2, 3], fR)
    _close(S[2, 3], fS)


def test_ctrl_passthrough_matches_jax():
    A, Bm, c = _affine_arrays(nc=1)
    jm = JPassthrough(JAffine(jnp.asarray(A), jnp.asarray(Bm),
                              jnp.asarray(c)))
    jnn, tnn = both_mlps(mlp_params((6,)), 'elu')
    jnn = JPassthrough(jnn)
    rng = np.random.RandomState(5)
    tx, u = rng.randn(7, 4), rng.randn(7, 1)
    for tm, ref in ((CtrlPassthroughDynamics(affine_from_numpy(
            A, Bm, c, device='cpu')), jm),
            (CtrlPassthroughDynamics(tnn), jnn)):
        _close(tm(torch.tensor(tx), torch.tensor(u)),
               ref(jnp.asarray(tx), jnp.asarray(u)))
        got = torch.func.jacfwd(tm, argnums=(0, 1))(torch.tensor(tx[0]),
                                                    torch.tensor(u[0]))
        want = jax.jacfwd(ref, argnums=(0, 1))(jnp.asarray(tx[0]),
                                               jnp.asarray(u[0]))
        _close(got[0], want[0])
        _close(got[1], want[1])
    # the wrapped MLP's parameters are the wrapper's
    assert len(list(CtrlPassthroughDynamics(tnn).parameters())) == 4


def test_pseudo_huber_matches_jax():
    rng = np.random.RandomState(6)
    w, goal = rng.rand(4) + 0.5, rng.randn(4)
    jc = JPseudoHuber(jnp.asarray(w), jnp.asarray(goal), 0.7)
    tc = pseudo_huber_from_numpy(w, goal, 0.7, device='cpu')
    assert isinstance(tc, PseudoHuberCost)
    tau = rng.randn(3, 5, 4)
    _close(tc(torch.tensor(tau)), jax.vmap(jax.vmap(jc))(jnp.asarray(tau)))
    t0 = torch.tensor(tau[1, 2])
    _close(torch.func.grad(tc)(t0), jax.grad(jc)(jnp.asarray(tau[1, 2])))
    _close(torch.func.hessian(tc)(t0),
           jax.hessian(jc)(jnp.asarray(tau[1, 2])))


# ---------------------------------------------------------------------------
# solves through MPC against mpc_tpu.MPC
# ---------------------------------------------------------------------------

def _mpc_kw(T, nc, **kw):
    base = dict(lqr_iter=6, eps=1e-10, exit_unconverged=False,
                detach_unconverged=False, backprop=False,
                linesearch_decay=0.2, max_linesearch_iter=4,
                use_fused='never')
    base.update(kw)
    return base


def test_affine_solve_matches_mpc_tpu():
    T, B, nc = 6, 5, 2
    A, Bm, c = _affine_arrays(nc=nc)
    rng = np.random.RandomState(7)
    x0 = rng.randn(B, 3)
    C = np.tile(np.diag([1., 0.5, 0.3, 0.1, 0.2]), (T, B, 1, 1))
    cv = 0.5 * rng.randn(T, B, 3 + nc)
    ref = mpc_tpu.MPC(3, nc, T, u_lower=-0.4, u_upper=0.4,
                      **_mpc_kw(T, nc))(
        jnp.asarray(x0), mpc_tpu.QuadCost(jnp.asarray(C), jnp.asarray(cv)),
        JAffine(jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(c)))
    dx = affine_from_numpy(A, Bm, c, device='cpu')
    assert fused.scope_gap(mt.MPCConfig(3, nc, T), None, dx) is not None
    got = mt.MPC(3, nc, T, u_lower=-0.4, u_upper=0.4, device='cpu',
                 **_mpc_kw(T, nc))(
        torch.tensor(x0), mt.QuadCost(torch.tensor(C), torch.tensor(cv)), dx)
    assert (np.abs(got[1].numpy()) == 0.4).mean() > 0.05   # the box acts
    for a, b in zip(got[:2], ref[:2]):
        _close(a, b, 1e-10)


def test_pseudo_huber_solve_matches_mpc_tpu():
    T, B = 5, 6
    rng = np.random.RandomState(8)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    w, goal = np.array([1., 1., 0.1, 0.01]), np.array([1., 0., 0., 0.])
    params = np.array([10., 1., 1.])
    # eps 1e-3: the pendulum's last accepted steps are real ones, not
    # round-off ties that two line searches may rightly break apart
    kw = _mpc_kw(T, 1, grad_method=mpc_tpu.GradMethods.AUTO_DIFF, eps=1e-3,
                 lqr_iter=10)
    ref = mpc_tpu.MPC(3, 1, T, u_lower=-2., u_upper=2., **kw)(
        jnp.asarray(x0), JPseudoHuber(jnp.asarray(w), jnp.asarray(goal), 0.5),
        JPendulumDx(params=jnp.asarray(params)))
    kw['grad_method'] = mt.GradMethods.AUTO_DIFF
    got = mt.MPC(3, 1, T, u_lower=-2., u_upper=2., device='cpu', **kw)(
        torch.tensor(x0), pseudo_huber_from_numpy(w, goal, 0.5, device='cpu'),
        mt.models.PendulumDx(params=torch.tensor(params), device='cpu'))
    for a, b in zip(got, ref):
        _close(a, b, 1e-10)


def test_pseudo_huber_solve_kernel_route_matches_mpc_tpu():
    """The eager route's problem above (``_mpc_kw`` pins
    use_fused='never') on the kernel route: the plain K1's cost build on
    the CPU, no eager solve, against the same jnp-path reference at the
    kernel route's float64 tolerance (tests/test_torch_huber.py)."""
    T, B = 5, 6
    rng = np.random.RandomState(8)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    w, goal = np.array([1., 1., 0.1, 0.01]), np.array([1., 0., 0., 0.])
    params = np.array([10., 1., 1.])
    kw = _mpc_kw(T, 1, grad_method=mpc_tpu.GradMethods.AUTO_DIFF, eps=1e-3,
                 lqr_iter=10)
    ref = mpc_tpu.MPC(3, 1, T, u_lower=-2., u_upper=2., **kw)(
        jnp.asarray(x0), JPseudoHuber(jnp.asarray(w), jnp.asarray(goal), 0.5),
        JPendulumDx(params=jnp.asarray(params)))
    kw.update(grad_method=mt.GradMethods.AUTO_DIFF, use_fused='always')
    solver.reset_eager_counts()
    got = mt.MPC(3, 1, T, u_lower=-2., u_upper=2., device='cpu', **kw)(
        torch.tensor(x0), pseudo_huber_from_numpy(w, goal, 0.5, device='cpu'),
        mt.models.PendulumDx(params=torch.tensor(params), device='cpu'))
    assert solver.eager_counts['eager_solve'] == 0
    for a, b in zip(got, ref):
        _close(a, b, 1e-9)
