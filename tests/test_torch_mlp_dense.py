"""The dense configuration's MLP build on the CPU, against mpc_tpu in
float64 (its plain version stands in for csrc/fused_ilqr_dense.cu's
MPC_MODEL 4 here):

- (1) ``NNDynamics.soa_step`` against mpc_tpu's ``soa_step`` and
  ``soa_jacobian`` against ``jax.jacfwd`` of it, 1e-12, at 1 to 3 hidden
  layers, each activation, passthrough on and off, 1, 2 and 4 controls;
  the slew passthrough ``fused.SlewSoA`` at 2 controls against
  ``_SlewSoA``; a saturated sigmoid stays finite;
- (2) whole solves on the kernel route (the plain dense version with the
  MLP) against ``mpc_tpu.learning.batched_solve(use_fused='never')`` with
  the same iteration budget: u, x and costs within 1e-8 relative, 1e-6
  where several bounded controls meet the box QP's stop (``SOLVE_TOL``);
- (3) the plain version in float32 against mpc_tpu's interpret-mode Pallas
  kernel, stream mode (3s2c, H=8) and tuple mode ((16, 8) at 3s1c), T=4,
  B=8, atol 5e-4 excluding alpha (tests/test_fused_nn.py:_compare);
- (4) gradients of a differentiable 3s2c solve to the weights and x_init
  (phase 2 the plain dense backward) against ``jax.grad`` through the jnp
  path, 1e-8 relative, with and without a box;
- (5) the routes: every row of ``utils/problems.MLP_ROWS`` admitted, K3
  keeps the one-hidden-layer 3s1c MLP, a deeper 3s1c MLP goes dense, the
  gate's refusals name their reason and 'always' raises them; the op's
  schema, an export, the operation counts and the shared memory.

The kernel route sits up to ~1e-9 from the jnp path where both take the
same decisions (test_torch_soa.py's note: the jnp PNQP adds 1e-11 to the
control block); several bounded controls meet the PNQP's stop at ties
(1e-6 measured there, as with u_zero_I's multi-control problems).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.learning import batched_solve as j_batched_solve
from mpc_tpu.models import NNDynamics as JNN
from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch import solver
from mpc_tpu_torch.ops import fused, fused_dense as fd
from mpc_tpu_torch.utils import export as ex
from mpc_tpu_torch.utils.convert import nn_dynamics_from_numpy
from mpc_tpu_torch.utils.problems import MLP_ROWS, mlp_row, mlp_weights

jax.config.update('jax_enable_x64', True)

STEP_TOL = 1e-12
SOLVE_TOL = 1e-8
SOLVE_TOL_PNQP = 1e-6
PALLAS_ATOL = 5e-4
GRAD_TOL = 1e-8


def _rel(got, ref, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (name, err)


def _models(ns, nc, hidden, act='sigmoid', passthrough=True, seed=0,
            dtype=np.float64):
    """The same MLP in both packages, weights from a numpy seed."""
    w = [(W.astype(dtype), b.astype(dtype)) for W, b in
         mlp_weights((ns + nc,) + tuple(hidden) + (ns,), seed)]
    jm = JNN([(jnp.asarray(W), jnp.asarray(b)) for W, b in w], act,
             passthrough, ns, nc)
    tm = nn_dynamics_from_numpy(w, act, passthrough, device='cpu')
    return jm, tm


def _ctrl(u, nc):
    """A control argument of soa_step: a component, or a tuple."""
    return u[:, 0] if nc == 1 else tuple(u[:, i] for i in range(nc))


# ---------------------------------------------------------------------------
# (1) the step and its Jacobian
# ---------------------------------------------------------------------------

STEP_CASES = [((7,), 'sigmoid', True, 1), ((5, 6), 'relu', False, 2),
              ((4, 3, 5), 'elu', True, 4), ((6, 4), 'sigmoid', False, 1),
              ((9,), 'elu', False, 2), ((3, 5, 4), 'relu', True, 1)]


@pytest.mark.parametrize('hidden,act,passthrough,nc', STEP_CASES)
def test_mlp_step_and_jacobian_match_jax(hidden, act, passthrough, nc):
    ns = 3
    jm, tm = _models(ns, nc, hidden, act, passthrough)
    rng = np.random.RandomState(1)
    x, u = 2 * rng.randn(12, ns), 2 * rng.randn(12, nc)
    w = tm.kernel_params().detach()
    np.testing.assert_array_equal(w.numpy(), np.asarray(jm.soa_params_flat()))
    ref = np.stack(jm.soa_step(tuple(jnp.asarray(x).T),
                               _ctrl(jnp.asarray(u), nc),
                               jm.soa_params()), 1)
    got = torch.stack(tm.soa_step(tuple(torch.tensor(x).unbind(-1)),
                                  _ctrl(torch.tensor(u), nc), w), -1)
    _rel(got, ref, STEP_TOL, 'step')

    def f(z):
        return jnp.stack(jm.soa_step(
            tuple(z[:ns]), z[ns] if nc == 1 else tuple(z[ns:]),
            jm.soa_params()))
    J = np.asarray(jax.vmap(jax.jacfwd(f))(jnp.asarray(np.c_[x, u])))
    rows = tm.soa_jacobian(tuple(torch.tensor(x).unbind(-1)),
                           _ctrl(torch.tensor(u), nc), w)
    got = torch.stack([torch.stack(r, -1) for r in rows], -2)
    _rel(got, J, STEP_TOL, 'jacobian')


@pytest.mark.parametrize('hidden,act,nc', [((7,), 'sigmoid', 1),
                                           ((33, 33), 'elu', 2),
                                           ((100, 7, 100), 'relu', 1),
                                           ((100,), 'sigmoid', 4),
                                           ((225, 33, 7, 225), 'sigmoid', 1)])
def test_the_kernels_step_sums_its_output_layer_over_the_lanes(hidden, act,
                                                               nc):
    """fused_dense.mlp_step_lanes, the MLP build's step with each output's
    dot product split over a warp's lanes (csrc/nn_dense.cuh:mlp_step), in
    float64 within 1e-12 of NNDynamics.soa_step (mpc_tpu's order), which
    stays as it is; widths below and past 32, 1 to 4 hidden layers."""
    ns = 3
    model = _models(ns, nc, hidden, act, True, seed=len(hidden))[1]
    p = model.kernel_params().detach()
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randn(40, ns))
    u = torch.tensor(rng.randn(40, nc))
    us = u[:, 0] if nc == 1 else tuple(u.unbind(-1))
    ref = torch.stack(model.soa_step(tuple(x.unbind(-1)), us, p), -1)
    got = torch.stack(fd.mlp_step_lanes(model, tuple(x.unbind(-1)), us, p),
                      -1)
    _rel(got, ref, STEP_TOL, 'lanes step')


def test_slew_mlp_matches_jax_at_two_controls():
    ns, nc = 3, 2
    jm, tm = _models(ns, nc, (6, 5), 'elu', True, seed=2)
    js, ts = jfused._SlewSoA(jm, nc), fused.SlewSoA(tm, nc)
    assert ts.n_state == ns + nc
    rng = np.random.RandomState(3)
    x, u = rng.randn(9, ns + nc), rng.randn(9, nc)
    w = tm.kernel_params().detach()
    ref = np.stack(js.soa_step(tuple(jnp.asarray(x).T),
                               _ctrl(jnp.asarray(u), nc),
                               jm.soa_params()), 1)
    got = torch.stack(ts.soa_step(tuple(torch.tensor(x).unbind(-1)),
                                  _ctrl(torch.tensor(u), nc), w), -1)
    _rel(got, ref, STEP_TOL, 'step')

    def f(z):
        return jnp.stack(js.soa_step(tuple(z[:ns + nc]), tuple(z[ns + nc:]),
                                     jm.soa_params()))
    J = np.asarray(jax.vmap(jax.jacfwd(f))(jnp.asarray(np.c_[x, u])))
    rows = ts.soa_jacobian(tuple(torch.tensor(x).unbind(-1)),
                           _ctrl(torch.tensor(u), nc), w)
    got = torch.stack([torch.stack(r, -1) for r in rows], -2)
    _rel(got, J, STEP_TOL, 'jacobian')


def test_saturated_sigmoid_jacobian_is_finite():
    """Pre-activations of |v| >> 88 (tests/test_fused_nn.py:69-88): the
    sigmoid through tanh keeps the step and its Jacobian finite, in
    float32 too."""
    w = mlp_weights((4, 6, 5, 3), 4)
    w[0] = (500.0 * w[0][0], w[0][1] - 200.0)
    tm = nn_dynamics_from_numpy(w, 'sigmoid', True, device='cpu').float()
    xs = tuple(torch.tensor([1.0, -3.0, 40.0]).unbind(-1))
    u = torch.tensor(0.3)
    p = tm.kernel_params().detach()
    assert all(torch.isfinite(v) for v in tm.soa_step(xs, u, p))
    assert all(torch.isfinite(v) for r in tm.soa_jacobian(xs, u, p)
               for v in r)


# ---------------------------------------------------------------------------
# (2) whole solves against the jnp path
# ---------------------------------------------------------------------------

def _custom(ns, nc, hidden, T, B, slew=None, act='sigmoid', seed=0,
            box=1.0):
    """A problem of both packages' inputs: weights, starts, a shared
    diagonal cost with a linear term, a box."""
    rng = np.random.RandomState(seed + 7)
    nt = ns + nc
    cfg = dict(lqr_iter=6, eps=1e-6, linesearch_decay=0.2,
               max_linesearch_iter=3)
    if slew is not None:
        cfg['slew_rate_penalty'] = slew
    return dict(weights=mlp_weights((nt,) + tuple(hidden) + (ns,), seed),
                activation=act, passthrough=True, n_state=ns, n_ctrl=nc,
                T=T, cfg=cfg, x0=rng.randn(B, ns),
                C=np.diag(rng.uniform(0.2, 1.0, nt)), c=0.2 * rng.randn(nt),
                u_lower=None if box is None else -box,
                u_upper=None if box is None else box,
                prev_ctrl=None if slew is None else rng.uniform(
                    -0.5, 0.5, (B, nc)))


def _solve_both(r, dtype=np.float64, grad_method=None):
    """The port's kernel route on the CPU (the plain dense version) and
    mpc_tpu's jnp path on the row ``r``: (port Solution, jax Solution)."""
    base = dict(n_state=r['n_state'], n_ctrl=r['n_ctrl'], T=r['T'],
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, **r['cfg'])
    jm = JNN([(jnp.asarray(W, dtype), jnp.asarray(b, dtype))
              for W, b in r['weights']], r['activation'], r['passthrough'],
             r['n_state'], r['n_ctrl'])
    tm = nn_dynamics_from_numpy([(W.astype(dtype), b.astype(dtype))
                                 for W, b in r['weights']], r['activation'],
                                r['passthrough'], device='cpu')
    box = {} if r['u_lower'] is None else dict(u_lower=r['u_lower'],
                                               u_upper=r['u_upper'])
    prev = r['prev_ctrl']
    cfg = mt.MPCConfig(**base, grad_method=mt.GradMethods.AUTO_DIFF)
    cost = mt.QuadCost(torch.tensor(r['C'], dtype=getattr(torch, np.dtype(
        dtype).name)), torch.tensor(r['c'], dtype=getattr(
            torch, np.dtype(dtype).name)))
    x0 = torch.tensor(r['x0'].astype(dtype))
    assert fused.scope_gap(cfg, cost, tm, dtype=x0.dtype) is None
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, tm, device='cpu',
                           prev_ctrl=None if prev is None else torch.tensor(
                               prev.astype(dtype)), **box)
    assert solver.eager_counts['eager_solve'] == 0
    jcfg = mpc_tpu.MPCConfig(**base, grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             use_fused='never')
    ref = jax.jit(lambda x, C, c: j_batched_solve(
        jcfg, x, mpc_tpu.QuadCost(C, c), jm,
        prev_ctrl=None if prev is None else jnp.asarray(prev, dtype),
        **box))(jnp.asarray(r['x0'], dtype), jnp.asarray(r['C'], dtype),
                jnp.asarray(r['c'], dtype))
    return sol, ref


# (label, row, tolerance): the learned-dynamics rows and other sizes,
# cut for the CPU
SOLVES = [
    ('3s2c H=23', lambda: _custom(3, 2, (23,), 8, 6), SOLVE_TOL_PNQP),
    ('3s2c H=23 unbounded', lambda: _custom(3, 2, (23,), 8, 6, box=None),
     SOLVE_TOL),
    ('8s4c H=16', lambda: mlp_row('mlp-multictrl', 6, T=8, hidden=(16,)),
     SOLVE_TOL_PNQP),
    ('8s4c H=16 unbounded', lambda: mlp_row('mlp-multictrl', 6, T=8,
                                            hidden=(16,), bounded=False),
     SOLVE_TOL),
    ('deep (16, 8) 3s1c', lambda: _custom(3, 1, (16, 8), 8, 6, act='elu'),
     SOLVE_TOL),
    ('deep (64, 64) 2s1c', lambda: mlp_row('mlp-deep', 4, T=4), SOLVE_TOL),
    ('slew 0.5 3s1c H=8', lambda: mlp_row('mlp-slew', 6, T=8, hidden=(8,)),
     SOLVE_TOL),
    ('slew 0.5 2s2c', lambda: _custom(2, 2, (10, 6), 6, 5, slew=0.5,
                                      act='relu'), SOLVE_TOL_PNQP),
    # past 8 controls: the box QP on the warp's tiles in the kernel
    ('2s9c H=32', lambda: _custom(2, 9, (32,), 6, 5), SOLVE_TOL_PNQP),
]


@pytest.mark.parametrize('label,make,tol', SOLVES, ids=[s[0] for s in SOLVES])
def test_mlp_solves_match_jnp_path(label, make, tol):
    r = make()
    sol, ref = _solve_both(r)
    for name in ('u', 'x', 'costs'):
        _rel(getattr(sol, name), getattr(ref, name), tol, name)
    np.testing.assert_array_equal(sol.n_iter.numpy(), np.asarray(ref.n_iter))


# ---------------------------------------------------------------------------
# (3) float32 against the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ns,nc,hidden', [(3, 2, (8,)), (3, 1, (16, 8))],
                         ids=['stream 3s2c', 'tuple (16, 8)'])
def test_plain_f32_matches_pallas_interpret(ns, nc, hidden):
    T, B = 4, 8
    jm, tm = _models(ns, nc, hidden, seed=5, dtype=np.float32)
    rng = np.random.RandomState(0)
    x0 = rng.randn(B, ns).astype(np.float32)
    kw = dict(n_state=ns, n_ctrl=nc, T=T, lqr_iter=2, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              backprop=False, linesearch_decay=0.2, max_linesearch_iter=2)
    jcfg = mpc_tpu.MPCConfig(**kw, grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             use_fused='never')
    C = jnp.broadcast_to(jnp.eye(ns + nc, dtype=jnp.float32),
                         (T, ns + nc, ns + nc))
    c = jnp.zeros((T, ns + nc), jnp.float32)
    lb = jnp.full((T, B, nc), -1.0, jnp.float32)
    streams = jfused._dyn_streams(jm, jm.soa_param_count())
    assert streams == (len(hidden) == 1)
    ref = jfused.fused_batched_solve(jcfg, jnp.asarray(x0),
                                     mpc_tpu.QuadCost(C, c), jm, u_lower=lb,
                                     u_upper=-lb, interpret=True)
    cfg = mt.MPCConfig(**kw, grad_method=mt.GradMethods.AUTO_DIFF)
    assert fused.routes_dense(tm, ns, nc)
    sol = mt.batched_solve(cfg, torch.tensor(x0), mt.QuadCost(
        torch.tensor(np.asarray(C)), torch.tensor(np.asarray(c))), tm,
        u_lower=torch.tensor(np.asarray(lb)),
        u_upper=torch.tensor(-np.asarray(lb)), device='cpu')
    for name in ('u', 'x', 'costs'):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=PALLAS_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# (4) gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('box', [1.0, None], ids=['box', 'unbounded'])
def test_mlp_gradients_match_jax_grad(box):
    r = _custom(3, 2, (9,), 5, 4, box=box, seed=3)
    r['cfg'].update(lqr_iter=10, eps=1e-9)
    rng = np.random.RandomState(8)
    wu, wx = rng.randn(r['T'], 4, 2), rng.randn(r['T'], 4, 3)
    bx = {} if box is None else dict(u_lower=-box, u_upper=box)
    base = dict(n_state=3, n_ctrl=2, T=r['T'], exit_unconverged=False,
                detach_unconverged=False, backprop=True, **r['cfg'])

    tm = nn_dynamics_from_numpy(r['weights'], 'sigmoid', True, device='cpu')
    x0 = torch.tensor(r['x0'], requires_grad=True)
    cfg = mt.MPCConfig(**base, grad_method=mt.GradMethods.AUTO_DIFF)
    cost = mt.QuadCost(torch.tensor(r['C']), torch.tensor(r['c']))
    assert fused.scope_gap(cfg, cost, tm, dtype=torch.float64) is None
    solver.reset_eager_counts()
    sol = mt.batched_solve(cfg, x0, cost, tm, device='cpu', **bx)
    loss = (sol.u * torch.tensor(wu)).sum() + (sol.x * torch.tensor(wx)).sum()
    params = [p for lin in tm.layers for p in (lin.weight, lin.bias)]
    grads = torch.autograd.grad(loss, params + [x0])
    assert solver.eager_counts == {'eager_solve': 0, 'eager_fixed_point': 0}

    def jloss(ws, x):
        jm = JNN([tuple(p) for p in ws], 'sigmoid', True, 3, 2)
        s = j_batched_solve(mpc_tpu.MPCConfig(
            **base, grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
            use_fused='never'), x, mpc_tpu.QuadCost(
                jnp.asarray(r['C']), jnp.asarray(r['c'])), jm, **bx)
        return (s.u * wu).sum() + (s.x * wx).sum()

    ws = [(jnp.asarray(W), jnp.asarray(b)) for W, b in r['weights']]
    jg_w, jg_x = jax.jit(jax.grad(jloss, (0, 1)))(ws, jnp.asarray(r["x0"]))
    refs = [g for pair in jg_w for g in pair] + [jg_x]
    for i, (g, ref) in enumerate(zip(grads, refs)):
        _rel(g, ref, GRAD_TOL, f'gradient {i}')


# ---------------------------------------------------------------------------
# (5) routes, gate, op, export, counts
# ---------------------------------------------------------------------------

def _mlp(ns, nc, hidden, act='sigmoid'):
    return mt.NNDynamics.init(ns, nc, hidden, act, generator=torch.Generator(
        ).manual_seed(0), device='cpu')


def _cfg(ns, nc, T=20, **kw):
    return mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T, **kw)


def _eye_cost(nt):
    return mt.QuadCost(torch.eye(nt), torch.zeros(nt))


@pytest.mark.parametrize('label', list(MLP_ROWS))
def test_each_row_routes_to_the_mlp_build(label):
    ns, nc, hidden, act, _, T, kw, _ = MLP_ROWS[label]
    model = _mlp(ns, nc, hidden, act)
    cfg = _cfg(ns, nc, T, **kw)
    slew = kw.get('slew_rate_penalty') is not None
    assert fused.scope_gap(cfg, _eye_cost(ns + nc + (nc if slew else 0)),
                           model, u_lower=-1.0) is None
    dyn = fused.SlewSoA(model, nc) if slew else model
    assert fused.routes_dense(dyn, ns + (nc if slew else 0), nc)
    assert fd.dense_model(dyn) == ('mlp', slew)
    # the block's shared memory: weights, tiles and scratch within 227 KB
    geo = fd.k3d_launch(T, 2048, dyn.n_state, nc, 3, True, model.sizes)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    # (the scratch rounded to 16-byte rows where the Jacobian chunk's rows
    # are vector loads or the layout prefetches)
    pre = fd.dense_prefetch(dyn.n_state, nc, model.sizes)
    chunk = geo['chunk']
    scratch = max(fd._mlp_base_floats(model.sizes),
                  chunk * fd._mlp_slot_floats(model.sizes))
    assert geo['smem_bytes'] == 4 * (
        fd.DENSE_WARPS * (fd._warp_floats(dyn.n_state, nc, pre)
                          + (-(-scratch // 4) * 4 if pre or chunk > 1
                             else scratch))
        + fd.mlp_weight_floats(model.sizes))


# Each MLP_ROWS row's blocks an SM by shared memory (fused_dense.
# blocks_an_sm) with the Jacobian pass one step at a time, the footprint
# the chunk may not cost: 10,344, 25,360 and 22,432 bytes a block.
ONE_STEP_BLOCKS = {'mlp-slew': 16, 'mlp-deep': 8, 'mlp-multictrl': 9}


@pytest.mark.parametrize('label', list(MLP_ROWS))
def test_the_jacobian_chunk_keeps_the_blocks_an_sm(label):
    """The chunk is sized from the shared memory left: at every MLP_ROWS
    row the block keeps the one-step design's blocks an SM, and the chunk
    is the most steps (up to MLP_MAX_CHUNK) that does."""
    ns, nc, hid = MLP_ROWS[label][:3]
    slew = label == 'mlp-slew'
    ns_k = ns + (nc if slew else 0)
    sizes = (ns + nc,) + hid + (ns,)
    geo = fd.k3d_launch(20, 2048, ns_k, nc, 5, True, sizes)
    one = fd.k3d_smem_bytes(ns_k, nc, sizes, chunk=1)
    assert fd.blocks_an_sm(one) == ONE_STEP_BLOCKS[label]
    assert fd.blocks_an_sm(geo['smem_bytes']) >= ONE_STEP_BLOCKS[label]
    chunk = geo['chunk']
    assert chunk == fd.mlp_chunk(ns_k, nc, sizes) and chunk > 1
    assert geo['smem_bytes'] == fd.k3d_smem_bytes(ns_k, nc, sizes)
    if chunk < fd.MLP_MAX_CHUNK:
        more = fd.k3d_smem_bytes(ns_k, nc, sizes, chunk=chunk + 1)
        assert fd.blocks_an_sm(more) < ONE_STEP_BLOCKS[label]
    # with one step the footprint is the one-step design's
    assert one == 4 * (fd.DENSE_WARPS * (fd._warp_floats(ns_k, nc, False)
                                         + fd._mlp_base_floats(sizes))
                       + fd.mlp_weight_floats(sizes))
    assert {'mlp-slew': 4, 'mlp-deep': 2, 'mlp-multictrl': 4}[label] == chunk


@pytest.mark.parametrize('depth', [1, 2, 3, 4])
def test_the_chunk_step_scratch_counts_its_buffers(depth):
    """A chunk step's scratch (csrc/nn_dense.cuh:mlp_slot_floats): every
    hidden layer's act', then the larger of the forward's inputs and
    activation buffers (one at two hidden layers, two past) and the
    reverse product's row buffers (n_state wide, as many)."""
    hidden = (40, 7, 33, 5)[:depth]
    sizes = (6,) + hidden + (4,)
    g = min(depth - 1, 2)
    hmid = max(hidden[:-1], default=0)
    assert fd._mlp_slot_floats(sizes) == sum(hidden) + max(
        6 + g * hmid, g * 4 * hmid)
    base = fd._mlp_base_floats(sizes)
    assert base == 40 * (2 + depth + 4 * g)
    for chunk in range(1, fd.MLP_MAX_CHUNK + 1):
        s = max(base, chunk * fd._mlp_slot_floats(sizes))
        assert fd._mlp_scratch_floats(sizes, chunk) == (
            s if chunk == 1 else -(-s // 4) * 4)
        assert fd._mlp_scratch_floats(sizes, chunk, True) % 4 == 0


@pytest.mark.parametrize('ns,nc,hidden,admitted', [
    (2, 1, (225, 225), True), (2, 1, (226, 226), False),
    (8, 4, (1644,), True), (8, 4, (1645,), False)])
def test_the_gate_keeps_its_edges(ns, nc, hidden, admitted):
    """mlp_gap admits what it admitted when the Jacobian pass took one
    step at a time, and refuses the first size past each edge: the gate
    reads the one-step footprint, and a chunk only takes the memory
    left (where none is, it is one step)."""
    model = mt.NNDynamics.shaped((ns + nc,) + hidden + (ns,), 'sigmoid',
                                 True)
    gap = fd.mlp_gap(model)
    assert (gap is None) == admitted
    if admitted:
        geo = fd.k3d_launch(20, 2048, ns, nc, 5, True, model.sizes)
        assert geo['smem_bytes'] <= fused.SMEM_LIMIT
        assert geo['chunk'] >= 1
    else:
        assert 'shared memory' in gap


def test_k3_keeps_its_mlp_and_deeper_ones_go_dense():
    cost = _eye_cost(4)
    bench = _mlp(3, 1, (100,))
    assert not fused.routes_dense(bench, 3, 1)
    assert fused.routes_long(bench, 20)
    assert fused.scope_gap(_cfg(3, 1), cost, bench) is None
    deep = _mlp(3, 1, (16, 8))
    assert fused.routes_dense(deep, 3, 1)
    assert fused.scope_gap(_cfg(3, 1), cost, deep) is None
    # under slew K3's MLP goes dense too (its 3 states become 4)
    slew = _cfg(3, 1, slew_rate_penalty=0.5)
    assert fused.scope_gap(slew, _eye_cost(5), bench) is None
    assert fused.routes_dense(fused.SlewSoA(bench, 1), 4, 1)
    # a 2-state MLP under slew has 3 augmented states and still goes dense
    assert fused.routes_dense(fused.SlewSoA(_mlp(2, 1, (8,)), 1), 3, 1)
    with pytest.raises(ValueError, match='K3 runs a one-hidden-layer'):
        fused.fused_ilqr_long(deep, deep.kernel_params().detach(), None,
                              None, None, None, torch.zeros(2, 3),
                              torch.zeros(4, 2), None, None, alphas=[1.0],
                              lqr_iter=1, eps=0.0, best_cost_eps=1e-4,
                              not_improved_lim=5.0)


def test_the_gate_names_its_reasons_and_always_raises_them():
    cost = _eye_cost(4)
    deep5 = _mlp(3, 1, (4,) * 5)
    gap = fused.scope_gap(_cfg(3, 1), cost, deep5)
    assert 'hidden layers' in gap and 'eager' in gap
    # the widest one-hidden-layer MLP at 8 states and 4 controls
    cfg8 = _cfg(8, 4)
    h = 1644
    assert fd.k3d_smem_bytes(8, 4, (12, h, 8)) <= fused.SMEM_LIMIT \
        < fd.k3d_smem_bytes(8, 4, (12, h + 1, 8))
    assert fused.scope_gap(cfg8, _eye_cost(12), _mlp(8, 4, (h,))) is None
    gap = fused.scope_gap(cfg8, _eye_cost(12), _mlp(8, 4, (h + 1,)))
    assert 'shared memory' in gap
    big = _mlp(30, 4, (8,))
    assert 'exceeds the dense' in fused.scope_gap(_cfg(30, 4), _eye_cost(34),
                                                  big)
    x0 = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError, match='hidden layers'):
        mt.batched_solve(_cfg(3, 1, T=3, use_fused='always'), x0, cost,
                         deep5, device='cpu')
    # under 'auto' it solves on the eager solver
    solver.reset_eager_counts()
    sol = mt.batched_solve(_cfg(3, 1, T=3, lqr_iter=2), x0, cost, deep5,
                           device='cpu')
    assert torch.isfinite(sol.u).all()
    assert solver.eager_counts['eager_solve'] == 1


def test_op_schema_and_its_checks():
    T, B = 3, 2
    tm = _mlp(3, 2, (5, 4))
    o = fd.k3d_operands(_cfg(3, 2, T, lqr_iter=2), torch.randn(B, 3),
                        _eye_cost(5), tm, u_lower=-1.0, u_upper=1.0)
    args = (None, None, o['C'], o['c'], o['x0'], o['u0'], o['lb'], o['ub'],
            o['alphas'], 2, 0.0, 1e-4, 5.0, 20, 'mlp', False, o['params'],
            None, None, None, [5, 5, 4, 3], 'sigmoid', True)
    torch.library.opcheck(torch.ops.mpc_tpu_torch.k3d_solve, args)
    # a weight vector of another length is refused by the launcher's checks
    from mpc_tpu_torch.ops import custom
    with pytest.raises(ValueError, match='params'):
        custom._check_dense_model('mlp', False, o['params'][:-1], None, None,
                                  3, 2, ((5, 5, 4, 3), 'sigmoid', True))
    with pytest.raises(ValueError, match='states'):
        custom._check_dense_model('mlp', False, o['params'], None, None,
                                  4, 2, ((5, 5, 4, 3), 'sigmoid', True))


def test_deep_mlp_solve_exports_as_one_node():
    T, B = 4, 3
    tm = _mlp(2, 1, (6, 5)).double()
    C, c = torch.diag(torch.tensor([1.0, 0.1, 0.001], dtype=torch.float64)), \
        torch.zeros(3, dtype=torch.float64)
    x0 = torch.tensor(np.random.RandomState(2).randn(B, 2))
    cfg = _cfg(2, 1, T, lqr_iter=3, exit_unconverged=False,
               detach_unconverged=False, backprop=False)
    data = ex.export_solve(cfg, tm, mt.QuadCost(C, c), x0, u_lower=-2.0,
                           u_upper=2.0, device='cpu')
    assert ex.kernel_nodes(data) == {'k3d_solve': 1}
    out = ex.load_fn(data)(x0, C, c)
    live = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), tm, u_lower=-2.0,
                            u_upper=2.0, device='cpu')
    assert all(torch.equal(a, b) for a, b in
               zip(out, (live.x, live.u, live.costs)))


def test_operation_counts_and_defines():
    # one hidden layer of 4 units on 2 inputs, 1 output, sigmoid
    step, jac = fd.mlp_op_counts((2, 4, 1), 'sigmoid', True)
    assert step == 2 * 2 * 4 + 2 * 4 * 1 + 4 * 4 + 1
    assert jac == 2 * 2 * 4 + 6 * 4 + 1 * 4 + 1 * 2 * (2 * 4 - 1) + 1
    # a deeper one: the middle layer's activations are needed, the last's
    # not
    step2, jac2 = fd.mlp_op_counts((2, 4, 3, 1), 'relu', False)
    assert step2 == 2 * 2 * 4 + 2 * 4 * 3 + 2 * 3 * 1
    assert jac2 == (2 * 2 * 4 + 2 * 4 * 3 + 1 * 3 + 1 * 4 * (2 * 3 - 1)
                    + 1 * 4 + 1 * 2 * (2 * 4 - 1))
    d = fd.dense_kernel_defines(4, 1, True, False, 'mlp', True, mlp=(
        (4, 100, 3), 'elu', True))
    assert d['MPC_MODEL'] == 4 and d['MPC_SLEW'] == 1
    assert d['MPC_ACT'] == 2 and d['MPC_NN_DEPTH'] == 1
    # the other models' defines carry neither
    assert 'MPC_NN_DEPTH' not in fd.dense_kernel_defines(5, 1, True, False,
                                                         'cartpole')
    ops = fd.k3d_flops(20, 2, 1, 10, 12, batch=1,
                       model_ops=fd.model_op_counts(
                           'mlp', ((3, 64, 64, 2), 'sigmoid', True)))
    lin = fd.k3d_flops(20, 2, 1, 10, 12, batch=1, model_ops=(0, 0))
    s, j = fd.mlp_op_counts((3, 64, 64, 2), 'sigmoid', True)
    assert ops - lin == 19 * s + 10 * 19 * j + 12 * 19 * s
