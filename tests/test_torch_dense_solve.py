"""The dense kernels' control solve past 8 controls across the lanes, their
tiles and their phase account, on the CPU.

- The plain back substitution past ``fused_dense.REG_CTRL_MAX`` controls
  (``_chol_solve_lanes``, the order of csrc/box_qp_smem.cuh:solve_lanes,
  terms k descending) against mpc_tpu's ``_chol_solve`` in float64 at
  nc = 9, 12, 16 and 31, one and several right-hand sides, 1e-12; the
  projected-Newton box QP (``_pnqp``, whose trial objectives the kernel now
  sums across the lanes in the same order) against ``_pnqp_kernel`` at
  the same sizes, 1e-10, the trips equal; ``_solve_rows`` at 4 and 8
  controls bitwise ``_chol_solve``, the order the register solves keep.
- The host's tile count: ``k3d_launch`` and ``k4d_launch`` under 227 KB a
  block at the gate's corners, 24s4c and every row of ``MLP_ROWS`` and
  ``WIDE_ROWS``, each admitted by ``scope_gap``, ``scope_gap_bwd`` and
  ``mlp_gap``; the layout without the prefetch never larger than the
  lane-a-row design's, so no size the gate admits is refused; the
  prefetch taken only where it keeps the blocks an SM.
- The phase account's host reader on a synthetic buffer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_tpu.ops import fused as jfused

import mpc_tpu_torch as mt
from mpc_tpu_torch.models.dynamics import NNDynamics
from mpc_tpu_torch.ops import fused, fused_bwd, fused_bwd_dense, fused_dense as fd
from mpc_tpu_torch.utils import phase_account
from mpc_tpu_torch.utils.problems import MLP_ROWS, WIDE_ROWS


def _spd(rng, n, B):
    R = rng.randn(B, n, n)
    return np.einsum('bij,bkj->bik', R, R) + 0.5 * np.eye(n)


def _lists(A):
    return [[A[:, i, j] for j in range(A.shape[2])]
            for i in range(A.shape[1])]


@pytest.mark.parametrize('n', [9, 12, 16, 31])
@pytest.mark.parametrize('rhs', [1, 5])
def test_lane_solve_matches_jax_chol_solve(n, rhs):
    """The back substitution k descending solves the same system as
    mpc_tpu's ``_chol_solve`` (k ascending): float64, 1e-12 relative."""
    rng = np.random.RandomState(7 * n + rhs)
    B = 6
    A = _spd(rng, n, B)
    b = rng.randn(B, n, rhs)
    L = fd._cholesky(_lists(torch.tensor(A)), fd.CHOL_JITTER)
    Lj = jfused._cholesky(_lists(jnp.asarray(A)), n, jitter=1e-11)
    got = fd._chol_solve_lanes(L, list(torch.tensor(b).unbind(1)))
    assert fd._solve_rows(L, list(torch.tensor(b).unbind(1)))[0].shape \
        == got[0].shape
    for r in range(rhs):
        want = jfused._chol_solve(Lj, [jnp.asarray(b[:, i, r])
                                       for i in range(n)], n)
        g = np.stack([v[:, r].numpy() for v in got], 1)
        w = np.stack([np.asarray(v) for v in want], 1)
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()
    x = np.stack([v.numpy() for v in got], 1)
    np.testing.assert_allclose(np.einsum('bij,bjr->bir', A, x), b,
                               atol=1e-8)


@pytest.mark.parametrize('n', [2, 4, 8])
def test_register_solves_keep_their_order(n):
    """Up to ``REG_CTRL_MAX`` controls the plain version keeps
    ``_chol_solve``'s order bit for bit (float32 and float64); past it
    the lanes' order differs from it in the last bits."""
    rng = np.random.RandomState(n)
    for dtype in (torch.float32, torch.float64):
        A = torch.tensor(_spd(rng, n, 64), dtype=dtype)
        b = list(torch.tensor(rng.randn(64, n), dtype=dtype).unbind(1))
        L = fd._cholesky(_lists(A), fd.CHOL_JITTER)
        for x, y in zip(fd._solve_rows(L, b), fd._chol_solve(L, b)):
            assert torch.equal(x, y)
    n = fd.REG_CTRL_MAX + 8
    A = torch.tensor(_spd(rng, n, 256), dtype=torch.float32)
    b = list(torch.tensor(rng.randn(256, n), dtype=torch.float32).unbind(1))
    L = fd._cholesky(_lists(A), fd.CHOL_JITTER)
    lanes, rows = fd._solve_rows(L, b), fd._chol_solve(L, b)
    assert any(not torch.equal(x, y) for x, y in zip(lanes, rows))
    assert all(torch.equal(x, y) for x, y in
               zip(lanes, fd._chol_solve_lanes(L, b)))


@pytest.mark.parametrize('n', [9, 12, 16, 31])
def test_lane_pnqp_matches_jax_kernel(n):
    """The box QP past 8 controls (the lanes' back substitution, the
    trial objectives in qp_objective's order) against ``_pnqp_kernel``:
    float64, x 1e-10, the free set and the trips equal."""
    B, n_iter = 12, 20
    rng = np.random.RandomState(31 * n)
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
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(ft[i].numpy(), np.asarray(fj[i]))
    x = np.stack([v.numpy() for v in xt], 1)
    assert ((x >= lo) & (x <= hi)).all()


def _parent_warp_floats(ns, nc, bwd=False):
    """A warp's tiles in the lane-a-row design the redesign replaced (Q,
    W and V of odd stride, F of ntau, the box QP's five rows past 8
    controls; the backward the factor alone)."""
    nt = ns + nc
    odd = lambda n: n | 1  # noqa: E731
    ctrl = (nc * odd(nc) + (0 if bwd else 5 * nc)) if nc > 8 else 0
    n = (nt * odd(nt) + ns * odd(nt) + ns * nt + ns * odd(ns)
         + 3 * nt + (3 if bwd else 2) * ns + 2 * nc * ns + nc + ctrl)
    return n + -n % 4


def test_single_set_layout_never_exceeds_the_lane_a_row_one():
    """Without the prefetch a warp's tiles never take more than the
    lane-a-row design's at every admitted size in the forward, so no size
    (and no MLP, which keeps one set where two do not fit) that design ran
    is refused; the backward adds only the factor's nc reciprocals past 8
    controls, and every size still fits a block."""
    for nt in range(2, 33):
        for nc in range(1, nt):
            ns = nt - nc
            assert fd._warp_floats(ns, nc, False) <= _parent_warp_floats(
                ns, nc)
            extra = nc if nc > fd.REG_CTRL_MAX else 0
            assert fused_bwd_dense._warp_floats(ns, nc, False) <= \
                _parent_warp_floats(ns, nc, True) + extra + 3
            assert fused_bwd_dense.k4d_launch(20, 1024, ns, nc)[
                'smem_bytes'] <= fused.SMEM_LIMIT


def test_prefetch_keeps_the_blocks_an_sm():
    """The second set is taken where a step's C and F are 512 floats or
    more and it keeps an SM's blocks (or 4): 20s4c, 16s4c and 1s31c
    prefetch; 24s4c (73 KB a block with it, three an SM: B = 2048 would
    take a second wave), the corners 4s28c and 23s9c, and the small
    steps (5s1c, 3s4c, the wide rows) do not."""
    for ns, nc, want in ((20, 4, True), (16, 4, True), (1, 31, True),
                         (4, 12, False), (3, 9, False), (2, 16, False),
                         (5, 1, False), (3, 4, False),
                         (24, 4, False), (4, 28, False), (23, 9, False)):
        assert fd.dense_prefetch(ns, nc) is want, (ns, nc)
        one = fd.k3d_smem_bytes(ns, nc, None, False)
        two = fd.k3d_smem_bytes(ns, nc, None, True)
        if want:
            assert fd.blocks_an_sm(two) >= min(fd.blocks_an_sm(one),
                                               fd.PREFETCH_BLOCKS)
            nt = ns + nc
            assert nt * nt + ns * nt >= fd.PREFETCH_MIN_FLOATS
        assert fd.dense_kernel_defines(ns, nc, True, False)[
            'MPC_PREFETCH'] == int(want)
        assert fused_bwd_dense.bwd_dense_kernel_defines(
            ns, nc, True, False)['MPC_PREFETCH'] == int(
                fused_bwd_dense.bwd_dense_prefetch(ns, nc))
    assert fd.blocks_an_sm(fd.k3d_smem_bytes(24, 4, None, True)) == 3
    assert fd.blocks_an_sm(fd.k3d_smem_bytes(24, 4, None, False)) == 4


def _lin(ns, nc, T=20):
    return mt.LinDx(torch.zeros(T - 1, ns, ns + nc))


CORNERS = [(1, 9), (1, 31), (4, 28), (23, 9), (24, 4)] + [
    r[:2] for r in WIDE_ROWS.values()]


@pytest.mark.parametrize('ns,nc', CORNERS)
def test_tiles_fit_and_the_gates_admit(ns, nc):
    T, B = 20, 2048
    geo = fd.k3d_launch(T, B, ns, nc, 10)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    assert geo['smem_bytes'] == 16 * fd.DENSE_WARPS * (
        -(-fd._warp_floats(ns, nc, fd.dense_prefetch(ns, nc)) // 4))
    bgeo = fused_bwd_dense.k4d_launch(T, B, ns, nc)
    assert bgeo['smem_bytes'] <= fused.SMEM_LIMIT
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T)
    cost = mt.QuadCost(torch.eye(ns + nc), torch.zeros(ns + nc))
    assert fused.scope_gap(cfg, cost, _lin(ns, nc, T)) is None
    assert fused_bwd.scope_gap_bwd(T, nc, n_state=ns) is None
    assert fused_bwd.scope_gap_bwd(T, nc, device=torch.device('cuda'),
                                   n_state=ns) is None


@pytest.mark.parametrize('label', list(MLP_ROWS))
def test_mlp_rows_fit_and_are_admitted(label):
    ns, nc, hid, act, passthrough = MLP_ROWS[label][:5]
    slew = label == 'mlp-slew'
    model = NNDynamics.shaped((ns + nc,) + hid + (ns,), act, passthrough)
    assert fd.mlp_gap(model, nc if slew else 0) is None
    ns_k = ns + (nc if slew else 0)
    sizes = model.sizes
    geo = fd.k3d_launch(20, 2048, ns_k, nc, 5, True, sizes)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    assert geo['smem_bytes'] == fd.k3d_smem_bytes(
        ns_k, nc, sizes, fd.dense_prefetch(ns_k, nc, sizes))


def test_an_mlp_whose_weights_fill_the_block_keeps_one_set():
    """An MLP admitted only without the second set still runs in the
    kernel: its build keeps one set (MPC_PREFETCH 0), within 227 KB."""
    assert fd.dense_prefetch(20, 4, (24, 100, 20))
    for h in range(700, 900):
        model = NNDynamics.shaped((24, h, 20), 'sigmoid', True)
        one = fd.k3d_smem_bytes(20, 4, model.sizes, False)
        two = fd.k3d_smem_bytes(20, 4, model.sizes, True)
        if one <= fused.SMEM_LIMIT < two:
            break
    else:
        pytest.fail('no width between one and two sets')
    assert fd.mlp_gap(model) is None
    assert not fd.dense_prefetch(20, 4, model.sizes)
    assert fd.dense_kernel_defines(20, 4, True, False, 'mlp', mlp=(
        model.sizes, 'sigmoid', True))['MPC_PREFETCH'] == 0
    assert fd.k3d_launch(20, 64, 20, 4, 5, True, model.sizes)[
        'smem_bytes'] == one


def test_phase_account_reader():
    """The clocks buffer [B, phases] to each phase's share of the warps'
    cycles and its mean cycles a warp, largest first in the line."""
    P = len(fd.PHASES)
    assert fd.PHASES[:5] == ('jacobians', 'jac_reverse', 'stage', 'W',
                             'Q') and P == 11
    # the counters stay 12 floats a warp (phase_clock.cuh:kClockFloats)
    assert fd.PHASE_CLOCK_FLOATS == 12
    c = torch.zeros(4, P, dtype=torch.int64)
    c[:, fd.PHASES.index('W')] = torch.tensor([100, 200, 300, 400])
    c[:, fd.PHASES.index('factor')] = 250
    c[0, fd.PHASES.index('rollouts')] = 1000
    shares = phase_account.phase_shares(c)
    assert set(shares) == {'W', 'factor', 'rollouts'}
    assert shares['W'] == (1000 / 3000, 250.0)
    assert shares['factor'] == (1000 / 3000, 250.0)
    assert abs(sum(v[0] for v in shares.values()) - 1.0) < 1e-12
    line = phase_account.format_shares(shares)
    assert line.startswith('W 33.3% (250)') or line.startswith(
        'factor 33.3% (250)')
    assert 'rollouts 33.3% (250)' in line
    with pytest.raises(ValueError):
        phase_account.phase_shares(torch.zeros(3, P - 1))
    with pytest.raises(ValueError):
        phase_account.phase_shares(torch.zeros(3, P))
