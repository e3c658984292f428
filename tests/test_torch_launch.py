"""The launch geometry of kernels K1 to K4, and what the plain versions
of K1 and K3 pin for the kernels' design.

The kernels run only on the card, but how they are launched (team
width, examples and warps a block, blocks, shared memory, workspace) is
plain Python in mpc_tpu_torch/ops/fused.py (K1, K3) and
mpc_tpu_torch/ops/fused_bwd.py (K2, K4), and is held here: shared memory
never above what a block may use, every example covered once,
``routes_long`` in step with the re-derived ``T_MAX`` and
``bwd_routes_long`` with ``T_MAX_BWD``, the workspace as large as the
geometry says.  Two more tests pin what the team design
rests on in the plain versions: stats[5] is the selected step size's
index plus one summed over the iterations (not the rollouts executed),
and K1's carried cost equals a recomputed one bit for bit.
"""

import numpy as np
import pytest
import torch

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused, fused_bwd

BATCHES = [0, 1, 33, 2050, 4096]
ALPHAS = [1, 3, 5, 32]
HORIZONS = [2, 20, fused.T_MAX, fused.T_MAX + 1, fused.K3_T_RESIDENT,
            fused.K3_T_RESIDENT + 1, 600]


def test_t_max_is_what_shared_memory_holds():
    per_step = fused.k1_launch(1, 1, fused.MAX_ALPHA)['smem_bytes']
    assert per_step == (32 * fused.K1_WARPS // fused.TEAM) * (
        6 + fused.TEAM) * 16
    assert fused.T_MAX * per_step <= fused.SMEM_LIMIT
    assert (fused.T_MAX + 1) * per_step > fused.SMEM_LIMIT
    assert fused.SMEM_LIMIT == 232448
    assert fused.T_MAX == 181


@pytest.mark.parametrize('n_alpha', ALPHAS)
@pytest.mark.parametrize('B', BATCHES)
@pytest.mark.parametrize('T', HORIZONS)
def test_k1_launch_geometry(T, B, n_alpha):
    geo = fused.k1_launch(T, B, n_alpha)
    assert geo['team'] == fused.TEAM and 32 % geo['team'] == 0
    assert geo['examples'] * geo['team'] == 32 * geo['warps']
    # every example in exactly one block, no empty block
    assert geo['blocks'] * geo['examples'] >= B
    assert (geo['blocks'] - 1) * geo['examples'] < B or B == 0
    assert geo['blocks'] == 0 or B > 0
    # (K, k), three rows of F, C tau + c, the current trajectory and one
    # trial slot for each lane that rolls out
    assert geo['slots'] == 5 + 1 + min(n_alpha, fused.TEAM)
    assert geo['smem_bytes'] == T * geo['slots'] * geo['examples'] * 16
    dx = PendulumDx(device='cpu')
    if not fused.routes_long(dx, T):
        assert T <= fused.T_MAX
        assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    else:
        assert T > fused.T_MAX
        if n_alpha >= fused.TEAM:
            assert geo['smem_bytes'] > fused.SMEM_LIMIT


@pytest.mark.parametrize('n_alpha', ALPHAS)
@pytest.mark.parametrize('B', BATCHES)
@pytest.mark.parametrize('T', HORIZONS)
def test_k3_launch_geometry_and_workspace(T, B, n_alpha):
    geo = fused.k3_launch(T, B, n_alpha)
    assert geo['team'] == fused.TEAM and geo['warps'] == fused.K3_WARPS
    assert geo['examples'] * geo['team'] == 32 * geo['warps']
    assert geo['blocks'] * geo['examples'] >= B
    assert (geo['blocks'] - 1) * geo['examples'] < B or B == 0
    # the state (gains and current trajectory, two float4 a step and
    # example) and the block's copy of the shared operands (40 floats a
    # step for LinDx with a QuadCost and bounds) are resident in shared
    # memory where they fit; else the state takes two more slots of the
    # workspace, which each lane reads through a ring of K3_RING steps of
    # two float4 in shared memory, beside the operands' copy where it
    # fits, so any T runs
    state = T * 2 * 16 * geo['examples']
    ops = T * 40 * 4
    resident = state + ops <= fused.SMEM_LIMIT
    assert resident == (T <= fused.K3_T_RESIDENT) == geo['resident']
    if not resident:
        state = fused.K3_RING * 2 * 16 * 32 * geo['warps']
    staged = state + ops <= fused.SMEM_LIMIT
    assert geo['staged'] == staged
    assert geo['smem_bytes'] == state + (ops if staged else 0)
    assert geo['smem_bytes'] <= fused.SMEM_LIMIT
    assert geo['slots'] == min(n_alpha, fused.TEAM) + (0 if resident else 2)
    assert geo['workspace_bytes'] == T * geo['slots'] * B * 16
    # the wrapper's allocation is what the geometry says (at a batch
    # small enough to allocate here)
    small = fused.k3_launch(T, min(B, 33), n_alpha)
    ws = fused.k3_workspace(small, T, min(B, 33), 'cpu')
    assert ws.dtype == torch.float32 and ws.is_contiguous()
    assert ws.shape == (T, geo['slots'], min(B, 33), 4)
    assert ws.numel() * ws.element_size() == small['workspace_bytes']


def test_main_path_geometries():
    """The shapes chip_smoke.py drives: the headline, config 4 and the
    long configuration."""
    head = fused.k1_launch(20, 4096, 5)
    assert head == dict(team=4, warps=1, examples=8, blocks=512, slots=10,
                        smem_bytes=25600)
    train = fused.k1_launch(10, 1024, 3)
    assert (train['blocks'], train['slots'], train['smem_bytes']) == (
        128, 9, 11520)
    assert fused.k1_launch(10, 8192, 3)['blocks'] == 1024
    long = fused.k3_launch(160, 4096, 3)
    assert long == dict(team=4, warps=4, examples=32, blocks=128, slots=3,
                        smem_bytes=189440, workspace_bytes=31457280,
                        resident=True, staged=True)
    assert fused.K3_T_RESIDENT == 196
    assert fused.k3_launch(384, 1024, 2) == dict(
        team=4, warps=4, examples=32, blocks=32, slots=4,
        smem_bytes=32768 + 384 * 160, workspace_bytes=384 * 4 * 1024 * 16,
        resident=False, staged=True)


def test_routes_long_follows_t_max():
    dx = PendulumDx(device='cpu')
    lin = mt.LinDx(torch.zeros(3, 3, 4), None)
    assert not fused.routes_long(dx, 2)
    assert not fused.routes_long(dx, fused.T_MAX)
    assert fused.routes_long(dx, fused.T_MAX + 1)
    assert fused.routes_long(lin, 4) and fused.routes_long(lin, 600)


BWD_HORIZONS = [2, 10, fused_bwd.T_MAX_BWD, fused_bwd.T_MAX_BWD + 1,
                fused_bwd.K4_T_RESIDENT, fused_bwd.K4_T_RESIDENT + 1, 600]


def _bwd_smem(T, examples):
    """A block's state, T * (9 * examples + 1) floats padded to float4,
    and its copy of the batch-shared C, c and F, 32 floats a step."""
    state = T * (9 * examples + 1)
    return 4 * (state + -state % 4 + 32 * T)


def _assert_covers(geo, B):
    """Every example in exactly one block, no empty block, and a warp
    for each thread of the team, a lane an example."""
    assert geo['warps'] == geo['team'] and geo['examples'] <= 32
    assert geo['blocks'] * geo['examples'] >= B
    assert (geo['blocks'] - 1) * geo['examples'] < B or B == 0
    assert geo['blocks'] == 0 or B > 0


def test_t_max_bwd_is_what_shared_memory_holds():
    assert fused_bwd.SMEM_LIMIT == fused.SMEM_LIMIT == 232448
    e2, e4 = fused_bwd.K2_EXAMPLES, fused_bwd.K4_EXAMPLES
    assert _bwd_smem(fused_bwd.T_MAX_BWD, e2) <= fused_bwd.SMEM_LIMIT
    assert _bwd_smem(fused_bwd.T_MAX_BWD + 1, e2) > fused_bwd.SMEM_LIMIT
    assert _bwd_smem(fused_bwd.K4_T_RESIDENT, e4) <= fused_bwd.SMEM_LIMIT
    assert _bwd_smem(fused_bwd.K4_T_RESIDENT + 1, e4) > fused_bwd.SMEM_LIMIT
    # every horizon K1 solves has a K2 backward; the long configuration's
    # T = 160 is resident in K4
    assert fused_bwd.T_MAX_BWD >= fused.T_MAX
    assert fused_bwd.T_MAX_BWD == 181 and fused_bwd.K4_T_RESIDENT == 181


@pytest.mark.parametrize('B', BATCHES)
@pytest.mark.parametrize('T', BWD_HORIZONS)
def test_k2_launch_geometry(T, B):
    geo = fused_bwd.k2_launch(T, B)
    assert (geo['team'], geo['examples']) == (fused_bwd.K2_TEAM,
                                              fused_bwd.K2_EXAMPLES)
    _assert_covers(geo, B)
    assert geo['resident']
    assert geo['smem_bytes'] == _bwd_smem(T, geo['examples'])
    # the costates lam, dlam in global memory
    assert geo['workspace_bytes'] == 4 * T * 6 * geo['blocks'] * geo['examples']
    # K2 keeps its chains' state in shared memory: what does not fit goes
    # to K4
    if fused_bwd.bwd_routes_long(T, False):
        assert T > fused_bwd.T_MAX_BWD
        assert geo['smem_bytes'] > fused_bwd.SMEM_LIMIT
    else:
        assert T <= fused_bwd.T_MAX_BWD
        assert geo['smem_bytes'] <= fused_bwd.SMEM_LIMIT


@pytest.mark.parametrize('B', BATCHES)
@pytest.mark.parametrize('T', BWD_HORIZONS)
def test_k4_launch_geometry_and_workspace(T, B):
    geo = fused_bwd.k4_launch(T, B)
    assert (geo['team'], geo['examples']) == (fused_bwd.K4_TEAM,
                                              fused_bwd.K4_EXAMPLES)
    _assert_covers(geo, B)
    # the state and the shared operands' copy are resident where they
    # fit; else the state follows the costates in the workspace, [T, 6 + 9,
    # padded batch] of float32, so any T runs, and shared memory is not
    # used
    smem = _bwd_smem(T, geo['examples'])
    resident = smem <= fused_bwd.SMEM_LIMIT
    assert resident == (T <= fused_bwd.K4_T_RESIDENT) == geo['resident']
    assert geo['smem_bytes'] == (smem if resident else 0)
    assert geo['smem_bytes'] <= fused_bwd.SMEM_LIMIT
    assert geo['workspace_bytes'] == 4 * T * (6 if resident else 15) * (
        geo['blocks'] * geo['examples'])


def test_bwd_routes_long_follows_t_max_bwd():
    for T in BWD_HORIZONS:
        assert fused_bwd.bwd_routes_long(T, False) == (
            T > fused_bwd.T_MAX_BWD)
        assert fused_bwd.bwd_routes_long(T, True)


def test_bwd_main_path_geometries():
    """The shapes chip_smoke.py drives: config 4 (K2) and the long
    configuration (K4), and what reaches the sources as defines."""
    assert fused_bwd.k2_launch(10, 1024) == dict(
        team=4, warps=4, examples=32, blocks=32, resident=True,
        smem_bytes=12848, workspace_bytes=4 * 10 * 6 * 1024)
    assert fused_bwd.k2_launch(10, 8192)['blocks'] == 256
    assert fused_bwd.k4_launch(160, 4096) == dict(
        team=4, warps=4, examples=32, blocks=128, resident=True,
        smem_bytes=205440, workspace_bytes=4 * 160 * 6 * 4096)
    assert fused_bwd.k4_launch(600, 4096)['workspace_bytes'] == (
        4 * 600 * 15 * 4096)
    assert fused_bwd.kernel_defines(10, True, False) == dict(
        MPC_T=10, MPC_HAS_I=1, MPC_COST_SHARED=0, MPC_TEAM=4,
        MPC_EXAMPLES=32)
    assert fused_bwd.long_kernel_defines(True, False) == dict(
        MPC_COST_SHARED=1, MPC_DYN_SHARED=0, MPC_TEAM=4, MPC_EXAMPLES=32)


def _pendulum_ops(B, T, dtype, n_alpha, decay, lqr_iter, eps=0.0, seed=0,
                  cheap_control=False):
    """The swing-up problem; with ``cheap_control`` the control costs
    1e-4 instead of 1e-3 and the speed 0.01, so that with wide bounds the
    full step overshoots and the line search takes later step sizes."""
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), rng.randn(B)], 1),
                      dtype=dtype)
    dx = PendulumDx(device='cpu', dtype=dtype)
    q, p = dx.get_true_obj()
    if cheap_control:
        q = q * torch.tensor([1.0, 1.0, 0.1, 0.1], dtype=dtype)
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
                       backprop=False, linesearch_decay=decay,
                       max_linesearch_iter=n_alpha)
    return cfg, x0, mt.QuadCost(torch.diag(q), p), dx


def _lindx_ops(B, T, dtype, seed=1):
    rng = np.random.RandomState(seed)
    Qo, _ = np.linalg.qr(rng.randn(3, 3))
    F = np.tile(np.concatenate([1.02 * Qo, 0.5 * rng.randn(3, 1)], 1),
                (T - 1, 1, 1))
    C = np.tile(np.diag([1.0, 1.0, 0.5, 0.05]), (T, 1, 1))
    c = 0.5 * rng.randn(T, B, 4)
    x0 = 2.0 * rng.randn(B, 3)

    def t(a):
        return torch.tensor(a, dtype=dtype)
    return t(x0), mt.LinDx(t(F), None), mt.QuadCost(t(C), t(c))


def _selected_index_sum(alphas, alpha_trace):
    """Sum over the iterations of (index of the selected step size + 1),
    from the per-iteration selected step sizes [n_iter, B]."""
    idx = torch.stack([(a[None] - torch.tensor(alphas, dtype=a.dtype)[:, None]
                        ).abs().argmin(0) for a in alpha_trace], 0)
    return (idx + 1).sum(0)


@pytest.mark.parametrize('kernel', ['K1', 'K3'])
def test_stats5_is_the_selected_index_plus_one(kernel):
    """Run the plain version one iteration at a time (warm-started from
    its own controls, which is what an iteration does) and read the
    selected step size of each iteration: stats[5] of the whole solve is
    the sum of their indices plus one."""
    n_alpha, decay, B, T, iters = 6, 0.5, 12, 6, 3
    if kernel == 'K1':
        cfg, x0, cost, dx = _pendulum_ops(B, T, torch.float64, n_alpha,
                                          decay, iters, cheap_control=True)
        operands, solve = fused.k1_operands, fused.fused_solve_plain
        kw = dict(u_lower=-20.0, u_upper=20.0)
    else:
        x0, dx, cost = _lindx_ops(B, T, torch.float64)
        cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=iters, eps=0.0,
                           backprop=False, linesearch_decay=decay,
                           max_linesearch_iter=n_alpha)
        operands, solve = fused.k3_operands, fused.fused_solve_long_plain
        kw = dict(u_lower=-0.3, u_upper=0.3)
    ops = operands(cfg, x0, cost, dx, **kw)
    _, _, stats = solve(**ops)
    assert torch.equal(stats[2], torch.full((B,), float(iters),
                                            dtype=torch.float64))
    # one iteration at a time; the trajectory an iteration ends with is
    # the rollout of its controls, so the next starts where it would
    trace, u = [], ops['u0']
    for _ in range(iters):
        one = dict(ops, lqr_iter=1, u0=u)
        _, u_new, s = solve(**one)
        trace.append(s[4])
        u = u_new[..., 0].contiguous()
    expected = _selected_index_sum(ops['alphas'], trace)
    assert torch.equal(stats[5], expected.to(stats.dtype))
    # the schedule is really searched: some iteration took a later step
    # size, and no count exceeds the schedule
    assert float(stats[5].max()) > iters
    assert float(stats[5].max()) <= iters * n_alpha


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('eps', [0.0, 1e-2])
def test_k1_carried_cost_equals_recomputed(dtype, eps):
    cfg, x0, cost, dx = _pendulum_ops(16, 8, dtype, 4, 0.3, 6, eps=eps)
    ops = fused.k1_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    carried = fused.fused_solve_plain(**ops)
    again = fused.fused_solve_plain(**ops, recompute_cost=True)
    for a, b in zip(carried, again):
        assert torch.equal(a, b)
    n_iter = carried[2][2]
    if eps > 0:
        # examples stop at different iterations, and a stopped one keeps
        # its carried cost
        assert float(n_iter.min()) < float(n_iter.max())
    else:
        assert float(n_iter.min()) == 6.0
