"""K3's MLP configuration as redesigned for the H100 (a warp an example:
csrc/fused_ilqr_long.cu:fused_ilqr_nn_kernel, csrc/nn.cuh), on the CPU:
its plain step and its launch geometry.

- The step split over a warp's lanes, ``fused_dense.mlp_step_lanes``,
  which ``fused.fused_solve_long_plain`` runs for K3's one-hidden-layer
  MLP: against ``NNDynamics.soa_stream_step`` and mpc_tpu's
  ``_stream_core`` (the stream form both kernels ran before) in float64,
  1e-12 relative, at H = 8, 33 (a ragged last slot) and 100, with and
  without passthrough, for each activation; and in float32, bitwise,
  against the kernel's lanes written out one at a time from the same
  activations: lane l's partial over its units l, l + 32, ... in order
  (past the width a unit of zero weights, as ``load_units`` pads the
  registers), then the xor butterfly (lane i adds lane i ^ o for o = 16,
  8, 4, 2, 1) in every lane, at H up to 130 (units past the 4 a lane
  keeps in registers).
- The plain K3 route of an MLP still solves: float64 against the jnp
  path in ``tests/test_torch_nn.py``, whose geometry tests hold
  ``k3_launch`` for the MLP.  Here: ``k3_nn_launch``'s shared memory and
  registers-bound choice against the kernel's layout, and the defines
  the build takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_tpu_torch.models.dynamics import _ACTS_SOA, _pre
from mpc_tpu_torch.ops import fused, fused_dense
from mpc_tpu_torch.ops.fused_dense import mlp_step_lanes

from test_torch_models import both_mlps, mlp_params

ACTIVATIONS = ('sigmoid', 'relu', 'elu')
TOL = 1e-12


def _points(n, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3), rng.randn(n)


@pytest.mark.parametrize('passthrough', [True, False], ids=['pass', 'nopass'])
@pytest.mark.parametrize('H', [8, 33, 100])
@pytest.mark.parametrize('act', ACTIVATIONS)
def test_lane_step_matches_the_stream_step_f64(act, H, passthrough):
    jm, tm = both_mlps(mlp_params((H,), seed=H), act, passthrough)
    x, u = _points(16)
    flat = jm.soa_params_flat()
    ref_j = jm.soa_stream_step(tuple(jnp.asarray(x[:, i]) for i in range(3)),
                               jnp.asarray(u), lambda i: flat[i])
    w = tm.kernel_params().detach()
    xs, ut = tuple(torch.tensor(x[:, i]) for i in range(3)), torch.tensor(u)
    got = torch.stack(mlp_step_lanes(tm, xs, ut, w), -1).numpy()
    ref_t = torch.stack(tm.soa_stream_step(xs, ut, w), -1).numpy()
    for ref in (ref_t, np.stack([np.asarray(r) for r in ref_j], -1)):
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _kernel_lanes(h, W2, b2, z, passthrough):
    """The kernel's sums one lane at a time (nn_step_warp) from the
    hidden activations ``h`` [n, H]: each lane's partials over its units
    from the first term on, zero weights past the width within its
    register slots, then the xor butterfly across the 32 lanes, then b2
    and the passthrough."""
    H = h.shape[1]
    lanes = []
    for lane in range(32):
        p = None
        for s in range(-(-H // 32)):
            k = lane + 32 * s
            term = (W2[:, k] if k < H else torch.zeros_like(W2[:, 0])) \
                * (h[:, k:k + 1] if k < H else torch.zeros_like(h[:, :1]))
            p = term if p is None else p + term
        lanes.append(p)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    assert all(torch.equal(lanes[0], v) for v in lanes)
    out = lanes[0] + b2
    return out + z[:, :3] if passthrough else out


@pytest.mark.parametrize('H', [8, 33, 100, 130])
@pytest.mark.parametrize('act', ACTIVATIONS)
def test_lane_step_is_the_kernels_lanes_and_butterfly_f32(act, H):
    _, tm = both_mlps(mlp_params((H,), seed=3), act, True)
    tm = tm.to(torch.float32)
    x, u = (torch.tensor(a, dtype=torch.float32) for a in _points(8, seed=2))
    w = tm.kernel_params().detach()
    got = torch.stack(mlp_step_lanes(tm, tuple(x.unbind(-1)), u, w), -1)
    (W1, b1), (W2, b2) = tm._flat_layers(w)
    z = torch.cat([x, u[:, None]], 1)
    h = _ACTS_SOA[act](_pre(z, W1, b1))
    assert torch.equal(got, _kernel_lanes(h, W2, b2, z, True))


@pytest.mark.parametrize('clocks', [False, True])
@pytest.mark.parametrize('T,H', [(20, 100), (99, 100), (100, 100),
                                 (20, 6923), (20, 6924), (5, 7263)])
def test_k3_nn_launch_layout_and_registers_bound(T, H, clocks):
    geo = fused.k3_nn_launch(T, 2050, H, clocks)
    assert geo == fused.k3_launch(T, 2050, 3, H, clocks)
    # shared memory: the counters (32 bytes a warp, clocked build only),
    # the weights, then where they cost an SM no block (of the 4 that the
    # registers allow) each warp's example, NN_SLOTS float4 a step, and
    # the block's copy of the shared operands, 40 floats a step
    head = 16 * (2 * H + 1) + (32 * geo['warps'] if clocks else 0)
    full = head + T * (geo['warps'] * fused.NN_SLOTS * 16 + 4 * 40)
    resident = full <= fused.SMEM_LIMIT and min(
        fused_dense.blocks_an_sm(full, 4), 4) == min(
            fused_dense.blocks_an_sm(head, 4), 4)
    assert geo['smem_bytes'] == (full if resident else head)
    assert geo['slots'] == (0 if resident else fused.NN_SLOTS)
    assert geo['workspace_bytes'] == (0 if resident
                                      else T * fused.NN_SLOTS * 2050 * 16)
    if not clocks:
        assert resident == ((T, H) in ((20, 100), (99, 100), (20, 6923)))
    # 128 registers a lane hold the __launch_bounds__ minimum: 16 warps
    assert fused_dense.blocks_by_registers(128, geo['warps']) \
        == geo['min_blocks'] == 16 // geo['warps']
    assert fused_dense.blocks_by_registers(136, geo['warps']) \
        < geo['min_blocks']


def test_the_mlp_builds_defines():
    d = fused.long_kernel_defines(False, True, 'relu', huber=True,
                                  has_uz=True)
    assert d == dict(MPC_DYN=2, MPC_ACT=1, MPC_HAS_BOUNDS=1, MPC_TEAM=32,
                     MPC_WARPS=fused.K3_NN_WARPS,
                     MPC_MIN_BLOCKS=fused.K3_NN_MIN_BLOCKS, MPC_OP_ROW=40,
                     MPC_COST=1, MPC_HAS_UZ=1)
    # (K, k), (x, u), three Jacobian rows and the one trial trajectory
    assert fused.NN_SLOTS == 6
    # the other builds keep their teams of 4 lanes; the team kernel's
    # clocked build counts in global memory and keeps the layout of the
    # build it measures
    assert fused.long_kernel_defines(True, True)['MPC_TEAM'] == fused.TEAM
    assert fused.k3_launch(20, 64, 3, clocks=True) == fused.k3_launch(20, 64,
                                                                      3)


@pytest.mark.parametrize('clocks', [False, True])
@pytest.mark.parametrize('bounded', [False, True])
def test_k3_build_of_the_operands_is_the_launch(bounded, clocks):
    """``custom.k3_build`` of ``fused.k3_args``: the defines and geometry
    that ``custom.k3_run`` launches the MLP operands with, which the phase
    account and the card checks read instead of deriving them again."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import custom
    T, B, H = 7, 5, 33
    model = mt.NNDynamics.init(3, 1, (H,), 'elu',
                               generator=torch.Generator().manual_seed(0),
                               device='cpu')
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=2,
                       max_linesearch_iter=3, linesearch_decay=0.2)
    x0 = torch.tensor(np.random.RandomState(0).randn(B, 3),
                      dtype=torch.float32)
    cost = mt.QuadCost(torch.eye(4), torch.zeros(4))
    lim = dict(u_lower=-1.0, u_upper=1.0) if bounded else {}
    ops = fused.k3_operands(cfg, x0, cost, model, **lim)
    args = fused.k3_args(**ops)
    assert args[14:17] == (H, 'elu', True)
    defines, geo = custom.k3_build(*args, clocks=clocks)
    want = fused.long_kernel_defines(False, bounded, 'elu')
    if clocks:
        want['MPC_PHASE_CLOCKS'] = 1
    assert defines == want
    assert geo == fused.k3_nn_launch(T, B, H, clocks)
    assert geo == fused.k3_launch(T, B, len(ops['alphas']), H, clocks)
