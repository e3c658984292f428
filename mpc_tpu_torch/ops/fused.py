"""Fused iLQR solve: kernels K1 and K3 for Hopper and their plain
PyTorch versions.

Counterpart of mpc_tpu/ops/fused.py, whose ``_make_kernel``
(mpc_tpu/ops/fused.py:617-1119) runs the whole box-constrained iLQR
solve in one Pallas kernel with a batch tile on the TPU's vector lanes,
and whose ``_make_kernel_long`` (mpc_tpu/ops/fused.py:1126-1932) runs
the same solve with the horizon as loops over per-t scratch.

Both kernels give one example to a TEAM of ``TEAM`` neighbouring lanes of
a warp and keep only the two true recurrences of an iLQR iteration
serial (the cost-to-go backwards, the rollout forwards): the line-search
step sizes roll out side by side on the team's lanes, each into a
trajectory slot of its own, and the winner's slot becomes the current
trajectory.  K1 is csrc/fused_ilqr.cu: the pendulum, T a compile-time
constant, the horizon resident in shared memory ([t, slot, example] of
float4), the Jacobians computed in a pass parallel over t.  K3 is
csrc/fused_ilqr_long.cu: LinDx, pendulum or MLP dynamics, T a run-time
argument, the same slots in a workspace in global memory that the
wrapper allocates and, where the horizon fits, the state the loops read
in shared memory; each step's rows are loaded one step ahead of their use.
An MLP (csrc/nn.cuh) runs in a kernel of its own there: a warp an
example, the block's weights in shared memory, the rollout step split
over the lanes (a lane's units in registers, a butterfly of shuffles),
the step Jacobians a step a lane before each Riccati sweep.
The launch geometry is computed here (``k1_launch``, ``k3_launch``,
``k3_nn_launch``), so the CPU tests reach it.

``fused_solve_plain`` and ``fused_solve_long_plain`` are the plain
versions of those kernels: each kernel scalar is a [B] tensor and the
arithmetic runs in the kernel's order.  The CPU path of the entry points
runs them (in any float dtype, so float64 is there for tests); on a CUDA
tensor ``fused_ilqr`` and ``fused_ilqr_long`` launch their kernel or
raise, and never fall back to the plain version.  Both go through the
kernels' ``torch.library`` ops (ops/custom.py), which hold the launches.

Scope (``scope_gap``): LinDx dynamics (F, f each shared or batched, f
optional) of any n_state and n_ctrl with n_state + n_ctrl <=
``DENSE_MAX_TAU`` (any n_ctrl); the simple and the
damped, biased pendulum and the cartpole (``SOA_MODELS``, their
structure-of-arrays steps and hand-written Jacobians); an
``NNDynamics`` of 1 to 4 hidden layers (sigmoid, relu or elu, with or
without the passthrough, its weights in a block's shared memory): at
n_state = 3, n_ctrl = 1 with one hidden layer K3's streamed-weights
configuration (csrc/nn.cuh), at every other admitted size and depth the
dense configuration's MLP build (csrc/nn_dense.cuh); a QuadCost with C
and c each shared or batched, or the pseudo-Huber cost (``PseudoHuberCost`` with w and goal
[n_tau] and a scalar delta, quadratised inside the kernels at every
iteration: each kernel's cost build, MPC_COST = 1, csrc/cost.cuh); bounds
absent, scalar, [T, nc] or [T, B, nc], an optional u_init, any T, float32
(float64 too on the CPU, in the plain versions).  Every kernel also takes
controls pinned to zero (``u_zero_I`` [T, nc] shared or [T, B, nc], each
kernel's MPC_HAS_UZ build) and, with bounds, the trust region
``delta_u`` on each iteration's control step, as the JAX kernels apply
them (mpc_tpu/ops/fused.py:872-928, 1019-1032, 1475-1515, 1681-1692).
``routes_dense`` and ``routes_long`` say which kernel takes a problem:
at 3 states and 1 control a LinDx and a one-hidden-layer MLP go to K3,
a pendulum to K1
up to ``T_MAX`` and to K3 past it; every other admitted problem goes to
K3's dense configuration (ops/fused_dense.py, csrc/fused_ilqr_dense.cu:
a warp an example, the in-kernel projected-Newton box QP for several
bounded controls), a model there in its model-step build (the model's
step in the rollouts, its Jacobians in a pass parallel over t); the
dispatch sends every other problem to the eager solver.  A slew-rate
penalty is solved as the JAX package solves it in its kernel
(``_fused_slew_solve``, mpc_tpu/ops/fused.py:2510-2580): the state is
augmented with the previous control on the host and the kernels take
the augmented problem, a LinDx in K3 where it has three states and one
control, everything else in the dense configuration (a model through
its passthrough step, ``SlewSoA``).
"""

from __future__ import annotations

import array
import ctypes
import math
from typing import Optional

import torch

from ..models.cartpole import CartpoleDx
from ..models.cost import PseudoHuberCost, huber_cost, huber_quad
from ..models.dynamics import NNDynamics
from ..models.pendulum import PendulumDx
from ..types import LinDx, QuadCost, Solution

# Line-search schedules are passed to the kernel by value, up to this
# many step sizes (csrc/fused_ilqr.cu:kMaxAlpha).
MAX_ALPHA = 32

# The launch geometry of K1 and K3 lives here alone: the sources get it
# as nvcc defines (``kernel_defines``, ``long_kernel_defines``) and the
# launchers take the slots and shared-memory bytes computed below.
#
# Lanes of a warp that own one example, in K1 and K3 (MPC_TEAM).
# Lane g rolls out step size g of the line search, so a team as wide as
# the usual schedules (3 to 5 step sizes) keeps its lanes busy; 8 lanes
# would idle 3 to 5 of them through every rollout.
TEAM = 4
# Warps a block.  K1's block is one warp (its 32 / TEAM examples share
# the block's shared memory, and the smaller the block, the longer the
# horizon that fits); K3 keeps two slots a step and example there, not
# ten, and takes four (2 and 8 measured slower, PERF.md).
K1_WARPS = 1
K3_WARPS = 4
# K3's team kernel on the pendulum (MPC_DYN = 1) takes a team as wide as
# its line search, up to K3_PEND_TEAM lanes: a step size a lane in one
# round, since a second round is a whole rollout more for the examples
# that need it and a launch lasts as long as its slowest example (PERF.md
# section 6); 32 examples a block either way.
K3_PEND_TEAM = 8
# K3's MLP configuration gives each example a warp (its hidden units over
# the lanes, csrc/nn.cuh) and takes 4 warps a block, at least
# K3_NN_MIN_BLOCKS blocks an SM (its __launch_bounds__, MPC_MIN_BLOCKS):
# 16 warps an SM, which holds a lane to 128 registers.
K3_NN_WARPS = 4
K3_NN_MIN_BLOCKS = 16 // K3_NN_WARPS
# Its float4 slots a step and example: (K, k), (x, u), three Jacobian
# rows and the trial trajectory (its trials run one after another).
NN_SLOTS = 6
# Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
# K1's shared-memory slots (float4) per step and example beside the
# trajectories: (K, k), three rows of F, C tau + c
# (csrc/fused_ilqr.cu:kSlotTraj).
_K1_FIXED_SLOTS = 5
# Floats a step of the block-wide copy of the batch-shared operands in K3's
# MLP configuration (MPC_OP_ROW): C 16, c 4, F 12, f 3 (padded to 4), the
# two bounds and a shared u_zero_I mask, padded to a multiple of 4; the
# team kernel's row holds what its build reads (``_k3_op_row``).
_K3_OPERAND_ROW = 40
# Steps of a lane's ring in K3's team kernel past residency (MPC_RING):
# the state rows of the position K3_RING - 2 on are in flight while a
# step computes (PERF.md section 6).
K3_RING = 8
# The columns of K3's phase account (csrc/fused_ilqr_long.cu:K3Phase).
K3_PHASES = ('initial rollout', 'jacobians', 'sweep', 'trials', 'copy')


def _trial_lanes(n_alpha, team=TEAM) -> int:
    """The lanes of a team that roll out a trial, each into an (x, u)
    slot of its own."""
    return min(n_alpha, team)


def _k3_team(lindx, n_alpha) -> tuple:
    """(lanes a team, warps a block) of K3's team kernel: LinDx's TEAM
    lanes; the pendulum's as wide as its ``n_alpha`` step sizes, TEAM to
    K3_PEND_TEAM lanes; 32 examples a block."""
    team = TEAM
    if not lindx:
        while team < min(n_alpha, K3_PEND_TEAM):
            team *= 2
    return team, K3_WARPS * team // TEAM


def _blocks(B, examples) -> int:
    return -(-B // examples)


def k1_launch(T, B, n_alpha) -> dict:
    """K1's launch geometry: team width, warps and examples a block,
    blocks, the float4 slots per step and example and the dynamic shared
    memory of a block, [T, slots, examples] of float4."""
    examples = 32 * K1_WARPS // TEAM
    slots = _K1_FIXED_SLOTS + 1 + _trial_lanes(n_alpha)
    return dict(team=TEAM, warps=K1_WARPS, examples=examples,
                blocks=_blocks(B, examples), slots=slots,
                smem_bytes=T * slots * examples * 16)


def _k3_op_row(lindx, huber, has_bounds, has_uz) -> int:
    """Floats a step of the team kernel's copy of the batch-shared
    operands (MPC_OP_ROW): C 16 and c 4 but in the cost build, F 12 and f
    3 (padded to 4) for LinDx, the two bounds, a u_zero_I mask, padded to
    a multiple of 4 (csrc/fused_ilqr_long.cu:kOpRowUsed)."""
    n = ((0 if huber else 20) + (16 if lindx else 0)
         + (2 if has_bounds else 0) + (1 if has_uz else 0))
    return -(-n // 4) * 4


def _k3_lin_bytes(lindx, huber, team) -> int:
    """Shared memory of a block's linearisation buffers in the team
    kernel: for the pendulum, a team's two rounds of ``team`` steps of F's
    three rows (and in the cost build H's diagonal and g) and one float4
    more, as float4, 32 teams; none for LinDx."""
    if lindx:
        return 0
    rows = 3 + (2 if huber else 0)
    return 32 * (2 * team * rows + 1) * 16


def k3_launch(T, B, n_alpha, nn_hidden=0, clocks=False, *, lindx=True,
              huber=False, has_bounds=True, has_uz=False) -> dict:
    """K3's launch geometry: team width, warps and examples a block,
    blocks, where the state lives, the shared memory of a block and the
    workspace [T, slots, B] of float4 in global memory, for the team
    kernel's build (``lindx``: LinDx, else the pendulum; ``huber`` the
    cost build; ``has_bounds``, ``has_uz``); with ``nn_hidden`` units the
    MLP configuration's (``k3_nn_launch``, ``clocks`` its phase account's
    build).  The team kernel's clocked build takes the layout of the
    build it measures.

    A block holds 32 examples: teams of TEAM lanes in K3_WARPS warps, the
    pendulum's teams as wide as its step sizes (``_k3_team``: 8 lanes in
    8 warps for 5 to 8).  The state that the horizon loops read at every
    step, the gains (K, k) and the current (x, u), is two float4 a step
    and example: 1024 T bytes of shared memory a block, beside the
    pendulum's linearisation buffers (``_k3_lin_bytes``: 12,800 bytes for
    teams of 4, 25,088 for teams of 8, 20,992 for the cost build's teams
    of 4).  The block's copy of the batch-shared operands takes 4
    ``_k3_op_row`` bytes a step (160 for LinDx with a QuadCost and
    bounds, 96 for the pendulum with them, 16 for its cost build).  The
    state is resident (``resident``) where it fits 227 KB beside the
    buffers, a LinDx's only with its operands' copy (its sweep reads 136
    bytes of operands at every step to the state's 32, so shared memory
    keeps the copy: at T=200 the rings run 0.84x the state resident
    without it, PERF.md section 6): up to T = 196 for LinDx
    (``K3_T_RESIDENT``), 214 and 202 for the pendulum's teams of 4 and 8,
    206 for its cost build (``k3_t_resident``); the workspace then holds
    the trial slots only.  Past it the state takes the workspace's last
    two slots and each lane reads it through a ring of ``K3_RING`` steps
    in shared memory (2 float4 a step: 32 KB a block for teams of 4), so
    any T runs.  The operands' copy is staged beside the state or the
    rings where it fits (``staged``), else read from global memory."""
    if nn_hidden:
        return k3_nn_launch(T, B, nn_hidden, clocks)
    team, warps = _k3_team(lindx, n_alpha)
    examples = 32 * warps // team
    lin = _k3_lin_bytes(lindx, huber, team)
    ops = T * 4 * _k3_op_row(lindx, huber, has_bounds, has_uz)
    state = T * 2 * 16 * examples
    # LinDx reads 136 bytes of operands a step to its state's 32, and
    # keeps the state resident only with their copy
    resident = lin + state + (ops if lindx else 0) <= SMEM_LIMIT
    slots = _trial_lanes(n_alpha, team)
    if not resident:
        slots += 2
        state = K3_RING * 2 * 16 * 32 * warps
    staged = lin + state + ops <= SMEM_LIMIT
    return dict(team=team, warps=warps, examples=examples,
                blocks=_blocks(B, examples), slots=slots,
                smem_bytes=lin + state + (ops if staged else 0),
                workspace_bytes=T * slots * B * 16, resident=resident,
                staged=staged)


def k3_t_resident(lindx=True, huber=False, has_bounds=True, has_uz=False,
                  n_alpha=1) -> int:
    """The longest horizon whose state K3's team kernel keeps in shared
    memory for this build (``k3_launch``)."""
    team, _ = _k3_team(lindx, n_alpha)
    per_step = 2 * 16 * 32 + (4 * _k3_op_row(lindx, huber, has_bounds,
                                             has_uz) if lindx else 0)
    return (SMEM_LIMIT - _k3_lin_bytes(lindx, huber, team)) // per_step


def k3_nn_launch(T, B, nn_hidden, clocks=False) -> dict:
    """The launch geometry of K3's MLP configuration (MPC_DYN = 2,
    csrc/fused_ilqr_long.cu:fused_ilqr_nn_kernel): a warp an example
    (its team is the warp: ``team`` 32), ``K3_NN_WARPS`` warps and
    examples a block, blocks, its shared memory and its workspace.

    The block's shared memory holds the weights, 2 float4 a unit and one
    for the output biases (``_nn_weight_bytes``), always, and, where they
    cost an SM no block, each example's ``NN_SLOTS`` float4 a step ((K, k),
    (x, u), the Jacobian's three rows, the trial trajectory) and the
    block's copy of the batch-shared operands (``_K3_OPERAND_ROW`` floats
    a step): resident while the blocks an SM by shared memory stay as many
    as the weights alone leave, up to ``min_blocks``, and the whole fits
    227 KB.  At 100 units and 4 warps that is 3,216 + 544 T bytes, 4
    blocks an SM up to T = 99.  Past it the slots go to the workspace
    [T, NN_SLOTS, B] and the operands are read from global memory
    (``slots`` and ``workspace_bytes`` 0 where resident), so any T runs,
    up to ``K3_NN_MAX_HIDDEN`` units.  Measured at bench_nn_dynamics
    (PERF.md section 6): resident 1-4% faster than the workspace at T =
    20, 60 and 99, the workspace 26%, 17% and 45% faster at T = 100, 200
    and 400, where shared memory would leave 3, 2 and 1 blocks an SM.
    ``min_blocks`` (``K3_NN_MIN_BLOCKS``) is the kernel's
    __launch_bounds__ minimum, so an SM holds 16 of its warps by
    registers (128 a lane): at the bench MLP's B = 2048, 512 blocks on
    all 132 SMs in one wave.

    ``clocks``: the phase account's build (MPC_PHASE_CLOCKS), whose
    counters take 32 bytes a warp at the start of the shared memory."""
    from .fused_dense import blocks_an_sm
    warps = K3_NN_WARPS
    head = _nn_weight_bytes(nn_hidden) + (32 * warps if clocks else 0)
    smem = head + T * (warps * NN_SLOTS * 16 + 4 * _K3_OPERAND_ROW)
    resident = smem <= SMEM_LIMIT and min(
        blocks_an_sm(smem, warps), K3_NN_MIN_BLOCKS) == min(
            blocks_an_sm(head, warps), K3_NN_MIN_BLOCKS)
    slots = 0 if resident else NN_SLOTS
    return dict(team=32, warps=warps, examples=warps,
                blocks=_blocks(B, warps), min_blocks=K3_NN_MIN_BLOCKS,
                slots=slots,
                smem_bytes=smem if resident else head,
                workspace_bytes=T * slots * B * 16)


def _nn_weight_bytes(hidden) -> int:
    """The shared memory of an MLP's weights in K3 (csrc/nn.cuh): per
    hidden unit k one float4 (w1[k, :]) and one (b1[k], w2[:, k]), then
    (b2, 0); none without an MLP."""
    return 16 * (2 * hidden + 1) if hidden else 0


# K1's horizon limit: the longest T whose block fits in shared memory
# with every lane of the team rolling out a trial.  A block holds
# 32 * K1_WARPS / TEAM = 8 examples of (5 + 1 + TEAM) = 10 float4 slots a
# step, 1280 bytes a step, so T_MAX = 232448 // 1280 = 181.  Longer
# horizons go to the streaming kernel K3, whose workspace is in global
# memory.  The pseudo-Huber cost build keeps the same slots (its g takes
# the C tau + c slot, its diagonal of H a trajectory slot that is not the
# current one until the trials), so the same limit.
T_MAX = SMEM_LIMIT // k1_launch(1, 1, MAX_ALPHA)['smem_bytes']
# The longest horizon whose state and shared operands' copy K3 keeps in
# shared memory in its LinDx build with a QuadCost and bounds, its widest
# row (196).
K3_T_RESIDENT = k3_t_resident()
# The widest one-hidden-layer MLP whose weights K3's block holds in shared
# memory with nothing else there (the state and the Jacobian rows then in
# the workspace): 16 (2 H + 1) <= 232448, H <= 7263, 8 H + 3 = 58107
# weights for 3 states and 1 control.  The weights are read at every
# hidden unit of every step, so they stay in shared memory; past this
# width an MLP goes to the eager solver.  Registers and the kernel's code
# do not grow with H (a loop over the units, H a run-time argument).
K3_NN_MAX_HIDDEN = (SMEM_LIMIT // 16 - 1) // 2

# The dense configuration's size gate (ops/fused_dense.py), from this
# card and not from the TPU's VMEM or its ntau <= 28 compile-time body
# gate: n_state + n_ctrl <= 32 at any n_ctrl.  It sits at 32 taus
# because one warp owns an example and lane r row r of Q, V and the
# gains: the lanes of a warp.  The tiles of an example take at most
# 16.3 KB of shared memory there (four examples a block, 65 KB).  Up to
# 8 controls every lane keeps the control block Quu, its factor and the
# box QP's vectors in registers (csrc/box_qp.cuh; 224 of a thread's 255
# registers at 24 states and 8 controls); past 8 they live in the
# warp's tiles (csrc/box_qp_smem.cuh: Quu read in place from Q's tile,
# the factor [nc][odd] and five rows of nc, at most 4.5 KB more a warp,
# at 1 state and 31 controls), so no control count is refused
# (chip_smoke.py [build] compiles the gate's corners and prints their
# registers and spills).  One library is built per (n_state, n_ctrl,
# bounds, f), in seconds.
DENSE_MAX_TAU = 32

# Initial best cost / step norm, as in the TPU kernel
# (mpc_tpu/ops/fused.py:719); any finite cost replaces it at iteration 0.
BIG = 3.0e38

# One count per launch of K1 and of K3 on the card, and nowhere else.
launch_counts = {'fused_ilqr': 0, 'fused_ilqr_long': 0,
                 'fused_ilqr_dense': 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def routes_long(dynamics, T) -> bool:
    """THE K1-or-K3 routing predicate of the forward solve at 3 states
    and 1 control (``routes_dense`` takes every other LinDx first),
    shared by ``scope_gap``, the dispatch in ``fused_batched_solve`` and
    the tests (as ``_routes_long`` is in mpc_tpu/ops/fused.py:287-300).

    K3 takes every LinDx problem and every MLP, because K1's source has
    neither step (ROADMAP queue 2, K1 configurations), and the pendulum
    past ``T_MAX``, which is what K1's block can hold in shared memory and
    not a threshold carried over from the TPU.  This differs from the
    JAX package for MLPs of 64 weights or fewer, which it runs in its
    unrolled kernel (K1); the two kernels compute the same function."""
    return isinstance(dynamics, (LinDx, NNDynamics)) or T > T_MAX


def routes_dense(dynamics, n_state, n_ctrl) -> bool:
    """THE dense-configuration predicate of the forward solve, shared by
    ``scope_gap``, the dispatch in ``fused_batched_solve`` and the tests:
    a LinDx or a model with a structure-of-arrays step (the pendulums,
    the cartpole, an MLP) at any other size than K1's and K3's 3 states
    and 1 control, a slew passthrough ``SlewSoA`` of any of them (its
    ``n_state`` the augmented one), and an MLP of more than one hidden
    layer at any size, at any T.  So the cartpole, every MLP but K3's
    one-hidden-layer 3s1c configuration and every slew-augmented model run
    in the dense configuration, its model-step build for the models; the
    damped pendulum stays on K1 and K3.  The JAX package sends such
    problems to K1 or K3 by their unrolled volume or parameter count
    (mpc_tpu/ops/fused.py:287-300, 122-129); here one kernel takes them
    all."""
    if isinstance(dynamics, SlewSoA):
        return True
    if isinstance(dynamics, NNDynamics) and not dynamics.streams:
        return True
    return (isinstance(dynamics, (LinDx, NNDynamics) + SOA_MODELS)
            and (n_state, n_ctrl) != (3, 1))


# The models whose structure-of-arrays step and hand-written Jacobian
# the kernels run (csrc/pendulum.cuh, csrc/cartpole.cuh).
SOA_MODELS = (PendulumDx, CartpoleDx)


class SlewSoA:
    """The passthrough step of a slew-augmented model (mpc_tpu/ops/
    fused.py:2441-2508, ``_SlewSoA``; the reference's
    CtrlPassthroughDynamics, mpc/dynamics.py:133-153): on the augmented
    state (u_{t-1}, x_t) the step is (u_t, f(x_t, u_t)), the controls
    passed through unclipped.  ``soa_step`` and ``soa_jacobian`` take the
    inner model's parameters and ``u`` as the inner model does (a
    component for one control, a tuple for several); the dense kernel's
    model-step build runs the same (csrc/soa_model.cuh, ``Slew``; the
    MLP's in csrc/fused_ilqr_dense.cu)."""

    def __init__(self, dynamics, n_ctrl):
        self.inner = dynamics
        self.n_ctrl = n_ctrl
        self.n_state = dynamics.n_state + n_ctrl

    @property
    def params(self):
        return self.inner.params

    def soa_params(self):
        return self.inner.soa_params()

    def soa_step(self, xs, u, params):
        nc = self.n_ctrl
        us = (u,) if nc == 1 else tuple(u)
        return us + tuple(self.inner.soa_step(tuple(xs[nc:]), u, params))

    def soa_jacobian(self, xs, u, params):
        """The first n_ctrl rows pick u_t (the augmented tau's last
        columns); the inner Jacobian's rows follow, shifted right past the
        u_{t-1} columns (``soa_stream_jac``, mpc_tpu/ops/fused.py:
        2487-2508)."""
        nc = self.n_ctrl
        inner = self.inner.soa_jacobian(tuple(xs[nc:]), u, params)
        zero = xs[0] * 0.0
        return [[zero] * self.n_state
                + [zero + 1.0 if i == m else zero for i in range(nc)]
                for m in range(nc)] + [[zero] * nc + list(row)
                                       for row in inner]


def dense_gap(n_state, n_ctrl) -> Optional[str]:
    """Why the dense configuration does not take a LinDx of these sizes
    (the gate above); None when it does."""
    if n_state + n_ctrl > DENSE_MAX_TAU:
        return (f'a LinDx of n_state + n_ctrl = {n_state + n_ctrl} exceeds '
                f'the dense configuration\'s {DENSE_MAX_TAU} (a warp an '
                'example, a lane a row of Q); it runs on the eager solver, '
                'as mpc_tpu runs problems past its kernels\' gate on its '
                'jnp path')
    return None


def nn_scope_gap(dynamics, slew=False) -> Optional[str]:
    """Why the kernels do not take an MLP (under a slew penalty with
    ``slew``); None when they do: K3's streamed-weights configuration its
    one-hidden-layer 3s1c MLP up to ``K3_NN_MAX_HIDDEN`` units, the dense
    configuration's MLP build every other MLP its gate admits
    (``fused_dense.mlp_gap``: the size gate, 1 to 4 hidden layers, the
    weights and the warps' scratch in a block's shared memory)."""
    if not slew and not routes_dense(dynamics, dynamics.n_state,
                                     dynamics.n_ctrl):
        if dynamics.hidden > K3_NN_MAX_HIDDEN:
            return (f'an MLP of {dynamics.hidden} hidden units exceeds the '
                    f'{K3_NN_MAX_HIDDEN} whose weights K3 holds in shared '
                    'memory')
        return None
    from .fused_dense import mlp_gap
    return mlp_gap(dynamics, dynamics.n_ctrl if slew else 0)


def scope_gap(cfg, cost, dynamics, *, u_zero_I=None, u_lower=None,
              dtype=torch.float32,
              device=torch.device('cpu')) -> Optional[str]:
    """Why the kernels (K1, K3 or its dense configuration, see
    ``routes_dense`` and ``routes_long``) do not take a
    problem, naming the kernel configuration or ROADMAP item that waits;
    None when they do.  Under a slew penalty it judges the augmented
    problem (n_state + n_ctrl states, ``fused_batched_solve``).  A
    ``u_zero_I`` mask of [T, n_ctrl] or [T, B, n_ctrl] and ``cfg.delta_u``
    with bounds (``u_lower`` not None) are in every kernel's scope, as in
    mpc_tpu's (mpc_tpu/ops/fused.py:211-214).  The
    admission test alone: the dispatch (learning.batched_solve) sends
    what it refuses to the eager solver, and ``cfg.use_fused`` is read
    there."""
    if isinstance(dynamics, LinDx):
        if (getattr(dynamics.F, 'ndim', 0) not in (3, 4)
                or (dynamics.f is not None
                    and getattr(dynamics.f, 'ndim', 0) not in (2, 3))):
            return ('LinDx takes F [T-1, n_state, n_tau] or [T-1, B, ...] '
                    'and f [T-1, n_state], [T-1, B, n_state] or None; '
                    'other layouts wait for ROADMAP queue 2 (K3 '
                    'configurations)')
    elif not isinstance(dynamics, (NNDynamics,) + SOA_MODELS):
        return (f'{type(dynamics).__name__} dynamics have no kernel step; '
                'the kernels run LinDx, the pendulums, the cartpole and '
                'MLPs (other models run on the eager solver)')
    if not isinstance(dynamics, LinDx) and (cfg.n_state, cfg.n_ctrl) != (
            dynamics.n_state, dynamics.n_ctrl):
        return (f'{type(dynamics).__name__} has {dynamics.n_state} states '
                f'and {dynamics.n_ctrl} control, not the configuration\'s '
                f'{cfg.n_state} and {cfg.n_ctrl}')
    slew = cfg.slew_rate_penalty is not None
    if isinstance(dynamics, NNDynamics):
        gap = nn_scope_gap(dynamics, slew)
        if gap is not None:
            return gap
    ns = cfg.n_state + (cfg.n_ctrl if slew else 0)
    if routes_dense(SlewSoA(dynamics, cfg.n_ctrl) if slew and not isinstance(
            dynamics, LinDx) else dynamics, ns, cfg.n_ctrl):
        gap = dense_gap(ns, cfg.n_ctrl)
        if gap is not None:
            return (f'the slew-augmented {type(dynamics).__name__} has {ns} '
                    f'states: {gap}') if slew else gap
    gap = cost_gap(cost, ns + cfg.n_ctrl)
    if gap is not None:
        return gap
    if u_zero_I is not None and getattr(u_zero_I, 'ndim', 0) not in (2, 3):
        return ('u_zero_I is [T, n_ctrl] (shared) or [T, B, n_ctrl] in the '
                'kernels (mpc_tpu/ops/fused.py:213-214)')
    if cfg.delta_u is not None and u_lower is None:
        # the trust region intersects the box (mpc_tpu/ops/fused.py:
        # 211-212; reference mpc/lqr_step.py:195)
        return ('delta_u needs bounds in the kernels, as in mpc_tpu\'s: '
                'its trust region is intersected with the box')
    delta = trust_region(cfg, dtype)
    if delta is not None and not 0 < delta < math.inf:
        return (f'delta_u={cfg.delta_u} is not finite and positive in '
                f'{dtype}: the kernels take no other trust region, and it '
                'runs on the eager solver')
    if cfg.verbose > 0:
        # the JAX package's kernels refuse it too
        # (mpc_tpu/ops/fused.py:217)
        return ('verbose > 0 runs on the eager solver, which records each '
                'iteration (iter_stats)')
    if dtype not in (torch.float32, torch.float64):
        return f'dtype {dtype} is not supported (float32 or float64)'
    if dtype == torch.float64 and device.type == 'cuda':
        return ('float64 is no kernel configuration (ROADMAP queue 2; the '
                'TPU kernels are float32 too): float64 runs on the eager '
                'solver')
    if cfg.max_linesearch_iter > MAX_ALPHA:
        return (f'max_linesearch_iter={cfg.max_linesearch_iter} exceeds '
                f'the kernels\' schedule of {MAX_ALPHA} step sizes')
    return None


def cost_gap(cost, n_tau) -> Optional[str]:
    """Why the kernels do not take a cost on ``n_tau`` components; None
    for a QuadCost and for a pseudo-Huber cost whose w and goal are
    [n_tau] and delta a scalar (``PseudoHuberCost.kernel_gap``).  A
    non-quadratic cost under a slew penalty never reaches it:
    ``solver.unported_gap`` refuses that before any route."""
    if isinstance(cost, QuadCost):
        return None
    if not isinstance(cost, PseudoHuberCost):
        return ('a callable cost has no hand-written gradient and Hessian '
                'in the kernels (as a callable model has no kernel step): '
                'they take a QuadCost or a PseudoHuberCost, and this cost '
                'runs on the eager solver')
    gap = cost.kernel_gap()
    if gap is not None:
        return gap
    if cost.w.shape[0] != n_tau:
        return (f'the pseudo-Huber cost has {cost.w.shape[0]} components, '
                f'not n_state + n_ctrl = {n_tau}')
    return None


def supports(cfg, cost, dynamics, **kw) -> bool:
    """Whether the fused solve runs this problem (see ``scope_gap``)."""
    return scope_gap(cfg, cost, dynamics, **kw) is None


# ---------------------------------------------------------------------------
# work and bytes of one launch (the kernel's bound)
# ---------------------------------------------------------------------------

# Arithmetic operations of the pendulum pieces, counted from
# csrc/pendulum.cuh with the parameter-only terms hoisted: the step
# (newdth 6, delta 1, cos+sin 2, r2 3, sqrt+div 2, rotation 8) and its
# Jacobian (the step's terms plus 2 for ir3, 2 for the chain factors,
# 16 for the rotation derivatives and 8 for the chain products).
_STEP_OPS = 22
_JAC_OPS = 50
# The damped, biased pendulum's, counted the same way: the step (atan2 1,
# newdth 10 with sin(th + b), newth 2, cos+sin 2) and its Jacobian (the
# step's 15, d th / d (cos, sin) 6, d newdth / d th 5, the chain factors
# 7 and the rows' 8 products).
_DAMPED_STEP_OPS = 15
_DAMPED_JAC_OPS = 41
# The pseudo-Huber cost's, counted from csrc/cost.cuh with the
# parameter-only products hoisted: a component's term of the stage cost
# (r 2, r r + 1 2, sqrt, - 1, the product with w delta^2) and its
# quadratisation (r 2, r r + 1 2, sqrt, g 2 from w delta, H 3); w delta
# and w delta^2 are formed once a launch (HUBER_SETUP_OPS a component:
# the parameters are shared by the batch).
HUBER_TERM_OPS = 7
HUBER_QUAD_OPS = 10
HUBER_SETUP_OPS = 2


def cost_op_counts(ntau, huber):
    """(stage cost, C tau + c or its pseudo-Huber counterpart g with H)
    operations on ntau components: a QuadCost's 0.5 tau^T C tau + c^T
    tau (_quad_lin_cost) and C tau + c, or the pseudo-Huber terms summed
    and the quadratisation.  The batch-shared products of the pseudo-
    Huber parameters are ``cost_setup_ops``, counted once a launch."""
    if huber:
        return HUBER_TERM_OPS * ntau + ntau - 1, HUBER_QUAD_OPS * ntau
    return ntau * (2 * ntau + 2), ntau * 2 * ntau


def cost_setup_ops(ntau, huber):
    """Operations on the cost's parameters alone, once a launch: the
    pseudo-Huber cost's w_i delta and w_i delta^2; none for a QuadCost."""
    return HUBER_SETUP_OPS * ntau if huber else 0


def trust_ops(nc, delta_u):
    """Operations that a ``delta_u`` trust region adds to a rollout step
    of every forward kernel: u - delta and u + delta for each control
    (2 nc).  Its max and min on the QP's box and the trial's clamp, and a
    ``u_zero_I`` mask's selects, are compares and selects: none."""
    return 2 * nc if delta_u else 0


def _op_counts(T, ns, nc, step_ops, jac_ops, huber=False, delta_u=False):
    """Operation counts of the pieces K1 and K3 share (n_ctrl = 1): one
    stage cost, one Riccati sweep over the horizon, the control of one
    rollout step (with a trust region its ``trust_ops``) and the
    full-step norm."""
    if nc != 1:
        raise ValueError('the operation counts are for the n_ctrl = 1 '
                         'kernels')
    ntau = ns + nc
    stage, cb = cost_op_counts(ntau, huber)
    box = 9                                        # 1-D box QP + gains
    vupd = ns * ns + ns + 2 * ns * (ns + 1) + 1 + 5 * ns
    ric_t = (ns * ntau * (2 * ns - 1)              # W = V F
             + ntau * (ntau + 1) // 2 * 2 * ns     # Qt = C + F^T W
             + ntau * 2 * ns                       # qt = cb + F^T v
             + jac_ops + cb + box + vupd)
    return dict(stage=stage,
                riccati=(T - 1) * ric_t + cb + box + vupd,
                ctrl=ns + (2 * ns - 1) + 3 + trust_ops(nc, delta_u),
                full_du=2 * T + 1,
                rollout=(T - 1) * step_ops)


def pendulum_op_counts(damped):
    """(step, Jacobian) operations of the simple or the damped pendulum
    (csrc/pendulum.cuh)."""
    return ((_DAMPED_STEP_OPS, _DAMPED_JAC_OPS) if damped
            else (_STEP_OPS, _JAC_OPS))


def k1_flops(T, ns, nc, lqr_iter, n_alpha, batch=1, damped=False,
             huber=False, delta_u=False):
    """Arithmetic operations the solve K1 computes needs (each +, -, *,
    /, sqrt, sin, cos counts one; compares and selects none): the least
    work of the function, not of one implementation of it.

    ``batch`` examples each roll out their initial trajectory and sum
    its cost; between them they run ``lqr_iter`` outer iterations (one
    Riccati sweep and one full-step norm each; the current cost is the
    accepted trial's, so it is not summed again) and ``n_alpha`` line-
    search trial rollouts with their costs in total: the trials up to
    the selected step size, which a search has to run, and whose winner
    is the new trajectory (pass the sums over the batch of n_iter and of
    stats[5], the selected step size's index plus one summed over the
    iterations, so data-dependent early stops are counted as they
    ran).  ``damped`` counts the damped pendulum's step and Jacobian,
    ``huber`` the pseudo-Huber cost (its terms in every stage cost, its
    quadratisation where a QuadCost's C tau + c is, and its batch-shared
    products once, ``cost_setup_ops``); ``delta_u`` a trust region's
    bounds u -+ delta in each trial step (``trust_ops``; a ``u_zero_I``
    mask adds only selects)."""
    n = _op_counts(T, ns, nc, *pendulum_op_counts(damped), huber=huber,
                   delta_u=delta_u)
    init = n['rollout'] + T * n['stage']
    trial = T * (n['ctrl'] + n['stage']) + n['rollout']
    per_iter = n['riccati'] + n['full_du'] + 4
    return (batch * init + lqr_iter * per_iter + n_alpha * trial
            + cost_setup_ops(ns + nc, huber))


# Operations of an activation and of its derivative from the
# pre-activation, as csrc/nn.cuh computes them: sigmoid 0.5 (tanh(0.5 v)
# + 1) (3 and the tanh) and s (1 - s) (2 more); relu none (a compare);
# elu exp(v) - 1 and exp(v) (counted whichever side v is on).
_NN_ACT_OPS = {'sigmoid': (4, 6), 'relu': (0, 0), 'elu': (2, 1)}


def nn_op_counts(hidden, activation, passthrough, n_in=4, ns=3):
    """(step, Jacobian) operations of K3's MLP step, counted from
    csrc/nn.cuh: per hidden unit the pre-activation (n_in products, n_in
    sums with b1) and the activation, then for the step n_state
    multiply-adds and for the Jacobian n_state products w2 act' and
    n_state * n_in multiply-adds; after the units b2 and the passthrough
    (the Jacobian's diagonal 1)."""
    act, dact = _NN_ACT_OPS[activation]
    pre = 2 * n_in
    step = hidden * (pre + act + 2 * ns) + ns + (ns if passthrough else 0)
    jac = hidden * (pre + dact + ns + 2 * ns * n_in) + (
        ns if passthrough else 0)
    return step, jac


def k3_flops(T, ns, nc, lqr_iter, n_alpha, batch=1, *, lindx=True,
             has_f=False, nn_ops=None, damped=False, huber=False,
             delta_u=False):
    """Arithmetic operations the solve K3 computes needs, counted as
    ``k1_flops`` counts K1's: the initial rollout with its cost, and per
    outer iteration one Riccati sweep (a LinDx Jacobian is a load) and
    the trial rollouts up to the selected step size (``n_alpha``:
    stats[5] summed over the batch), whose winner is the new trajectory:
    no rollout to commit it and no second sum of the current cost.
    ``nn_ops``, the (step, Jacobian) counts of ``nn_op_counts``, counts
    an MLP's instead of the pendulum's (``lindx`` False; ``damped`` the
    damped pendulum's); ``huber`` the pseudo-Huber cost's and
    ``delta_u`` a trust region's, as in ``k1_flops``."""
    opts = dict(huber=huber, delta_u=delta_u)
    if lindx:
        step_ops = ns * (2 * (ns + nc) - 1) + (ns if has_f else 0)
        n = _op_counts(T, ns, nc, step_ops, 0, **opts)
    else:
        n = _op_counts(T, ns, nc, *(nn_ops or pendulum_op_counts(damped)),
                       **opts)
    init = n['rollout'] + T * n['stage']
    trial = T * (n['ctrl'] + n['stage']) + n['rollout']
    per_iter = n['riccati'] + n['full_du'] + 4
    return (batch * init + lqr_iter * per_iter + n_alpha * trial
            + cost_setup_ops(ns + nc, huber))


def k1_bytes(ops):
    """Bytes K1 or K3 must move for the operands ``ops``
    (``k1_operands`` or ``k3_operands``): each input read once, shared
    ones once for the whole batch (the cost build's parameter vector in
    place of C and c; a shared mask once), and each output (x, u and six
    stats rows) written once.  K3's workspace is neither."""
    T, B = ops['u0'].shape
    ins = [ops[k] for k in ('params', 'cost_params', 'F', 'f', 'C', 'c',
                            'x0', 'u0', 'lb', 'ub', 'uz')
           if ops.get(k) is not None]
    out = (T * B * 4 + 6 * B) * ops['x0'].element_size()
    return sum(a.numel() * a.element_size() for a in ins) + out


k3_bytes = k1_bytes


# ---------------------------------------------------------------------------
# the plain version of K1
# ---------------------------------------------------------------------------

def _dot(a, b):
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


def _stage_cost(Ct, ct, tau):
    """0.5 tau^T C tau + c^T tau in mpc_tpu's _quad_lin_cost order
    (mpc_tpu/ops/fused.py:468-476)."""
    acc = None
    for i in range(len(tau)):
        term = (0.5 * _dot(Ct[i], tau) + ct[i]) * tau[i]
        acc = term if acc is None else acc + term
    return acc


def _quad_cost_parts(C, c, cost_params, T):
    """What the plain K1 and K3 read of the cost: ``stage(t, tau)`` the
    stage cost of the components ``tau`` (a list of [B] tensors) and
    ``quad(t, tau)`` (C_t as a 4 x 4 list, C_t tau + c_t); for the
    pseudo-Huber cost (``cost_params`` [w, goal, delta], C and c None)
    the terms summed in sequence, and (diag(H) with exact zeros
    elsewhere, g) at tau, as csrc/cost.cuh computes them."""
    if cost_params is not None:
        cp = tuple(cost_params.unbind())

        def stage(t, tau):
            return huber_cost(tau, cp)

        def quad(t, tau):
            H, g = huber_quad(tau, cp)
            zero = torch.zeros_like(tau[0])
            return [[H[i] if i == j else zero for j in range(4)]
                    for i in range(4)], g
        return stage, quad
    Cl = [[[C[t, :, i, j] for j in range(4)] for i in range(4)]
          for t in range(T)]
    cl = [[c[t, :, i] for i in range(4)] for t in range(T)]

    def stage(t, tau):
        return _stage_cost(Cl[t], cl[t], tau)

    def quad(t, tau):
        return Cl[t], [_dot(Cl[t][i], tau) + cl[t][i] for i in range(4)]
    return stage, quad


def _at(rows, t):
    """Row t of a list of per-step rows, or None for an absent operand."""
    return None if rows is None else rows[t]


def _check_trust_region(delta_u, has_bounds):
    if delta_u is not None and not has_bounds:
        raise ValueError('delta_u needs bounds: its trust region is '
                         'intersected with the box')


def _ctrl_1d(Quu, qu, Qux, u_t, lb_t, ub_t, uz_t, delta_u):
    """The control solve of one step at one control, as K1 and K3 compute
    it (mpc_tpu/ops/fused.py:872-942, 1475-1527): (K_t, k_t, QP trips).
    With bounds the closed-form 1-D box QP on lo = lb - u and hi = ub - u,
    narrowed to [-delta_u, delta_u] by a trust region; without, the
    Newton step, whose k and K are zero where ``uz_t`` pins the control
    (the mask never enters the box QP)."""
    inv = 1.0 / Quu
    zero = torch.zeros_like(qu)
    if lb_t is not None:
        lo = lb_t - u_t
        hi = ub_t - u_t
        if delta_u is not None:
            lo = torch.clamp_min(lo, -delta_u)
            hi = torch.clamp_max(hi, delta_u)
        kv = torch.clamp(-qu * inv, lo, hi)
        g = Quu * kv + qu
        clamped = ((kv == lo) & (g > 0)) | ((kv == hi) & (g < 0))
        return [torch.where(clamped, zero, -q * inv) for q in Qux], kv, 1.0
    kt = -qu * inv
    Kt = [-q * inv for q in Qux]
    if uz_t is not None:
        free = uz_t < 0.5
        kt = torch.where(free, kt, zero)
        Kt = [torch.where(free, v, zero) for v in Kt]
    return Kt, kt, 0.0


def _trial_ctrl(v, u_old, lb_t, ub_t, uz_t, delta_u):
    """A rollout's control from its unclamped value ``v`` as K1 and K3
    take it (mpc_tpu/ops/fused.py:1019-1032, 1681-1692): zero where
    ``uz_t`` pins it, then clamped to the box, which a trust region
    intersects with [u_old - delta_u, u_old + delta_u] around the current
    iterate's control ``u_old``."""
    if uz_t is not None:
        v = torch.where(uz_t > 0.5, torch.zeros_like(v), v)
    if lb_t is None:
        return v
    lo, hi = lb_t, ub_t
    if delta_u is not None:
        lo = torch.maximum(u_old - delta_u, lo)
        hi = torch.minimum(u_old + delta_u, hi)
    return torch.clamp(v, lo, hi)


def fused_solve_plain(dynamics, params, C, c, x0, u0, lb, ub, *, alphas,
                      lqr_iter, eps, best_cost_eps, not_improved_lim,
                      recompute_cost=False, cost_params=None, uz=None,
                      delta_u=None):
    """The plain PyTorch version of kernel K1, on the kernel's operands.

    ``dynamics`` a pendulum, params its [3] (g, m, l) or, damped, [5]
    (g, m, l, d, b); C [T, 1 or B, 4, 4]; c [T, 1 or B, 4]; or, for the
    cost build, C and c None and ``cost_params`` the pseudo-Huber cost's
    [w, goal, delta] [9] (``PseudoHuberCost.kernel_params``);
    x0 [B, 3]; u0 [T, B]; lb, ub None or [T, 1 or B]; ``alphas`` the
    line-search schedule as Python floats.  Returns x [T, B, 3],
    u [T, B, 1] and stats [6, B]: best cost, best full-step norm,
    n_iter, n_qp_iter, alpha and the selected step size's index plus one
    summed over the iterations.

    Same arithmetic in the same order as csrc/fused_ilqr.cu.  The kernel
    rolls the step sizes out side by side and takes the first passing
    one, else the last; here all examples try each step size until every
    one has passed, and each keeps its first passing trial, which
    selects the same one.  The current cost is carried from the accepted
    trial, as in the kernel; ``recompute_cost=True`` sums it anew every
    iteration instead, which gives the same bits (the tests hold that).

    ``uz`` None or [T, 1 or B], 1 where the control is pinned to zero
    (the MPC_HAS_UZ build), and ``delta_u`` None or the trust region's
    half-width (bounds required), as the JAX kernel applies them
    (``_ctrl_1d`` and ``_trial_ctrl``).
    """
    T = u0.shape[0]
    B = x0.shape[0]
    ns = 3
    has_bounds = lb is not None
    _check_trust_region(delta_u, has_bounds)
    p = tuple(params.unbind())
    step = dynamics.soa_step
    jac = dynamics.soa_jacobian
    zero = x0.new_zeros(B)
    stage_tau, quad = _quad_cost_parts(C, c, cost_params, T)
    lbl = ubl = None
    if has_bounds:
        lbl = [lb[t] + zero for t in range(T)]
        ubl = [ub[t] + zero for t in range(T)]
    uzl = None if uz is None else [uz[t] + zero for t in range(T)]

    def stage(t, xt, ut):
        return stage_tau(t, list(xt) + [ut])

    x = [list(x0.unbind(-1))]
    u = list(u0.unbind(0))
    for t in range(T - 1):
        x.append(list(step(tuple(x[t]), u[t], p)))

    def total_cost(xs, us):
        acc = stage(0, xs[0], us[0])
        for t in range(1, T):
            acc = acc + stage(t, xs[t], us[t])
        return acc

    cost_cur = total_cost(x, u)
    best_x, best_u = x, u
    best_cost = zero + BIG
    best_du = zero + BIG
    cur_du = zero + BIG
    nni = zero.clone()
    n_qp = zero.clone()
    alpha_sel = zero + 1.0
    n_it = zero.clone()
    n_trials = zero.clone()
    active = torch.ones(B, dtype=torch.bool, device=x0.device)

    for it in range(lqr_iter):
        # ---- Riccati backward recursion with the 1-D box QP ----------
        K = [None] * T
        k = [None] * T
        V = v = None
        qp_cnt = 0.0
        for t in range(T - 1, -1, -1):
            Ct, cb = quad(t, x[t] + [u[t]])
            if t == T - 1:
                Qt = [[Ct[i][j] for j in range(4)] for i in range(4)]
                qt = cb
            else:
                F = jac(tuple(x[t]), u[t], p)
                W = [[_dot(V[i], [F[kk][j] for kk in range(ns)])
                      for j in range(4)] for i in range(ns)]
                Qt = [[None] * 4 for _ in range(4)]
                for a in range(4):
                    for b in range(a, 4):
                        Qt[a][b] = Ct[a][b] + _dot(
                            [F[kk][a] for kk in range(ns)],
                            [W[kk][b] for kk in range(ns)])
                        Qt[b][a] = Qt[a][b]
                qt = [cb[a] + _dot([F[kk][a] for kk in range(ns)], v)
                      for a in range(4)]
            Quu = Qt[3][3]
            qu = qt[3]
            Kt, kt, qp_inc = _ctrl_1d(Quu, qu, [Qt[3][j] for j in range(ns)],
                                      u[t], _at(lbl, t), _at(ubl, t),
                                      _at(uzl, t), delta_u)
            qp_cnt += qp_inc
            K[t], k[t] = Kt, kt
            # cost-to-go: V = Qxx + Qxu K + K^T Qux + K^T Quu K; likewise v
            QK = [[Qt[i][3] * Kt[j] for j in range(ns)] for i in range(ns)]
            KQuu = [Quu * Kt[j] for j in range(ns)]
            Vn = [[None] * ns for _ in range(ns)]
            for i in range(ns):
                for j in range(i, ns):
                    Vn[i][j] = (Qt[i][j] + QK[i][j]) + (
                        QK[j][i] + Kt[i] * KQuu[j])
                    Vn[j][i] = Vn[i][j]
            quk = qu + Quu * kt
            V = Vn
            v = [(qt[i] + Qt[i][3] * kt) + Kt[i] * quk for i in range(ns)]

        # ---- line search: first passing step size, else the last -----
        old_cost = total_cost(x, u) if recompute_cost else cost_cur
        found = torch.zeros(B, dtype=torch.bool, device=x0.device)
        for ki, a in enumerate(alphas):
            nx = [x[0]]
            nu = []
            cost_a = None
            for t in range(T):
                dx = [nx[t][i] - x[t][i] for i in range(ns)]
                ut = _trial_ctrl(_dot(K[t], dx) + (u[t] + a * k[t]), u[t],
                                 _at(lbl, t), _at(ubl, t), _at(uzl, t),
                                 delta_u)
                nu.append(ut)
                sc = stage(t, nx[t], ut)
                cost_a = sc if cost_a is None else cost_a + sc
                if t < T - 1:
                    nx.append(list(step(tuple(nx[t]), ut, p)))
            take = ~found
            n_trials = n_trials + (take & active).to(x0.dtype)
            if ki == 0:
                du2 = (u[0] - nu[0]) * (u[0] - nu[0])
                for t in range(1, T):
                    du2 = du2 + (u[t] - nu[t]) * (u[t] - nu[t])
                full_du = torch.sqrt(du2)
                sel_x, sel_u, sel_cost = nx, nu, cost_a
                sel_alpha = zero + a
            else:
                sel_x = [[torch.where(take, nx[t][i], sel_x[t][i])
                          for i in range(ns)] for t in range(T)]
                sel_u = [torch.where(take, nu[t], sel_u[t])
                         for t in range(T)]
                sel_cost = torch.where(take, cost_a, sel_cost)
                sel_alpha = torch.where(take, zero + a, sel_alpha)
            found = found | (take & (cost_a <= old_cost))
            if bool(found.all()):
                break

        # ---- best tracking and per-example stopping ------------------
        improved = sel_cost <= best_cost + best_cost_eps
        take_best = active & (improved | (it == 0))
        nni = torch.where(active, torch.where(
            improved & (it != 0), zero, nni + 1.0), nni)
        x = [[torch.where(active, sel_x[t][i], x[t][i]) for i in range(ns)]
             for t in range(T)]
        u = [torch.where(active, sel_u[t], u[t]) for t in range(T)]
        best_x = [[torch.where(take_best, sel_x[t][i], best_x[t][i])
                   for i in range(ns)] for t in range(T)]
        best_u = [torch.where(take_best, sel_u[t], best_u[t])
                  for t in range(T)]
        best_cost = torch.where(take_best, sel_cost, best_cost)
        best_du = torch.where(take_best, full_du, best_du)
        cur_du = torch.where(active, full_du, cur_du)
        n_qp = n_qp + torch.where(active, zero + qp_cnt, zero)
        alpha_sel = torch.where(active, sel_alpha, alpha_sel)
        n_it = n_it + active.to(x0.dtype)
        cost_cur = torch.where(active, sel_cost, cost_cur)
        active = active & (cur_du >= eps) & (nni <= not_improved_lim)
        if not bool(active.any()):
            break

    xs = torch.stack([torch.stack(best_x[t], -1) for t in range(T)], 0)
    us = torch.stack(best_u, 0).unsqueeze(-1)
    stats = torch.stack([best_cost, best_du, n_it, n_qp, alpha_sel,
                         n_trials], 0)
    return xs, us, stats


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGTYPES = [
    ctypes.c_int, _P, _P,                 # B, params, cost parameters
    _P, _I64, _I64,                       # C, t stride, batch stride
    _P, _I64, _I64,                       # c, t stride, batch stride
    _P, _P,                               # x0, u0
    _P, _P, _I64, _I64,                   # lb, ub, t stride, batch stride
    _P, _I64, _I64,                       # u_zero_I, t stride, batch stride
    ctypes.c_float,                       # delta_u (+inf: none)
    ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # alphas (host), n
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int,           # slots, shared memory bytes
    _P, _P, _P,                           # x, u, stats
    _P,                                   # stream
]


def _optional_defines(d, huber, has_uz):
    """``d`` with the defines of the optional builds: the pseudo-Huber
    cost (MPC_COST = 1) and the u_zero_I mask (MPC_HAS_UZ = 1), each left
    out where absent (0 in the sources), so that an earlier build keeps
    its defines and its library."""
    if huber:
        d = dict(d, MPC_COST=1)
    if has_uz:
        d = dict(d, MPC_HAS_UZ=1)
    return d


def kernel_defines(T, has_bounds, damped=False, huber=False,
                   has_uz=False) -> dict:
    """The nvcc defines of the K1 build for this horizon and bounds, of
    the simple pendulum or the damped, biased one (MPC_DAMPED), of a
    QuadCost or, ``huber``, the pseudo-Huber cost (MPC_COST = 1; a
    QuadCost build leaves it out, 0 in the source), and with ``has_uz``
    the u_zero_I mask (MPC_HAS_UZ = 1, likewise).  The trust region
    delta_u is a run-time argument (+inf where there is none)."""
    d = {'MPC_T': T, 'MPC_HAS_BOUNDS': int(has_bounds), 'MPC_TEAM': TEAM,
         'MPC_WARPS': K1_WARPS, 'MPC_DAMPED': int(damped)}
    return _optional_defines(d, huber, has_uz)


def _kernel_lib(T, has_bounds, damped=False, huber=False, has_uz=False):
    from . import _build
    fn = _build.load('fused_ilqr', kernel_defines(
        T, has_bounds, damped, huber, has_uz)).mpc_fused_ilqr
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_float4(name, *operands):
    """The kernels read C, c and F sixteen bytes at a time."""
    for a in operands:
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f'{name} takes C, c and F aligned to 16 bytes')


def _check_device(name, a):
    """The kernels and their plain versions run on the card and the CPU;
    on any other device the wrappers raise (the ops' fake versions would
    answer there with empty tensors)."""
    if a.device.type not in ('cpu', 'cuda'):
        raise NotImplementedError(f'{name} runs on cuda or cpu, not '
                                  f'{a.device.type}')


def _batch_stride(a, inner):
    return 0 if a.shape[1] == 1 else inner


def _opt_float(v):
    return None if v is None else float(v)


def fused_ilqr(dynamics, params, C, c, x0, u0, lb, ub, *, alphas, lqr_iter,
               eps, best_cost_eps, not_improved_lim, cost_params=None,
               uz=None, delta_u=None):
    """Run K1 on its operands (layouts as in ``fused_solve_plain``)
    through the op ``mpc_tpu_torch::k1_solve`` (ops/custom.py).

    On the CPU the op runs ``fused_solve_plain``.  On a CUDA tensor it
    launches csrc/fused_ilqr.cu on the current stream with the geometry
    of ``k1_launch`` and raises on any operand the kernel does not take
    or on a launch error (the launcher refuses, as an invalid value, an
    array too large for its 32-bit indices).  ``dynamics`` must be a
    pendulum, the model of K1's source: the simple one (params [3]) or
    the damped, biased one (params [5]; the build's MPC_DAMPED).  With
    ``cost_params`` (C and c None) the cost build runs the pseudo-Huber
    cost (MPC_COST); with ``uz`` (a [T, 1 or B] mask, 1 pinned) the
    MPC_HAS_UZ build pins controls to zero; ``delta_u`` (bounds
    required) is the trust region."""
    _check_device('K1', x0)
    if not isinstance(dynamics, PendulumDx):
        raise ValueError('K1 runs the pendulum')
    return torch.ops.mpc_tpu_torch.k1_solve(
        params, C, c, x0, u0, lb, ub, [float(a) for a in alphas],
        int(lqr_iter), float(eps), float(best_cost_eps),
        float(not_improved_lim), cost_params, uz, _opt_float(delta_u))


# ---------------------------------------------------------------------------
# the plain version of K3
# ---------------------------------------------------------------------------

def fused_solve_long_plain(dynamics, params, F, f, C, c, x0, u0, lb, ub, *,
                           alphas, lqr_iter, eps, best_cost_eps,
                           not_improved_lim, trace=None, cost_params=None,
                           uz=None, delta_u=None):
    """The plain PyTorch version of kernel K3, on the kernel's operands.

    ``dynamics`` is a ``PendulumDx`` with ``params`` [3] or, damped, [5]
    (F and f None),
    a one-hidden-layer ``NNDynamics`` with ``params`` its flat weights
    (``kernel_params``; F and f None), or None for LinDx with F
    [T-1, 1 or B, 3, 4] and f None or [T-1, 1 or B, 3];
    C [T, 1 or B, 4, 4]; c [T, 1 or B, 4] (or, for the cost build, C and
    c None and ``cost_params`` the pseudo-Huber cost's [w, goal, delta]);
    x0 [B, 3]; u0 [T, B]; lb, ub None or [T, 1 or B]; ``alphas`` the line-search
    schedule as Python floats.  Returns x [T, B, 3], u [T, B, 1] and
    stats [6, B]: best cost, best full-step norm, n_iter, n_qp_iter,
    alpha and the selected step size's index plus one summed over the
    iterations.

    Same arithmetic in the same order as csrc/fused_ilqr_long.cu: the
    current cost is carried from the last accepted trial.  The kernel
    rolls the step sizes out side by side, each trial keeping its
    trajectory, and the first passing one (else the last) becomes the
    current trajectory; here the trials keep only their cost, all
    examples try each step size until every active one has passed, and
    one more rollout with each example's selected step size writes the
    new trajectory: the same operations on the same numbers, so the same
    trajectory.  An MLP's step is the kernel's split over a warp's lanes,
    ``fused_dense.mlp_step_lanes`` (each output's lane partials over
    every 32nd unit summed in the butterfly's tree: another order than
    the model's ``soa_stream_step``, ROADMAP section 3), its Jacobian the
    model's ``soa_stream_jac`` (csrc/nn.cuh); the kernel computes the
    Jacobians of a sweep in a pass before it, at the same points, so the
    same values.

    ``trace``, a list, receives one (iteration, step-size index, current
    cost, trial cost, tried, full-step norm) per trial, ``tried`` marking
    the examples still searching: the decisions of the line search, for
    a caller that wants to know where they were ties of round-off.

    ``uz`` and ``delta_u`` as in ``fused_solve_plain`` (read_uz,
    ctrl_solve and _ctrl_from, mpc_tpu/ops/fused.py:1233-1236,
    1475-1515, 1681-1692).
    """
    T = u0.shape[0]
    B = x0.shape[0]
    ns = 3
    has_bounds = lb is not None
    _check_trust_region(delta_u, has_bounds)
    lindx = dynamics is None
    zero = x0.new_zeros(B)
    stage_tau, quad = _quad_cost_parts(C, c, cost_params, T)
    lbl = ubl = None
    if has_bounds:
        lbl = [lb[t] + zero for t in range(T)]
        ubl = [ub[t] + zero for t in range(T)]
    uzl = None if uz is None else [uz[t] + zero for t in range(T)]
    if lindx:
        Fl = [[[F[t, :, i, j] for j in range(4)] for i in range(ns)]
              for t in range(T - 1)]
        fl = None if f is None else [[f[t, :, i] for i in range(ns)]
                                     for t in range(T - 1)]

        def step(t, xt, ut):
            tau = list(xt) + [ut]
            out = [_dot(Fl[t][i], tau) for i in range(ns)]
            if fl is not None:
                out = [out[i] + fl[t][i] for i in range(ns)]
            return out

        def jac(t, xt, ut):
            return Fl[t]
    elif isinstance(dynamics, NNDynamics):
        from .fused_dense import mlp_step_lanes

        def step(t, xt, ut):
            return list(mlp_step_lanes(dynamics, tuple(xt), ut, params))

        def jac(t, xt, ut):
            return dynamics.soa_stream_jac(tuple(xt), ut, params)
    else:
        p = tuple(params.unbind())

        def step(t, xt, ut):
            return list(dynamics.soa_step(tuple(xt), ut, p))

        def jac(t, xt, ut):
            return dynamics.soa_jacobian(tuple(xt), ut, p)

    def stage(t, xt, ut):
        return stage_tau(t, list(xt) + [ut])

    def control(t, xt, K, k, alpha):
        dx = [xt[i] - x[t][i] for i in range(ns)]
        return _trial_ctrl((_dot(K[t], dx) + u[t]) + alpha * k[t], u[t],
                           _at(lbl, t), _at(ubl, t), _at(uzl, t), delta_u)

    # ---- init: x <- rollout(u0), best <- the same, its cost ------------
    x = [list(x0.unbind(-1))]
    u = list(u0.unbind(0))
    cost_cur = stage(0, x[0], u[0])
    for t in range(T - 1):
        x.append(step(t, x[t], u[t]))
        cost_cur = cost_cur + stage(t + 1, x[t + 1], u[t + 1])
    best_x, best_u = x, u
    best_cost = zero + BIG
    best_du = zero + BIG
    cur_du = zero + BIG
    nni = zero.clone()
    n_qp = zero.clone()
    alpha_sel = zero + 1.0
    n_it = zero.clone()
    n_trials = zero.clone()
    active = torch.ones(B, dtype=torch.bool, device=x0.device)

    for it in range(lqr_iter):
        # ---- Riccati backward recursion with the 1-D box QP ----------
        K = [None] * T
        k = [None] * T
        V = v = None
        qp_cnt = 0.0
        for t in range(T - 1, -1, -1):
            Ct, cb = quad(t, x[t] + [u[t]])
            if t == T - 1:
                Qt = [[Ct[i][j] for j in range(4)] for i in range(4)]
                qt = cb
            else:
                Ft = jac(t, x[t], u[t])
                W = [[_dot(V[i], [Ft[kk][j] for kk in range(ns)])
                      for j in range(4)] for i in range(ns)]
                Qt = [[None] * 4 for _ in range(4)]
                for a in range(4):
                    for b in range(a, 4):
                        Qt[a][b] = Ct[a][b] + _dot(
                            [Ft[kk][a] for kk in range(ns)],
                            [W[kk][b] for kk in range(ns)])
                        Qt[b][a] = Qt[a][b]
                qt = [cb[a] + _dot([Ft[kk][a] for kk in range(ns)], v)
                      for a in range(4)]
            Quu = Qt[3][3]
            qu = qt[3]
            Kt, kt, qp_inc = _ctrl_1d(Quu, qu, [Qt[3][j] for j in range(ns)],
                                      u[t], _at(lbl, t), _at(ubl, t),
                                      _at(uzl, t), delta_u)
            qp_cnt += qp_inc
            K[t], k[t] = Kt, kt
            # cost-to-go, summed left to right (vv_update,
            # mpc_tpu/ops/fused.py:1546-1573)
            QK = [[Qt[i][3] * Kt[j] for j in range(ns)] for i in range(ns)]
            KQuu = [Quu * Kt[j] for j in range(ns)]
            Vn = [[None] * ns for _ in range(ns)]
            for i in range(ns):
                for j in range(i, ns):
                    Vn[i][j] = ((Qt[i][j] + QK[i][j]) + QK[j][i]) \
                        + Kt[i] * KQuu[j]
                    Vn[j][i] = Vn[i][j]
            quk = qu + Quu * kt
            V = Vn
            v = [(qt[i] + Qt[i][3] * kt) + Kt[i] * quk for i in range(ns)]

        # ---- line search: cost-only trials, the first passing step
        # size, else the last --------------------------------------------
        old_cost = cost_cur
        found = torch.zeros(B, dtype=torch.bool, device=x0.device)
        for ki, a in enumerate(alphas):
            xt = x[0]
            cost_a = None
            du2 = None
            for t in range(T):
                ut = control(t, xt, K, k, a)
                sc = stage(t, xt, ut)
                cost_a = sc if cost_a is None else cost_a + sc
                if ki == 0:
                    d2 = (u[t] - ut) * (u[t] - ut)
                    du2 = d2 if du2 is None else du2 + d2
                if t < T - 1:
                    xt = step(t, xt, ut)
            take = ~found
            n_trials = n_trials + (take & active).to(x0.dtype)
            if ki == 0:
                full_du = torch.sqrt(du2)
                sel_cost = cost_a
                sel_alpha = zero + a
            else:
                sel_cost = torch.where(take, cost_a, sel_cost)
                sel_alpha = torch.where(take, zero + a, sel_alpha)
            if trace is not None:
                trace.append((it, ki, old_cost, cost_a, take & active,
                              full_du))
            found = found | (take & (cost_a <= old_cost))
            if bool((found | ~active).all()):
                break

        # ---- commit: re-roll with each lane's selected step size ------
        improved = sel_cost <= best_cost + best_cost_eps
        take_best = active & (improved | (it == 0))
        new_x, new_u = [], []
        xt = x[0]
        for t in range(T):
            ut = control(t, xt, K, k, sel_alpha)
            new_x.append([torch.where(active, xt[i], x[t][i])
                          for i in range(ns)])
            new_u.append(torch.where(active, ut, u[t]))
            if t < T - 1:
                xt = step(t, xt, ut)
        best_x = [[torch.where(take_best, new_x[t][i], best_x[t][i])
                   for i in range(ns)] for t in range(T)]
        best_u = [torch.where(take_best, new_u[t], best_u[t])
                  for t in range(T)]
        x, u = new_x, new_u

        # ---- best tracking and per-example stopping ------------------
        nni = torch.where(active, torch.where(
            improved & (it != 0), zero, nni + 1.0), nni)
        best_cost = torch.where(take_best, sel_cost, best_cost)
        best_du = torch.where(take_best, full_du, best_du)
        cur_du = torch.where(active, full_du, cur_du)
        n_qp = n_qp + torch.where(active, zero + qp_cnt, zero)
        alpha_sel = torch.where(active, sel_alpha, alpha_sel)
        n_it = n_it + active.to(x0.dtype)
        cost_cur = torch.where(active, sel_cost, cost_cur)
        active = active & (cur_du >= eps) & (nni <= not_improved_lim)
        if not bool(active.any()):
            break

    xs = torch.stack([torch.stack(best_x[t], -1) for t in range(T)], 0)
    us = torch.stack(best_u, 0).unsqueeze(-1)
    stats = torch.stack([best_cost, best_du, n_it, n_qp, alpha_sel,
                         n_trials], 0)
    return xs, us, stats


# ---------------------------------------------------------------------------
# K3's wrapper
# ---------------------------------------------------------------------------

_ARGTYPES_LONG = [
    ctypes.c_int, ctypes.c_int, _P,       # B, T, params
    ctypes.c_int, ctypes.c_int,           # MLP: hidden units, passthrough
    _P,                                   # cost parameters
    _P, _I64, _I64,                       # F, t stride, batch stride
    _P, _I64, _I64,                       # f, t stride, batch stride
    _P, _I64, _I64,                       # C, t stride, batch stride
    _P, _I64, _I64,                       # c, t stride, batch stride
    _P, _P,                               # x0, u0
    _P, _P, _I64, _I64,                   # lb, ub, t stride, batch stride
    _P, _I64, _I64,                       # u_zero_I, t stride, batch stride
    ctypes.c_float,                       # delta_u (+inf: none)
    ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # alphas (host), n
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    _P, ctypes.c_int, ctypes.c_int,       # workspace, its slots, shared
    ctypes.c_int, ctypes.c_int,           # memory bytes, resident, staged
    _P, _P, _P,                           # x, u, stats
    _P,                                   # clocks (the phase account)
    _P,                                   # stream
]


# csrc/nn.cuh's activations, by their MPC_ACT define
NN_ACTIVATIONS = ('sigmoid', 'relu', 'elu')


def long_kernel_defines(lindx, has_bounds, activation=None,
                        damped=False, huber=False, has_uz=False,
                        n_alpha=1) -> dict:
    """The nvcc defines of the K3 build for these dynamics and bounds:
    LinDx, the pendulum (``damped``: the damped, biased one, MPC_DAMPED),
    or with ``activation`` an MLP (MPC_DYN 0, 1, 2); of a QuadCost or,
    ``huber``, the pseudo-Huber cost (MPC_COST = 1, left out for a
    QuadCost); with ``has_uz`` the u_zero_I mask (MPC_HAS_UZ = 1, left out
    without one).  The pendulum's ``n_alpha`` step sizes set its team's
    width (``_k3_team``)."""
    if activation is not None:
        d = {'MPC_DYN': 2, 'MPC_ACT': NN_ACTIVATIONS.index(activation),
             'MPC_HAS_BOUNDS': int(has_bounds), 'MPC_TEAM': 32,
             'MPC_WARPS': K3_NN_WARPS, 'MPC_MIN_BLOCKS': K3_NN_MIN_BLOCKS,
             'MPC_OP_ROW': _K3_OPERAND_ROW}
    else:
        team, warps = _k3_team(lindx, n_alpha)
        d = {'MPC_DYN': 0 if lindx else 1,
             'MPC_HAS_BOUNDS': int(has_bounds), 'MPC_TEAM': team,
             'MPC_WARPS': warps,
             'MPC_OP_ROW': _k3_op_row(lindx, huber, has_bounds, has_uz),
             'MPC_RING': K3_RING, 'MPC_DAMPED': int(damped)}
    return _optional_defines(d, huber, has_uz)


def _kernel_lib_long(defines):
    from . import _build
    fn = _build.load('fused_ilqr_long', defines).mpc_fused_ilqr_long
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_LONG
        fn.restype = ctypes.c_int
    return fn


def _strided(a, inner):
    """(pointer, t stride, batch stride) of a [T', 1 or B, ...] operand
    with ``inner`` elements per example and step; batch stride 0 for a
    shared one."""
    if a is None:
        return None, 0, 0
    return a.data_ptr(), a.shape[1] * inner, _batch_stride(a, inner)


def k3_workspace(geo, T, B, device):
    """K3's workspace for the geometry ``geo`` of ``k3_launch``: the
    trial slots (and the state's two where it is not resident; the MLP
    configuration's slots where they are not resident, else none),
    [t, slot, b] of float4, so that the 8 examples of a team warp share
    one 128-byte line per slot; None where it has no slots."""
    if not geo['slots']:
        return None
    return torch.empty((T, geo['slots'], B, 4), dtype=torch.float32,
                       device=device)


def fused_ilqr_long(dynamics, params, F, f, C, c, x0, u0, lb, ub, *, alphas,
                    lqr_iter, eps, best_cost_eps, not_improved_lim,
                    cost_params=None, uz=None, delta_u=None):
    """Run K3 on its operands (layouts as in ``fused_solve_long_plain``)
    through the op ``mpc_tpu_torch::k3_solve`` (ops/custom.py).

    On the CPU the op runs ``fused_solve_long_plain``.  On a CUDA tensor
    it allocates the workspace of ``k3_launch``, launches
    csrc/fused_ilqr_long.cu on the current stream and raises on any
    operand the kernel does not take or on a launch error (the launcher
    refuses, as an invalid value, an array or a workspace too large for
    its 32-bit indices).  With ``cost_params`` (C and c None) the cost
    build runs the pseudo-Huber cost (MPC_COST); ``uz`` and ``delta_u``
    as in ``fused_ilqr``."""
    return torch.ops.mpc_tpu_torch.k3_solve(*k3_args(
        dynamics, params, F, f, C, c, x0, u0, lb, ub, alphas=alphas,
        lqr_iter=lqr_iter, eps=eps, best_cost_eps=best_cost_eps,
        not_improved_lim=not_improved_lim, cost_params=cost_params, uz=uz,
        delta_u=delta_u))


def k3_args(dynamics, params, F, f, C, c, x0, u0, lb, ub, *, alphas,
            lqr_iter, eps, best_cost_eps, not_improved_lim, cost_params=None,
            uz=None, delta_u=None) -> tuple:
    """``fused_ilqr_long``'s operands, checked, as the arguments of the op
    ``k3_solve`` (and of ``custom.k3_run`` and ``custom.k3_build``)."""
    _check_device('K3', x0)
    nn_hidden, activation, passthrough = 0, '', False
    if isinstance(dynamics, NNDynamics):
        gap = ('K3 runs a one-hidden-layer MLP of 3 states and 1 control; '
               'the dense configuration takes every other MLP'
               if routes_dense(dynamics, dynamics.n_state, dynamics.n_ctrl)
               else nn_scope_gap(dynamics))
        if gap is not None:
            raise ValueError(gap)
        nn_hidden, activation = dynamics.hidden, dynamics.activation
        passthrough = bool(dynamics.passthrough)
    elif dynamics is not None and not isinstance(dynamics, PendulumDx):
        raise ValueError('K3 runs LinDx (dynamics None), a pendulum or a '
                         'one-hidden-layer MLP')
    if (dynamics is None) != (params is None):
        raise ValueError('K3 takes params for the pendulum and an MLP, and '
                         'none for LinDx')
    return (params, F, f, C, c, x0, u0, lb, ub, [float(a) for a in alphas],
            int(lqr_iter), float(eps), float(best_cost_eps),
            float(not_improved_lim), nn_hidden, activation, passthrough,
            cost_params, uz, _opt_float(delta_u))


# ---------------------------------------------------------------------------
# host-side launcher
# ---------------------------------------------------------------------------

def _cost_operand(a, T, B, n_lead, dtype, device):
    """Shared [n] / [T, n] or batched [T, B, n] (n the trailing dims) to
    a contiguous [T, 1 or B, n]."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.dim() == n_lead:
        a = a.expand((T,) + a.shape)
    if a.dim() == n_lead + 1:
        a = a.unsqueeze(1)
    if a.dim() != n_lead + 2 or a.shape[0] != T or a.shape[1] not in (1, B):
        raise ValueError(f'unexpected cost shape {tuple(a.shape)}')
    return a.contiguous()


def _bound_operand(a, T, B, dtype, device):
    """Scalar, [T, 1] or [T, B, 1] bounds to a contiguous [T, 1 or B]."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.dim() == 0:
        a = a.expand(T, 1)
    elif a.dim() == 3 and a.shape[1] in (1, B):
        a = a[..., 0]
    elif a.dim() != 2:
        raise ValueError(f'unexpected bound shape {tuple(a.shape)}')
    if a.shape[0] != T or a.shape[1] not in (1, B):
        raise ValueError(f'unexpected bound shape {tuple(a.shape)}')
    return a.contiguous()


def mask_operand(u_zero_I, T, B, nc, dtype, device):
    """A u_zero_I mask, [T, n_ctrl] shared or [T, B, n_ctrl] batched (bool
    or 0/1), to a contiguous [T, 1 or B, n_ctrl] in the kernels' dtype, 1
    where the control is pinned to zero, as the TPU kernel casts it
    (mpc_tpu/ops/fused.py:2270-2280); None for no mask."""
    if u_zero_I is None:
        return None
    a = torch.as_tensor(u_zero_I, device=device).to(dtype)
    if a.dim() == 2:
        a = a.unsqueeze(1)
    if a.dim() != 3 or a.shape[0] != T or a.shape[1] not in (1, B) \
            or a.shape[2] != nc:
        raise ValueError(f'unexpected u_zero_I shape {tuple(a.shape)}')
    return a.contiguous()


def trust_region(cfg, dtype):
    """``cfg.delta_u`` as the kernels get it: the float32 value of the
    Python float in float32 (the JAX kernel bakes it in as a float32
    constant), None for no trust region."""
    if cfg.delta_u is None:
        return None
    d = float(cfg.delta_u)
    return array.array('f', [d])[0] if dtype == torch.float32 else d


def _dyn_operand(a, T, B, n_lead, dtype, device):
    """A LinDx leaf, shared [T-1, ...] or batched [T-1, B, ...], to a
    contiguous [T-1, 1 or B, ...]."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.dim() == n_lead + 1:
        a = a.unsqueeze(1)
    if a.dim() != n_lead + 2 or a.shape[0] != T - 1 \
            or a.shape[1] not in (1, B):
        raise ValueError(f'unexpected LinDx shape {tuple(a.shape)} for '
                         f'T={T}, B={B}')
    return a.contiguous()


def line_search_schedule(cfg, dtype) -> list:
    """The line search's step sizes as the kernels get them: in float32
    the float32 values of the Python floats (the JAX kernel bakes the same
    floats in as float32 constants), rounded on the host so that
    torch.export sees constants."""
    alphas = [float(cfg.linesearch_decay) ** i
              for i in range(cfg.max_linesearch_iter)]
    if dtype == torch.float32:
        alphas = array.array('f', alphas).tolist()
    return alphas


def cost_operands(cost, T, B, dtype, device) -> dict:
    """The cost's operands of every forward kernel: a QuadCost's C
    [T, 1 or B, ntau, ntau] and c [T, 1 or B, ntau] (``cost_params``
    None), or the pseudo-Huber cost's [w, goal, delta] (2 ntau + 1
    values, detached; C and c None) for the kernels' cost build."""
    if isinstance(cost, PseudoHuberCost):
        return dict(C=None, c=None, cost_params=cost.kernel_params().to(
            device=device, dtype=dtype).contiguous())
    return dict(C=_cost_operand(cost.C, T, B, 2, dtype, device),
                c=_cost_operand(cost.c, T, B, 1, dtype, device),
                cost_params=None)


def _problem_operands(cfg, x_init, cost, u_init, u_lower, u_upper,
                      u_zero_I) -> dict:
    """The operands K1 and K3 share: cost, x0, u0, bounds, the mask uz
    [T, 1 or B] and the trust region delta_u, the line-search schedule and
    the solver's scalars."""
    T = cfg.T
    dtype, device = x_init.dtype, x_init.device
    x0 = x_init.contiguous()
    B = x0.shape[0]
    if u_init is None:
        u0 = torch.zeros((T, B), dtype=dtype, device=device)
    else:
        u0 = torch.as_tensor(u_init, dtype=dtype, device=device)
        if u0.dim() == 2:
            u0 = u0.unsqueeze(1)
        u0 = u0[..., 0].expand(T, B).contiguous()
    lb = ub = None
    if u_lower is not None:
        lb = _bound_operand(u_lower, T, B, dtype, device)
        ub = _bound_operand(u_upper, T, B, dtype, device)
    uz = mask_operand(u_zero_I, T, B, 1, dtype, device)
    return dict(
        **cost_operands(cost, T, B, dtype, device),
        x0=x0, u0=u0, lb=lb, ub=ub, uz=None if uz is None else uz[..., 0],
        delta_u=trust_region(cfg, dtype),
        alphas=line_search_schedule(cfg, dtype), lqr_iter=cfg.lqr_iter,
        eps=cfg.eps, best_cost_eps=cfg.best_cost_eps,
        not_improved_lim=float(cfg.not_improved_lim))


def _pendulum_params(dynamics, x0):
    return dynamics.params.to(device=x0.device, dtype=x0.dtype).contiguous()


def k1_operands(cfg, x_init, cost, dynamics, u_init=None,
                u_lower=None, u_upper=None, u_zero_I=None) -> dict:
    """K1's operands (the keyword arguments of ``fused_ilqr`` and
    ``fused_solve_plain``) on x_init's device and dtype.

    Layouts match learning.batched_solve: x_init [B, 3]; QuadCost leaves
    shared ([4, 4] / [T, 4, 4], [4] / [T, 4]) or batched ([T, B, ...]),
    or a pseudo-Huber cost (``cost_operands``);
    bounds scalar, [T, 1] or [T, B, 1]; u_init [T, 1] or [T, B, 1];
    u_zero_I None, [T, 1] or [T, B, 1] (``uz`` [T, 1 or B] of 0/1) and
    ``cfg.delta_u`` (``delta_u``).
    Shared operands keep a batch extent of 1 (batch stride 0 in the
    kernel)."""
    ops = _problem_operands(cfg, x_init, cost, u_init, u_lower, u_upper,
                            u_zero_I)
    return dict(ops, dynamics=dynamics,
                params=_pendulum_params(dynamics, ops['x0']))


def k3_operands(cfg, x_init, cost, dynamics, u_init=None,
                u_lower=None, u_upper=None, u_zero_I=None) -> dict:
    """K3's operands (the keyword arguments of ``fused_ilqr_long`` and
    ``fused_solve_long_plain``), layouts as in ``k1_operands``.  A LinDx
    (F [T-1, 3, 4] or [T-1, B, 3, 4]; f None, [T-1, 3] or [T-1, B, 3])
    gives ``dynamics=None``, ``params=None``, F [T-1, 1 or B, 3, 4] and f
    None or [T-1, 1 or B, 3]; the pendulum gives F = f = None, and an
    MLP F = f = None with its flat weights (``kernel_params``) as
    ``params``.

    Every leaf keeps its own layout: K3 reads each operand with its own
    batch stride, so a shared F beside a batched f (or a shared C beside
    a batched c) needs no broadcast, where the TPU kernel keys layouts
    per pair and normalises a mixed pair to batched
    (mpc_tpu/ops/fused.py:2021-2066)."""
    ops = _problem_operands(cfg, x_init, cost, u_init, u_lower, u_upper,
                            u_zero_I)
    if isinstance(dynamics, NNDynamics):
        w = dynamics.kernel_params().detach()
        return dict(ops, dynamics=dynamics, F=None, f=None,
                    params=w.to(device=x_init.device,
                                dtype=x_init.dtype).contiguous())
    if not isinstance(dynamics, LinDx):
        return dict(ops, dynamics=dynamics, F=None, f=None,
                    params=_pendulum_params(dynamics, ops['x0']))
    T, B = ops['u0'].shape
    dtype, device = x_init.dtype, x_init.device
    f = dynamics.f
    if f is not None:
        f = _dyn_operand(f, T, B, 1, dtype, device)
    return dict(ops, dynamics=None, params=None, f=f,
                F=_dyn_operand(dynamics.F, T, B, 2, dtype, device))


def solution_from_outputs(x, u, stats, eps) -> Solution:
    best_cost, best_du, n_it, n_qp, alpha = stats[:5].unbind(0)
    return Solution(
        x=x, u=u, costs=best_cost, full_du_norm=best_du,
        n_iter=n_it.to(torch.int32), n_qp_iter=n_qp.to(torch.int32),
        converged=best_du < eps, alpha=alpha)


def slew_problem(cfg, x_init, cost: QuadCost, dynamics, prev_ctrl):
    """The augmented problem that the kernels solve for a slew-penalised
    LinDx of any size, model of ``SOA_MODELS`` or MLP
    (mpc_tpu/ops/fused.py:2510-2580; K3 takes a LinDx at three augmented
    states and one control, the dense configuration everything else):
    (cfg, x_init [B, nc + ns], QuadCost, dynamics) with the state
    augmented by the previous control (prev_ctrl [B, n_ctrl], [n_ctrl]
    or None), each leaf in its own layout (a shared leaf stays shared);
    a LinDx's F and f augmented, a model wrapped in its passthrough step
    (``SlewSoA``).  The controls are the same, so a u_zero_I mask and the
    bounds pass to the augmented solve as they are
    (mpc_tpu/ops/fused.py:2576)."""
    import dataclasses

    from ..solver import (augment_cost, augment_lindx, prev_ctrl_operand,
                          slew_block)
    ns, nc = cfg.n_state, cfg.n_ctrl
    dtype, device = x_init.dtype, x_init.device

    def leaf(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    blk = slew_block(cfg.slew_rate_penalty, ns, nc, dtype, device)
    C, c = augment_cost(leaf(cost.C), leaf(cost.c), blk, nc)
    if isinstance(dynamics, LinDx):
        dynamics = LinDx(*augment_lindx(leaf(dynamics.F), leaf(dynamics.f),
                                        ns, nc))
    else:
        dynamics = SlewSoA(dynamics, nc)
    x0 = torch.cat([prev_ctrl_operand(cfg, prev_ctrl, x_init), x_init], -1)
    return (dataclasses.replace(cfg, n_state=ns + nc, slew_rate_penalty=None),
            x0, QuadCost(C, c), dynamics)


def fused_batched_solve(cfg, x_init, cost, dynamics,
                        u_init=None, u_lower=None, u_upper=None,
                        prev_ctrl=None, u_zero_I=None) -> Solution:
    """Batched solve through the dense configuration (``routes_dense``),
    K1 or K3 (``routes_long``) on x_init's device (layouts as in
    ``fused_dense.k3d_operands``, ``k1_operands`` and ``k3_operands``;
    a QuadCost or a pseudo-Huber cost, each kernel's cost build; a
    u_zero_I mask and ``cfg.delta_u``, each kernel's); under a slew
    penalty, of the augmented problem (``slew_problem``)."""
    kw = dict(u_init=u_init, u_lower=u_lower, u_upper=u_upper,
              u_zero_I=u_zero_I)
    if cfg.slew_rate_penalty is not None:
        sol = fused_batched_solve(*slew_problem(cfg, x_init, cost, dynamics,
                                                prev_ctrl), **kw)
        # strip u_{t-1} from the augmented states (mpc/mpc.py:444)
        return sol._replace(x=sol.x[..., cfg.n_ctrl:])
    if routes_dense(dynamics, cfg.n_state, cfg.n_ctrl):
        from .fused_dense import fused_ilqr_dense, k3d_operands
        x, u, stats = fused_ilqr_dense(**k3d_operands(cfg, x_init, cost,
                                                      dynamics, **kw))
    elif routes_long(dynamics, cfg.T):
        x, u, stats = fused_ilqr_long(**k3_operands(cfg, x_init, cost,
                                                    dynamics, **kw))
    else:
        x, u, stats = fused_ilqr(**k1_operands(cfg, x_init, cost, dynamics,
                                               **kw))
    return solution_from_outputs(x, u, stats, cfg.eps)
