"""K3's dense configuration: the iLQR solve of a LinDx problem of any
admitted n_state and n_ctrl on Hopper, and its plain PyTorch version.

Counterpart of the general-size configurations of the TPU kernels
``_make_kernel`` and ``_make_kernel_long`` (mpc_tpu/ops/fused.py:617-1119,
1126-1932): LinDx dynamics or a model's step (the model-step build,
MPC_MODEL: the pendulums, the cartpole and, MPC_MODEL 4, an MLP of 1 to
``MAX_NN_DEPTH`` hidden layers, csrc/nn_dense.cuh, where the TPU kernels
take its stream form or tuple path, :1252-1340), a QuadCost or the
pseudo-Huber cost (its cost build, MPC_COST), and the control solve of the
problem's regime (``ctrl_solve``, :1464-1544): the closed-form 1-D box
QP for one control, the in-kernel projected-Newton box QP
(``_pnqp_kernel``, :534-616) on the masked unrolled Cholesky
(``_cholesky``, ``_chol_solve``, ``_masked_free_chol``, :479-533) for
several bounded controls, and the Cholesky with a 1e-11 jitter for
several unbounded ones.

The kernel is csrc/fused_ilqr_dense.cu (+ csrc/riccati_dense.cuh,
box_qp.cuh, box_qp_smem.cuh): ONE WARP AN EXAMPLE, the Riccati step's
products as register tiles, lane r owning row r of the cost-to-go V and
of Q's tile, so n_state + n_ctrl <= 32 (``fused.DENSE_MAX_TAU``); the
second set of tiles where it pays (``dense_prefetch``); n_state, n_ctrl and
the bounds and f flags are nvcc defines (``dense_kernel_defines``), so
the small loops unroll; the layouts (each operand shared or batched) are
run-time batch strides, as in K3.  The launch geometry is computed here
(``k3d_launch``, with the MLP build's Jacobian chunk, ``mlp_chunk``), so
the CPU tests reach it.

``fused_solve_dense_plain`` is the plain version: each kernel scalar is
a [B] tensor (a row of lanes a [B, n] tensor) and every sum runs in the
kernel's order: a dot product over its index from the first term on, a
sum over the warp's lanes (a stage cost, the full step's squares) by
the xor-butterfly of warp shuffles (``_lane_sum``).  It runs in any
float dtype; the entry points run it for tensors on the CPU, and on a
CUDA tensor ``fused_ilqr_dense`` launches the kernel or raises, through
the op ``mpc_tpu_torch::k3d_solve`` (ops/custom.py).
"""

from __future__ import annotations

import array
import ctypes

import torch

from ..models.cartpole import CartpoleDx
from ..models.dynamics import _ACTS_SOA, NNDynamics, _pre
from ..models.pendulum import PendulumDx
from ..types import LinDx
from ..models.cost import huber_quad, huber_terms
from .fused import (_NN_ACT_OPS, BIG, MAX_ALPHA, NN_ACTIVATIONS,
                    SMEM_LIMIT, SlewSoA, _check_device,
                    _check_trust_region, _dyn_operand, _opt_float,
                    _optional_defines, cost_op_counts, cost_operands,
                    cost_setup_ops, dense_gap, line_search_schedule,
                    mask_operand, pendulum_op_counts, trust_ops,
                    trust_region)
from .math import sqrt_rn as _sqrt

# Examples (warps) a block of the dense kernel.  A warp's tiles of an
# example (Q, W, F and V, ``_warp_floats``) take 12.4 KB at 24 states and
# 4 controls, 16.3 KB at n_state + n_ctrl = 32, so a block of 4 takes
# 50-65 KB and three or four blocks share an SM.
DENSE_WARPS = 4
# An H100 SM's shared memory, 228 KB, of which each resident block
# reserves 1 KB; the blocks an SM the prefetch must leave (B = 2048, the
# medium and wide rows' batch, is 512 blocks, 3.9 an SM of 132).
SM_SMEM = 233472
BLOCK_RESERVED = 1024
PREFETCH_BLOCKS = 4
# An H100's SMs, over which a launch's blocks run in waves.
H100_SMS = 132
# the least floats of a step's operands (C_t and F_t) worth prefetching
PREFETCH_MIN_FLOATS = 512
# The most controls whose control solve runs on register arrays
# (csrc/box_qp.cuh: the block Quu, its factor and the box QP's vectors,
# nc^2 + nc (nc + 1) / 2 + 7 nc floats in every lane); past it the solve
# runs across the warp's lanes (csrc/box_qp_smem.cuh:kRegCtrlMax), its
# back substitution k descending with the diagonal's reciprocals
# (``_chol_solve_lanes``).
REG_CTRL_MAX = 8

# The projected-Newton box QP's constants (mpc_tpu/ops/fused.py:70-73):
# Armijo ratio, step-size decay and count, and the norm of the Newton
# step that freezes an example.
PNQP_GAMMA = 0.1
PNQP_LS_DECAY = 0.1
PNQP_MAX_LS = 10
PNQP_CONV_TOL = 1e-4
# the unbounded Cholesky's jitter (mpc_tpu/ops/fused.py:908-920, 1464-1544)
CHOL_JITTER = 1e-11
# The phases of the dense kernels' account (csrc/phase_clock.cuh:Phase, in
# its order): the clocked builds add each phase's cycles into [B, 11].
PHASES = ('jacobians', 'jac_reverse', 'stage', 'W', 'Q', 'factor', 'qp',
          'gains', 'cost_to_go', 'rollouts', 'other')
# the clocked build's counters at the end of a warp's tiles
# (phase_clock.cuh:kClockFloats: the phases rounded up to 4 floats)
PHASE_CLOCK_FLOATS = -(-len(PHASES) // 4) * 4


def _odd(n) -> int:
    """A row stride of a lane-per-row tile: odd, so that the 32 lanes
    reading one column of their rows hit 32 banks."""
    return n | 1


def _round4(n) -> int:
    return -(-n // 4) * 4


def riccati_tiles(ns, nc, prefetch) -> int:
    """The floats of the Riccati step's tiles in a warp's shared memory
    (csrc/riccati_dense.cuh:RiccatiStrides, the same in both dense
    kernels): F [sets][ns][sf], W [ns][sw], V [ns][sv] and Q [sets][ntau]
    [odd].  With ``prefetch`` two sets of F and Q (the next step's
    operands in flight) and the rows of F, W and V a multiple of 4 floats
    (16-byte loads); else one set, W's stride odd, F's ntau, V's odd."""
    nt = ns + nc
    sets = 2 if prefetch else 1
    if prefetch:
        sw = sf = _round4(nt)
        sv = _round4(ns)
    else:
        sw, sf, sv = _odd(nt), nt, _odd(ns)
    return sets * ns * sf + ns * sw + ns * sv + sets * nt * _odd(nt)


def _warp_floats(ns, nc, prefetch=None) -> int:
    """The floats of a warp's shared tiles (csrc/fused_ilqr_dense.cu, oF
    to oQhi): the Riccati step's (``riccati_tiles``), the vectors tau, q,
    c (one a set), v, dx, the gains K [nc][ns], k [nc] and K^T Quu
    [nc][ns]; past ``REG_CTRL_MAX`` controls the control solve's
    (``_ctrl_tile_floats``); padded to a multiple of 4.  ``prefetch`` None
    takes the LinDx build's (``dense_prefetch``)."""
    if prefetch is None:
        prefetch = dense_prefetch(ns, nc)
    nt = ns + nc
    n = (riccati_tiles(ns, nc, prefetch) + (4 if prefetch else 3) * nt
         + 2 * ns + 2 * nc * ns + nc + _ctrl_tile_floats(nc, 4))
    return n + -n % 4


def _ctrl_tile_floats(nc, rows) -> int:
    """The control solve's tiles past ``REG_CTRL_MAX`` controls
    (csrc/box_qp_smem.cuh): the factor L [nc][odd], its diagonal's
    reciprocals [nc] and ``rows`` vectors of nc (the forward's box QP: x,
    dx, lo, hi; the backward none); nothing at fewer controls, whose solve
    runs on registers."""
    return nc * _odd(nc) + (rows + 1) * nc if nc > REG_CTRL_MAX else 0


def dense_workspace_floats(T, ns, nc, model=False) -> int:
    """An example's workspace: two trajectory slots [2][T][ntau] (the
    current one and the trial), the gains [T][nc][ns + 1] (K then k) and,
    in the model-step and MLP builds, the step Jacobians of the current
    trajectory [T-1][ns][ntau] (720 floats at the cartpole's 5 states, 1
    control and T = 25; 1,170 floats in all).  It lives in global memory
    ([B][...], the example's region contiguous), or, in the model-step
    build where ``dense_ws_shared`` says so, in its warp's shared memory
    above the warp's tiles, rounded up to 4 floats
    (``_ws_shared_floats``)."""
    nt = ns + nc
    return T * (2 * nt + nc * (ns + 1)) + (
        (T - 1) * ns * nt if model else 0)


# The models of the dense kernel's model-step build (MPC_MODEL 1, 2, 3,
# 4; 0 is LinDx) and the parameter counts of the first three; an MLP
# ('mlp') is described by its layer widths, activation and passthrough
# (``mlp_spec``) and takes its flat weights.
DENSE_MODELS = ('pendulum', 'damped_pendulum', 'cartpole', 'mlp')
DENSE_MODEL_PARAMS = {'pendulum': 3, 'damped_pendulum': 5, 'cartpole': 4}
# The MLP build's hidden layers at most (csrc/nn_dense.cuh:kNNMaxDepth):
# its layout's arrays have this many entries; no deeper MLP is used
# anywhere in the repository.
MAX_NN_DEPTH = 4


def dense_model(dynamics):
    """(model name, slew) of a model the dense kernel runs: a pendulum,
    the cartpole, an MLP, or a ``SlewSoA`` of one of them."""
    slew = isinstance(dynamics, SlewSoA)
    inner = dynamics.inner if slew else dynamics
    if isinstance(inner, CartpoleDx):
        return 'cartpole', slew
    if isinstance(inner, PendulumDx):
        return ('pendulum' if inner.simple else 'damped_pendulum'), slew
    if isinstance(inner, NNDynamics):
        return 'mlp', slew
    raise ValueError(f'the dense kernel has no step for '
                     f'{type(inner).__name__}')


def mlp_spec(dynamics):
    """(layer widths (n_in, hidden..., n_state), activation, passthrough)
    of an MLP or a ``SlewSoA`` of one; None for any other model."""
    inner = dynamics.inner if isinstance(dynamics, SlewSoA) else dynamics
    if not isinstance(inner, NNDynamics):
        return None
    return inner.sizes, inner.activation, bool(inner.passthrough)


def model_params(dynamics):
    """The parameter vector the model-step build takes: an MLP's flat
    weights (``kernel_params``), the other models' ``params``."""
    inner = dynamics.inner if isinstance(dynamics, SlewSoA) else dynamics
    if isinstance(inner, NNDynamics):
        return inner.kernel_params()
    return inner.params


def model_of(name, slew, n_ctrl=1, mlp=None):
    """The plain model of a (model name, slew) pair, its step taking the
    parameters it is given (its own hold zeros; an MLP, of the
    ``mlp_spec`` ``mlp``, has no weights of its own)."""
    if name == 'mlp':
        m = NNDynamics.shaped(*mlp)
        n_ctrl = m.n_ctrl
    elif name == 'cartpole':
        m = CartpoleDx(params=torch.zeros(DENSE_MODEL_PARAMS[name]))
    else:
        m = PendulumDx(params=torch.zeros(DENSE_MODEL_PARAMS[name]),
                       simple=name == 'pendulum')
    return SlewSoA(m, n_ctrl) if slew else m


# The Jacobian pass's steps at once at most (csrc/nn_dense.cuh:kMaxChunk).
MLP_MAX_CHUNK = 4


def _mlp_base_floats(sizes):
    """The MLP build's one-step scratch (csrc/nn_dense.cuh,
    ``mlp_base_floats``), in units of the widest hidden layer wmax: two
    activation buffers, the derivatives of each hidden layer and, for the
    reverse product's rows, one (two hidden layers) or two (more) buffers
    of n_state x wmax.  A warp's scratch is never less, so that the gate
    (``mlp_gap``, at a chunk of one step) admits the same MLPs whatever
    the chunk."""
    depth, ns = len(sizes) - 2, sizes[-1]
    return max(sizes[1:-1]) * (2 + depth + ns * min(depth - 1, 2))


def _mlp_slot_floats(sizes):
    """A step of the Jacobian pass's chunk in a warp's scratch
    (``mlp_slot_floats``): the derivatives of every hidden layer, then the
    larger of the forward pass's inputs and one or two activation buffers
    and the reverse product's one or two buffers of rows [n_state]; the
    buffers are as wide as the widest hidden layer but the last."""
    depth, n_in, ns = len(sizes) - 2, sizes[0], sizes[-1]
    hidden = sizes[1:-1]
    g = min(depth - 1, 2)
    hmid = max(hidden[:-1], default=0)
    return sum(hidden) + max(n_in + g * hmid, g * ns * hmid)


def _mlp_scratch_floats(sizes, chunk=1, prefetch=False):
    """A warp's scratch of the MLP build with a chunk of ``chunk`` steps
    (csrc/nn_dense.cuh, ``mlp_scratch_floats``): the larger of the
    one-step base and the chunk's steps (the rollout's activation buffers
    share it), a multiple of 4 floats where the chunk's rows are vector
    loads (chunk > 1) or the layout prefetches, so that every warp's
    scratch starts 16-byte aligned."""
    s = max(_mlp_base_floats(sizes), chunk * _mlp_slot_floats(sizes))
    return _round4(s) if prefetch or chunk > 1 else s


def mlp_weight_floats(sizes):
    """The block's copy of the MLP's weights in shared memory: each layer's
    W [n_out][n_in | 1] (rows of odd stride: a lane a unit reads a column,
    a lane an input a row, both conflict-free) and b [n_out]."""
    return sum(b * _odd(a) + b for a, b in zip(sizes[:-1], sizes[1:]))


def k3d_smem_bytes(ns, nc, mlp_sizes=None, prefetch=None,
                   chunk=None) -> int:
    """The dense kernel's dynamic shared memory a block: the warps' tiles
    (``_warp_floats``) and, in the MLP build, each warp's scratch for a
    Jacobian chunk of ``chunk`` steps (``_mlp_scratch_floats``; None takes
    the build's, ``mlp_chunk``) and one copy of the weights above them;
    ``prefetch`` None takes the build's (``dense_prefetch``)."""
    if prefetch is None:
        prefetch = dense_prefetch(ns, nc, mlp_sizes)
    floats = DENSE_WARPS * _warp_floats(ns, nc, prefetch)
    if mlp_sizes is not None:
        if chunk is None:
            chunk = mlp_chunk(ns, nc, mlp_sizes, prefetch)
        floats += (DENSE_WARPS * _mlp_scratch_floats(mlp_sizes, chunk,
                                                     prefetch)
                   + mlp_weight_floats(mlp_sizes))
    return 4 * floats


def mlp_chunk(ns, nc, sizes, prefetch=None) -> int:
    """The steps the MLP build's Jacobian pass takes at once (a warp's
    register tiles over them, csrc/nn_dense.cuh): the most, up to
    ``MLP_MAX_CHUNK``, whose scratch keeps the block within 227 KB and an
    SM the blocks that one step gives (``blocks_an_sm``).  So it is sized
    from the shared memory left; where none is left it is one step, the
    one-step footprint (``_mlp_base_floats``).  The kernel
    takes the most steps whose scratch gives the same shared memory, which
    is this count."""
    if prefetch is None:
        prefetch = dense_prefetch(ns, nc, sizes)
    one = k3d_smem_bytes(ns, nc, sizes, prefetch, 1)
    best = 1
    for ch in range(2, MLP_MAX_CHUNK + 1):
        smem = k3d_smem_bytes(ns, nc, sizes, prefetch, ch)
        if smem <= SMEM_LIMIT and blocks_an_sm(smem) >= blocks_an_sm(one):
            best = ch
    return best


def _ws_shared_floats(T, ns, nc) -> int:
    """A warp's workspace in the shared layout: the model-step build's
    ``dense_workspace_floats``, a multiple of 4 floats."""
    return _round4(dense_workspace_floats(T, ns, nc, True))


def blocks_by_registers(regs, warps=DENSE_WARPS) -> int:
    """Blocks of ``warps`` warps an H100 SM holds by registers: 64K an SM,
    a warp's allocated in units of 256 (a lane's count rounded up to 8)."""
    return 65536 // (-(-regs // 8) * 8 * 32 * warps)


def waves(blocks, blocks_an_sm_) -> int:
    """Waves of a launch of ``blocks`` blocks at ``blocks_an_sm_``
    resident an SM on the H100's SMs."""
    return -(-blocks // (H100_SMS * blocks_an_sm_))


def step_min_blocks(ns, nc) -> int:
    """The model-step build's blocks an SM by registers at least: its
    __launch_bounds__ minimum (csrc/fused_ilqr_dense.cu:kStepMinBlocks).
    8 (64 registers a lane) up to n_tau = 5, the slew-augmented
    pendulums, whose headline row (B = 4096, 1,024 blocks) then runs in
    one wave; 4 (128) above, where 64 registers spill the cartpole's
    step and Jacobian, whose rows run one block an SM either way."""
    return 8 if ns + nc <= 5 else 4


def dense_ws_shared(T, B, ns, nc) -> bool:
    """Whether the model-step build keeps each example's workspace in its
    warp's shared memory (MPC_WS_SHARED, csrc/fused_ilqr_dense.cu): where
    the block stays within 227 KB (``fused.SMEM_LIMIT``) and the launch
    of B examples runs in no more waves than with the workspace in global
    memory, the blocks an SM taken as the fewer of those its shared
    memory leaves (``blocks_an_sm``) and ``step_min_blocks`` (its
    registers).  Config 3 (T=25, 4.7 KB an example) and the cartpole at
    T=200 and B=512 (38 KB an example, one block an SM: 128 blocks, one
    wave either way) take it; the cartpole at T=200 and B=2050 (513
    blocks: four waves at one block an SM, one in global memory) does
    not.  A build that prefetches (none of the models') keeps global
    memory."""
    if dense_prefetch(ns, nc):
        return False
    blocks = -(-B // DENSE_WARPS)
    glob = k3d_smem_bytes(ns, nc, prefetch=False)
    shared = glob + 4 * DENSE_WARPS * _ws_shared_floats(T, ns, nc)

    def resident(smem):
        return min(blocks_an_sm(smem), step_min_blocks(ns, nc))
    return (shared <= SMEM_LIMIT
            and waves(blocks, resident(shared)) <= waves(blocks,
                                                         resident(glob)))


def blocks_an_sm(smem_bytes, warps=DENSE_WARPS) -> int:
    """Blocks of ``warps`` warps an H100 SM holds by shared memory: 228 KB
    an SM, 1 KB of it reserved for each block, at most 64 warps."""
    return min(SM_SMEM // (smem_bytes + BLOCK_RESERVED), 64 // warps)


def prefetch_fits(ns, nc, smem_one, smem_two) -> bool:
    """Whether a dense kernel's second set of tiles (``smem_two`` bytes a
    block against ``smem_one`` with one set) is worth its memory and its
    copies: a step's operands C_t and F_t must be at least
    ``PREFETCH_MIN_FLOATS`` (16 copies a lane; below it starting and
    waiting on the copies costs more than the loads they hide: 5s1c, config 3 and the
    MLP rows ran 2-3% slower with it, 16s4c and 20s4c 9-10% faster, PERF.md
    section 6), fit 227 KB (``fused.SMEM_LIMIT``), and leave an SM
    at least as many blocks as one set does, or ``PREFETCH_BLOCKS``: a
    second wave of blocks would cost more than the prefetch saves (at 24
    states and 4 controls the second set takes 73 KB a block, three an
    SM, and B = 2048, 512 blocks, would no longer fit the card at once)."""
    nt = ns + nc
    return (nt * nt + ns * nt >= PREFETCH_MIN_FLOATS
            and smem_two <= SMEM_LIMIT
            and blocks_an_sm(smem_two) >= min(blocks_an_sm(smem_one),
                                              PREFETCH_BLOCKS))


def dense_prefetch(ns, nc, mlp_sizes=None) -> bool:
    """Whether the dense build prefetches the next step's operands
    (MPC_PREFETCH, csrc/riccati_dense.cuh), by ``prefetch_fits``.  A build
    without keeps one set and the lane-a-row strides: the tiles of
    ``_warp_floats(..., False)``, never more than the design before the
    prefetch took, so that no size or MLP the gate admits is refused."""
    return prefetch_fits(ns, nc, k3d_smem_bytes(ns, nc, mlp_sizes, False, 1),
                         k3d_smem_bytes(ns, nc, mlp_sizes, True, 1))


def mlp_gap(dynamics, slew_nc=0):
    """Why the dense configuration's MLP build does not take an MLP
    (under a slew penalty of ``slew_nc`` controls, its state augmented by
    them); None when it does.  The gate is this card's: the size gate
    (``fused.dense_gap``), 1 to ``MAX_NN_DEPTH`` hidden layers (the
    layout's arrays) and a block's shared memory, 227 KB
    (``fused.SMEM_LIMIT``), holding the four warps' tiles and scratch
    and one copy of the weights (``k3d_smem_bytes``), with the Jacobian
    pass one step at a time: a chunk of steps takes only the memory left
    (``mlp_chunk``), so the gate is where the one-step design put it.  It
    sits where the weights and the scratch fill a block: (64, 64) at 2
    states and 1 control takes 25,360 bytes (27,408 with its chunk of 2)
    and two hidden layers of 225 units fit there; a one-hidden-layer MLP
    at 8 states and 4 controls takes 8,768 bytes of tiles and 104 bytes a
    hidden unit, so up to 1,644 units.
    The weights are read at every unit of every step, so they stay in
    shared memory and nothing past the gate is streamed."""
    ns = dynamics.n_state + slew_nc
    gap = dense_gap(ns, dynamics.n_ctrl)
    if gap is not None:
        return gap
    sizes = dynamics.sizes
    if not 1 <= len(sizes) - 2 <= MAX_NN_DEPTH:
        return (f'an MLP of {len(sizes) - 2} hidden layers exceeds the dense '
                f'configuration\'s {MAX_NN_DEPTH} (its MLP build\'s layout); '
                'it runs on the eager solver')
    smem = k3d_smem_bytes(ns, dynamics.n_ctrl, sizes, prefetch=False,
                          chunk=1)
    if smem > SMEM_LIMIT:
        return (f'an MLP of hidden widths {sizes[1:-1]} needs {smem} bytes of '
                'a block\'s shared memory in the dense configuration (its '
                f'weights and four warps\' tiles and scratch), over the '
                f'{SMEM_LIMIT} an H100 block has; it runs on the eager solver')
    return None


def k3d_launch(T, B, ns, nc, n_alpha, model=False, mlp_sizes=None,
               clocks=False) -> dict:
    """The dense kernel's launch geometry: lanes an example (a warp),
    warps and examples a block, blocks, the dynamic shared memory of a
    block (``k3d_smem_bytes``: with an MLP's layer widths ``mlp_sizes``
    its weights and the warps' scratch too) and the workspace in global
    memory, [B, ``dense_workspace_floats``] of float32.  ``model`` (no
    ``mlp_sizes``) is the model-step build, whose workspace
    ``ws_shared`` (``dense_ws_shared``) puts in each warp's shared memory
    above its tiles instead: then the block's shared memory holds the
    four workspaces and the global one is empty.  ``n_alpha`` step sizes
    run one after another on the warp, so they change nothing here; it is
    checked against ``MAX_ALPHA``.  ``clocks``: the phase account's build,
    each warp's counters above its tiles (the layout is the build's
    without them); ``chunk`` the MLP build's Jacobian chunk
    (``mlp_chunk``), else 0."""
    if not 0 < n_alpha <= MAX_ALPHA:
        raise ValueError(f'the dense kernel takes 1 to {MAX_ALPHA} step '
                         'sizes')
    chunk = 0 if mlp_sizes is None else mlp_chunk(ns, nc, mlp_sizes)
    ws_shared = bool(model) and mlp_sizes is None and dense_ws_shared(
        T, B, ns, nc)
    smem = k3d_smem_bytes(ns, nc, mlp_sizes, chunk=chunk or None) + (
        4 * DENSE_WARPS * PHASE_CLOCK_FLOATS if clocks else 0)
    if ws_shared:
        smem += 4 * DENSE_WARPS * _ws_shared_floats(T, ns, nc)
    return dict(team=32, warps=DENSE_WARPS, examples=DENSE_WARPS,
                blocks=-(-B // DENSE_WARPS), smem_bytes=smem, chunk=chunk,
                ws_shared=ws_shared,
                workspace_bytes=0 if ws_shared else
                4 * B * dense_workspace_floats(T, ns, nc, model))


def dense_kernel_defines(ns, nc, has_bounds, has_f, model=None,
                         slew=False, huber=False, has_uz=False,
                         mlp=None, ws_shared=False) -> dict:
    """The nvcc defines of the dense build for these sizes, bounds and f
    (present or absent: a compile-time flag, so that no load goes through
    the pointer of an absent f); with ``model`` (a name of
    ``DENSE_MODELS``) the model-step build, which has no F or f operand
    (MPC_MODEL, and MPC_SLEW for the passthrough step), for an MLP with
    its ``mlp_spec`` ``mlp``'s activation (MPC_ACT, as K3's) and number
    of hidden layers (MPC_NN_DEPTH; the widths and the passthrough are
    run-time arguments); ``huber`` the
    cost build, which has no C or c operand (MPC_COST = 1, left out for a
    QuadCost); ``has_uz`` the u_zero_I mask (MPC_HAS_UZ = 1, left out
    without one, likewise a compile-time flag); ``ws_shared`` the
    model-step build's workspace in shared memory (MPC_WS_SHARED = 1, left
    out for global memory; ``k3d_launch``'s ``ws_shared``)."""
    d = _optional_defines({'MPC_NS': ns, 'MPC_NC': nc,
                           'MPC_HAS_BOUNDS': int(has_bounds),
                           'MPC_HAS_F': int(has_f),
                           'MPC_WARPS': DENSE_WARPS,
                           'MPC_PREFETCH': int(dense_prefetch(
                               ns, nc, mlp[0] if model == 'mlp' else None))},
                          huber, has_uz)
    if model is not None:
        if has_f:
            raise ValueError('the model-step build has no f')
        d.update(MPC_MODEL=DENSE_MODELS.index(model) + 1,
                 MPC_SLEW=int(slew))
        if model == 'mlp':
            sizes, activation, _ = mlp
            d.update(MPC_ACT=NN_ACTIVATIONS.index(activation),
                     MPC_NN_DEPTH=len(sizes) - 2)
    if ws_shared:
        if model is None or model == 'mlp':
            raise ValueError('only the model-step build keeps its '
                             'workspace in shared memory')
        d.update(MPC_WS_SHARED=1)
    return d


# ---------------------------------------------------------------------------
# work and bytes of one launch (the kernel's bound)
# ---------------------------------------------------------------------------

def _chol_ops(n, jitter) -> int:
    """+, -, *, /, sqrt of ``_cholesky`` on an n x n matrix."""
    ops = 0
    for j in range(n):
        ops += int(jitter) + 2 * j + 2
        ops += (n - 1 - j) * (2 * j + 1)
    return ops


def _solve_ops(n) -> int:
    """Of ``_chol_solve`` for one right-hand side."""
    return 2 * n * n


# (step, Jacobian) operations of the cartpole, counted from
# csrc/cartpole.cuh with the parameter-only terms hoisted as
# fused._STEP_OPS counts the pendulum's: the step (cart_in 5, th_acc 9,
# xacc 4, the renormalised rotation 16, the three Euler updates 6) and
# its Jacobian (cart_in, den, th_acc and 1 / den 15, the partials of
# cart_in 6, of den 4, of th_acc 10, of xacc 12, the rotation with its
# derivative 34, the rows' 11).  The slew passthrough adds none.
_CART_STEP_OPS = 40
_CART_JAC_OPS = 92


def mlp_op_counts(sizes, activation, passthrough):
    """(step, Jacobian) operations of an MLP of layer widths ``sizes`` in
    the MLP build, counted from csrc/nn_dense.cuh: the step's layers, each
    unit's pre-activation a dot product with its bias (2 n_in) and a
    hidden unit's activation, then the passthrough; the Jacobian's
    forward pass over the hidden layers (the pre-activations, the
    derivatives and the activations the next layer reads) and its
    reverse product, layer l down to the inputs: G act' (n_state h_l
    products) and its product with W_l (n_state n_in (2 h_l - 1)), the
    passthrough's diagonal last."""
    act, dact = _NN_ACT_OPS[activation]
    ns, depth = sizes[-1], len(sizes) - 2
    pairs = list(zip(sizes[:-1], sizes[1:]))
    step = sum(2 * a * b for a, b in pairs) + act * sum(sizes[1:-1])
    jac = 0
    for l, (a, b) in enumerate(pairs[:-1]):
        jac += 2 * a * b + dact * b + (act * b if l < depth - 1 else 0)
        jac += ns * b + ns * a * (2 * b - 1)
    if passthrough:
        step += ns
        jac += ns
    return step, jac


def model_op_counts(name, mlp=None):
    """(step, Jacobian) operations of a model of ``DENSE_MODELS`` (an MLP
    by its ``mlp_spec`` ``mlp``)."""
    if name == 'mlp':
        return mlp_op_counts(*mlp)
    if name == 'cartpole':
        return _CART_STEP_OPS, _CART_JAC_OPS
    return pendulum_op_counts(name == 'damped_pendulum')


def k3d_flops(T, ns, nc, lqr_iter, n_alpha, batch=1, *, has_f=False,
              has_bounds=True, n_qp=0, model_ops=None, huber=False,
              uz=False, delta_u=False):
    """Arithmetic operations the dense solve needs (each +, -, *, /,
    sqrt counts one; compares, selects and sign flips none), counted as
    ``fused.k3_flops`` counts K3's: ``batch`` initial rollouts with their
    cost, ``lqr_iter`` Riccati sweeps (pass the sum over the batch of
    n_iter), ``n_alpha`` trial rollouts (the sum of stats[5]: the trials
    up to the selected step size) and, for several bounded controls,
    ``n_qp`` projected-Newton trips (the sum of n_qp_iter), each with the
    first trial of its Armijo search, the least a search runs.
    ``model_ops``, a model's (step, Jacobian) counts
    (``model_op_counts``), counts the model-step build: its step in the
    rollouts and its T - 1 Jacobians before every sweep; ``huber`` the
    pseudo-Huber cost's terms in the stage costs and its quadratisation
    where a QuadCost's C tau + c is (``fused.cost_op_counts``), and its
    batch-shared products once (``fused.cost_setup_ops``); ``delta_u`` a
    trust region's bounds u -+ delta in each trial step
    (``fused.trust_ops``), and ``uz`` a mask, which without bounds at
    several controls takes the masked factor (no jitter) in place of the
    jittered one (its selects count none)."""
    nt = ns + nc
    stage, cb = cost_op_counts(nt, huber)
    step = ns * (2 * nt - 1) + (ns if has_f else 0)
    jac = 0
    if model_ops is not None:
        step, jac = model_ops
    if nc == 1:
        ctrl = ns + 1 + (6 if has_bounds else 2)
    elif has_bounds:
        # the gains from the last trip's factor, the bounds' offsets
        ctrl = ns * _solve_ops(nc) + 2 * nc
    else:
        ctrl = _chol_ops(nc, not uz) + (ns + 1) * _solve_ops(nc)
    vupd = (ns * ns * (2 * nc - 1) + nc * ns * (2 * nc - 1)
            + ns * (ns + 1) // 2 * (2 * nc + 2) + nc * (2 * nc - 1)
            + ns * 5 * nc)
    ric_t = (cb + ns * nt * (2 * ns - 1) + nt * (nt + 1) // 2 * 2 * ns
             + nt * 2 * ns + ctrl + vupd)
    riccati = (T - 1) * (ric_t + jac) + cb + ctrl + vupd
    if nc > 1 and has_bounds:
        # the unclamped solve that starts the search at t = T - 1
        riccati += _chol_ops(nc, True) + _solve_ops(nc)
    obj = nc * (2 * nc + 2)
    trip = (nc * 2 * nc + _chol_ops(nc, False) + _solve_ops(nc) + 2 * nc + 1
            + obj + 2 * nc + obj + 1 + 3 * nc + 1)
    ctrl_roll = ns + nc * (2 * ns + 2) + trust_ops(nc, delta_u)
    trial = T * (ctrl_roll + stage) + (T - 1) * step
    full_du = T * 3 * nc + 1
    init = T * stage + (T - 1) * step
    return (batch * init + lqr_iter * (riccati + full_du + 4)
            + n_alpha * trial + n_qp * trip + cost_setup_ops(nt, huber))


def k3d_bytes(ops):
    """Bytes the dense solve must move for the operands ``ops``
    (``k3d_operands``): each input read once, shared ones once for the
    whole batch (the cost build's parameter vector in place of C and c; a
    shared mask once), and each output (x, u and six stats rows) written
    once.  The workspace is neither."""
    T, B, nc = ops['u0'].shape
    ns = ops['x0'].shape[1]
    ins = [ops[k] for k in ('params', 'cost_params', 'F', 'f', 'C', 'c',
                            'x0', 'u0', 'lb', 'ub', 'uz')
           if ops.get(k) is not None]
    out = (T * B * (ns + nc) + 6 * B) * ops['x0'].element_size()
    return sum(a.numel() * a.element_size() for a in ins) + out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _lane_sum(terms):
    """The sum over the last axis (a lane each, at most 32) in the order
    of the kernel's xor-butterfly of warp shuffles: the lanes beyond the
    axis hold 0, and level by level lane i adds lane i ^ o for o = 16, 8,
    4, 2, 1 (every lane ends with the same bits)."""
    n = terms.shape[-1]
    a = torch.nn.functional.pad(terms, (0, 32 - n))
    for o in (16, 8, 4, 2, 1):
        a = a[..., :o] + a[..., o:2 * o]
    return a[..., 0]


def mlp_step_lanes(nn, xs, u, params):
    """The MLP build's step (csrc/nn_dense.cuh:mlp_step) on component
    tensors, as ``NNDynamics.soa_step`` takes them: its hidden layers (each
    unit's pre-activation from the first term on, then the bias and the
    activation), then each output's dot product over the last hidden layer
    summed as the kernel splits it over a warp's lanes: lane l's partial
    over the units l, l + 32, ... from the first term on (0 past the
    width), the 32 partials by the xor butterfly (``_lane_sum``), then the
    bias and the passthrough.  Only that sum's order differs from
    ``soa_step``'s."""
    z0 = nn._soa_inputs(xs, u)
    layers = nn._flat_layers(params)
    z = z0
    for W, b in layers[:-1]:
        z = _ACTS_SOA[nn.activation](_pre(z, W, b))
    W, b = layers[-1]
    h = W.shape[1]
    # the products [..., n_out, slot, lane], 0 past the width; lane l's
    # partial adds its slots in order (a 0 leaves a partial unchanged)
    n = -(-h // 32) * 32
    terms = torch.nn.functional.pad(W * z.unsqueeze(-2), (0, n - h))
    terms = terms.unflatten(-1, (n // 32, 32))
    parts = terms[..., 0, :]
    for slot in range(1, n // 32):
        parts = parts + terms[..., slot, :]
    out = _lane_sum(parts) + b
    if nn.passthrough:
        out = out + z0[..., :nn.n_state]
    return tuple(out.unbind(-1))


def _dot(a, b, dim):
    """sum_k a[k] b[k] along ``dim`` (broadcast), from the first term
    on, k ascending: the kernel's order of every dot product."""
    acc = a.select(dim, 0) * b.select(dim, 0)
    for k in range(1, a.shape[dim]):
        acc = acc + a.select(dim, k) * b.select(dim, k)
    return acc


def _upper(M):
    """M's upper triangle mirrored below the diagonal, as the kernel
    writes a symmetric matrix (mpc_tpu/ops/fused.py:1660-1664)."""
    n = M.shape[-1]
    up = torch.ones(n, n, dtype=torch.bool, device=M.device).triu()
    return torch.where(up, M, M.transpose(-1, -2))


def _cholesky(A, jitter=0.0):
    """``_cholesky`` (mpc_tpu/ops/fused.py:479-499) on a list of lists of
    [...] tensors: L (lower, zeros above), in its order.  Past
    ``REG_CTRL_MAX`` the same arithmetic on the stacked matrix
    (``_cholesky_columns``)."""
    n = len(A)
    if n > REG_CTRL_MAX:
        return _Factor(_cholesky_columns(_stack(A), jitter))
    z = torch.zeros_like(A[0][0])
    L = [[z] * n for _ in range(n)]
    for j in range(n):
        s = A[j][j] + jitter if jitter else A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = _sqrt(torch.clamp_min(s, 1e-30))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s2 = A[i][j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv
    return L


def _stack(M):
    """A list of lists of [...] tensors stacked, [..., n, n]."""
    return torch.stack([torch.stack(list(r), -1) for r in M], -2)


class _Factor:
    """A factor stacked, [..., n, n] (``m``), which the solves past
    ``REG_CTRL_MAX`` read, that reads as ``_cholesky``'s list of rows of
    [...] tensors where indexed (a row built at each access)."""

    def __init__(self, m):
        self.m = m

    def __len__(self):
        return self.m.shape[-1]

    def __getitem__(self, i):
        return [self.m[..., i, j] for j in range(len(self))]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _cholesky_columns(A, jitter=0.0):
    """``_cholesky`` of A [..., n, n], a column at a time, each column's
    rows side by side: every entry takes ``_cholesky``'s terms in its
    order (A_ij + jitter, then - L_i0 L_j0, - L_i1 L_j1, ...; the root,
    the reciprocal), so it has its bits, in n^2 / 2 tensor operations
    where the loop over entries takes n^3 / 3.  Returns L [..., n, n]."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        s = A[..., j:, j]
        if jitter:
            s = torch.cat([s[..., :1] + jitter, s[..., 1:]], -1)
        for k in range(j):
            s = s - cols[k][..., j:] * cols[k][..., j:j + 1]
        d = _sqrt(torch.clamp_min(s[..., :1], 1e-30))
        cols.append(torch.cat([A.new_zeros(A.shape[:-2] + (j,)), d,
                               s[..., 1:] * (1.0 / d)], -1))
    return torch.stack(cols, -1)


def _chol_solve(L, b):
    """``_chol_solve`` (mpc_tpu/ops/fused.py:502-516): (L L^T) x = b, b a
    list of tensors whose leading axes are L's (trailing ones are more
    right-hand sides)."""
    n = len(L)
    extra = b[0].dim() - L[0][0].dim()

    def e(v):
        return v.reshape(v.shape + (1,) * extra)

    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - e(L[i][k]) * y[k]
        y[i] = s / e(L[i][i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - e(L[k][i]) * x[k]
        x[i] = s / e(L[i][i])
    return x


def _chol_solve_lanes(L, b):
    """(L L^T) x = b as the kernels solve it past ``REG_CTRL_MAX``
    controls, a row a lane (csrc/box_qp_smem.cuh:solve_lanes): the forward
    substitution of ``_chol_solve``, and the back substitution with its
    terms taken k descending (x_{n-1} is ready first): x_i = (y_i -
    L_{n-1,i} x_{n-1} - L_{n-2,i} x_{n-2} - ...) (1 / L_ii); each
    division a product with the diagonal's reciprocal (the factor's
    ``1.0 / L[j][j]``).  b as ``_chol_solve``'s."""
    m = L.m if isinstance(L, _Factor) else _stack(L)
    d = m.dim() - 2
    return list(_lanes_solve(m, torch.stack(b, d), d).unbind(d))


def _lanes_solve(L, b, d):
    """``_chol_solve_lanes`` on L [..., n, n] and b stacked with its rows
    on axis ``d`` (L's leading axes first, more right-hand sides after):
    each step's rows side by side, every entry's terms in the order of
    the lanes (so their bits).  Returns x stacked as b."""
    n = L.shape[-1]
    extra = b.dim() - d - 1

    def e(v):
        return v.reshape(v.shape + (1,) * extra)

    inv = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    s, y = b, []
    for k in range(n):
        y.append(s.select(d, 0) * e(inv[..., k]))
        if k + 1 < n:
            s = s.narrow(d, 1, n - k - 1) - (e(L[..., k + 1:, k])
                                             * y[k].unsqueeze(d))
    s, x = torch.stack(y, d), [None] * n
    for k in range(n - 1, -1, -1):
        x[k] = s.select(d, k) * e(inv[..., k])
        if k:
            s = s.narrow(d, 0, k) - e(L[..., k, :k]) * x[k].unsqueeze(d)
    return torch.stack(x, d)


def _solve_rows(L, b):
    """The control solve's triangular solves in the kernels' order:
    ``_chol_solve`` up to ``REG_CTRL_MAX`` controls (every lane on
    registers), ``_chol_solve_lanes`` past it."""
    return (_chol_solve_lanes if len(L) > REG_CTRL_MAX else _chol_solve)(L, b)


def _masked_free_chol(H, free):
    """``_masked_free_chol`` (mpc_tpu/ops/fused.py:519-533): the factor of
    H with the clamped rows and columns zeroed and a unit diagonal on
    them."""
    n = len(H)
    if n > REG_CTRL_MAX:
        return _masked_free_columns(_stack(H), torch.stack(free, -1))
    z = torch.zeros_like(H[0][0])
    Hm = [[torch.where(free[i] & free[j], H[i][j], z) for j in range(n)]
          for i in range(n)]
    for i in range(n):
        Hm[i][i] = torch.where(free[i], H[i][i], z + 1.0)
    return _cholesky(Hm)


def _masked_free_columns(H, free):
    """``_masked_free_chol`` of H [..., n, n] stacked and the free set
    [..., n]: the ``_Factor`` of ``_cholesky_columns``."""
    n = H.shape[-1]
    M = torch.where(free[..., :, None] & free[..., None, :], H, 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=H.device)
    diag = torch.where(free, torch.diagonal(H, dim1=-2, dim2=-1), 1.0)
    return _Factor(_cholesky_columns(torch.where(eye, torch.diag_embed(diag),
                                                 M)))


def _pnqp_steps(dtype):
    """The Armijo search's step sizes 0.1^k as the kernel has them (the
    float32 values of the Python floats, as the JAX kernel bakes them
    in)."""
    steps = [PNQP_LS_DECAY ** k for k in range(PNQP_MAX_LS)]
    if dtype == torch.float32:
        steps = array.array('f', steps).tolist()
    return steps


def _pnqp(H, q, lo, hi, x0, n_iter):
    """``_pnqp_kernel`` (mpc_tpu/ops/fused.py:534-616), batched: H, q,
    lo, hi and the start x0 lists of [B] tensors.  The start is clamped;
    each trip takes the Newton direction on the free set (clamped:
    at a bound with the gradient pushing out), stops an example whose
    step norm is below PNQP_CONV_TOL (its x stays), else takes the first
    of the ten step sizes whose Armijo ratio exceeds PNQP_GAMMA, else the
    last.  Returns (x, L_free, free, trips): the factor and free set of
    the last trip an example ran, the trips it ran.  Trips stop once
    every example has stopped, which changes nothing: a stopped
    example's trip recomputes the same factor from the same x."""
    n = len(q)
    if n > REG_CTRL_MAX:
        return _pnqp_stacked(H, q, lo, hi, x0, n_iter)
    z = torch.zeros_like(q[0])
    x = [torch.clamp(x0[i], lo[i], hi[i]) for i in range(n)]
    done = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    trips = z.clone()
    L = [[z + float(i == j) for j in range(n)] for i in range(n)]
    free = [torch.ones_like(done) for _ in range(n)]
    steps = torch.tensor(_pnqp_steps(z.dtype), dtype=z.dtype,
                         device=z.device).reshape((-1,) + (1,) * z.dim())

    def obj(v):
        acc = None
        for i in range(n):
            s = H[i][0] * v[0]
            for j in range(1, n):
                s = s + H[i][j] * v[j]
            term = (0.5 * s + q[i]) * v[i]
            acc = term if acc is None else acc + term
        return acc

    for _ in range(n_iter):
        if bool(done.all()):
            break
        g = []
        for i in range(n):
            s = H[i][0] * x[0]
            for j in range(1, n):
                s = s + H[i][j] * x[j]
            g.append(s + q[i])
        clamped = [((x[i] == lo[i]) & (g[i] > 0))
                   | ((x[i] == hi[i]) & (g[i] < 0)) for i in range(n)]
        fr = [~c for c in clamped]
        g_ = [torch.where(clamped[i], z, g[i]) for i in range(n)]
        Lf = _masked_free_chol(H, fr)
        dx = [-v for v in _solve_rows(Lf, g_)]
        dx2 = dx[0] * dx[0]
        for i in range(1, n):
            dx2 = dx2 + dx[i] * dx[i]
        done_new = done | (_sqrt(dx2) < PNQP_CONV_TOL)
        ox = obj(x)
        # the ten step sizes side by side, [10, B]
        xt = [torch.clamp(x[i] + steps * dx[i], lo[i], hi[i])
              for i in range(n)]
        num = ox - obj(xt)
        den = g[0] * (x[0] - xt[0])
        for i in range(1, n):
            den = den + g[i] * (x[i] - xt[i])
        armijo = torch.where(den.abs() < 1e-30,
                             torch.full_like(den, PNQP_GAMMA + 1e-6),
                             num / den)
        passing = armijo > PNQP_GAMMA
        first = torch.where(passing.any(0), passing.to(torch.int8).argmax(0),
                            PNQP_MAX_LS - 1)
        sel = [v.gather(0, first.unsqueeze(0))[0] for v in xt]
        x = [torch.where(done_new, x[i], sel[i]) for i in range(n)]
        trips = trips + torch.where(done, z, z + 1.0)
        L, free, done = Lf, fr, done_new
    return x, L, free, trips


def _pnqp_stacked(H, q, lo, hi, x0, n_iter):
    """``_pnqp`` past ``REG_CTRL_MAX`` on the stacked [..., n] and
    [..., n, n] operands: each entry's arithmetic in ``_pnqp``'s order
    (H x from its first term on, j ascending; the trial objectives' and
    the Armijo denominator's terms i ascending), so its bits, a tensor
    operation a term where ``_pnqp`` takes one an entry and a term.  The
    same arguments and returns."""
    n = len(q)
    Hm, qm = _stack(H), torch.stack(q, -1)
    lom, him = torch.stack(lo, -1), torch.stack(hi, -1)
    x = torch.clamp(torch.stack(x0, -1), lom, him)
    z = torch.zeros_like(q[0])
    done = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    trips = z.clone()
    L = _Factor(torch.eye(n, dtype=z.dtype, device=z.device).expand(
        z.shape + (n, n)))
    free = torch.ones(z.shape + (n,), dtype=torch.bool, device=z.device)
    steps = torch.tensor(_pnqp_steps(z.dtype), dtype=z.dtype,
                         device=z.device).reshape((-1,) + (1,) * (z.dim() + 1))

    def hv(v):
        s = Hm[..., :, 0] * v[..., 0:1]
        for j in range(1, n):
            s = s + Hm[..., :, j] * v[..., j:j + 1]
        return s

    def ordered(t):
        acc = t[..., 0]
        for i in range(1, n):
            acc = acc + t[..., i]
        return acc

    def obj(v):
        return ordered((0.5 * hv(v) + qm) * v)

    for _ in range(n_iter):
        if bool(done.all()):
            break
        g = hv(x) + qm
        clamped = ((x == lom) & (g > 0)) | ((x == him) & (g < 0))
        fr = ~clamped
        Lf = _masked_free_columns(Hm, fr)
        dx = -_lanes_solve(Lf.m, torch.where(clamped, 0.0, g), z.dim())
        done_new = done | (_sqrt(ordered(dx * dx)) < PNQP_CONV_TOL)
        ox = obj(x)
        # the ten step sizes side by side, [10, ..., n]
        xt = torch.clamp(x + steps * dx, lom, him)
        num = ox - obj(xt)
        den = ordered(g * (x - xt))
        armijo = torch.where(den.abs() < 1e-30,
                             torch.full_like(den, PNQP_GAMMA + 1e-6),
                             num / den)
        passing = armijo > PNQP_GAMMA
        first = torch.where(passing.any(0), passing.to(torch.int8).argmax(0),
                            PNQP_MAX_LS - 1)
        sel = xt.gather(0, first[None, ..., None].expand((1,) + x.shape))[0]
        x = torch.where(done_new[..., None], x, sel)
        trips = trips + torch.where(done, z, z + 1.0)
        L, free, done = Lf, fr, done_new
    return list(x.unbind(-1)), L, list(free.unbind(-1)), trips


def _ctrl_solve(t, T, Q, q, u_t, lb_t, ub_t, prev_kt, ns, pnqp_iter,
                uz_t=None, delta_u=None):
    """``ctrl_solve`` (mpc_tpu/ops/fused.py:1464-1544) at one step, for
    the three regimes: (K [B, nc, ns], k [B, nc], the QP's trips [B]).
    Without bounds a mask ``uz_t`` [1 or B, nc] (1 pinned) zeroes the
    pinned rows of k and K: at one control by a select, at several by the
    masked factor ``_masked_free_chol`` (no jitter) of the free block with
    qu and Qux masked (:1475-1503); with bounds it never enters the QP,
    and ``delta_u`` narrows the box to [-delta_u, delta_u] (:1513-1515)."""
    nc = q.shape[-1] - ns
    B = q.shape[0]
    z = q.new_zeros(B)
    Quu = [[Q[:, ns + i, ns + j] for j in range(nc)] for i in range(nc)]
    qu = [q[:, ns + i] for i in range(nc)]
    Qux = Q[:, ns:, :ns]
    if lb_t is None:
        free = None if uz_t is None else [(uz_t[:, i] + z) < 0.5
                                          for i in range(nc)]
        if nc == 1:
            inv = 1.0 / Quu[0][0]
            K, k = (-Qux) * inv[:, None, None], ((-qu[0]) * inv)[:, None]
            if free is not None:
                K = torch.where(free[0][:, None, None], K, 0.0)
                k = torch.where(free[0][:, None], k, 0.0)
            return K, k, z
        if free is None:
            L = _cholesky(Quu, CHOL_JITTER)
            rhs_k, rhs_K = qu, list(Qux.unbind(1))
        else:
            L = _masked_free_chol(Quu, free)
            rhs_k = [torch.where(free[i], qu[i], 0.0) for i in range(nc)]
            rhs_K = [torch.where(free[i][:, None], Qux[:, i], 0.0)
                     for i in range(nc)]
        kt = [-v for v in _solve_rows(L, rhs_k)]
        cols = _solve_rows(L, rhs_K)
        return -torch.stack(cols, 1), torch.stack(kt, 1), z
    lo = lb_t - u_t
    hi = ub_t - u_t
    if delta_u is not None:
        lo = torch.clamp_min(lo, -delta_u)
        hi = torch.clamp_max(hi, delta_u)
    if nc == 1:
        Quu_s, qu_s = Quu[0][0], qu[0]
        inv = 1.0 / Quu_s
        kv = torch.clamp((-qu_s) * inv, lo[:, 0], hi[:, 0])
        g = Quu_s * kv + qu_s
        clamped = (((kv == lo[:, 0]) & (g > 0))
                   | ((kv == hi[:, 0]) & (g < 0)))
        K = torch.where(clamped[:, None, None], 0.0,
                        (-Qux) * inv[:, None, None])
        return K, kv[:, None], z + 1.0
    if t == T - 1:
        L0 = _cholesky(Quu, CHOL_JITTER)
        x_init = [-v for v in _solve_rows(L0, qu)]
    else:
        x_init = list(prev_kt.unbind(1))
    kt, L_free, free, trips = _pnqp(Quu, qu, list(lo.unbind(1)),
                                    list(hi.unbind(1)), x_init, pnqp_iter)
    rhs = [torch.where(free[i][:, None], Qux[:, i], 0.0) for i in range(nc)]
    cols = _solve_rows(L_free, rhs)
    return -torch.stack(cols, 1), torch.stack(kt, 1), trips


def fused_solve_dense_plain(F, f, C, c, x0, u0, lb, ub, *, alphas, lqr_iter,
                            eps, best_cost_eps, not_improved_lim, pnqp_iter,
                            model=None, params=None, cost_params=None,
                            uz=None, delta_u=None):
    """The plain PyTorch version of the dense kernel, on its operands.

    F [T-1, 1 or B, ns, ntau]; f None or [T-1, 1 or B, ns]; or, for the
    model-step build, F and f None and ``model`` one of the kernels'
    models (a pendulum, the cartpole, an MLP or a ``SlewSoA`` of one)
    and ``params`` its parameter vector (``model_params``): the rollouts
    take its ``soa_step`` (an MLP's ``mlp_step_lanes``, the MLP build's
    order of the output layer's sums) and each sweep its ``soa_jacobian``
    at the current trajectory, computed before the sweep as the kernel
    computes them (u a component for one control, a tuple for several);
    C [T, 1 or B, ntau, ntau]; c [T, 1 or B, ntau]; or, for the cost
    build, C and c None and ``cost_params`` the pseudo-Huber cost's [w,
    goal, delta] (2 ntau + 1), lane i's term of a stage cost summed by
    the butterfly and its (H_ii, g_i) at the current trajectory in place
    of C_t's row and (C_t tau + c_t)_i; x0 [B, ns];
    u0 [T, B, nc]; lb, ub None or [T, 1 or B, nc]; ``alphas`` the
    line-search schedule as Python floats.  Returns x [T, B, ns],
    u [T, B, nc] and stats [6, B]: best cost, best full-step norm,
    n_iter, n_qp_iter, alpha and the selected step size's index plus one
    summed over the iterations.

    Same arithmetic in the same order as csrc/fused_ilqr_dense.cu, which
    computes what ``_make_kernel_long`` computes at these sizes: the
    initial rollout and its cost; per iteration one Riccati sweep
    (Q's upper triangle mirrored, the control solve of the regime, the
    cost-to-go as vv_update sums it, mpc_tpu/ops/fused.py:1546-1573),
    the line search's trial rollouts with the first passing step size
    (trial cost <= current cost), else the last, the selected trial
    becoming the current trajectory; best-tracking and per-example
    stopping.  The kernel stops an example's search at its first passing
    step size; here every example tries each step size until every
    active one has passed, and each keeps its first passing trial.
    ``n_qp_iter`` counts the box QP's trips (one a step for one control,
    the projected-Newton trips for several, none without bounds).

    ``uz`` None or [T, 1 or B, nc], 1 where a control is pinned to zero
    (the MPC_HAS_UZ build: ``_ctrl_solve`` without bounds, and each
    rollout zeroes the control before the clamp), and ``delta_u`` None or
    the trust region's half-width (bounds required: the QP's box and each
    rollout's clamp narrowed around the current iterate's control,
    mpc_tpu/ops/fused.py:1681-1692)."""
    T, B, nc = u0.shape
    ns = x0.shape[1]
    nt = ns + nc
    has_bounds = lb is not None
    _check_trust_region(delta_u, has_bounds)
    dev, dt = x0.device, x0.dtype
    zero = x0.new_zeros(B)

    if cost_params is not None:
        cp = tuple(cost_params.unbind())

        def stage(t, tau):
            return _lane_sum(torch.stack(huber_terms(list(tau.unbind(-1)),
                                                     cp), -1))

        def quad(t, tau):
            H, g = huber_quad(list(tau.unbind(-1)), cp)
            return torch.diag_embed(torch.stack(H, -1)), torch.stack(g, -1)
    else:
        def stage(t, tau):
            s = _dot(C[t], tau[:, None, :], -1)
            return _lane_sum((0.5 * s + c[t]) * tau)

        def quad(t, tau):
            Ct = C[t].expand(B, nt, nt)
            return Ct, _dot(Ct, tau[:, None, :], -1) + c[t]

    if model is not None:
        if F is not None or f is not None:
            raise ValueError('the model-step build takes no F or f')
        inner = model.inner if isinstance(model, SlewSoA) else model
        # an MLP takes its flat weights, the other models their scalars
        p = params if isinstance(inner, NNDynamics) else tuple(
            params.unbind())

        def ctrl(us):
            return us[..., 0] if nc == 1 else tuple(us.unbind(-1))

        def step(t, tau):
            xs, us = tuple(tau[:, :ns].unbind(-1)), ctrl(tau[:, ns:])
            if not isinstance(inner, NNDynamics):
                return torch.stack(model.soa_step(xs, us, p), -1)
            # the MLP build's step (its output layer summed over the lanes)
            k = ns - inner.n_state      # the slew passthrough's u_{t-1}
            out = mlp_step_lanes(inner, xs[k:], us, p)
            if k:
                out = ((us,) if nc == 1 else us) + out
            return torch.stack(out, -1)

        def jacobians(x, u):
            """F_t [B, ns, ntau] at the current trajectory for t < T - 1,
            all steps in one elementwise pass, as the kernel's pass over t
            computes them."""
            if T == 1:
                return []
            xs = torch.stack(x[:-1])
            rows = model.soa_jacobian(tuple(xs.unbind(-1)),
                                      ctrl(torch.stack(u[:-1])), p)
            return list(torch.stack([torch.stack(r, -1) for r in rows],
                                    -2).unbind(0))
    else:
        def step(t, tau):
            out = _dot(F[t], tau[:, None, :], -1)
            return out if f is None else out + f[t]

    # ---- init: x <- rollout(u0), best <- the same, its cost ------------
    x = [x0]
    u = list(u0.unbind(0))
    cost_cur = stage(0, torch.cat([x[0], u[0]], -1))
    for t in range(T - 1):
        x.append(step(t, torch.cat([x[t], u[t]], -1)))
        cost_cur = cost_cur + stage(t + 1, torch.cat([x[t + 1], u[t + 1]],
                                                     -1))
    best_x, best_u = x, u
    best_cost = zero + BIG
    best_du = zero + BIG
    cur_du = zero + BIG
    nni = zero.clone()
    n_qp = zero.clone()
    alpha_sel = zero + 1.0
    n_it = zero.clone()
    n_trials = zero.clone()
    active = torch.ones(B, dtype=torch.bool, device=dev)

    for it in range(lqr_iter):
        # ---- Riccati backward recursion --------------------------------
        K = [None] * T
        k = [None] * T
        V = v = prev_kt = None
        qp_cnt = zero.clone()
        if model is not None:
            Fm = jacobians(x, u)
        for t in range(T - 1, -1, -1):
            Ct, cb = quad(t, torch.cat([x[t], u[t]], -1))
            if t == T - 1:
                Q, q = Ct, cb
            else:
                Ft = Fm[t] if model is not None else F[t].expand(B, ns, nt)
                W = _dot(V[:, :, :, None], Ft[:, None, :, :], 2)
                Q = _upper(Ct + _dot(Ft[:, :, :, None], W[:, :, None, :], 1))
                q = cb + _dot(Ft, v[:, :, None], 1)
            Kt, kt, qp_inc = _ctrl_solve(
                t, T, Q, q, u[t], lb[t] if has_bounds else None,
                ub[t] if has_bounds else None, prev_kt, ns, pnqp_iter,
                None if uz is None else uz[t], delta_u)
            K[t], k[t], prev_kt = Kt, kt, kt
            qp_cnt = qp_cnt + qp_inc
            # cost-to-go, summed as vv_update sums it
            Qxu = Q[:, :ns, ns:]
            Quu = Q[:, ns:, ns:]
            qu = q[:, ns:]
            QK = _dot(Qxu[:, :, :, None], Kt[:, None, :, :], 2)
            KQuu = _dot(Quu[:, :, :, None], Kt[:, None, :, :], 2)
            kqk = _dot(Kt[:, :, :, None], KQuu[:, :, None, :], 1)
            V = _upper(((Q[:, :ns, :ns] + QK) + QK.transpose(1, 2)) + kqk)
            Quuk = _dot(Quu, kt[:, None, :], 2)
            v = (q[:, :ns] + _dot(Qxu, kt[:, None, :], 2)) \
                + _dot(Kt, (qu + Quuk)[:, :, None], 1)

        # ---- line search: trial rollouts, the first passing step size,
        # else the last; the selected trial becomes the trajectory -------
        old_cost = cost_cur
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        for ki, a in enumerate(alphas):
            xt = x0
            nx, nu = [], []
            cost_a = du2 = None
            for t in range(T):
                dx = xt - x[t]
                ut = (_dot(K[t], dx[:, None, :], -1) + u[t]) + a * k[t]
                if uz is not None:
                    ut = torch.where(uz[t] > 0.5, 0.0, ut)
                if has_bounds:
                    lo, hi = lb[t], ub[t]
                    if delta_u is not None:
                        lo = torch.maximum(u[t] - delta_u, lo)
                        hi = torch.minimum(u[t] + delta_u, hi)
                    ut = torch.clamp(ut, lo, hi)
                tau = torch.cat([xt, ut], -1)
                sc = stage(t, tau)
                cost_a = sc if cost_a is None else cost_a + sc
                if ki == 0:
                    d = u[t] - ut
                    d2 = _lane_sum(d * d)
                    du2 = d2 if du2 is None else du2 + d2
                nx.append(xt)
                nu.append(ut)
                if t < T - 1:
                    xt = step(t, tau)
            take = ~found
            n_trials = n_trials + (take & active).to(dt)
            if ki == 0:
                full_du = _sqrt(du2)
                sel_x, sel_u, sel_cost = nx, nu, cost_a
                sel_alpha = zero + a
            else:
                sel_x = [torch.where(take[:, None], nx[t], sel_x[t])
                         for t in range(T)]
                sel_u = [torch.where(take[:, None], nu[t], sel_u[t])
                         for t in range(T)]
                sel_cost = torch.where(take, cost_a, sel_cost)
                sel_alpha = torch.where(take, zero + a, sel_alpha)
            found = found | (take & (cost_a <= old_cost))
            if bool((found | ~active).all()):
                break

        # ---- best tracking and per-example stopping ------------------
        improved = sel_cost <= best_cost + best_cost_eps
        take_best = active & (improved | (it == 0))
        nni = torch.where(active, torch.where(
            improved & (it != 0), zero, nni + 1.0), nni)
        on = active[:, None]
        x = [torch.where(on, sel_x[t], x[t]) for t in range(T)]
        u = [torch.where(on, sel_u[t], u[t]) for t in range(T)]
        best = take_best[:, None]
        best_x = [torch.where(best, x[t], best_x[t]) for t in range(T)]
        best_u = [torch.where(best, u[t], best_u[t]) for t in range(T)]
        best_cost = torch.where(take_best, sel_cost, best_cost)
        best_du = torch.where(take_best, full_du, best_du)
        cur_du = torch.where(active, full_du, cur_du)
        n_qp = n_qp + torch.where(active, qp_cnt, zero)
        alpha_sel = torch.where(active, sel_alpha, alpha_sel)
        n_it = n_it + active.to(dt)
        cost_cur = torch.where(active, sel_cost, cost_cur)
        active = active & (cur_du >= eps) & (nni <= not_improved_lim)
        if not bool(active.any()):
            break

    stats = torch.stack([best_cost, best_du, n_it, n_qp, alpha_sel,
                         n_trials], 0)
    return torch.stack(best_x, 0), torch.stack(best_u, 0), stats


# ---------------------------------------------------------------------------
# the kernel's wrapper and operands
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
ARGTYPES = [
    ctypes.c_int, ctypes.c_int, _P,       # B, T, model parameters
    ctypes.POINTER(ctypes.c_int), ctypes.c_int,     # MLP widths (host), n
    ctypes.c_int,                         # MLP passthrough
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
    ctypes.c_int, ctypes.c_int,           # lqr_iter, pnqp_iter
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    _P, ctypes.c_int,                     # workspace, shared memory bytes
    _P, _P, _P,                           # x, u, stats
    _P,                                   # clocks (the phase account)
    _P,                                   # stream
]


def kernel_lib(ns, nc, has_bounds, has_f, model=None, slew=False,
               huber=False, has_uz=False, mlp=None, clocks=False,
               ws_shared=False):
    """The build's entry point; ``clocks`` the phase account's build
    (MPC_PHASE_CLOCKS = 1, csrc/phase_clock.cuh), ``ws_shared`` the
    model-step build's shared workspace."""
    from . import _build
    defines = dense_kernel_defines(ns, nc, has_bounds, has_f, model, slew,
                                   huber, has_uz, mlp, ws_shared)
    if clocks:
        defines['MPC_PHASE_CLOCKS'] = 1
    fn = _build.load('fused_ilqr_dense', defines).mpc_fused_ilqr_dense
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_ilqr_dense(F, f, C, c, x0, u0, lb, ub, *, alphas, lqr_iter, eps,
                     best_cost_eps, not_improved_lim, pnqp_iter, model=None,
                     params=None, cost_params=None, uz=None, delta_u=None):
    """Run the dense kernel on its operands (layouts as in
    ``fused_solve_dense_plain``) through the op
    ``mpc_tpu_torch::k3d_solve`` (ops/custom.py), a ``model`` as its name
    and slew flag (``dense_model``), an MLP's widths, activation and
    passthrough (``mlp_spec``), and its ``params``; with
    ``cost_params`` (C and c None) the cost build (MPC_COST); with ``uz``
    [T, 1 or B, nc] the mask build (MPC_HAS_UZ); ``delta_u`` (bounds
    required) the trust region.

    On the CPU the op runs ``fused_solve_dense_plain``.  On a CUDA tensor
    it allocates the workspace of ``k3d_launch`` (none where the
    model-step build keeps it in shared memory), launches
    csrc/fused_ilqr_dense.cu on the current stream and raises on any
    operand the kernel does not take or on a launch error."""
    _check_device('the dense kernel', x0)
    return torch.ops.mpc_tpu_torch.k3d_solve(*op_args(
        F, f, C, c, x0, u0, lb, ub, alphas=alphas, lqr_iter=lqr_iter, eps=eps,
        best_cost_eps=best_cost_eps, not_improved_lim=not_improved_lim,
        pnqp_iter=pnqp_iter, model=model, params=params,
        cost_params=cost_params, uz=uz, delta_u=delta_u))


def op_args(F, f, C, c, x0, u0, lb, ub, *, alphas, lqr_iter, eps,
            best_cost_eps, not_improved_lim, pnqp_iter, model=None,
            params=None, cost_params=None, uz=None, delta_u=None):
    """The arguments of the op ``k3d_solve`` for the wrapper's keyword
    operands (``fused_ilqr_dense``)."""
    name, slew = dense_model(model) if model is not None else ('', False)
    mlp = mlp_spec(model) if model is not None else None
    sizes, activation, passthrough = mlp or (None, '', False)
    return (F, f, C, c, x0, u0, lb, ub, [float(a) for a in alphas],
            int(lqr_iter), float(eps), float(best_cost_eps),
            float(not_improved_lim), int(pnqp_iter), name, slew, params,
            cost_params, uz, _opt_float(delta_u),
            None if sizes is None else list(sizes), activation, passthrough)


def _ctrl_bound(a, T, B, nc, dtype, device):
    """A scalar, [T, nc] or [T, 1 or B, nc] bound to a contiguous
    [T, 1 or B, nc]."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.dim() == 0:
        a = a.expand(T, 1, nc)
    elif a.dim() == 2:
        a = a.unsqueeze(1)
    if a.dim() != 3 or a.shape[0] != T or a.shape[1] not in (1, B) \
            or a.shape[2] != nc:
        raise ValueError(f'unexpected bound shape {tuple(a.shape)}')
    return a.contiguous()


def k3d_operands(cfg, x_init, cost, dynamics, u_init=None,
                 u_lower=None, u_upper=None, u_zero_I=None) -> dict:
    """The dense kernel's operands (the keyword arguments of
    ``fused_ilqr_dense`` and ``fused_solve_dense_plain``) on x_init's
    device and dtype.  Layouts match learning.batched_solve: x_init
    [B, ns]; cost and LinDx leaves shared ([T, ...] or without the time
    axis for the cost) or batched ([T, B, ...]), each in its own layout
    (the kernel reads each with its own batch stride); bounds scalar,
    [T, nc] or [T, B, nc]; u_init [T, nc] or [T, B, nc].  A model (a
    pendulum, the cartpole, an MLP or a ``SlewSoA`` of one) gives F = f =
    None, the model and its parameters (``model_params``: an MLP's flat
    weights); a pseudo-Huber cost gives C = c = None and
    its ``cost_params`` (``fused.cost_operands``); u_zero_I None, [T, nc]
    or [T, B, nc] gives ``uz`` [T, 1 or B, nc] of 0/1
    (``fused.mask_operand``) and ``cfg.delta_u`` ``delta_u``."""
    T, nc = cfg.T, cfg.n_ctrl
    dtype, device = x_init.dtype, x_init.device
    x0 = x_init.contiguous()
    B = x0.shape[0]
    if u_init is None:
        u0 = torch.zeros((T, B, nc), dtype=dtype, device=device)
    else:
        u0 = torch.as_tensor(u_init, dtype=dtype, device=device)
        if u0.dim() == 2:
            u0 = u0.unsqueeze(1)
        u0 = u0.expand(T, B, nc).contiguous()
    lb = ub = None
    if u_lower is not None:
        lb = _ctrl_bound(u_lower, T, B, nc, dtype, device)
        ub = _ctrl_bound(u_upper, T, B, nc, dtype, device)
    if isinstance(dynamics, LinDx):
        f = dynamics.f
        if f is not None:
            f = _dyn_operand(f, T, B, 1, dtype, device)
        dyn = dict(F=_dyn_operand(dynamics.F, T, B, 2, dtype, device), f=f,
                   model=None, params=None)
    else:
        dense_model(dynamics)
        dyn = dict(F=None, f=None, model=dynamics,
                   params=model_params(dynamics).detach().to(
                       device=device, dtype=dtype).contiguous())
    return dict(**dyn, **cost_operands(cost, T, B, dtype, device),
                x0=x0, u0=u0, lb=lb, ub=ub,
                uz=mask_operand(u_zero_I, T, B, nc, dtype, device),
                delta_u=trust_region(cfg, dtype),
                alphas=line_search_schedule(cfg, dtype),
                lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                best_cost_eps=cfg.best_cost_eps,
                not_improved_lim=float(cfg.not_improved_lim),
                pnqp_iter=int(cfg.pnqp_iter))

