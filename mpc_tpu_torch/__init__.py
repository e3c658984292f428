"""mpc_tpu_torch: the PyTorch/CUDA port of mpc_tpu for an NVIDIA H100.

A second package beside the JAX one (which stays the reference it is
tested against).  It imports torch and nothing of JAX or mpc_tpu.  The
entry points run on the CUDA card unless the caller passes
``device="cpu"``.

``batched_solve`` (and the ``MPC`` front end on top of it) routes each
problem as the JAX package does.  The problems the hand-written Hopper
kernels take (the pendulums at n_state = 3, n_ctrl = 1, the cartpole,
an MLP of 1 to 4 hidden layers and a LinDx of n_state + n_ctrl <= 32
at any n_ctrl, a QuadCost or a pseudo-Huber cost, float32 on the
card) are solved by K1 (csrc/fused_ilqr.cu, up to T = 181), K3
(csrc/fused_ilqr_long.cu, LinDx and the one-hidden-layer MLP of 3 states
and 1 control, and longer horizons) or K3's dense configuration
(csrc/fused_ilqr_dense.cu, every other LinDx, MLP and model)
and differentiated at 3 states and 1 control by K2 or K4
(csrc/fused_kkt_bwd.cu, csrc/fused_kkt_bwd_long.cu), at every other size
by their dense configuration (csrc/fused_kkt_bwd_dense.cu); on the CPU
their plain PyTorch versions run instead; each kernel also takes
controls pinned to zero (u_zero_I) and, with bounds, the trust region
delta_u.  Every other problem (float64 on the card, callable costs and
models, delta_u without bounds, ``use_fused='never'``, ``verbose`` > 0)
runs on the eager solver
(``solver.py``), batched natively, and so does every other backward (and
a slew penalty's), on its differentiable fixed point (``ops/diff.py``),
on the card or the CPU.  A slew-rate penalty augments the state with
the previous control: a LinDx, a pendulum, the cartpole or an MLP then
solves in K3 or the dense configuration, and the eager fixed point is
the slew backward.  ``parallel_riccati`` (True, or 'auto' at
T >= 128) takes the eager solver's unconstrained steps and exact solves
through the O(log T) Riccati scan (``ops/pscan.py``).

The kernels are ``torch.library`` ops (``ops/custom.py``), so a solve, a
gradient through it or a closed loop exports with ``torch.export``
(``utils/export.py``) and runs where only the ops are imported.  A batch
is split over several devices by ``parallel.solve_sharded`` and trained
over them, or over processes, by ``make_sharded_train_step``; a training
state saves and loads with ``utils.save_checkpoint`` and
``utils.load_checkpoint``.

Public surface:
  MPC                        - reference-compatible batched solver class
                               (verbose tables, ANALYTIC_CHECK)
  SlewRateCost               - a callable cost on the slew-augmented tau
  batched_solve              - functional batched solve (differentiable
                               with cfg.backprop)
  solve_single               - one instance through the eager solver
  imitation_loss, make_imitation_train_step - training through the solve
  make_sharded_train_step, TrainState - data-parallel training over a
                               mesh of devices or processes
  make_closed_loop           - receding-horizon rollouts on the device
  QuadCost, LinDx            - cost / linear-dynamics tuples
  GradMethods, MPCConfig, Solution
  rollout, trajectory_cost   - trajectory helpers
  linearize_dynamics, quadratize_cost - the model along a trajectory
  NNDynamics, AffineDynamics, CtrlPassthroughDynamics, PseudoHuberCost
                             - the learned, affine and passthrough models
                               and the robust cost (also in ``models``)
  models.PendulumDx, models.CartpoleDx
  parallel                   - make_mesh, shard_batch, solve_sharded and
                               the multi-process helpers
  utils.finite_mask, utils.assert_finite, utils.nan_checks,
  utils.table_log            - numerical debugging and iteration logging
  utils.save_checkpoint, utils.load_checkpoint
  utils.export               - export_solve, export_closed_loop,
                               export_fn, load_fn

The solver's modules load at the first use of a name that needs them,
so ``import mpc_tpu_torch.ops.custom`` (what an exported program needs)
imports none of them.
"""

import importlib

from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
# the ops before the models: the kernels' modules import every model whose
# step they run, and each model imports the ops' elementwise helpers
from . import ops
from . import models, utils
from .models import (AffineDynamics, CtrlPassthroughDynamics, NNDynamics,
                     PseudoHuberCost)

# name -> the module that defines it, imported at first use
_LAZY = {
    'MPC': 'mpc', 'SlewRateCost': 'mpc',
    'batched_solve': 'learning', 'imitation_loss': 'learning',
    'make_imitation_train_step': 'learning',
    'make_sharded_train_step': 'learning', 'TrainState': 'learning',
    'make_closed_loop': 'closed_loop',
    'linearize_dynamics': 'solver', 'quadratize_cost': 'solver',
    'rollout': 'solver', 'solve_single': 'solver',
    'trajectory_cost': 'solver',
}
_LAZY_MODULES = ('closed_loop', 'learning', 'mpc', 'parallel', 'solver')


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f'.{name}', __name__)
    if name in _LAZY:
        value = getattr(importlib.import_module(f'.{_LAZY[name]}', __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(_LAZY_MODULES))


__version__ = '0.1.0'

__all__ = [
    'MPC', 'SlewRateCost', 'QuadCost', 'LinDx', 'GradMethods', 'MPCConfig',
    'Solution', 'batched_solve', 'solve_single', 'imitation_loss',
    'make_imitation_train_step', 'make_sharded_train_step', 'TrainState',
    'make_closed_loop', 'rollout',
    'trajectory_cost',
    'linearize_dynamics', 'quadratize_cost', 'models', 'NNDynamics',
    'AffineDynamics', 'CtrlPassthroughDynamics', 'PseudoHuberCost', 'utils',
    'parallel',
]
