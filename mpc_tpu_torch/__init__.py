"""mpc_tpu_torch: the PyTorch/CUDA port of mpc_tpu for an NVIDIA H100.

A second package beside the JAX one (which stays the reference it is
tested against).  It imports torch and nothing of JAX or mpc_tpu.  The
entry points run on the CUDA card unless the caller passes
``device="cpu"``.

``batched_solve`` (and the ``MPC`` front end on top of it) routes each
problem as the JAX package does.  The problems the hand-written Hopper
kernels take (the simple pendulum or a LinDx, n_state = 3, n_ctrl = 1, a
QuadCost, float32 on the card) are solved by K1 (csrc/fused_ilqr.cu, up
to T = 181) or K3 (csrc/fused_ilqr_long.cu, LinDx and longer horizons)
and differentiated by K2 or K4 (csrc/fused_kkt_bwd.cu,
csrc/fused_kkt_bwd_long.cu); on the CPU their plain PyTorch versions run
instead.  Every other problem (n_ctrl > 1, float64 on the card, callable
costs and models, the damped pendulum, the cartpole, u_zero_I, delta_u,
``use_fused='never'``, ``verbose`` > 0) runs on the eager solver
(``solver.py``), batched natively, and its differentiable fixed point
(``ops/diff.py``), on the card or the CPU.  A slew-rate penalty augments
the state with the previous control: a LinDx of 2 states and 1 control
then solves in K3, everything else on the eager solver, whose fixed
point is the slew backward.  ``parallel_riccati`` (True, or 'auto' at
T >= 128) takes the eager solver's unconstrained steps and exact solves
through the O(log T) Riccati scan (``ops/pscan.py``).  The sharded paths,
checkpoints and export wait for ROADMAP queue 1 item 8.

Public surface:
  MPC                        - reference-compatible batched solver class
                               (verbose tables, ANALYTIC_CHECK)
  SlewRateCost               - a callable cost on the slew-augmented tau
  batched_solve              - functional batched solve (differentiable
                               with cfg.backprop)
  solve_single               - one instance through the eager solver
  imitation_loss, make_imitation_train_step - training through the solve
  make_closed_loop           - receding-horizon rollouts on the device
  QuadCost, LinDx            - cost / linear-dynamics tuples
  GradMethods, MPCConfig, Solution
  rollout, trajectory_cost   - trajectory helpers
  linearize_dynamics, quadratize_cost - the model along a trajectory
  NNDynamics, AffineDynamics, CtrlPassthroughDynamics, PseudoHuberCost
                             - the learned, affine and passthrough models
                               and the robust cost (also in ``models``)
  models.PendulumDx, models.CartpoleDx
  utils.finite_mask, utils.assert_finite, utils.nan_checks,
  utils.table_log            - numerical debugging and iteration logging
"""

from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
from .mpc import MPC, SlewRateCost
from .learning import (batched_solve, imitation_loss,
                       make_imitation_train_step)
from .closed_loop import make_closed_loop
from .solver import (linearize_dynamics, quadratize_cost, rollout,
                     solve_single, trajectory_cost)
from . import models, utils
from .models import (AffineDynamics, CtrlPassthroughDynamics, NNDynamics,
                     PseudoHuberCost)

__version__ = '0.1.0'

__all__ = [
    'MPC', 'SlewRateCost', 'QuadCost', 'LinDx', 'GradMethods', 'MPCConfig',
    'Solution', 'batched_solve', 'solve_single', 'imitation_loss',
    'make_imitation_train_step', 'make_closed_loop', 'rollout',
    'trajectory_cost',
    'linearize_dynamics', 'quadratize_cost', 'models', 'NNDynamics',
    'AffineDynamics', 'CtrlPassthroughDynamics', 'PseudoHuberCost', 'utils',
]
