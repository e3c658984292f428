"""mpc_tpu_torch: the PyTorch/CUDA port of mpc_tpu for an NVIDIA H100.

A second package beside the JAX one (which stays the reference it is
tested against).  It imports torch and nothing of JAX or mpc_tpu.  It
serves the iLQR solve of the pendulum through the hand-written Hopper
kernel K1 (ops/fused.py, csrc/fused_ilqr.cu) and differentiates through
it with kernel K2 (ops/fused_bwd.py, csrc/fused_kkt_bwd.cu), which makes
imitation training run on the card.  The entry points run on the CUDA
card unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run.

Public surface so far:
  MPC                        - reference-compatible batched solver class
  batched_solve              - functional batched solve (differentiable
                               with cfg.backprop)
  imitation_loss, make_imitation_train_step - training through the solve
  QuadCost, LinDx            - cost / linear-dynamics tuples
  GradMethods, MPCConfig, Solution
  rollout, trajectory_cost   - trajectory helpers
"""

from .types import GradMethods, LinDx, MPCConfig, QuadCost, Solution
from .mpc import MPC
from .learning import (batched_solve, imitation_loss,
                       make_imitation_train_step)
from .solver import rollout, trajectory_cost

__version__ = '0.1.0'

__all__ = [
    'MPC', 'QuadCost', 'LinDx', 'GradMethods', 'MPCConfig', 'Solution',
    'batched_solve', 'imitation_loss', 'make_imitation_train_step',
    'rollout', 'trajectory_cost',
]
