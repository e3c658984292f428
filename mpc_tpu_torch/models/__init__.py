"""Models of the port: the pendulum (simple and damped-biased), the
cartpole, the learned MLP, affine and control-passthrough dynamics, and
the pseudo-Huber cost (as mpc_tpu/models/__init__.py:4-10)."""

from .cartpole import CartpoleDx
from .cost import PseudoHuberCost
from .dynamics import AffineDynamics, CtrlPassthroughDynamics, NNDynamics
from .pendulum import PendulumDx

__all__ = ['NNDynamics', 'AffineDynamics', 'CtrlPassthroughDynamics',
           'PendulumDx', 'CartpoleDx', 'PseudoHuberCost']
