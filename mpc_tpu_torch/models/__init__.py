"""Models of the port: the pendulum (simple and damped-biased) and the
cartpole."""

from .cartpole import CartpoleDx
from .pendulum import PendulumDx

__all__ = ['CartpoleDx', 'PendulumDx']
