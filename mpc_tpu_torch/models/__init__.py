"""Models of the port: so far the pendulum."""

from .pendulum import PendulumDx

__all__ = ['PendulumDx']
