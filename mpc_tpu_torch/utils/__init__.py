"""Utilities of the port: device resolution (``device``) and numpy
conversion to and from the JAX package's arrays (``convert``)."""

from .device import resolve_device

__all__ = ['resolve_device']
