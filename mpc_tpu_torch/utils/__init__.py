"""Utilities of the port: device resolution (``device``), numpy
conversion to and from the JAX package's arrays (``convert``) and
central differences for gradient tests (``fd``)."""

from .device import resolve_device

__all__ = ['resolve_device']
