"""Utilities of the port: device resolution (``device``), numpy
conversion to and from the JAX package's arrays (``convert``), central
differences for gradient tests (``fd``), iteration logging (``logging``),
numerical debugging (``debug``), training-state checkpoints
(``checkpoint``) and serving artifacts (``export``, imported on its
own: it needs the solver)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .debug import assert_finite, finite_mask, nan_checks
from .device import resolve_device
from .fd import fd_grad, fd_hess, fd_jacobian
from .logging import table_log

__all__ = ['resolve_device', 'fd_grad', 'fd_hess', 'fd_jacobian',
           'table_log', 'assert_finite', 'finite_mask', 'nan_checks',
           'save_checkpoint', 'load_checkpoint']
