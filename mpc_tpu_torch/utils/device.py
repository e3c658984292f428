"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller names another.  Raises when the card is asked for (or
    defaulted to) and none is present: nothing falls back to the CPU
    without being asked."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'mpc_tpu_torch runs on the CUDA card by default and no card '
            'is available; pass device="cpu" to run the plain PyTorch '
            'path on the CPU')
    return device
