"""Training-state checkpoints (counterpart of
mpc_tpu/utils/checkpoint.py:26-52).

The JAX package writes any pytree with orbax.  Here a state is any
nesting of dicts, lists, tuples and NamedTuples (``learning.TrainState``)
whose leaves are tensors, numbers, strings or None, a ``torch.optim``
``state_dict`` included, written with ``torch.save`` and read with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers and nothing else.  A NamedTuple is written as the dict of its
fields, so a checkpoint read without ``like`` comes back as nested
dicts, as the JAX package's does; with ``like`` it takes ``like``'s
structure and types, and a structure, dtype or shape that differs from
``like``'s is refused.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from .device import resolve_device


def _plain(state):
    """``state`` with every NamedTuple replaced by the dict of its
    fields (what ``weights_only`` loading accepts)."""
    if isinstance(state, tuple) and hasattr(state, '_fields'):
        return {k: _plain(v) for k, v in zip(state._fields, state)}
    if isinstance(state, dict):
        return type(state)((k, _plain(v)) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v) for v in state)
    return state


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> str:
    """Write ``state`` (e.g. a ``learning.TrainState``) to the file
    ``path`` and return its absolute path.  ``force=False`` refuses to
    overwrite an existing file.  The file is written beside ``path`` and
    renamed over it, so a reader never sees half a checkpoint."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f'{path} exists (force=False)')
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        torch.save(_plain(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _restore(data, like, where):
    """``data`` in the structure of ``like``; raises ValueError at the
    first leaf or container that differs."""
    if isinstance(like, tuple) and hasattr(like, '_fields'):
        if not isinstance(data, dict) or set(data) != set(like._fields):
            raise ValueError(f'checkpoint{where}: expected the fields '
                             f'{like._fields} of {type(like).__name__}')
        return type(like)(*(_restore(data[k], v, f'{where}.{k}')
                            for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        if not isinstance(data, dict) or set(data) != set(like):
            raise ValueError(f'checkpoint{where}: expected the keys '
                             f'{sorted(like, key=str)}')
        return type(like)((k, _restore(data[k], v, f'{where}[{k!r}]'))
                          for k, v in like.items())
    if isinstance(like, (list, tuple)):
        if not isinstance(data, (list, tuple)) or len(data) != len(like):
            raise ValueError(f'checkpoint{where}: expected a sequence of '
                             f'{len(like)}')
        return type(like)(_restore(d, v, f'{where}[{i}]')
                          for i, (d, v) in enumerate(zip(data, like)))
    if isinstance(like, torch.Tensor):
        if not isinstance(data, torch.Tensor) or data.dtype != like.dtype \
                or data.shape != like.shape:
            got = (f'{data.dtype} {tuple(data.shape)}'
                   if isinstance(data, torch.Tensor) else type(data).__name__)
            raise ValueError(f'checkpoint{where}: expected {like.dtype} '
                             f'{tuple(like.shape)}, found {got}')
        return data
    if type(data) is not type(like):
        raise ValueError(f'checkpoint{where}: expected '
                         f'{type(like).__name__}, found '
                         f'{type(data).__name__}')
    return data


def load_checkpoint(path: str, like: Optional[Any] = None, device=None):
    """Read a state written by ``save_checkpoint``, its tensors on
    ``device`` (the CUDA card unless the caller names another).

    With ``like`` (e.g. a TrainState built like the one saved) the state
    comes back in ``like``'s structure and types, and a structure, dtype
    or shape that differs raises ValueError; without it, NamedTuples come
    back as dicts."""
    data = torch.load(os.path.abspath(path),
                      map_location=resolve_device(device), weights_only=True)
    return data if like is None else _restore(data, like, '')
