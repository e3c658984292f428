"""Multi-process scale-out (counterpart of
mpc_tpu/parallel/distributed.py:27-124).

The JAX package initialises its distributed runtime, builds a (hosts,
chips) mesh over every process's devices and shards a global batch over
it; XLA then inserts the one collective training needs.  Here the
processes form a ``torch.distributed`` process group, each process holds
its own slice of the global batch (there are no global arrays), and the
only collectives are the ones training makes by hand: the all-reduce of
the loss and of the gradients (``learning.make_sharded_train_step``) and
the broadcast that starts every process from the same parameters
(``replicate``).  The solve itself never communicates.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(name):
    return int(os.environ[name]) if name in os.environ else None


def _local_world_size(world_size):
    """Processes on this host: LOCAL_WORLD_SIZE (set by torchrun), else
    all of them."""
    return _env_int('LOCAL_WORLD_SIZE') or world_size


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group (idempotent: nothing happens when this
    process already has one).

    ``init_method`` defaults to ``env://``, which reads MASTER_ADDR and
    MASTER_PORT; ``world_size`` and ``rank`` default to WORLD_SIZE and
    RANK.  ``backend`` defaults to NCCL where each process of this host
    has a card of its own, and to gloo otherwise: on the CPU, and when
    several processes share a card, which NCCL refuses.  Under NCCL the
    process takes card LOCAL_RANK (else ``rank``) modulo the cards."""
    if dist.is_initialized():
        return
    world_size = world_size if world_size is not None else \
        _env_int('WORLD_SIZE')
    rank = rank if rank is not None else _env_int('RANK')
    if world_size is None or rank is None:
        raise ValueError('initialize needs world_size and rank (or the '
                         'WORLD_SIZE and RANK variables)')
    if backend is None:
        own_card = (torch.cuda.is_available() and torch.cuda.device_count()
                    >= _local_world_size(world_size))
        backend = 'nccl' if own_card else 'gloo'
    if backend == 'nccl':
        local = _env_int('LOCAL_RANK')
        torch.cuda.set_device((rank if local is None else local)
                              % torch.cuda.device_count())
    kw = {}
    if timeout_s is not None:
        kw['timeout'] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank, **kw)


def make_pod_mesh(axis_names: Sequence[str] = ('hosts', 'chips')):
    """A (hosts, chips) ``DeviceMesh`` over every process of the group: a
    row of processes a host (LOCAL_WORLD_SIZE of them, else all), one
    process a chip.  Its device type is 'cuda' under NCCL and 'cpu'
    under gloo (whose processes may share one card).  The batch is split
    over both axes, as ``pod_batch_spec`` does."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    local = _local_world_size(world)
    if world % local:
        raise ValueError(f'{world} processes do not fill hosts of {local}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, (world // local, local),
                            mesh_dim_names=tuple(axis_names))


def pod_batch_spec(global_batch: int, rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> slice:
    """This process's slice of a global batch split evenly over every
    process (the pure data-parallel layout of the JAX package's
    ``pod_batch_spec``)."""
    rank = dist.get_rank() if rank is None else rank
    world_size = dist.get_world_size() if world_size is None else world_size
    if global_batch % world_size:
        raise ValueError(f'batch {global_batch} does not divide evenly over '
                         f'{world_size} processes')
    b = global_batch // world_size
    return slice(rank * b, (rank + 1) * b)


class GlobalBatch(NamedTuple):
    """A process's shard of a global batch: ``local`` as the process
    holds it, and the size of the batch over every process."""
    local: object
    global_batch: int


def shard_global_batch(tree, batch_axis_by_rank=None) -> GlobalBatch:
    """This process's shard of a global batch, kept as given (each
    process passes its own slice), with the global batch size: the local
    batch (axis 1 of a tensor of rank >= 3, else axis 0, unless
    ``batch_axis_by_rank`` says otherwise) times the processes.  Every
    tensor must carry the same local batch."""
    from torch.utils import _pytree as pytree
    from .mesh import _batch_axis
    sizes = {a.shape[_batch_axis(a, batch_axis_by_rank)]
             for a in pytree.tree_leaves(tree) if isinstance(a, torch.Tensor)}
    if len(sizes) != 1:
        raise ValueError(f'the local shards carry different batches {sizes}')
    return GlobalBatch(tree, sizes.pop() * dist.get_world_size())


def replicate(tree):
    """Give every process rank 0's values of the tensors of ``tree``
    (``dist.broadcast``, in place, so parameters an optimizer holds stay
    the same tensors); returns ``tree``."""
    from torch.utils import _pytree as pytree
    with torch.no_grad():
        for a in pytree.tree_leaves(tree):
            if isinstance(a, torch.Tensor):
                dist.broadcast(a, src=0)
    return tree
