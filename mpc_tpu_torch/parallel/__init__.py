"""Scale-out: batch-sharded solving over the devices of one process
(``mesh``) and the multi-process helpers (``distributed``), as
mpc_tpu/parallel/__init__.py."""

from .mesh import make_mesh, shard_batch, solve_sharded
from .distributed import (initialize, make_pod_mesh, pod_batch_spec,
                          replicate, shard_global_batch)

__all__ = ['make_mesh', 'shard_batch', 'solve_sharded',
           'initialize', 'make_pod_mesh', 'pod_batch_spec',
           'shard_global_batch', 'replicate']
