"""Build and load the port's CUDA kernels.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/mpc_tpu_torch/`` at
the root of the checkout, named by a hash of the sources, the defines
and the flags, so a build is reused until one of them changes.  The
``-Xptxas -v`` report of each build (registers, spills) is kept beside
the library.  Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mpc_tpu_torch'

# no --use_fast_math: the kernels compare bounds exactly and want IEEE
# division, sqrtf and the accurate cosf/sinf
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded = {}


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels of mpc_tpu_torch '
                       'are built on the machine with the card')


def _library_path(name, defines) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(sorted(defines.items())).encode())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def start(specs, niceness=0, jobs=None):
    """Start nvcc for every (name, defines) in ``specs`` that is not built
    yet, one process each, at most ``jobs`` at a time (all together by
    default), at ``niceness`` (19: the lowest priority, so that the
    caller's processes keep their cores); ``finish`` waits for them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = [_library_path(n, d) for n, d in specs]
    todo = [(name, defines, lib) for (name, defines), lib in zip(specs, paths)
            if not lib.exists()]
    pool = ThreadPoolExecutor(max_workers=max(1, jobs or len(todo)))
    futures = [pool.submit(_nvcc, *t, niceness) for t in todo]
    pool.shutdown(wait=False)
    return paths, futures


def _nvcc(name, defines, lib, niceness):
    """One build; returns its log where it failed, else None."""
    # unique, so that two builds of one library never share a file
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS,
           *(f'-D{k}={v}' for k, v in sorted(defines.items())),
           '-o', str(tmp), str(CSRC / f'{name}.cu')]
    if niceness and shutil.which('nice'):
        cmd = ['nice', '-n', str(niceness), *cmd]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f'{lib.name}:\n{proc.stdout}'
    lib.with_suffix('.ptxas.txt').write_text(proc.stdout)
    os.replace(tmp, lib)
    return None


def finish(started):
    """Wait for the builds of ``start``; a failed build raises.  Returns
    the library paths in order."""
    paths, futures = started
    failures = [f for f in (fut.result() for fut in futures) if f]
    if failures:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
    return paths


def build(specs):
    """Build every (name, defines) in ``specs`` that is not built yet,
    one nvcc process each, all started together.  Returns the library
    paths in order."""
    return finish(start(specs))


def ptxas_report(name, defines) -> str:
    """The ``-Xptxas -v`` output of a built library."""
    return _library_path(name, defines).with_suffix('.ptxas.txt').read_text()


def load(name, defines) -> ctypes.CDLL:
    """The built library for ``name`` with ``defines``, building it at
    first use."""
    key = (name, tuple(sorted(defines.items())))
    if key not in _loaded:
        (path,) = build([(name, defines)])
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]
