"""The port's multi-process path on the CPU (mpc_tpu_torch/parallel/
distributed.py, learning.make_sharded_train_step over a process mesh):
two OS processes joined by gloo, the counterpart of
tests/test_multiprocess.py and its worker tests/_mp_worker.py.

Each process runs this file as a script (the worker below): it joins the
group from the MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK variables
(``parallel.initialize``), builds the (hosts, chips) mesh, and checks
the two paths of the JAX package's worker:

1. the batch split over the processes (``pod_batch_spec``), each solving
   its half: the halves gathered are bitwise the full-batch solve, as
   every example is solved alone;
2. the imitation train step over the process mesh, SGD, from parameters
   broadcast from rank 0 (``replicate``): the loss and gradients are
   averaged over the processes (one all-reduce), so both ranks print the
   same bits, and the parent holds them to the JAX package's loss,
   gradient and SGD step on the full batch (``jax.value_and_grad``, its
   jnp path; the worker's step runs the eager route, the same algorithm)
   within 1e-10.  On the kernel route (the plain K1 and K2) the ranks
   agree bitwise too.

Every process has its own timeout and is killed at it.
"""

import os
import socket
import subprocess
import sys

import numpy as np

B, T, LR = 8, 5, 0.1
Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])
CFG = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=0.0,
           exit_unconverged=False, detach_unconverged=False,
           linesearch_decay=0.2, max_linesearch_iter=2)
TOL = 1e-10
TIMEOUT_S = 240


def _data():
    rng = np.random.RandomState(0)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    return x0, rng.randn(T, B, 1)


def worker():
    import torch
    import torch.distributed as dist

    import mpc_tpu_torch as mt
    from mpc_tpu_torch import parallel
    from mpc_tpu_torch.models import PendulumDx

    parallel.initialize(timeout_s=TIMEOUT_S)
    assert dist.get_backend() == 'gloo' and dist.get_world_size() == 2
    mesh = parallel.make_pod_mesh()
    assert mesh.shape == (1, 2) and mesh.mesh_dim_names == ('hosts', 'chips')
    x0, u_expert = (torch.tensor(a) for a in _data())
    sl = parallel.pod_batch_spec(B)
    local = parallel.shard_global_batch({'x0': x0[sl],
                                         'u': u_expert[:, sl]})
    assert local.global_batch == B
    dx = PendulumDx(device='cpu', dtype=torch.float64)
    cost = mt.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))

    # path 1: each process solves its half
    cfg = mt.MPCConfig(backprop=False, **CFG)
    kw = dict(u_lower=-2.0, u_upper=2.0, device='cpu')
    u_local = mt.batched_solve(cfg, local.local['x0'], cost, dx, **kw).u
    halves = [torch.empty_like(u_local) for _ in range(2)]
    dist.all_gather(halves, u_local.contiguous())
    full = mt.batched_solve(cfg, x0, cost, dx, **kw).u
    print('SOLVE_EQUAL', torch.equal(torch.cat(halves, 1), full), flush=True)

    # path 2: the train step over the processes, from rank 0's parameters
    def make_cost(t):
        return mt.QuadCost(torch.diag(torch.tensor(Q)), t['c'])

    for route in ('never', 'auto'):
        theta = {'c': torch.tensor(P) + dist.get_rank()}
        parallel.replicate(theta)
        theta['c'].requires_grad_()
        opt = torch.optim.SGD([theta['c']], lr=LR)
        step = mt.make_sharded_train_step(
            mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                         use_fused=route, **CFG),
            mesh, opt, make_cost, lambda t: dx, u_lower=-2.0, u_upper=2.0)
        loss = step(theta, local.local['x0'], local.local['u'])
        print(f'{route.upper()}_LOSS {float(loss).hex()}', flush=True)
        print(f'{route.upper()}_GRAD '
              + ' '.join(float(g).hex() for g in theta['c'].grad), flush=True)
        print(f'{route.upper()}_THETA '
              + ' '.join(float(v).hex() for v in theta['c'].detach()),
              flush=True)
    dist.destroy_process_group()
    print('WORKER_OK', flush=True)


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _field(out, name):
    for line in out.splitlines():
        if line.startswith(name + ' '):
            return line.split()[1:]
    raise AssertionError(f'{name} not found in:\n{out}')


def test_two_process_pod_mesh():
    import jax
    import jax.numpy as jnp

    import mpc_tpu
    from mpc_tpu.learning import imitation_loss
    from mpc_tpu.models import PendulumDx as JPendulumDx

    jax.config.update('jax_enable_x64', True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR='localhost', MASTER_PORT=port,
                   WORLD_SIZE='2', RANK=str(rank))
        env.pop('LOCAL_WORLD_SIZE', None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and 'WORKER_OK' in out, \
            f'worker {i} failed:\n{out}'
        assert _field(out, 'SOLVE_EQUAL') == ['True'], out
    # both ranks took the same step, bit for bit, on both routes
    for name in ('NEVER_LOSS', 'NEVER_GRAD', 'NEVER_THETA', 'AUTO_LOSS',
                 'AUTO_GRAD', 'AUTO_THETA'):
        assert _field(outs[0], name) == _field(outs[1], name), name

    # the JAX package on the full batch: loss, gradient, SGD step
    x0, u_expert = _data()
    jcfg = mpc_tpu.MPCConfig(grad_method=mpc_tpu.GradMethods.AUTO_DIFF,
                             **CFG)
    jdx = JPendulumDx()
    loss, grad = jax.value_and_grad(lambda t: imitation_loss(
        t, jcfg, jnp.asarray(x0), jnp.asarray(u_expert),
        lambda th: mpc_tpu.QuadCost(jnp.diag(jnp.asarray(Q)), th['c']),
        lambda th: jdx, u_lower=-2.0, u_upper=2.0))({'c': jnp.asarray(P)})

    def floats(name):
        return np.array([float.fromhex(v) for v in _field(outs[0], name)])

    np.testing.assert_allclose(floats('NEVER_LOSS'), [float(loss)], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(floats('NEVER_GRAD'), np.asarray(grad['c']),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(floats('NEVER_THETA'),
                               P - LR * np.asarray(grad['c']), rtol=0,
                               atol=TOL)


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    worker()
