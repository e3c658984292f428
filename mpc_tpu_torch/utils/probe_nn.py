"""K3's MLP configuration on the card: how far its float32 solves sit
from float64, and its shared-memory layout against the workspace.

    python3 mpc_tpu_torch/utils/probe_nn.py eager [DIR]
    python3 mpc_tpu_torch/utils/probe_nn.py horizon [DIR]
    python3 mpc_tpu_torch/utils/probe_nn.py layout [T ...]

``eager``: chip_smoke's [eager-nn] problem (bench_nn_dynamics, B=2048)
with the pendulum starts of seeds 4 (chip_smoke's) and 5, in the
checkout at DIR (default: this one), solved by K3 and by the plain K3 in
float32 and by the eager solver in float32 and float64: each float32
solve's tail against the float64 eager solve and against the others,
with the examples that part (some |du| over the horizon above 1e-3).
``horizon``: the sigmoid MLP of ``tests/test_torch_gpu.py``'s
``test_k3_nn_matches_plain`` (B=256, box +-2, 5 iterations) at T = 20,
90, 200 and 430 in the checkout at DIR: K3 against the plain K3 in
float32 (the tail and the examples that part) and each one's mean |du|
from the plain K3 in float64 (the test's float64 rule holds K3 to twice
the plain float32 run's), n_iter agreement and the reversed batch,
bitwise.  ``layout``: bench_nn_dynamics (B=2048) at each T (default 20,
100, 200 and 400) in this checkout, the examples' slots resident in shared memory
(``fused.k3_nn_launch``'s rule) and in the workspace, each timed from a
CUDA graph with its blocks an SM by shared memory, and their outputs
against each other, bitwise.  Judges nothing; needs a CUDA card.
"""

import os
import sys

import numpy as np

TAIL = 1e-3


def _setup(root=None):
    root = os.path.abspath(root or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), '..', '..'))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from mpc_tpu_torch.ops import fused
    return torch, cs, fused, torch.device('cuda'), os.path.basename(root)


def _apart(u, ref):
    """mean |du|, the share above TAIL, max |du| and the examples of
    [T, B, 1] controls with some |du| above TAIL."""
    d = (u.double() - ref.double()).abs()
    parted = int((d.amax(dim=(0, 2)) > TAIL).sum())
    return (f'mean |du| {float(d.mean()):.3e}, share |du|>1e-3 '
            f'{float((d > TAIL).double().mean()):.5f}, max '
            f'{float(d.max()):.3e}, examples parted {parted} of '
            f'{u.shape[1]}')


def eager(root):
    import dataclasses
    torch, cs, fused, d, name = _setup(root)
    import mpc_tpu_torch as mt
    kw = dict(u_lower=-2.0, u_upper=2.0, device=d)
    for seed in (4, 5):
        u = {}
        for dtype in (torch.float32, torch.float64):
            cfg, x0, cost, model = cs.nn_problem(
                torch, d, dtype=dtype, seed=seed, use_fused='never')
            u[f'eager {dtype}'] = mt.batched_solve(cfg, x0, cost, model,
                                                   **kw).u
        cfg, x0, cost, model = cs.nn_problem(torch, d, seed=seed,
                                             use_fused='never')
        u['K3'] = mt.batched_solve(dataclasses.replace(cfg, use_fused='auto'),
                                   x0, cost, model, **kw).u
        u['plain K3'] = fused.fused_solve_long_plain(
            **cs.nn_k3_operands(torch, d, seed=seed))[1]
        for a, b in (('K3', 'eager torch.float64'),
                     ('plain K3', 'eager torch.float64'),
                     ('eager torch.float32', 'eager torch.float64'),
                     ('K3', 'eager torch.float32'),
                     ('plain K3', 'eager torch.float32'),
                     ('K3', 'plain K3')):
            cs.log(f'[eager] {name} seed {seed}: {a} vs {b}: '
                   + _apart(u[a], u[b]))
    cs.log(cs.card_line())


def _horizon_ops(torch, fused, d, T, dtype):
    """test_k3_nn_matches_plain's sigmoid problem at horizon T."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PendulumDx
    B = 256
    model = mt.NNDynamics.init(3, 1, (100,), 'sigmoid',
                               generator=torch.Generator().manual_seed(0),
                               device=d).to(dtype)
    th = np.pi * (2 * np.random.RandomState(4).rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      dtype=dtype, device=d)
    q, p = PendulumDx(device=d, dtype=dtype).get_true_obj()
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=5, eps=0.0,
                       backprop=False, max_linesearch_iter=3,
                       linesearch_decay=0.2)
    return fused.k3_operands(cfg, x0, mt.QuadCost(torch.diag(q), p), model,
                             u_lower=-2.0, u_upper=2.0)


def horizon(root, horizons=(20, 90, 200, 430)):
    torch, cs, fused, d, name = _setup(root)
    for T in horizons:
        ops = _horizon_ops(torch, fused, d, T, torch.float32)
        _, uk, sk = fused.fused_ilqr_long(**ops)
        _, up, sp = fused.fused_solve_long_plain(**ops)
        u64 = fused.fused_solve_long_plain(
            **_horizon_ops(torch, fused, d, T, torch.float64))[1]
        k_far = float((uk.double() - u64).abs().mean())
        p_far = float((up.double() - u64).abs().mean())
        rev = torch.arange(uk.shape[1] - 1, -1, -1, device=d)
        r = fused.fused_ilqr_long(**cs.batch_subset(torch, ops, rev))
        same = torch.equal(r[1].flip(1), uk)
        cs.log(f'[horizon] {name} T={T}: K3 vs plain f32: '
               f'{_apart(uk, up)}; K3 vs plain f64 mean |du| {k_far:.3e}, '
               f'plain f32 vs plain f64 {p_far:.3e} (ratio '
               f'{k_far / p_far:.3f}); K3 vs plain f64: {_apart(uk, u64)}; '
               f'n_iter equal {float((sk[2] == sp[2]).double().mean()):.4f}; '
               f'reversed batch bitwise {same}')
    cs.log(cs.card_line())


def layout(horizons):
    torch, cs, fused, d, name = _setup()
    from mpc_tpu_torch.ops import fused_dense as fd
    limit = fused.SMEM_LIMIT
    for T in horizons:
        ops = cs.nn_k3_operands(torch, d, T=T)
        out, ms = {}, {}
        for where in ('shared memory', 'workspace'):
            # the workspace: the rule finds no room for the slots
            fused.SMEM_LIMIT = limit if where == 'shared memory' else 0
            try:
                geo = fused.k3_nn_launch(T, cs.NN_B, cs.NN_H)
                out[where] = fused.fused_ilqr_long(**ops)
                ms[where], _ = cs.graph_ms(
                    torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                    per_graph=4)
            finally:
                fused.SMEM_LIMIT = limit
            cs.log(f'[layout] T={T}, B={cs.NN_B}: slots in the {where}: '
                   f'{ms[where]:.4f} ms (from a CUDA graph); '
                   f'{geo["smem_bytes"]} bytes of shared memory a block, '
                   f'blocks an SM by shared memory '
                   f'{fd.blocks_an_sm(geo["smem_bytes"], geo["warps"])}, '
                   f'workspace {geo["workspace_bytes"]} bytes')
        same = all(torch.equal(a, b) for a, b in
                   zip(out['shared memory'], out['workspace']))
        cs.log(f'[layout] T={T}: workspace / shared memory '
               f'{ms["workspace"] / ms["shared memory"]:.3f}; outputs '
               f'bitwise equal {same}')
    cs.log(cs.card_line())


def main(argv):
    # run as a script, this directory comes first on the path, where the
    # package's logging.py would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or '.') != here]
    if len(argv) in (2, 3) and argv[1] in ('eager', 'horizon'):
        (eager if argv[1] == 'eager' else horizon)(
            argv[2] if len(argv) == 3 else None)
    elif len(argv) >= 2 and argv[1] == 'layout':
        layout([int(v) for v in argv[2:]] or [20, 100, 200, 400])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
