"""A short first call of K3's dense configuration on the card.

    python3 mpc_tpu_torch/utils/probe_dense.py

Builds csrc/fused_ilqr_dense.cu at ten define sets (the JAX package's
rows and the gate's corners) and prints each build's registers and
spills (ptxas), then runs the kernel once against its plain version at
four small shapes and times it with CUDA events at the medium-state
rows (16 and 24 states, 4 controls, T=20, box +-1) at B = 1024 and
2048.  It judges nothing: chip_smoke.py holds the kernel; this is the
quick look at a new build.  Needs a CUDA card.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import mpc_tpu_torch as mt  # noqa: E402
from mpc_tpu_torch.ops import _build, fused, fused_dense as fd  # noqa: E402

BUILDS = [(3, 4, False, True), (16, 4, True, False), (24, 4, True, False),
          (28, 4, True, False), (24, 8, True, False), (5, 1, True, False),
          (1, 8, False, False), (2, 2, True, False), (19, 4, True, False),
          (3, 2, False, False)]


def problem(T, B, ns, nc, seed, box=True, tvlqr=False):
    """The medium-state rows' system (or config 1's random TVLQR)."""
    rng = np.random.RandomState(seed)
    nt = ns + nc
    f = None
    if tvlqr:
        C = rng.randn(T, B, nt, nt)
        C = np.einsum('tbij,tbkj->tbik', C, C)
        c = rng.randn(T, B, nt)
        F = np.concatenate([np.eye(ns) + 0.1 * rng.randn(T - 1, B, ns, ns),
                            0.5 * rng.randn(T - 1, B, ns, nc)], 3)
        f = rng.randn(T - 1, B, ns)
    else:
        A = np.eye(ns) + 0.01 * rng.randn(ns, ns)
        A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
        F = np.tile(np.concatenate([A, 0.1 * rng.randn(ns, nc)], 1)[None],
                    (T - 1, 1, 1))
        C = np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)]))
        c = np.zeros(nt)
    t = (lambda a: None if a is None else torch.tensor(
        a, dtype=torch.float32, device='cuda'))
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T, lqr_iter=10, eps=0.0,
                       exit_unconverged=False, detach_unconverged=False,
                       backprop=False)
    bk = dict(u_lower=-1.0, u_upper=1.0) if box else {}
    return fd.k3d_operands(cfg, t(rng.randn(B, ns)), mt.QuadCost(t(C), t(c)),
                           mt.LinDx(t(F), t(f)), **bk)


def event_ms(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main():
    if not torch.cuda.is_available():
        print('probe_dense: no CUDA card is visible', file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    specs = [('fused_ilqr_dense', fd.dense_kernel_defines(*b))
             for b in BUILDS]
    t0 = time.perf_counter()
    _build.build(specs)
    print(f'built in {time.perf_counter() - t0:.1f} s')
    for name, defines in specs:
        rep = _build.ptxas_report(name, defines)
        print(defines, ' | '.join(line.strip() for line in rep.splitlines()
                                  if 'registers' in line or 'spill' in line))
    for what, args in (('tvlqr 3s4c B=128', (5, 128, 3, 4, 1, False, True)),
                       ('5s1c box B=256', (20, 256, 5, 1, 2)),
                       ('24s4c box B=256', (20, 256, 24, 4, 3)),
                       ('2s2c box B=64', (6, 64, 2, 2, 4))):
        ops = problem(*args)
        fused.reset_launch_counts()
        ms, (xk, uk, sk) = event_ms(lambda: fd.fused_ilqr_dense(**ops))
        ms2, _ = event_ms(lambda: fd.fused_ilqr_dense(**ops))
        pms, (xp, up, sp) = event_ms(lambda: fd.fused_solve_dense_plain(**ops))
        d = (uk - up).abs()
        print(f'{what}: launches {fused.launch_counts}, kernel {ms:.3f}/'
              f'{ms2:.3f} ms (the first call loads the library), plain '
              f'{pms:.1f} ms; mean |du| {float(d.mean()):.3e}, max '
              f'{float(d.max()):.3e}; n_iter equal '
              f'{bool(torch.equal(sk[2], sp[2]))}')
    for ns, B in ((16, 2048), (24, 1024), (24, 2048)):
        ops = problem(20, B, ns, 4, 5)
        fd.fused_ilqr_dense(**ops)
        times = [event_ms(lambda: fd.fused_ilqr_dense(**ops))[0]
                 for _ in range(3)]
        print(f'{ns}s4c B={B}: kernel ms {times}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
