#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds kernel K1 (mpc_tpu_torch/csrc/fused_ilqr.cu) with nvcc for
sm_90a, holds it against its plain PyTorch version on the card, serves
a few batched requests of the pendulum swing-up solve (the JAX package's
headline workload: T=20, lqr_iter=10, B=4096, box bounds +-2, float32)
through the port's entry points, runs the receding-horizon swing-up at
B=4096, times K1 against its bound, and prints one JSON line of kernel
numbers, the card's name and power limit, and a last JSON line with the
device.  Every phase raises on failure; the script then exits nonzero.
It exits nonzero without a result when no card is visible or when the
package is not beside it.  It imports nothing of JAX or mpc_tpu.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the headline configuration (bench.py:47-69)
B, T = 4096, 20
HEADLINE = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=10, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=5)
# K1 against its plain version in float32: the bang-bang tail of
# tests/test_fused_fulltile.py (a few switch steps flip between two
# float32 solves; FMA contraction in nvcc is the only arithmetic
# difference)
TAIL_MEAN, TAIL_ENTRY, TAIL_SHARE = 1e-4, 1e-3, 0.005
# swing-up success share at B=4096, from a CPU rehearsal of the same
# seed and loop at B=64 (64 of 64 within 0.1 of cos th = 1) less a margin
# for float32 on the card (PERF.md)
SWINGUP_MIN_SHARE = 0.95
# H100 SXM peaks (NVIDIA datasheet): float32 outside the tensor cores,
# and HBM bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def x0_batch(n, seed, torch, device):
    import numpy as np
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    x = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)
    return torch.tensor(x, dtype=torch.float32, device=device)


def problem(torch, device, dtype=None):
    from mpc_tpu_torch import QuadCost
    from mpc_tpu_torch.models import PendulumDx
    dtype = dtype or torch.float32
    dx = PendulumDx(device=device, dtype=dtype)
    q, p = dx.get_true_obj()
    return dx, QuadCost(torch.diag(q), p)


def tail(u, ref):
    d = (u - ref).abs()
    return float(d.mean()), float((d > TAIL_ENTRY).double().mean()), \
        float(d.max())


def check_tail(what, u, ref):
    mean, share, mx = tail(u, ref)
    log(f'  {what}: mean |du| {mean:.3e}, share |du|>1e-3 {share:.5f}, '
        f'max |du| {mx:.3e}')
    if not (mean < TAIL_MEAN and share < TAIL_SHARE):
        raise AssertionError(f'{what}: outside the float32 bang-bang tail')
    return mx


def phase_build():
    from mpc_tpu_torch.ops import _build
    specs = [('fused_ilqr', {'MPC_T': T, 'MPC_HAS_BOUNDS': 1})]
    t0 = time.perf_counter()
    paths = _build.build(specs)
    log(f'[build] nvcc {" ".join(_build.NVCC_FLAGS)} '
        f'({time.perf_counter() - t0:.1f} s)')
    for (name, defines), path in zip(specs, paths):
        log(f'  {os.path.relpath(path, HERE)}')
        for line in _build.ptxas_report(name, defines).splitlines():
            if 'registers' in line or 'spill' in line or 'stack' in line:
                log(f'  ptxas: {line.strip()}')


def phase_compare(torch, device, n=B):
    """K1 against fused_solve_plain on the card; returns max |du|."""
    from mpc_tpu_torch import MPCConfig
    from mpc_tpu_torch.ops import fused
    cfg = MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    dx64, cost64 = problem(torch, device, torch.float64)
    log(f'[compare] K1 vs its plain version, B={n}')

    def ops(x0, **kw):
        return fused.k1_operands(cfg, x0, kw.pop('cost', cost), dx,
                                 u_lower=kw.pop('lb', -2.0),
                                 u_upper=kw.pop('ub', 2.0))

    x0 = x0_batch(n, 0, torch, device)
    xk, uk, sk = fused.fused_ilqr(**ops(x0))
    xp, up, sp = fused.fused_solve_plain(**ops(x0))
    o64 = fused.k1_operands(cfg, x0.double(), cost64, dx64, u_lower=-2.0,
                            u_upper=2.0)
    _, u64, _ = fused.fused_solve_plain(**o64)
    for t in (xk, uk, sk):
        if not torch.isfinite(t).all():
            raise AssertionError('K1 returned non-finite values')
    mx = check_tail('K1 vs plain (f32)', uk, up)
    if not torch.equal(sk[2], sp[2]):
        raise AssertionError('n_iter differs between K1 and plain')
    cost_gap = float((sk[0] - sp[0]).abs().max())
    log(f'  max |cost K1 - cost plain| {cost_gap:.3e}')
    k_far = tail(uk.double(), u64)[0]
    p_far = tail(up.double(), u64)[0]
    log(f'  mean |du| to the f64 plain run: K1 {k_far:.3e}, '
        f'plain f32 {p_far:.3e}')
    if k_far > 2 * p_far + 1e-6:
        raise AssertionError('K1 sits further from float64 than the '
                             'plain float32 run')
    # batch reversal: no example reads another's data
    r = fused.fused_ilqr(**ops(x0.flip(0).contiguous()))
    if not (torch.equal(r[1].flip(1), uk) and torch.equal(r[0].flip(1), xk)
            and torch.equal(r[2].flip(1), sk)):
        raise AssertionError('reversed batch is not bitwise equal')
    log('  reversed batch: bitwise equal')
    # batched cost / bounds layouts: batch stride 16 and 1 instead of 0
    from mpc_tpu_torch import QuadCost
    cb = QuadCost(cost.C.expand(T, n, 4, 4), cost.c.expand(T, n, 4))
    lbB = torch.full((T, n, 1), -2.0, device=device)
    rb = fused.fused_ilqr(**ops(x0, cost=cb, lb=lbB, ub=-lbB))
    if not (torch.equal(rb[1], uk) and torch.equal(rb[2], sk)):
        raise AssertionError('batched layouts differ from shared ones')
    log('  batched cost and bounds: bitwise equal to shared')
    # ragged tail: 2050 = 32 blocks of 64 and 2 examples
    x2 = x0_batch(2050, 1, torch, device)
    _, u2, s2 = fused.fused_ilqr(**ops(x2))
    _, u2p, s2p = fused.fused_solve_plain(**ops(x2))
    mx = max(mx, check_tail('K1 vs plain, B=2050', u2, u2p))
    if not torch.equal(s2[2], s2p[2]):
        raise AssertionError('n_iter differs at B=2050')
    return mx


def phase_serve(torch, device, n_requests=8, n=B):
    """Serve distinct B=4096 request batches through batched_solve and
    MPC; returns the K1 launches counted in this phase."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    ctrl = mt.MPC(3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=10, eps=0.0,
                  exit_unconverged=False, detach_unconverged=False,
                  backprop=False, linesearch_decay=0.2,
                  max_linesearch_iter=5, device=device)
    requests = [x0_batch(n, 100 + i, torch, 'cpu')
                for i in range(2 * n_requests)]
    # warm-up request (first use loads the library)
    mt.batched_solve(cfg, requests[0].to(device), cost, dx, u_lower=-2.0,
                     u_upper=2.0, device=device).u.cpu()
    fused.reset_launch_counts()
    lat = []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        x0 = req.to(device)
        if i < n_requests:
            sol = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0,
                                   u_upper=2.0, device=device)
            u, costs = sol.u, sol.costs
        else:
            _, u, costs = ctrl(x0, cost, dx)
        u = u.cpu()
        lat.append(time.perf_counter() - t0)
    launches = fused.launch_counts['fused_ilqr']
    log(f'[serve] {len(requests)} requests of B={n} '
        f'({n_requests} batched_solve, {n_requests} MPC)')
    log('  latency ms: ' + ' '.join(f'{1e3 * v:.3f}' for v in lat))
    log(f'  median {1e3 * sorted(lat)[len(lat) // 2]:.3f} ms, '
        f'{n * len(lat) / sum(lat):.0f} solves/s, K1 launches {launches}')
    if device.type == 'cuda' and launches < len(requests):
        raise AssertionError('served requests did not all launch K1')
    # the last answer holds up: its states are the rollout of its
    # controls and its costs are their objective
    xr = rollout(dx, x0, u.to(device))
    cr = trajectory_cost(cost, xr, u.to(device))
    gap = float((cr - costs).abs().max() / costs.abs().max())
    log(f'  last answer: relative cost gap to its own rollout {gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0
            and gap < 1e-3):
        raise AssertionError('served controls are not a feasible solve')
    return launches


def phase_swingup(torch, device, n=B, steps=100):
    """The pendulum's receding-horizon swing-up from random starts."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    dx, cost = problem(torch, device)
    x = x0_batch(n, 0, torch, device)
    u_init = None
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        ctrl = mt.MPC(3, 1, T, u_lower=-2., u_upper=2., lqr_iter=50,
                      n_batch=n, u_init=u_init,
                      grad_method=mt.GradMethods.AUTO_DIFF, eps=1e-2,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, linesearch_decay=0.2,
                      max_linesearch_iter=5, device=device)
        xs, us, costs = ctrl(x, cost, dx)
        x = dx(x, us[0])
        u_init = torch.cat([us[1:], torch.zeros_like(us[:1])], 0)
    share = float((x[:, 0] > 0.9).double().mean())
    wall = time.perf_counter() - t0
    log(f'[swingup] B={n}, {steps} steps, {wall:.2f} s, K1 launches '
        f'{fused.launch_counts["fused_ilqr"]}: share within 0.1 of '
        f'cos th = 1: {share:.4f} (threshold {SWINGUP_MIN_SHARE}), '
        f'mean final cost {float(costs.mean()):.4f}')
    if not torch.isfinite(x).all() or share < SWINGUP_MIN_SHARE:
        raise AssertionError('swing-up did not reach its success share')
    return share


def phase_time(torch, device, reps=50):
    """K1 with CUDA events over many launches after warm-up, its bound,
    and the plain version on the card."""
    from mpc_tpu_torch import MPCConfig
    from mpc_tpu_torch.ops import fused
    cfg = MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    ops = fused.k1_operands(cfg, x0_batch(B, 2, torch, device), cost, dx,
                            u_lower=-2.0, u_upper=2.0)
    for _ in range(3):
        _, _, stats = fused.fused_ilqr(**ops)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fused.fused_ilqr(**ops)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    start.record()
    fused.fused_solve_plain(**ops)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    n_it = float(stats[2].double().sum())
    n_trials = float(stats[5].double().sum())
    flops = fused.k1_flops(T, 3, 1, n_it, n_trials, batch=B)
    nbytes = fused.k1_bytes(ops)
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f'[time] K1 B={B}: {ms:.4f} ms ({reps} launches), plain '
        f'{plain_ms:.2f} ms; {flops:.4e} operations '
        f'({n_trials / B:.2f} trials/solve), {nbytes} bytes; bound '
        f'{max(t_ops, t_bytes):.5f} ms by '
        f'{"operations" if t_ops >= t_bytes else "bytes"}; '
        f'{B / ms * 1e3:.0f} solves/s')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card is visible', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'mpc_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository '
              '(mpc_tpu_torch/ is missing)', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device('cuda')
    card = card_line()
    log(f'[card] {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    phase_build()
    max_err = phase_compare(torch, device)
    launches = phase_serve(torch, device)
    phase_swingup(torch, device)
    timing = phase_time(torch, device)
    log(f'[done] {time.perf_counter() - t0:.1f} s')
    log(json.dumps({'kernels': [{
        'name': 'fused_ilqr', 'route': 'cuda',
        'source': 'mpc_tpu_torch/csrc/fused_ilqr.cu',
        'replaces': 'mpc_tpu/ops/fused.py:617',
        'launches': launches, 'max_abs_err': max_err,
        'tolerance': f'mean|du|<{TAIL_MEAN}, '
                     f'share(|du|>{TAIL_ENTRY})<{TAIL_SHARE}',
        'library_ms': None, **timing}]}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
