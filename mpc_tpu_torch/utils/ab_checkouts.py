"""Two checkouts of this repository in turns on one card: the main
paths' host times and the kernels' device times.

    python3 mpc_tpu_torch/utils/ab_checkouts.py OTHER [THIS]
    python3 mpc_tpu_torch/utils/ab_checkouts.py --phases OTHER [THIS]
    python3 mpc_tpu_torch/utils/ab_checkouts.py --phases-nn OTHER [THIS]
    python3 mpc_tpu_torch/utils/ab_checkouts.py --phases-k3 OTHER [THIS]

OTHER and THIS (default: the checkout this file is in) each hold a
``chip_smoke.py`` beside ``mpc_tpu_torch/``; for the parent commit, say,
``mkdir -p build/parent && git archive <commit> | tar -x -C build/parent``.
Every turn is a process of its own, run from its checkout, that builds
the checkout's kernels (once: a build is reused) and runs chip_smoke's
[serve], [train] at B=1024 and 8192, [serve-long], [train-long], [time],
[time-train] at B=1024 and 8192, [time-long], [time-bwd] at B=1024 and
8192 and [time-bwd-long]; the turns go OTHER, THIS, THIS, OTHER, so
that a drift of the machine shows as a difference between the two turns
of one checkout.  The script reports the phases' own lines and judges
no time; host times compare within one call only.

Each turn also solves the headline (K1, B=4096), the long LinDx system
(K3, T=160, B=4096), bench_nn_dynamics (K3's MLP configuration,
B=2048) with its cost and mask builds (chip_smoke's HUBER_ROWS and
UZ_ROWS 'MLP'), K3's other builds at chip_smoke's rows (the damped
pendulum at T=196, 200 and 384: K3_T_RESIDENT, past it, and past the
pendulum's own horizon, where the state is read through the lanes'
rings; the cost build at the pendulum T=200 and the long LinDx rows,
the mask build at the long LinDx row), and the dense kernels' rows once
on the operands chip_smoke builds for them and prints a digest of the outputs' bytes (x, u and
stats; the backward's five gradients): the dense forward at the medium
rows 24s4c and 16s4c (B=2048), 5s1c (B=2048), TVLQR (B=128), config 3
(the cartpole in the model-step build, B=512), the cartpole at T=200
(B=512), the headline under slew 0.5 (B=4096), the MLP build's rows
mlp-deep, mlp-slew and mlp-multictrl (B=2048) and the rows past 8
controls wide-3s9c, wide-4s12c and wide-2s16c (B=2048); the dense
backward at 20s4c and 4s12c (B=1024).  Each dense row's device time
comes from a CUDA graph ([dense-time]), and so does each K3 row's
([k3-time]).  The last lines say whether each
row's digest is the same in all four turns, that is whether the two
checkouts' kernels give the same bits there, and each timed row's best
time in each checkout beside the spread of its two turns.

With ``--phases`` each checkout runs, once, chip_smoke's phase account
([phases-dense]: the clocked builds of the dense forward) at the
model-step build's rows config 3, the cartpole at T=200 (B=512) and the
headline under slew 0.5 (B=4096) and at the MLP build's rows mlp-deep,
mlp-slew and mlp-multictrl, each row's iterations (mean and most: a
launch lasts as long as its slowest warp), the registers and spills of
its build, its workspace's layout, its blocks an SM by registers and by
shared memory and its waves of blocks, and a digest of its outputs
beside; the rows' operands come from ``soa_operands`` and
``mlp_operands``, which every checkout's chip_smoke has.  With
``--phases-nn`` each checkout runs chip_smoke's ``--phases-nn`` alone:
the phase account of K3's MLP configuration (its clocked build, which
a checkout needs) at bench_nn_dynamics and its cost and mask builds.
With ``--phases-k3`` each checkout runs chip_smoke's ``--phases-k3``
alone: the phase account of K3's team kernel (its clocked build, which
a checkout needs) at the damped pendulum at T=196 and T=200, the simple
pendulum's QuadCost and cost builds at T=200 and the long LinDx row.
"""

import os
import subprocess
import sys

TURN = '''
import sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
d = torch.device('cuda')
cs.phase_build()
cs.phase_serve(torch, d)
cs.phase_train(torch, d, 1024)
cs.phase_train(torch, d, 8192)
cs.phase_serve_long(torch, d)
cs.phase_train_long(torch, d)
cs.phase_time(torch, d)
cs.phase_time_train(torch, d, 1024)
cs.phase_time_train(torch, d, 8192)
cs.phase_time_long(torch, d)
cs.phase_time_bwd(torch, d, 1024)
cs.phase_time_bwd(torch, d, 8192)
cs.phase_time_bwd_long(torch, d)
import hashlib
from mpc_tpu_torch import MPCConfig
from mpc_tpu_torch.ops import fused, fused_dense
def digest(outs):
    h = hashlib.sha256()
    for a in outs:
        if a is not None:
            h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]
from mpc_tpu_torch.ops import fused_bwd_dense
dx, cost = cs.problem(torch, d)
bits = {
    'headline': fused.fused_ilqr(**fused.k1_operands(
        MPCConfig(**cs.HEADLINE), cs.x0_batch(cs.B, 0, torch, d), cost, dx,
        u_lower=-2.0, u_upper=2.0)),
}
def damped(T_):
    import dataclasses
    cfg, x0, cost, dx, bk, _ = cs.soa_problem(torch, d, 'damped T=200')
    return fused.k3_operands(dataclasses.replace(cfg, T=T_), x0, cost, dx,
                             **bk)
k3 = {
    'long': cs.long_k3_operands(torch, d),
    'mlp': cs.nn_k3_operands(torch, d),
    'mlp-cost': cs.huber_operands(torch, d, 'MLP')[0],
    'mlp-mask': cs.uz_operands(torch, d, 'MLP')[0],
    'k3-damped-196': damped(196),
    'k3-damped-200': cs.soa_operands(torch, d, 'damped T=200')[0],
    'k3-damped-384': damped(384),
    'k3-cost-pendulum-200': cs.huber_operands(torch, d, 'pendulum T=200')[0],
    'k3-cost-long': cs.huber_operands(torch, d, 'long LinDx')[0],
    'k3-mask-long': cs.uz_operands(torch, d, 'long LinDx')[0],
}
for key, ops in k3.items():
    bits[key] = fused.fused_ilqr_long(**ops)
    ms, _ = cs.graph_ms(torch, lambda: fused.fused_ilqr_long(**ops),
                        reps=3, per_graph=4)
    print(f'[k3-time] {key} {ms:.4f}', flush=True)
fwd = {
    '24s4c': cs.dense_operands(torch, d, 'medium', 24, 4, 2048),
    '16s4c': cs.dense_operands(torch, d, 'medium', 16, 4, 2048),
    '5s1c': cs.dense_operands(torch, d, 'box', 5, 1, 2048),
    'tvlqr': cs.dense_operands(torch, d, 'tvlqr', 3, 4, cs.TVLQR_B),
    'config3': cs.soa_operands(torch, d, 'config 3')[0],
    'cartpole-200': cs.soa_operands(torch, d, 'cartpole T=200')[0],
    'slew': cs.soa_operands(torch, d, 'slew 0.5')[0],
    'mlp-deep': cs.mlp_operands(torch, d, 'mlp-deep'),
    'mlp-slew': cs.mlp_operands(torch, d, 'mlp-slew'),
    'mlp-multictrl': cs.mlp_operands(torch, d, 'mlp-multictrl'),
    'wide-3s9c': cs.wide_operands(torch, d, 'wide-3s9c'),
    'wide-4s12c': cs.wide_operands(torch, d, 'wide-4s12c'),
    'wide-2s16c': cs.wide_operands(torch, d, 'wide-2s16c'),
}
bwd = {
    'bwd-20s4c': cs.bwd_dense_operands(torch, d, 'medium', 20, 4, 1024),
    'bwd-4s12c': cs.wide_bwd_operands(torch, d),
}
for key, ops in fwd.items():
    bits[key] = fused_dense.fused_ilqr_dense(**ops)
    ms, _ = cs.graph_ms(torch, lambda: fused_dense.fused_ilqr_dense(**ops),
                        reps=3, per_graph=4)
    print(f'[dense-time] {key} {ms:.4f}', flush=True)
for key, (o, kw) in bwd.items():
    bits[key] = fused_bwd_dense.fused_kkt_backward_dense(**o, **kw)
    ms, _ = cs.graph_ms(
        torch, lambda: fused_bwd_dense.fused_kkt_backward_dense(**o, **kw))
    print(f'[dense-time] {key} {ms:.4f}', flush=True)

print('[bits] ' + ' '.join(f'{k} {digest(v)}' for k, v in bits.items()))
print(cs.card_line())
'''
KEEP = ('[serve', '[train', '[time', '  median', '  latency', '[bits',
        '[dense-time', '[k3-time')

PHASES = '''
import hashlib, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from mpc_tpu_torch.ops import fused_dense
soa = ('config 3', 'cartpole T=200', 'slew 0.5')
mlp = ('mlp-deep', 'mlp-slew', 'mlp-multictrl')
rows = soa + mlp


def operands(torch, device, label, n=None):
    if label in soa:
        return cs.soa_operands(torch, device, label, n=n)[0]
    return cs.mlp_operands(torch, device, label, n=n)


cs.phase_row_operands = operands
cs.PHASE_ROWS = rows
cs.phases_dense_main(*rows)
d = torch.device('cuda')
sms = torch.cuda.get_device_properties(0).multi_processor_count
for label in rows:
    ops = operands(torch, d, label)
    outs = fused_dense.fused_ilqr_dense(**ops)
    st = outs[2]
    h = hashlib.sha256()
    for a in outs:
        h.update(a.cpu().contiguous().numpy().tobytes())
    defines, geo = cs.dense_defines(ops)
    des = cs.design('fused_ilqr_dense', defines, geo)
    regs = des['registers']
    by_regs = 65536 // (-(-regs // 8) * 8 * 32 * geo['warps'])
    by_smem = fused_dense.blocks_an_sm(geo['smem_bytes'])
    waves = -(-geo['blocks'] // (sms * min(by_regs, by_smem)))
    print(f'[phases-model] {label}, B={ops["x0"].shape[0]}: n_iter mean '
          f'{float(st[2].mean()):.2f}, max {float(st[2].max()):.0f}; '
          f'registers {regs}, spill stores {des["spill_store_bytes"]} bytes; '
          f'shared memory {geo["smem_bytes"]} bytes a block, workspace '
          f'{"shared" if geo.get("ws_shared") else "global"} '
          f'({geo["workspace_bytes"]} bytes in global memory); blocks an SM '
          f'{by_regs} by registers, {by_smem} by shared memory; '
          f'{geo["blocks"]} blocks, {waves} wave(s) on {sms} SMs; digest '
          f'{h.hexdigest()[:16]}', flush=True)
print(cs.card_line())
'''


def phases(other, this, flag=None):
    """The phase account of both checkouts at the model-step and MLP
    builds' rows, or with ``flag`` (``--phases-nn``, ``--phases-k3``)
    chip_smoke's phase of that name alone."""
    for who, where in (('other', other), ('this', this)):
        cmd = ([sys.executable, 'chip_smoke.py', flag] if flag
               else [sys.executable, '-c', PHASES])
        r = subprocess.run(cmd, cwd=where, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], sep='\n')
            return r.returncode
        for line in r.stdout.splitlines():
            print(f'{who:5s} {line}', flush=True)
    return 0


def main(argv):
    here = os.path.dirname(os.path.abspath(__file__))
    if len(argv) > 1 and argv[1] in ('--phases', '--phases-nn',
                                     '--phases-k3'):
        if not 3 <= len(argv) <= 4:
            print(__doc__, file=sys.stderr)
            return 2
        return phases(argv[2], argv[3] if len(argv) == 4
                      else os.path.join(here, '..', '..'),
                      flag=None if argv[1] == '--phases' else argv[1])
    if not 2 <= len(argv) <= 3:
        print(__doc__, file=sys.stderr)
        return 2
    this = argv[2] if len(argv) == 3 else os.path.join(here, '..', '..')
    turns = [('other', argv[1]), ('this', this), ('this', this),
             ('other', argv[1])]
    digests, dense_ms = [], {}
    for i, (who, where) in enumerate(turns):
        r = subprocess.run([sys.executable, '-c', TURN], cwd=where,
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], sep='\n')
            return r.returncode
        lines = r.stdout.splitlines()
        for line in lines[:-1]:
            if line.startswith(KEEP):
                print(f'turn {i + 1} {who:5s} {line}', flush=True)
            if line.startswith('[bits] '):
                words = line.split()[1:]
                digests.append(dict(zip(words[::2], words[1::2])))
            if line.startswith(('[dense-time] ', '[k3-time] ')):
                _, key, ms = line.split()
                dense_ms.setdefault(key, {}).setdefault(who, []).append(
                    float(ms))
        print(f'turn {i + 1} {who:5s} [card] {lines[-1]}', flush=True)
    print('[bits] the same in all four turns: ' + ', '.join(
        f'{k} {"yes" if len({d[k] for d in digests}) == 1 else "NO"}'
        for k in digests[0]), flush=True)
    for key, t in dense_ms.items():
        print(f'[time] {key}: other ' + ' '.join(
            f'{v:.4f}' for v in t['other']) + ', this ' + ' '.join(
            f'{v:.4f}' for v in t['this']) + f'; this / other '
            f'{min(t["this"]) / min(t["other"]):.3f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
