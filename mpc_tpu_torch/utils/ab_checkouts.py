"""Two checkouts of this repository in turns on one card: the main
paths' host times and the kernels' device times.

    python3 mpc_tpu_torch/utils/ab_checkouts.py OTHER [THIS]

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
(K3, T=160, B=4096), the medium row (the dense configuration, 24
states and 4 controls, B=2048), bench_nn_dynamics (K3's MLP
configuration, B=2048), config 3 (the cartpole in the dense
configuration's model-step build, B=512) and the headline under slew 0.5
(the slew-augmented pendulum there, B=4096) once on the operands
chip_smoke builds for them and prints a digest of the outputs' bytes (x,
u and stats); the
last line says whether each row's digest is the same in all four turns,
that is whether the two checkouts' kernels give the same bits there.
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
        h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]
dx, cost = cs.problem(torch, d)
bits = {
    'headline': fused.fused_ilqr(**fused.k1_operands(
        MPCConfig(**cs.HEADLINE), cs.x0_batch(cs.B, 0, torch, d), cost, dx,
        u_lower=-2.0, u_upper=2.0)),
    'long': fused.fused_ilqr_long(**cs.long_k3_operands(torch, d)),
    '24s4c': fused_dense.fused_ilqr_dense(**cs.dense_operands(
        torch, d, 'medium', 24, 4, 2048)),
    'mlp': fused.fused_ilqr_long(**cs.nn_k3_operands(torch, d)),
}
for key, label in (('config3', 'config 3'), ('slew', 'slew 0.5')):
    ops, kernel, _ = cs.soa_operands(torch, d, label)
    bits[key] = kernel(**ops)

print('[bits] ' + ' '.join(f'{k} {digest(v)}' for k, v in bits.items()))
print(cs.card_line())
'''
KEEP = ('[serve', '[train', '[time', '  median', '  latency', '[bits')


def main(argv):
    if not 2 <= len(argv) <= 3:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    this = argv[2] if len(argv) == 3 else os.path.join(here, '..', '..')
    turns = [('other', argv[1]), ('this', this), ('this', this),
             ('other', argv[1])]
    digests = []
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
        print(f'turn {i + 1} {who:5s} [card] {lines[-1]}', flush=True)
    print('[bits] the same in all four turns: ' + ', '.join(
        f'{k} {"yes" if len({d[k] for d in digests}) == 1 else "NO"}'
        for k in digests[0]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
