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
nothing; host times compare within one call only.
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
print(cs.card_line())
'''
KEEP = ('[serve', '[train', '[time', '  median', '  latency')


def main(argv):
    if not 2 <= len(argv) <= 3:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    this = argv[2] if len(argv) == 3 else os.path.join(here, '..', '..')
    turns = [('other', argv[1]), ('this', this), ('this', this),
             ('other', argv[1])]
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
        print(f'turn {i + 1} {who:5s} [card] {lines[-1]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
