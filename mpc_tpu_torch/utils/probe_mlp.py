"""A quick look at the dense configuration's MLP build on the card.

    python3 mpc_tpu_torch/utils/probe_mlp.py times [DIR]
    python3 mpc_tpu_torch/utils/probe_mlp.py account B [ROW ...]
    python3 mpc_tpu_torch/utils/probe_mlp.py chunks [ROW ...]

``times``: each of chip_smoke's MLP rows (mlp-deep, mlp-slew,
mlp-multictrl, B=2048) of the checkout at DIR (default: this one) timed
from a CUDA graph, with its build's registers, spill stores and Jacobian
chunk; run it on two checkouts in turns (other, this, this, other) in one
call to compare them.  ``account``: the clocked build
(utils/phase_account.py) at batch B, each phase's cycles an iteration
(every warp's cycles over its iterations, averaged), and those of the
warps that ran the most iterations and of those that ran 3 or fewer apart
(a launch lasts as long as its slowest warps).  ``chunks``: each row with
the Jacobian chunk forced to 1, 2 and 4 steps (``fused_dense.mlp_chunk``
replaced; the kernel takes the chunk the shared memory it is given
holds), then the host's own, at B=128 (a warp a scheduler) and 2048.  It
judges nothing (chip_smoke.py holds the kernel).  Needs a CUDA card.
"""

import os
import sys

ROWS = ('mlp-deep', 'mlp-slew', 'mlp-multictrl')


def _setup(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from mpc_tpu_torch.ops import fused_dense as fd
    return torch, cs, fd, torch.device('cuda'), os.path.basename(root)


def times(root):
    torch, cs, fd, d, name = _setup(root)
    for label in ROWS:
        ops = cs.mlp_operands(torch, d, label)
        fd.fused_ilqr_dense(**ops)
        ms, _ = cs.graph_ms(torch, lambda: fd.fused_ilqr_dense(**ops),
                            reps=3, per_graph=4)
        defines, geo = cs.dense_defines(ops)
        des = cs.design('fused_ilqr_dense', defines, geo)
        print(f'[times] {name} {label}: {ms:.4f} ms; registers '
              f'{des["registers"]}, spill stores {des["spill_store_bytes"]} '
              f'bytes, chunk {geo.get("chunk")}; {cs.card_line()}',
              flush=True)


def _clocked(torch, cs, fd, ops):
    from mpc_tpu_torch.ops import _build
    from mpc_tpu_torch.utils import phase_account as pa
    defines = cs.dense_defines(ops)[0]
    _build.build([('fused_ilqr_dense', dict(defines, MPC_PHASE_CLOCKS=1))])
    pa.clocked_forward(ops)
    _, _, st, clk = pa.clocked_forward(ops)
    return st[2].cpu().double(), clk.cpu().double()


def account(n, rows):
    torch, cs, fd, d, name = _setup('.')
    for label in rows or ROWS:
        ops = cs.mlp_operands(torch, d, label, n=n)
        it, clk = _clocked(torch, cs, fd, ops)
        per = (clk / it[:, None]).mean(0)
        line = ', '.join(f'{p} {float(v):.0f}' for p, v in
                         zip(fd.PHASES, per.tolist()) if v)
        print(f'[account] {label} B={n}: n_iter mean {float(it.mean()):.2f}, '
              f'max {float(it.max()):.0f}; cycles an iteration '
              f'{float(per.sum()):.0f}: {line}', flush=True)
        for what, sel in (('the most iterations', it == it.max()),
                          ('3 or fewer', it <= 3)):
            if bool(sel.any()) and not bool(sel.all()):
                m = clk[sel].mean(0)
                print(f'  warps of {what} ({int(sel.sum())}): cycles a warp '
                      f'{float(m.sum()):.0f}: ' + ', '.join(
                          f'{p} {float(v):.0f}' for p, v in
                          zip(fd.PHASES, m.tolist()) if v), flush=True)
    print(cs.card_line())


def chunks(rows):
    torch, cs, fd, d, name = _setup('.')
    own = fd.mlp_chunk
    for forced in (1, 2, 4, None):
        fd.mlp_chunk = own if forced is None else (lambda *a, **k: forced)
        for label in rows or ROWS:
            for n in (128, 2048):
                ops = cs.mlp_operands(torch, d, label, n=n)
                fd.fused_ilqr_dense(**ops)
                ms, _ = cs.graph_ms(torch, lambda: fd.fused_ilqr_dense(**ops),
                                    reps=3, per_graph=4)
                it, clk = _clocked(torch, cs, fd, ops)
                c = clk.mean(0)
                jac = fd.PHASES.index('jacobians')
                print(f'[chunks] forced {forced or "no"}, {label} B={n}: '
                      f'{ms:.4f} ms; cycles a warp {float(c.sum()):.0f}, '
                      f'Jacobian forward {float(c[jac]):.0f}, reverse '
                      f'{float(c[jac + 1]):.0f}', flush=True)
    fd.mlp_chunk = own
    print(cs.card_line())


def main(argv):
    # run as a script, this directory comes first on the path, where the
    # package's logging.py would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or '.') != here]
    if len(argv) >= 2 and argv[1] == 'times' and len(argv) <= 3:
        times(argv[2] if len(argv) == 3 else os.path.join(
            os.path.dirname(os.path.abspath(__file__)), '..', '..'))
    elif len(argv) >= 3 and argv[1] == 'account':
        account(int(argv[2]), argv[3:])
    elif len(argv) >= 2 and argv[1] == 'chunks':
        chunks(argv[2:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
