"""K3's team kernel on the card: its layouts against each other, and its
team widths on the pendulum.

    python3 mpc_tpu_torch/utils/probe_k3.py layout
    python3 mpc_tpu_torch/utils/probe_k3.py team
    python3 mpc_tpu_torch/utils/probe_k3.py ring

``layout``: chip_smoke's [phases-k3] rows (the damped pendulum at T=196
and 200, the simple pendulum's QuadCost and cost builds at T=200, the
long LinDx system at T=160) and a LinDx system at T=200 (the long row's
F and C at every step, a zero c), each in ``fused.k3_launch``'s layout
and in the other one, forced by a geometry made for this probe: where
the state is resident, read through the lanes' rings; where it is read
through them, resident without the block's copy of the batch-shared
operands (where that fits); each timed from a CUDA graph, and their
outputs against each other, bitwise.  ``team``: the damped pendulum at T = 196, 200 and 384 and the
cost build at the pendulum T=200 with the pendulum's team capped at 4
lanes and at ``fused.K3_PEND_TEAM`` (8), each timed from a CUDA graph
with its phase account's mean and slowest example (the clocked build,
utils/phase_account.clocked_k3) and its outputs against the other
width's, bitwise.  ``ring``: the damped pendulum, the cost build on the
pendulum and the long LinDx row at T=384 (past residency: the state read
through the lanes' rings) with rings of ``fused.K3_RING`` (8), 4 and 16
steps, each timed from a CUDA graph, and their outputs against the
default ring's, bitwise.  Judges nothing; needs a CUDA card.
"""

import dataclasses
import os
import sys


def _setup():
    root = os.path.abspath(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), '..', '..'))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from mpc_tpu_torch.ops import fused
    return torch, cs, fused, torch.device('cuda')


def _lindx_ops(torch, cs, fused, d, T):
    """The long LinDx row's system and cost at every step of T."""
    import mpc_tpu_torch as mt
    cfg, x0, cost, dx, _ = cs.long_problem(torch, d, cs.LONG_B)
    F = dx.F[:1].expand(T - 1, 3, 4).contiguous()
    C = cost.C[:1].expand(T, 4, 4).contiguous()
    c = torch.zeros(T, 4, dtype=C.dtype, device=d)
    return fused.k3_operands(dataclasses.replace(cfg, T=T), x0,
                             mt.QuadCost(C, c), mt.LinDx(F, None),
                             u_lower=-2.0, u_upper=2.0)


def _build(cs, rows, clocks=(False,)):
    from mpc_tpu_torch.ops import _build as b
    specs = []
    for ops in rows.values():
        for c in clocks:
            s = ('fused_ilqr_long', cs.nn_defines(ops, c)[0])
            if s not in specs:
                specs.append(s)
    b.build(specs)


def layout():
    torch, cs, fused, d = _setup()
    launch = fused.k3_launch

    def other(T, B, n_alpha, nn_hidden=0, clocks=False, **kw):
        """The other layout: the rings where ``k3_launch`` keeps the
        state resident; where it reads the state through the rings, the
        state resident without the operands' copy (where that fits)."""
        g = launch(T, B, n_alpha, nn_hidden, clocks, **kw)
        if nn_hidden:
            return g
        lindx, huber = kw.get('lindx', True), kw.get('huber', False)
        lin = fused._k3_lin_bytes(lindx, huber, g['team'])
        ops = T * 4 * fused._k3_op_row(lindx, huber,
                                       kw.get('has_bounds', True),
                                       kw.get('has_uz', False))
        if g['resident']:
            state, slots = fused.K3_RING * 2 * 16 * 32 * g['warps'], 2
        else:
            state, slots = T * 2 * 16 * g['examples'], -2
            if lin + state > fused.SMEM_LIMIT:
                return g
        staged = g['resident'] and lin + state + ops <= fused.SMEM_LIMIT
        slots += g['slots']
        return dict(g, resident=not g['resident'], staged=staged,
                    slots=slots, smem_bytes=lin + state + (ops if staged
                                                           else 0),
                    workspace_bytes=T * slots * B * 16)

    rows = {label: cs.k3_phase_operands(torch, d, label)
            for label in cs.K3_PHASE_ROWS}
    rows['LinDx T=200'] = _lindx_ops(torch, cs, fused, d, 200)
    _build(cs, rows)
    for label, ops in rows.items():
        out, ms, geo = {}, {}, {}
        for where, fn in (('its layout', launch), ('the other', other)):
            fused.k3_launch = fn
            try:
                geo[where] = cs.nn_defines(ops)[1]
                out[where] = fused.fused_ilqr_long(**ops)
                ms[where], _ = cs.graph_ms(
                    torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                    per_graph=4)
            finally:
                fused.k3_launch = launch
        same = all(torch.equal(a, b) for a, b in
                   zip(out['its layout'], out['the other']))
        g, h = geo['its layout'], geo['the other']
        cs.log(f'[layout] {label}, B={ops["x0"].shape[0]}: its layout '
               f'{ms["its layout"]:.4f} ms (team {g["team"]}, resident '
               f'{g["resident"]}, staged {g["staged"]}, '
               f'{g["smem_bytes"]} bytes a block); the other '
               f'{ms["the other"]:.4f} ms (resident {h["resident"]}, '
               f'staged {h["staged"]}, {h["smem_bytes"]} bytes); the other '
               f'/ its layout {ms["the other"] / ms["its layout"]:.3f}; '
               f'outputs bitwise equal {same}')
    cs.log(cs.card_line())


def team():
    torch, cs, fused, d = _setup()
    from mpc_tpu_torch.utils import phase_account as pa

    def damped(T):
        cfg, x0, cost, dx, bk, _ = cs.soa_problem(
            torch, d, f'damped T={cs.SOA_LONG_T}')
        return fused.k3_operands(dataclasses.replace(cfg, T=T), x0, cost,
                                 dx, **bk)

    rows = {f'damped T={T}': damped(T) for T in (196, 200, 384)}
    rows['cost pendulum T=200'] = cs.k3_phase_operands(
        torch, d, 'cost pendulum T=200')
    widest = fused.K3_PEND_TEAM
    out = {}
    for cap in (4, widest):
        fused.K3_PEND_TEAM = cap
        try:
            _build(cs, rows, clocks=(False, True))
            for label, ops in rows.items():
                out[label, cap] = fused.fused_ilqr_long(**ops)
                ms, _ = cs.graph_ms(
                    torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                    per_graph=4)
                pa.clocked_k3(ops)
                clocks = pa.clocked_k3(ops)[-1]
                per = clocks.sum(1).double()
                per = per[per > 0]
                g = cs.nn_defines(ops)[1]
                cs.log(f'[team] {label}, B={ops["x0"].shape[0]}, at most '
                       f'{cap} lanes: team {g["team"]}, resident '
                       f'{g["resident"]}; {ms:.4f} ms (from a CUDA graph); '
                       f'cycles an example mean {float(per.mean()):.0f}, '
                       f'slowest {float(per.max()):.0f}')
        finally:
            fused.K3_PEND_TEAM = widest
    for label in rows:
        same = all(torch.equal(a, b) for a, b in
                   zip(out[label, 4], out[label, widest]))
        cs.log(f'[team] {label}: outputs of the two widths bitwise equal '
               f'{same}')
    cs.log(cs.card_line())


def ring():
    torch, cs, fused, d = _setup()
    T = 384

    def longer(problem):
        cfg, x0, cost, dx, bk = problem[:5]
        return fused.k3_operands(dataclasses.replace(cfg, T=T), x0, cost,
                                 dx, **bk)

    rows = {'damped': longer(cs.soa_problem(
                torch, d, f'damped T={cs.SOA_LONG_T}')),
            'cost pendulum': longer(cs.huber_problem(
                torch, d, f'pendulum T={cs.SOA_LONG_T}')),
            'long LinDx': _lindx_ops(torch, cs, fused, d, T)}
    default = fused.K3_RING
    out = {}
    for depth in (default, 4, 16):
        fused.K3_RING = depth
        try:
            _build(cs, rows)
            for label, ops in rows.items():
                out[label, depth] = fused.fused_ilqr_long(**ops)
                ms, _ = cs.graph_ms(
                    torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                    per_graph=4)
                g = cs.nn_defines(ops)[1]
                same = all(torch.equal(a, b) for a, b in
                           zip(out[label, depth], out[label, default]))
                cs.log(f'[ring] {label}, B={ops["x0"].shape[0]}, T={T}, a '
                       f'ring of {depth} steps: {ms:.4f} ms (from a CUDA '
                       f'graph); resident {g["resident"]}, staged '
                       f'{g["staged"]}, {g["smem_bytes"]} bytes a block; '
                       f'outputs bitwise the {default}-step ring\'s {same}')
        finally:
            fused.K3_RING = default
    cs.log(cs.card_line())


def main(argv):
    # run as a script, this directory comes first on the path, where the
    # package's logging.py would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or '.') != here]
    modes = {'layout': layout, 'team': team, 'ring': ring}
    if len(argv) == 2 and argv[1] in modes:
        modes[argv[1]]()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
