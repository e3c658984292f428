"""The phase account of the dense kernels and of K3 on the card: where a
warp's (or a team's) cycles go.

The clocked builds (MPC_PHASE_CLOCKS = 1, csrc/phase_clock.cuh) of
csrc/fused_ilqr_dense.cu and csrc/fused_kkt_bwd_dense.cu have lane 0 of
each warp read ``clock64()`` at the boundaries of the phases of
``fused_dense.PHASES`` and add each phase's cycles into an int64 buffer
[B, phases]; the backward's gradient pass and chunk-order sums are
launched apart and timed by CUDA events.  Only this module launches
those builds: the ops' builds carry none of it, and a clocked launch is
not counted as one of the main path's.

    from mpc_tpu_torch.utils import phase_account
    clocks = phase_account.clocked_forward(ops)[-1]   # ops: k3d_operands
    print(phase_account.format_shares(phase_account.phase_shares(clocks)))

chip_smoke.py's [phases-dense] prints the account at its rows
(``python3 chip_smoke.py --phases-dense`` runs that phase alone).  K3's
clocked build (csrc/fused_ilqr_long.cu) counts its own phases,
``fused.K3_PHASES``, a row an example slot of its launch (``clocked_k3``:
a warp of the MLP configuration, a team of the team kernel, whose lane 0
adds into it in global memory); [phases-nn] and [phases-k3] print them
(``python3 chip_smoke.py --phases-nn``, ``--phases-k3``).
"""

from __future__ import annotations

import torch

from ..ops import fused_dense

PHASES = fused_dense.PHASES


def clocked_forward(ops):
    """The dense forward's clocked build on ``ops`` (the keyword operands
    of ``fused_dense.fused_ilqr_dense``, on the card): (x, u, stats,
    clocks [B, len(PHASES)] int64)."""
    from ..ops import custom
    return custom.k3d_run(*fused_dense.op_args(**ops), clocks=True)


def clocked_backward(o, kw):
    """The dense backward's clocked build on ``o`` and ``kw`` (the
    arguments of ``fused_bwd_dense.fused_kkt_backward_dense``), its
    three launches one after the other: (the five outputs, the chains'
    clocks [B, len(PHASES)] int64, {'chains', 'grads', 'sums': device ms
    between CUDA events})."""
    from ..ops import custom
    names = {1: 'chains', 2: 'grads', 4: 'sums'}
    ms = {}

    def timer(bits, fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms[names[bits]] = start.elapsed_time(end)
    out = custom.k4d_run(o['C'], o['c'], o['F'], o['x_star'], o['u_star'],
                         o['dl_dx'], o['dl_du'], o.get('I_mask'),
                         bool(kw['has_f']), bool(kw['f_shared']), clocks=True,
                         timer=timer)
    return out[:5], out[5], ms


def clocked_k3(ops):
    """K3's clocked build on ``ops`` (the keyword operands of
    ``fused.fused_ilqr_long``, on the card): (x, u, stats, clocks
    [examples, len(fused.K3_PHASES)] int64, a row an example slot of the
    launch, the rows of slots that ran no example zero)."""
    from ..ops import custom, fused
    return custom.k3_run(*fused.k3_args(**ops), clocks=True)


def phase_shares(clocks, phases=PHASES):
    """{phase: (share of the rows' cycles, mean cycles a row)} of a
    clocks buffer [rows, len(phases)] (a row a warp, or a team of K3's
    team kernel; all-zero rows, which ran no example, left out), the
    phases that took none left out; the shares sum to 1."""
    c = torch.as_tensor(clocks).detach().to('cpu', torch.float64)
    if c.dim() != 2 or c.shape[1] != len(phases):
        raise ValueError(f'a clocks buffer is [rows, {len(phases)}]')
    c = c[c.sum(1) > 0]
    per = c.sum(0)
    total = float(per.sum())
    if not total > 0:
        raise ValueError('the clocks buffer holds no cycles')
    return {name: (float(v) / total, float(v) / c.shape[0])
            for name, v in zip(phases, per.tolist()) if v}


def format_shares(shares):
    """One line: each phase's share in percent and its mean cycles a
    warp, largest first."""
    return ', '.join(f'{k} {100 * s:.1f}% ({cyc:.0f})' for k, (s, cyc) in
                     sorted(shares.items(), key=lambda kv: -kv[1][0]))
