"""Public types of the PyTorch/CUDA port (counterpart of mpc_tpu/types.py).

Same names, fields and defaults as the JAX package so that a reader can
move between the two: ``QuadCost`` and ``LinDx`` named tuples of
tensors, the ``GradMethods`` enum, the ``Solution`` named tuple and the
frozen ``MPCConfig`` dataclass of the reference's 21 constructor knobs
(mpc/mpc.py:123-144) plus the JAX package's own options.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional

import torch


class QuadCost(NamedTuple):
    """Quadratic cost 0.5 tau^T C tau + c^T tau.

    C: [T, n_tau, n_tau], [T, B, n_tau, n_tau] batched, or [n_tau, n_tau]
    shared over time; c: [T, n_tau], [T, B, n_tau] or [n_tau].  C and c
    are shared or batched independently of each other.
    """
    C: torch.Tensor = None
    c: torch.Tensor = None


class LinDx(NamedTuple):
    """Linear dynamics x' = F @ (x, u) + f.

    F: [T-1, n_state, n_tau] shared or [T-1, B, n_state, n_tau] batched;
    f: [T-1, n_state], [T-1, B, n_state] or None.  F and f are shared or
    batched independently of each other.  With n_state = 3 and n_ctrl = 1
    the forward solve runs in the streaming kernel K3, the backward in K4
    when both are shared, else in K2 (ops/fused.py:routes_long,
    ops/fused_bwd.py:bwd_routes_long); any other LinDx runs on the eager
    solver.
    """
    F: torch.Tensor = None
    f: Optional[torch.Tensor] = None


class GradMethods(enum.Enum):
    """Dynamics-Jacobian method (reference mpc/mpc.py:29-33).  The
    kernel path always uses the model's hand-written step Jacobian; the
    eager solver follows solver.linearize_dynamics."""
    AUTO_DIFF = 1
    FINITE_DIFF = 2
    ANALYTIC = 3
    ANALYTIC_CHECK = 4


class Solution(NamedTuple):
    """Full solver output, batched: x [T, B, n_state], u [T, B, n_ctrl],
    and per-example costs, full_du_norm, n_iter, n_qp_iter, converged and
    alpha, each [B]."""
    x: torch.Tensor
    u: torch.Tensor
    costs: torch.Tensor
    full_du_norm: torch.Tensor
    n_iter: torch.Tensor
    n_qp_iter: torch.Tensor
    converged: torch.Tensor
    # accepted line-search step size of the last executed iteration
    alpha: torch.Tensor
    # [B, lqr_iter, 4] per-iteration history (best cost, full-step norm,
    # step size, PNQP iterations; NaN after an example stopped), recorded
    # by the eager solver at verbose > 0 only
    iter_stats: Any = None


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static solver configuration, same names and defaults as
    mpc_tpu.types.MPCConfig."""
    n_state: int
    n_ctrl: int
    T: int
    lqr_iter: int = 10
    grad_method: GradMethods = GradMethods.ANALYTIC
    delta_u: Optional[float] = None
    verbose: int = 0
    eps: float = 1e-7
    back_eps: float = 1e-7
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    exit_unconverged: bool = True
    detach_unconverged: bool = True
    backprop: bool = True
    slew_rate_penalty: Optional[float] = None
    not_improved_lim: int = 5
    best_cost_eps: float = 1e-4
    pnqp_iter: int = 20
    parallel_linesearch: bool = True
    scan_unroll: int = 4
    # 'auto' runs a problem through the kernels K1/K3 or K3's dense
    # configuration (K2/K4 for its backward) when they take it
    # (ops/fused.py:scope_gap; on the CPU
    # their plain PyTorch versions, which take float64 too, where the
    # card sends float64 to the eager solver) and through the eager
    # solver otherwise; 'never' forces the eager solver; 'always' raises
    # where the kernels do not take the problem (learning.batched_solve)
    use_fused: str = 'auto'
    matmul_precision: str = 'float32'
    parallel_riccati: Any = 'auto'

    def __post_init__(self):
        if self.max_linesearch_iter <= 0:
            raise ValueError('max_linesearch_iter must be positive')
        if self.lqr_iter < 1:
            raise ValueError('lqr_iter must be at least 1')
