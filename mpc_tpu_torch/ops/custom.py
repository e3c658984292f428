"""The kernels as ``torch.library`` custom ops.

``mpc_tpu_torch::k1_solve`` (K1, csrc/fused_ilqr.cu),
``::k3_solve`` (K3, csrc/fused_ilqr_long.cu), ``::k3d_solve`` (K3's dense
configuration, csrc/fused_ilqr_dense.cu), ``::k2_backward`` (K2,
csrc/fused_kkt_bwd.cu), ``::k4_backward`` (K4,
csrc/fused_kkt_bwd_long.cu) and ``::k4d_backward`` (K2 and K4's dense
configuration, csrc/fused_kkt_bwd_dense.cu).  Each op has three implementations: the
kernel's launch on a CUDA tensor (the ``ctypes`` call on the tensors'
pointers, on the current stream, raising on an operand the kernel does
not take or on a launch error, and adding one to the kernel's count in
``fused.launch_counts`` or ``fused_bwd.launch_counts``), the kernel's
plain PyTorch version on a CPU tensor, and a fake one that gives the
output shapes, so that ``torch.export`` can trace a solve or a gradient
through the op and keep it as one node of the graph.  The wrappers
(``fused.fused_ilqr``, ``fused_ilqr_long``,
``fused_dense.fused_ilqr_dense``, ``fused_bwd.fused_kkt_backward``,
``fused_kkt_backward_long``, ``fused_bwd_dense.fused_kkt_backward_dense``)
call nothing else, so the live path and an
exported program run the same code.

The ops take the kernels' operands as the plain versions do: a
batch-shared leaf keeps a batch extent of 1 (the launch reads it with
batch stride 0), absent bounds, f and active set are None, the
line-search schedule is a list of floats (the values the kernel gets),
and every scratch array (K3's and K4's workspaces, the partial sums) is
allocated inside the op, so no op writes to its inputs.  The forward ops
take either a QuadCost's C and c or, with C and c None, the pseudo-Huber
cost's parameter vector ``cost_params`` [w, goal, delta] (2 n_tau + 1):
the kernels' cost build (MPC_COST = 1, csrc/cost.cuh).  The forward ops
end with the optional ``uz``, a mask of the controls pinned to zero (1
pinned; [T, 1 or B] for K1 and K3, [T, 1 or B, n_ctrl] for the dense
configuration: each kernel's MPC_HAS_UZ build), and ``delta_u``, the
trust region on a control step (bounds required; the kernels get +inf
where it is None), so that a call or an exported program without them
traces as before.

Importing this module registers the ops and builds nothing: a kernel is
built at its first launch (``_build``).  It imports the kernels'
wrappers and the models whose steps the plain versions run, and none of
the solver (``solver``, ``learning``, ``ops/lqr``, ``ops/pnqp``,
``ops/diff``, ``ops/pscan``): a process that loads an exported program
needs this module and nothing more of the package.
"""

import ctypes
import functools
from typing import Optional

import torch
from torch import Tensor, nn

from ..models.dynamics import NNDynamics
from ..models.pendulum import PendulumDx
from . import fused, fused_bwd, fused_bwd_dense, fused_dense


@functools.lru_cache(maxsize=2)
def _pendulum(n_params=3):
    """The pendulum whose step the plain K1 and K3 run (its parameters
    are the op's ``params``): the simple one for 3 parameters, the
    damped, biased one for 5."""
    return PendulumDx(params=torch.zeros(n_params), simple=n_params == 3)


def _check_pendulum_params(label, params):
    if params.dim() != 1 or params.shape[0] not in (3, 5):
        raise ValueError(f'{label} takes the pendulum\'s params [3] '
                         '(simple) or [5] (damped)')


@functools.lru_cache(maxsize=8)
def _mlp(hidden, activation, passthrough):
    """The one-hidden-layer MLP of K3's MLP configuration, its stream
    step taking the flat weights ``params`` (its own layers hold none)."""
    return NNDynamics([nn.Linear(4, hidden, device='meta'),
                       nn.Linear(hidden, 3, device='meta')],
                      activation, passthrough)


def _check_cost(label, C, c, cost_params, ntau):
    """A QuadCost's C and c, or (C and c None) the pseudo-Huber cost's
    [w, goal, delta] of ``ntau`` components; returns whether it is the
    latter (the kernel's cost build)."""
    if cost_params is None:
        if C is None or c is None:
            raise ValueError(f'{label} takes C and c, or the pseudo-Huber '
                             'cost\'s cost_params')
        return False
    if C is not None or c is not None:
        raise ValueError(f'{label} takes C and c or cost_params, not both')
    if cost_params.shape != (2 * ntau + 1,):
        raise ValueError(f'{label} takes the pseudo-Huber cost\'s [w, goal, '
                         f'delta] of {2 * ntau + 1} values')
    return True


def _mask_and_trust(label, uz, delta_u, shape, has_bounds):
    """The mask ``uz`` of ``shape`` (its batch extent 1 or B) and the
    trust region ``delta_u`` (positive, with bounds) of a forward op; its
    (mask pointer, t stride, batch stride, delta) for the launcher, +inf
    for no trust region."""
    if delta_u is not None and (not has_bounds or not delta_u > 0):
        raise ValueError(f'{label} takes a positive delta_u, and only with '
                         'bounds')
    delta = float('inf') if delta_u is None else float(delta_u)
    if uz is None:
        return None, 0, 0, delta
    T, B = shape[:2]
    if (uz.dim() != len(shape) or uz.shape[0] != T
            or uz.shape[1] not in (1, B) or uz.shape[2:] != shape[2:]):
        raise ValueError(f'{label}\'s u_zero_I mask shape does not match')
    inner = shape[2] if len(shape) == 3 else 1
    return (uz.data_ptr(), uz.shape[1] * inner,
            fused._batch_stride(uz, inner), delta)


def _floats_on_device(label, device, *operands):
    for a in operands:
        if a is not None and (a.dtype != torch.float32 or a.device != device
                              or not a.is_contiguous()):
            raise ValueError(f'{label} takes contiguous float32 operands on '
                             'one device')


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

@torch.library.custom_op('mpc_tpu_torch::k1_solve', mutates_args=(),
                         device_types='cpu')
def k1_solve(params: Tensor, C: Optional[Tensor], c: Optional[Tensor],
             x0: Tensor, u0: Tensor, lb: Optional[Tensor],
             ub: Optional[Tensor], alphas: list[float], lqr_iter: int,
             eps: float, best_cost_eps: float, not_improved_lim: float,
             cost_params: Optional[Tensor] = None,
             uz: Optional[Tensor] = None, delta_u: Optional[float] = None
             ) -> tuple[Tensor, Tensor, Tensor]:
    """K1 on the pendulum: params [3] (simple) or [5] (damped, biased;
    the MPC_DAMPED build); C [T, 1 or B, 4, 4] and c [T, 1 or B, 4], or
    C and c None and ``cost_params`` [9] (the pseudo-Huber cost, the
    MPC_COST build); x0 [B, 3]; u0 [T, B]; lb, ub None or [T, 1 or B];
    uz None or [T, 1 or B] (the MPC_HAS_UZ build); delta_u None or the
    trust region.  Returns x [T, B, 3], u [T, B, 1], stats [6, B]
    (``fused.fused_solve_plain``, which runs here on the CPU)."""
    return fused.fused_solve_plain(
        _pendulum(params.shape[0]), params, C, c, x0, u0, lb, ub,
        alphas=alphas,
        lqr_iter=lqr_iter, eps=eps, best_cost_eps=best_cost_eps,
        not_improved_lim=not_improved_lim, cost_params=cost_params, uz=uz,
        delta_u=delta_u)


@k1_solve.register_fake
def _k1_fake(params, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
             best_cost_eps, not_improved_lim, cost_params=None, uz=None,
             delta_u=None):
    T, B = u0.shape
    return (x0.new_empty((T, B, 3)), x0.new_empty((T, B, 1)),
            x0.new_empty((6, B)))


@k1_solve.register_kernel('cuda')
def _k1_cuda(params, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
             best_cost_eps, not_improved_lim, cost_params=None, uz=None,
             delta_u=None):
    """Launch csrc/fused_ilqr.cu with the geometry of ``fused.k1_launch``
    (the launcher refuses, as an invalid value, an array too large for
    its 32-bit indices)."""
    T, B = u0.shape
    has_bounds = lb is not None
    if has_bounds != (ub is not None):
        raise ValueError('K1 takes both bounds or neither')
    _floats_on_device('K1', x0.device, params, C, c, x0, u0, lb, ub,
                      cost_params, uz)
    _check_pendulum_params('K1', params)
    huber = _check_cost('K1', C, c, cost_params, 4)
    if (not huber and (C.shape[0] != T or C.shape[2:] != (4, 4)
                       or c.shape[0] != T or c.shape[2:] != (4,)
                       or C.shape[1] not in (1, B)
                       or c.shape[1] not in (1, B))) or x0.shape != (B, 3):
        raise ValueError('K1 operand shapes do not match')
    if has_bounds and (lb.shape != ub.shape or lb.shape[0] != T
                       or lb.shape[1] not in (1, B)):
        raise ValueError('K1 bound shapes do not match')
    mask = _mask_and_trust('K1', uz, delta_u, (T, B), has_bounds)
    if not 0 < len(alphas) <= fused.MAX_ALPHA:
        raise ValueError(f'K1 takes 1 to {fused.MAX_ALPHA} step sizes')
    fused._check_float4('K1', C, c)
    geo = fused.k1_launch(T, B, len(alphas))
    if geo['smem_bytes'] > fused.SMEM_LIMIT:
        raise ValueError(f'K1 holds T <= {fused.T_MAX} in shared memory; '
                         f'T={T} goes to K3 (routes_long)')
    fn = fused._kernel_lib(T, has_bounds, params.shape[0] == 5, huber,
                           uz is not None)
    x = torch.empty((T, B, 3), dtype=torch.float32, device=x0.device)
    u = torch.empty((T, B, 1), dtype=torch.float32, device=x0.device)
    stats = torch.empty((6, B), dtype=torch.float32, device=x0.device)
    if B == 0:
        return x, u, stats
    a_host = (ctypes.c_float * len(alphas))(*alphas)
    if has_bounds:
        bounds = (lb.data_ptr(), ub.data_ptr(), B if lb.shape[1] > 1 else 1,
                  fused._batch_stride(lb, 1))
    else:
        bounds = (None, None, 0, 0)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(B, params.data_ptr(),
                 cost_params.data_ptr() if huber else None,
                 *fused._strided(C, 16), *fused._strided(c, 4),
                 x0.data_ptr(), u0.data_ptr(), *bounds, *mask,
                 a_host, len(alphas), int(lqr_iter), float(eps),
                 float(best_cost_eps), float(not_improved_lim),
                 geo['slots'], geo['smem_bytes'],
                 x.data_ptr(), u.data_ptr(), stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'K1 launch failed with cudaError_t {err}')
    fused.launch_counts['fused_ilqr'] += 1
    return x, u, stats


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _k3_model(params, nn_hidden, activation, passthrough):
    """The model of a K3 call: None for LinDx (no params), the MLP of
    ``nn_hidden`` units, or the pendulum."""
    if params is None:
        return None
    if nn_hidden:
        return _mlp(nn_hidden, activation, passthrough)
    return _pendulum(params.shape[0])


@torch.library.custom_op('mpc_tpu_torch::k3_solve', mutates_args=(),
                         device_types='cpu')
def k3_solve(params: Optional[Tensor], F: Optional[Tensor],
             f: Optional[Tensor], C: Optional[Tensor], c: Optional[Tensor],
             x0: Tensor, u0: Tensor, lb: Optional[Tensor],
             ub: Optional[Tensor], alphas: list[float], lqr_iter: int,
             eps: float, best_cost_eps: float, not_improved_lim: float,
             nn_hidden: int, activation: str, passthrough: bool,
             cost_params: Optional[Tensor] = None,
             uz: Optional[Tensor] = None, delta_u: Optional[float] = None
             ) -> tuple[Tensor, Tensor, Tensor]:
    """K3: a LinDx (params None, F [T-1, 1 or B, 3, 4], f None or
    [T-1, 1 or B, 3]), a pendulum (params [3], or [5] for the damped
    one, nn_hidden 0) or
    a one-hidden-layer MLP of ``nn_hidden`` units (params its flat
    weights, ``NNDynamics.kernel_params``; ``activation``,
    ``passthrough``); the other operands (the cost's C and c, or
    ``cost_params``, the mask ``uz`` and ``delta_u``) and the outputs as
    ``k1_solve``'s (``fused.fused_solve_long_plain``, which runs here on
    the CPU)."""
    return fused.fused_solve_long_plain(
        _k3_model(params, nn_hidden, activation, passthrough), params, F, f,
        C, c, x0, u0, lb, ub, alphas=alphas, lqr_iter=lqr_iter, eps=eps,
        best_cost_eps=best_cost_eps, not_improved_lim=not_improved_lim,
        cost_params=cost_params, uz=uz, delta_u=delta_u)


@k3_solve.register_fake
def _k3_fake(params, F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
             best_cost_eps, not_improved_lim, nn_hidden, activation,
             passthrough, cost_params=None, uz=None, delta_u=None):
    T, B = u0.shape
    return (x0.new_empty((T, B, 3)), x0.new_empty((T, B, 1)),
            x0.new_empty((6, B)))


@k3_solve.register_kernel('cuda')
def _k3_cuda(params, F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
             best_cost_eps, not_improved_lim, nn_hidden, activation,
             passthrough, cost_params=None, uz=None, delta_u=None):
    """Allocate the workspace of ``fused.k3_launch`` and launch
    csrc/fused_ilqr_long.cu (the launcher refuses, as an invalid value,
    an array or a workspace too large for its 32-bit indices)."""
    return k3_run(params, F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
                  best_cost_eps, not_improved_lim, nn_hidden, activation,
                  passthrough, cost_params, uz, delta_u)[:3]


def k3_run(params, F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
           best_cost_eps, not_improved_lim, nn_hidden, activation,
           passthrough, cost_params=None, uz=None, delta_u=None,
           clocks=False):
    """The launch of ``k3_solve`` on the card: (x, u, stats, clocks).
    With ``clocks`` the build of the phase account (MPC_PHASE_CLOCKS,
    utils/phase_account.py), its cycles [examples, len(fused.K3_PHASES)]
    of int64 (a row an example slot of the launch: a warp of the MLP
    configuration, a team of the team kernel) returned and its launch not
    counted; else clocks is None."""
    T, B = u0.shape
    lindx = params is None
    nn = not lindx and nn_hidden > 0
    has_bounds = lb is not None
    _floats_on_device('K3', x0.device, params, F, f, C, c, x0, u0, lb, ub,
                      cost_params, uz)
    huber = _check_cost('K3', C, c, cost_params, 4)
    if (not huber and (C.shape[0] != T or C.shape[2:] != (4, 4)
                       or c.shape[0] != T or c.shape[2:] != (4,)
                       or C.shape[1] not in (1, B)
                       or c.shape[1] not in (1, B))) or x0.shape != (B, 3):
        raise ValueError('K3 operand shapes do not match')
    if lindx:
        if (F is None or F.shape[0] != T - 1
                or F.shape[1] not in (1, B) or F.shape[2:] != (3, 4)
                or (f is not None and (f.shape[0] != T - 1
                                       or f.shape[1] not in (1, B)
                                       or f.shape[2:] != (3,)))):
            raise ValueError('K3 LinDx operand shapes do not match')
    elif nn:
        if nn_hidden > fused.K3_NN_MAX_HIDDEN:
            raise ValueError(f'an MLP of {nn_hidden} hidden units exceeds '
                             f'the {fused.K3_NN_MAX_HIDDEN} whose weights '
                             'K3 holds in shared memory')
        if activation not in fused.NN_ACTIVATIONS:
            raise ValueError(f'K3 takes the activations '
                             f'{fused.NN_ACTIVATIONS}, not {activation!r}')
        if (params.shape != (8 * nn_hidden + 3,) or F is not None
                or f is not None):
            raise ValueError('K3 takes an MLP\'s flat weights as params')
    else:
        _check_pendulum_params('K3', params)
        if F is not None or f is not None:
            raise ValueError('K3 pendulum operands do not match')
    if has_bounds and (ub is None or lb.shape != ub.shape
                       or lb.shape[0] != T or lb.shape[1] not in (1, B)):
        raise ValueError('K3 bound shapes do not match')
    mask = _mask_and_trust('K3', uz, delta_u, (T, B), has_bounds)
    if not 0 < len(alphas) <= fused.MAX_ALPHA:
        raise ValueError(f'K3 takes 1 to {fused.MAX_ALPHA} step sizes')
    fused._check_float4('K3', C, c, F)
    defines, geo = k3_build(params, F, f, C, c, x0, u0, lb, ub, alphas,
                            lqr_iter, eps, best_cost_eps, not_improved_lim,
                            nn_hidden, activation, passthrough, cost_params,
                            uz, delta_u, clocks)
    fn = fused._kernel_lib_long(defines)
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x0.device)
    x, u, stats = empty((T, B, 3)), empty((T, B, 1)), empty((6, B))
    hidden = nn_hidden if nn else 0
    cyc = torch.zeros((geo['blocks'] * geo['examples'], len(fused.K3_PHASES)),
                      dtype=torch.int64, device=x0.device) if clocks else None
    if B == 0:
        return x, u, stats, cyc
    ws = fused.k3_workspace(geo, T, B, x0.device)
    a_host = (ctypes.c_float * len(alphas))(*alphas)
    lb_ptr, sbt, sbb = fused._strided(lb, 1)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(B, T, params.data_ptr() if params is not None else None,
                 hidden, int(nn and passthrough),
                 cost_params.data_ptr() if huber else None,
                 *fused._strided(F, 12), *fused._strided(f, 3),
                 *fused._strided(C, 16), *fused._strided(c, 4),
                 x0.data_ptr(), u0.data_ptr(),
                 lb_ptr, ub.data_ptr() if has_bounds else None, sbt, sbb,
                 *mask, a_host, len(alphas), int(lqr_iter), float(eps),
                 float(best_cost_eps), float(not_improved_lim),
                 None if ws is None else ws.data_ptr(), geo['slots'],
                 geo['smem_bytes'],
                 int(geo['slots'] == 0 if nn else geo['resident']),
                 int(geo['slots'] == 0 if nn else geo['staged']),
                 x.data_ptr(), u.data_ptr(),
                 stats.data_ptr(), cyc.data_ptr() if clocks else None,
                 stream)
    if err != 0:
        raise RuntimeError(f'K3 launch failed with cudaError_t {err}')
    if not clocks:
        fused.launch_counts['fused_ilqr_long'] += 1
    return x, u, stats, cyc


def k3_build(params, F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
             best_cost_eps, not_improved_lim, nn_hidden, activation,
             passthrough, cost_params=None, uz=None, delta_u=None,
             clocks=False):
    """(nvcc defines, launch geometry of ``fused.k3_launch``) with which
    ``k3_run`` launches K3 on these arguments (``fused.k3_args`` of the
    keyword operands of ``fused.fused_ilqr_long``)."""
    T, B = u0.shape
    lindx = params is None
    nn = not lindx and nn_hidden > 0
    defines = fused.long_kernel_defines(
        lindx, lb is not None, activation if nn else None,
        damped=not (lindx or nn) and params.shape[0] == 5,
        huber=cost_params is not None, has_uz=uz is not None,
        n_alpha=len(alphas))
    if clocks:
        defines['MPC_PHASE_CLOCKS'] = 1
    return defines, fused.k3_launch(
        T, B, len(alphas), nn_hidden if nn else 0, clocks, lindx=lindx,
        huber=cost_params is not None, has_bounds=lb is not None,
        has_uz=uz is not None)


# ---------------------------------------------------------------------------
# K3's dense configuration
# ---------------------------------------------------------------------------

@torch.library.custom_op('mpc_tpu_torch::k3d_solve', mutates_args=(),
                         device_types='cpu')
def k3d_solve(F: Optional[Tensor], f: Optional[Tensor], C: Optional[Tensor],
              c: Optional[Tensor], x0: Tensor, u0: Tensor,
              lb: Optional[Tensor], ub: Optional[Tensor], alphas: list[float],
              lqr_iter: int, eps: float, best_cost_eps: float,
              not_improved_lim: float, pnqp_iter: int, model: str = '',
              slew: bool = False, params: Optional[Tensor] = None,
              cost_params: Optional[Tensor] = None,
              uz: Optional[Tensor] = None, delta_u: Optional[float] = None,
              nn_sizes: Optional[list[int]] = None, activation: str = '',
              passthrough: bool = False) -> tuple[Tensor, Tensor, Tensor]:
    """K3's dense configuration: a LinDx of any admitted size, F
    [T-1, 1 or B, ns, ntau], f None or [T-1, 1 or B, ns]; or the
    model-step build, F and f None, ``model`` a name of
    ``fused_dense.DENSE_MODELS`` with its ``params``, ``slew`` for its
    passthrough step on (u_{t-1}, x_t); an MLP ('mlp') with its layer
    widths ``nn_sizes`` (n_in, hidden..., n_state of the model itself),
    ``activation`` and ``passthrough`` and its flat weights as
    ``params``; C [T, 1 or B, ntau, ntau], c
    [T, 1 or B, ntau], or C and c None and ``cost_params`` [2 ntau + 1]
    (the pseudo-Huber cost, the MPC_COST build); x0 [B, ns], u0 [T, B,
    nc], lb, ub None or
    [T, 1 or B, nc]; uz None or [T, 1 or B, nc] (the MPC_HAS_UZ build);
    delta_u None or the trust region.  Returns x [T, B, ns], u [T, B, nc],
    stats [6, B] (``fused_dense.fused_solve_dense_plain``, which runs here
    on the CPU)."""
    return fused_dense.fused_solve_dense_plain(
        F, f, C, c, x0, u0, lb, ub, alphas=alphas, lqr_iter=lqr_iter,
        eps=eps, best_cost_eps=best_cost_eps,
        not_improved_lim=not_improved_lim, pnqp_iter=pnqp_iter,
        model=fused_dense.model_of(
            model, slew, u0.shape[2], (nn_sizes, activation, passthrough))
        if model else None,
        params=params, cost_params=cost_params, uz=uz, delta_u=delta_u)


@k3d_solve.register_fake
def _k3d_fake(F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
              best_cost_eps, not_improved_lim, pnqp_iter, model='',
              slew=False, params=None, cost_params=None, uz=None,
              delta_u=None, nn_sizes=None, activation='', passthrough=False):
    T, B, nc = u0.shape
    return (x0.new_empty((T, B, x0.shape[1])), x0.new_empty((T, B, nc)),
            x0.new_empty((6, B)))


def _check_dense_model(model, slew, params, F, f, ns, nc, mlp):
    """The model-step build's operands: a known model at its own sizes
    (plus the controls under ``slew``), its parameter vector (an MLP's
    flat weights, as many as its widths ``mlp[0]`` give, and the MLP
    inside the gate, ``fused_dense.mlp_gap``), no F, f."""
    if model not in fused_dense.DENSE_MODELS:
        raise ValueError(f'the dense kernel has no model {model!r}')
    if model == 'mlp':
        sizes, activation, _ = mlp
        if (sizes is None or len(sizes) < 3 or min(sizes) < 1
                or activation not in fused.NN_ACTIVATIONS):
            raise ValueError('the MLP build takes the layer widths (n_in, '
                             'hidden..., n_state) and an activation of '
                             f'{fused.NN_ACTIVATIONS}')
    m = fused_dense.model_of(model, slew, nc, mlp)
    if (ns, nc) != (m.n_state, m.n_ctrl):
        raise ValueError(f'the {model} model{" under slew" if slew else ""} '
                         f'has {m.n_state} states and {m.n_ctrl} controls, '
                         f'not {ns} and {nc}')
    n_params = (m.inner if slew else m).soa_param_count() if model == 'mlp' \
        else fused_dense.DENSE_MODEL_PARAMS[model]
    if params is None or params.shape != (n_params,):
        raise ValueError(f'the {model} model takes {n_params} params')
    if model == 'mlp':
        gap = fused_dense.mlp_gap(m.inner if slew else m, nc if slew else 0)
        if gap is not None:
            raise ValueError(gap)
    if F is not None or f is not None:
        raise ValueError('the model-step build takes no F or f')


@k3d_solve.register_kernel('cuda')
def _k3d_cuda(F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
              best_cost_eps, not_improved_lim, pnqp_iter, model='',
              slew=False, params=None, cost_params=None, uz=None,
              delta_u=None, nn_sizes=None, activation='', passthrough=False):
    """Allocate the workspace of ``fused_dense.k3d_launch`` and launch
    csrc/fused_ilqr_dense.cu (the launcher refuses, as an invalid value,
    an array or a workspace too large for its 32-bit indices)."""
    return k3d_run(F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
                      best_cost_eps, not_improved_lim, pnqp_iter, model,
                      slew, params, cost_params, uz, delta_u, nn_sizes,
                      activation, passthrough)[:3]


def k3d_run(F, f, C, c, x0, u0, lb, ub, alphas, lqr_iter, eps,
            best_cost_eps, not_improved_lim, pnqp_iter, model='',
            slew=False, params=None, cost_params=None, uz=None,
            delta_u=None, nn_sizes=None, activation='', passthrough=False,
            clocks=False):
    """The launch of ``k3d_solve`` on the card: (x, u, stats, clocks).
    With ``clocks`` the build of the phase account (MPC_PHASE_CLOCKS,
    utils/phase_account.py), its cycles [B, len(fused_dense.PHASES)] of
    int64 returned and its launch not counted; else clocks is None."""
    T, B, nc = u0.shape
    if x0.dim() != 2:
        raise ValueError('the dense kernel takes x0 [B, n_state]')
    ns = x0.shape[1]
    nt = ns + nc
    has_bounds = lb is not None
    _floats_on_device('the dense kernel', x0.device, F, f, C, c, x0, u0, lb,
                      ub, params, cost_params, uz)
    gap = fused.dense_gap(ns, nc)
    if gap is not None:
        raise ValueError(gap)
    mlp = (tuple(nn_sizes), activation, passthrough) \
        if model == 'mlp' and nn_sizes is not None else None
    if model:
        _check_dense_model(model, slew, params, F, f, ns, nc,
                           mlp or (None, activation, passthrough))
    elif (F is None or params is not None or F.shape[0] != T - 1
          or F.shape[1] not in (1, B) or F.shape[2:] != (ns, nt)
          or (f is not None and (f.shape[0] != T - 1
                                 or f.shape[1] not in (1, B)
                                 or f.shape[2:] != (ns,)))):
        raise ValueError('the dense kernel\'s LinDx operands do not match')
    huber = _check_cost('the dense kernel', C, c, cost_params, nt)
    if x0.shape != (B, ns) or (not huber and (
            C.shape[0] != T or C.shape[2:] != (nt, nt)
            or c.shape[0] != T or c.shape[2:] != (nt,)
            or C.shape[1] not in (1, B) or c.shape[1] not in (1, B))):
        raise ValueError('the dense kernel\'s operand shapes do not match')
    if has_bounds and (ub is None or lb.shape != ub.shape
                       or lb.shape[0] != T or lb.shape[1] not in (1, B)
                       or lb.shape[2] != nc):
        raise ValueError('the dense kernel\'s bound shapes do not match')
    mask = _mask_and_trust('the dense kernel', uz, delta_u, (T, B, nc),
                           has_bounds)
    if pnqp_iter < 0:
        raise ValueError('pnqp_iter must not be negative')
    geo = fused_dense.k3d_launch(T, B, ns, nc, len(alphas), bool(model),
                                 mlp[0] if mlp else None, clocks)
    fn = fused_dense.kernel_lib(ns, nc, has_bounds, f is not None,
                                model or None, slew, huber, uz is not None,
                                mlp, clocks, geo['ws_shared'])
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x0.device)
    x, u, stats = empty((T, B, ns)), empty((T, B, nc)), empty((6, B))
    cyc = torch.zeros((B, len(fused_dense.PHASES)), dtype=torch.int64,
                      device=x0.device) if clocks else None
    if B == 0:
        return x, u, stats, cyc
    # none where the model-step build keeps it in shared memory
    ws = empty((geo['workspace_bytes'] // 4,)) if geo['workspace_bytes'] \
        else None
    a_host = (ctypes.c_float * len(alphas))(*alphas)
    sizes = mlp[0] if mlp else ()
    sizes_host = (ctypes.c_int * max(len(sizes), 1))(*sizes)
    lb_ptr, sbt, sbb = fused._strided(lb, nc)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(B, T, params.data_ptr() if model else None,
                 sizes_host, len(sizes), int(bool(mlp and passthrough)),
                 cost_params.data_ptr() if huber else None,
                 *fused._strided(F, ns * nt), *fused._strided(f, ns),
                 *fused._strided(C, nt * nt), *fused._strided(c, nt),
                 x0.data_ptr(), u0.data_ptr(),
                 lb_ptr, ub.data_ptr() if has_bounds else None, sbt, sbb,
                 *mask, a_host, len(alphas), int(lqr_iter), int(pnqp_iter),
                 float(eps), float(best_cost_eps), float(not_improved_lim),
                 None if ws is None else ws.data_ptr(), geo['smem_bytes'],
                 x.data_ptr(),
                 u.data_ptr(), stats.data_ptr(),
                 cyc.data_ptr() if clocks else None, stream)
    if err != 0:
        raise RuntimeError('the dense kernel\'s launch failed with '
                           f'cudaError_t {err}')
    if not clocks:
        fused.launch_counts['fused_ilqr_dense'] += 1
    return x, u, stats, cyc


# ---------------------------------------------------------------------------
# K2 and K4
# ---------------------------------------------------------------------------

def _bwd_fake(C, c, F, x_star, has_f, dyn_reduced):
    """The gradient shapes of K2 (``dyn_reduced`` False) and K4: dC, dc
    summed over the batch for a shared cost, dF, df for shared dynamics
    (K4); df [0] for K4 without f."""
    T, B, ns = x_star.shape
    empty = x_star.new_empty
    cost_shared = fused_bwd._cost_shared(C, c)
    dyn_shared = dyn_reduced and fused_bwd._dyn_shared(F)
    ntau = C.shape[-1]
    df = empty((T - 1, ns) if dyn_shared else (T - 1, B, ns))
    return (empty((B, ns)),
            empty((T, ntau, ntau) if cost_shared else (T, B, ntau, ntau)),
            empty((T, ntau) if cost_shared else (T, B, ntau)),
            empty((T - 1, ns, ntau) if dyn_shared else (T - 1, B, ns, ntau)),
            df if has_f or not dyn_reduced else empty((0,)))


def _bwd_launch(label, fn, geo, C, c, F, x_star, u_star, dl_dx, dl_du,
                I_mask, has_f, dxi, dC, dc, dF, df):
    """Launch K2 or K4 (``fn``) with the geometry ``geo`` on the current
    stream: the workspace of ``geo``, and the per-block partial sums of
    the shared gradients, which the kernel's second pass sums in block
    order."""
    T, B, _ = x_star.shape
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x_star.device)
    # the costates, and behind them the state where it is not resident
    ws = empty((geo['workspace_bytes'] // 4,))
    part_cost = (empty((geo['blocks'], T, 20))
                 if fused_bwd._cost_shared(C, c) else None)
    part_dyn = (empty((geo['blocks'], T - 1, 15))
                if fused_bwd._dyn_shared(F) and T > 1 else None)

    def ptr(a):
        return a.data_ptr() if a is not None else None

    with torch.cuda.device(x_star.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(B, T, *fused_bwd._strided(C, 16), *fused_bwd._strided(c, 4),
                 *fused_bwd._strided(F, 12),
                 dl_dx.data_ptr(), dl_du.data_ptr(), x_star.data_ptr(),
                 u_star.data_ptr(), ptr(I_mask), int(has_f), ptr(ws),
                 int(geo['resident']), geo['smem_bytes'], dxi.data_ptr(),
                 dC.data_ptr(), dc.data_ptr(), dF.data_ptr(), ptr(df),
                 ptr(part_cost), ptr(part_dyn), stream)
    if err != 0:
        raise RuntimeError(f'{label} launch failed with cudaError_t {err}')


@torch.library.custom_op('mpc_tpu_torch::k2_backward', mutates_args=(),
                         device_types='cpu')
def k2_backward(C: Tensor, c: Tensor, F: Tensor, x_star: Tensor,
                u_star: Tensor, dl_dx: Tensor, dl_du: Tensor,
                I_mask: Optional[Tensor], has_f: bool
                ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K2: the KKT backward with per-example F [T-1, B, 3, 4]; operands
    and outputs (dx_init, dC, dc, dF, df) as
    ``fused_bwd.fused_kkt_backward_plain``, which runs here on the
    CPU."""
    return fused_bwd.fused_kkt_backward_plain(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f=has_f)


@k2_backward.register_fake
def _k2_fake(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f):
    return _bwd_fake(C, c, F, x_star, has_f, False)


@k2_backward.register_kernel('cuda')
def _k2_cuda(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f):
    """Launch csrc/fused_kkt_bwd.cu with the geometry of
    ``fused_bwd.k2_launch``; T past ``T_MAX_BWD`` and a shared F are
    refused."""
    T, B, _ = x_star.shape
    fused_bwd._check_operands('K2', C, c, F, x_star, u_star, dl_dx, dl_du,
                              I_mask)
    if T > fused_bwd.T_MAX_BWD or F.shape[1] != B:
        raise ValueError('K2 takes per-example F and T <= '
                         f'{fused_bwd.T_MAX_BWD}')
    cost_shared = fused_bwd._cost_shared(C, c)
    fn = fused_bwd._kernel_lib(T, I_mask is not None, cost_shared)
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x_star.device)
    dxi = empty((B, 3))
    dC = empty((T, 4, 4) if cost_shared else (T, B, 4, 4))
    dc = empty((T, 4) if cost_shared else (T, B, 4))
    dF = empty((T - 1, B, 3, 4))
    df = empty((T - 1, B, 3))
    if B == 0:
        return dxi, dC.zero_(), dc.zero_(), dF, df
    _bwd_launch('K2', fn, fused_bwd.k2_launch(T, B), C, c, F, x_star, u_star,
                dl_dx, dl_du, I_mask, has_f, dxi, dC, dc, dF, df)
    fused_bwd.launch_counts['fused_kkt_bwd'] += 1
    return dxi, dC, dc, dF, df


@torch.library.custom_op('mpc_tpu_torch::k4_backward', mutates_args=(),
                         device_types='cpu')
def k4_backward(C: Tensor, c: Tensor, F: Tensor, x_star: Tensor,
                u_star: Tensor, dl_dx: Tensor, dl_du: Tensor,
                I_mask: Optional[Tensor], has_f: bool
                ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K4: the KKT backward with F [T-1, 1 or B, 3, 4]; operands and
    outputs as ``fused_bwd.fused_kkt_backward_long_plain``, which runs
    here on the CPU, but df [0] (no values) when ``has_f`` is false."""
    dxi, dC, dc, dF, df = fused_bwd.fused_kkt_backward_long_plain(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f=has_f)
    return dxi, dC, dc, dF, df if has_f else x_star.new_empty((0,))


@k4_backward.register_fake
def _k4_fake(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f):
    return _bwd_fake(C, c, F, x_star, has_f, True)


@k4_backward.register_kernel('cuda')
def _k4_cuda(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f):
    """Allocate what ``fused_bwd.k4_launch`` says (the workspace past
    ``K4_T_RESIDENT``) and the scratch of the reductions, and launch
    csrc/fused_kkt_bwd_long.cu."""
    T, B, _ = x_star.shape
    fused_bwd._check_operands('K4', C, c, F, x_star, u_star, dl_dx, dl_du,
                              I_mask)
    cost_shared = fused_bwd._cost_shared(C, c)
    dyn_shared = fused_bwd._dyn_shared(F)
    fn = fused_bwd._kernel_lib_long(cost_shared, dyn_shared)
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x_star.device)
    dxi = empty((B, 3))
    dC = empty((T, 4, 4) if cost_shared else (T, B, 4, 4))
    dc = empty((T, 4) if cost_shared else (T, B, 4))
    dF = empty((T - 1, 3, 4) if dyn_shared else (T - 1, B, 3, 4))
    df = empty((T - 1, 3) if dyn_shared else (T - 1, B, 3)) if has_f \
        else empty((0,))
    if B == 0:
        if cost_shared:
            dC.zero_(), dc.zero_()
        if dyn_shared:
            dF.zero_(), df.zero_()
        return dxi, dC, dc, dF, df
    _bwd_launch('K4', fn, fused_bwd.k4_launch(T, B), C, c, F, x_star,
                u_star, dl_dx, dl_du, I_mask, True, dxi, dC, dc, dF,
                df if has_f else None)
    fused_bwd.launch_counts['fused_kkt_bwd_long'] += 1
    return dxi, dC, dc, dF, df


# ---------------------------------------------------------------------------
# K2 and K4's dense configuration
# ---------------------------------------------------------------------------

def _k4d_reduced(C, c, F, has_f, f_shared):
    """The leaves whose gradients the dense backward sums over the batch:
    each one with a batch extent of 1, and f where ``f_shared``."""
    return tuple(name for name, shared in (
        ('C', C.shape[1] == 1), ('c', c.shape[1] == 1),
        ('F', F.shape[1] == 1), ('f', has_f and f_shared)) if shared)


@torch.library.custom_op('mpc_tpu_torch::k4d_backward', mutates_args=(),
                         device_types='cpu')
def k4d_backward(C: Tensor, c: Tensor, F: Tensor, x_star: Tensor,
                 u_star: Tensor, dl_dx: Tensor, dl_du: Tensor,
                 I_mask: Optional[Tensor], has_f: bool, f_shared: bool
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K2 and K4's dense configuration: the KKT backward at any admitted
    n_state and n_ctrl, C [T, 1 or B, ntau, ntau], c [T, 1 or B, ntau],
    F [T-1, 1 or B, ns, ntau], x_star, dl_dx [T, B, ns], u_star, dl_du
    [T, B, nc], I_mask None or [T, B, nc]; each gradient in its leaf's
    layout, summed over the batch for a shared one (f: ``f_shared``), as
    ``fused_bwd_dense.fused_kkt_backward_dense_plain``, which runs here
    on the CPU, but df [0] (no values) when ``has_f`` is false."""
    dxi, dC, dc, dF, df = fused_bwd_dense.fused_kkt_backward_dense_plain(
        C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f=has_f,
        f_shared=f_shared)
    return dxi, dC, dc, dF, df if has_f else x_star.new_empty((0,))


@k4d_backward.register_fake
def _k4d_fake(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f,
              f_shared):
    T, B, ns = x_star.shape
    nt = C.shape[-1]
    red = _k4d_reduced(C, c, F, has_f, f_shared)
    empty = x_star.new_empty

    def batch(name):
        return () if name in red else (B,)
    return (empty((B, ns)), empty((T, *batch('C'), nt, nt)),
            empty((T, *batch('c'), nt)), empty((T - 1, *batch('F'), ns, nt)),
            empty((T - 1, *batch('f'), ns)) if has_f else empty((0,)))


@k4d_backward.register_kernel('cuda')
def _k4d_cuda(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f,
              f_shared):
    """Allocate the workspace of ``fused_bwd_dense.k4d_launch`` and the
    partial sums of the shared leaves, and launch
    csrc/fused_kkt_bwd_dense.cu (the launcher refuses, as an invalid
    value, an array or a workspace too large for its 32-bit indices)."""
    return k4d_run(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f,
                      f_shared)[:5]


def k4d_run(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f,
            f_shared, clocks=False, timer=None):
    """The launch of ``k4d_backward`` on the card: its five outputs and
    the clocks.  With ``clocks`` the build of the phase account
    (utils/phase_account.py): the chains' cycles [B, len(PHASES)] of
    int64, the launch not counted, and with ``timer`` the chains, the
    gradient pass and the chunk-order sums launched one call each (the
    C entry's launch bits 1, 2, 4; ``timer(bits, fn)`` runs ``fn``, that
    launch, and records its device ms); else clocks is None."""
    T, B, ns = x_star.shape
    if u_star.dim() != 3:
        raise ValueError('the dense backward takes u_star [T, B, n_ctrl]')
    nc = u_star.shape[-1]
    nt = ns + nc
    _floats_on_device('the dense backward', x_star.device, C, c, F, x_star,
                      u_star, dl_dx, dl_du, I_mask)
    gap = fused.dense_gap(ns, nc)
    if gap is not None:
        raise ValueError(gap)
    if (C.shape[0] != T or C.shape[1] not in (1, B)
            or C.shape[2:] != (nt, nt) or c.shape[0] != T
            or c.shape[1] not in (1, B) or c.shape[2:] != (nt,)
            or F.shape[0] != T - 1 or F.shape[1] not in (1, B)
            or F.shape[2:] != (ns, nt) or u_star.shape != (T, B, nc)
            or dl_dx.shape != (T, B, ns) or dl_du.shape != (T, B, nc)
            or (I_mask is not None and I_mask.shape != (T, B, nc))):
        raise ValueError('the dense backward\'s operand shapes do not match')
    geo = fused_bwd_dense.k4d_launch(T, B, ns, nc, clocks)
    fn = fused_bwd_dense.kernel_lib(ns, nc, I_mask is not None, has_f,
                                    clocks)
    outs = _k4d_fake(C, c, F, x_star, u_star, dl_dx, dl_du, I_mask, has_f,
                     f_shared)
    cyc = torch.zeros((B, len(fused_dense.PHASES)), dtype=torch.int64,
                      device=x_star.device) if clocks else None
    if B == 0:
        return (*(o.zero_() for o in outs), cyc)
    dxi, dC, dc, dF, df = outs
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x_star.device)
    ws = empty((geo['workspace_bytes'] // 4,))
    sums = [empty(s) if s is not None else None
            for s in fused_bwd_dense.partial_shapes(
                T, B, ns, nc, _k4d_reduced(C, c, F, has_f, f_shared))]

    def ptr(a):
        return a.data_ptr() if a is not None and a.numel() else None

    with torch.cuda.device(x_star.device):
        stream = torch.cuda.current_stream().cuda_stream

        def launch(bits):
            return fn(B, T, *fused._strided(C, nt * nt),
                      *fused._strided(c, nt),
                      # F has no rows at T = 1; its pointer is then never
                      # read
                      ptr(F) or x_star.data_ptr(), F.shape[1] * ns * nt,
                      fused._batch_stride(F, ns * nt),
                      x_star.data_ptr(), u_star.data_ptr(), dl_dx.data_ptr(),
                      dl_du.data_ptr(), ptr(I_mask), int(has_f and f_shared),
                      ws.data_ptr(), geo['smem_bytes'],
                      geo['grad_smem_bytes'], dxi.data_ptr(), dC.data_ptr(),
                      dc.data_ptr(), ptr(dF), ptr(df), *map(ptr, sums),
                      ptr(cyc), bits, stream)
        errs = []
        for bits in ((1, 2, 4) if clocks and timer else (7,)):
            if timer:
                timer(bits, lambda: errs.append(launch(bits)))
            else:
                errs.append(launch(bits))
    err = next((e for e in errs if e != 0), 0)
    if err != 0:
        raise RuntimeError('the dense backward\'s launch failed with '
                           f'cudaError_t {err}')
    if not clocks:
        fused_bwd.launch_counts['fused_kkt_bwd_dense'] += 1
    return dxi, dC, dc, dF, df, cyc
