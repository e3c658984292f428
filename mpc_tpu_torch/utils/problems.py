"""Problems that the card checks and the CPU tests share, as numpy
arrays made from a seed."""

import numpy as np


def hw_sweep_delta_u(T, B, seed=3):
    """benchmarks/hw_sweep.py:145-170's trust-region problem at T, B: 3
    states and 2 controls, batched C = R R^T + I, c, F (the identity plus
    noise, an input block) and bounds, no f; solved with delta_u 0.3,
    pnqp_iter 20 and lqr_iter 8 there.  Returns (F, C, c, x0, lb, ub)."""
    ns, nc = 3, 2
    nt = ns + nc
    rng = np.random.RandomState(seed)
    R = rng.randn(T, B, nt, nt)
    C = np.einsum('tbij,tbkj->tbik', R, R) + np.eye(nt)
    c = rng.randn(T, B, nt)
    F = np.concatenate([np.tile(np.eye(ns), (T - 1, B, 1, 1))
                        + 0.1 * rng.randn(T - 1, B, ns, ns),
                        0.4 * rng.randn(T - 1, B, ns, nc)], 3)
    x0 = rng.randn(B, ns)
    lb = -np.abs(rng.randn(T, B, nc)) - .1
    ub = np.abs(rng.randn(T, B, nc)) + .1
    return F, C, c, x0, lb, ub


# The learned-dynamics rows of the dense configuration's MLP build, each
# at its source's sizes: (n_state, n_ctrl, hidden widths, activation,
# passthrough, T, MPCConfig fields, box half-width or None).
#   'mlp-slew': benchmarks/configs.py:647-678 (bench_nn_dynamics: one
#     hidden layer of 100 sigmoid units with the passthrough, the
#     pendulum's swing-up cost, its angles, box +-2) under
#     slew_rate_penalty=0.5, so 4 augmented states;
#   'mlp-deep': examples/gym_pendulum_approximate.py:87-109 (2 states,
#     hidden (64, 64), sigmoid, passthrough; C = diag(1, 0.1, 0.001),
#     c = 0; eps 1e-2, lqr_iter 20, 5 step sizes; starts as its validate
#     draws them, :56-63);
#   'mlp-multictrl': the reference's default width (mpc/dynamics.py:9-13)
#     on tests/test_fused_nn.py:280-300's 8 states and 4 controls, T=8,
#     C = I, c = 0, box +-1 (None: no bounds).
MLP_ROWS = {
    'mlp-slew': (3, 1, (100,), 'sigmoid', True, 20,
                 dict(lqr_iter=10, eps=0.0, linesearch_decay=0.2,
                      max_linesearch_iter=3, slew_rate_penalty=0.5), 2.0),
    'mlp-deep': (2, 1, (64, 64), 'sigmoid', True, 20,
                 dict(lqr_iter=20, eps=1e-2, linesearch_decay=0.2,
                      max_linesearch_iter=5), 2.0),
    'mlp-multictrl': (8, 4, (100,), 'sigmoid', True, 8,
                      dict(lqr_iter=10, eps=0.0, linesearch_decay=0.2,
                           max_linesearch_iter=3), 1.0),
}


def mlp_weights(sizes, seed=0):
    """torch.nn.Linear's default init from a numpy seed: for each layer
    W [n_out, n_in] then b [n_out], uniform(-1/sqrt(n_in), 1/sqrt(n_in))
    (mpc_tpu's NNDynamics.init, mpc_tpu/models/dynamics.py:74-87)."""
    rng = np.random.RandomState(seed)
    out = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_out, n_in)),
                    rng.uniform(-bound, bound, n_out)))
    return out


def mlp_row(label, B, T=None, hidden=None, seed=0, bounded=True):
    """A row of MLP_ROWS at batch B (T and the hidden widths may be cut
    for a test): a dict of the model's ``weights`` (mpc_tpu's params
    layout, float64), ``activation``, ``passthrough``, ``n_state``,
    ``n_ctrl``, ``T``, the MPCConfig fields ``cfg`` (without the sizes),
    the starts ``x0`` [B, n_state], the cost ``C`` [ntau, ntau] and ``c``
    [ntau] (shared), the bounds ``u_lower``/``u_upper`` (scalars, or None
    without ``bounded`` or where the row has none) and ``prev_ctrl``
    [B, n_ctrl] under a slew penalty, else None."""
    ns, nc, hid, act, passthrough, T0, cfg, box = MLP_ROWS[label]
    hid = hidden or hid
    T = T or T0
    rng = np.random.RandomState(seed + 4)
    if label == 'mlp-slew':
        th = np.pi * (2 * rng.rand(B) - 1)
        x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
        # the pendulum's swing-up objective (PendulumDx.get_true_obj)
        q = np.array([1.0, 1.0, 0.1, 0.001])
        C, c = np.diag(q), np.concatenate([-np.sqrt(q[:3])
                                           * [1.0, 0.0, 0.0], [0.0]])
        prev = np.random.RandomState(seed + 33).uniform(-1, 1, (B, nc))
    elif label == 'mlp-deep':
        th = np.pi * (2 * rng.rand(B) - 1)
        x0 = np.stack([th, 8.0 * (2 * rng.rand(B) - 1)], 1)
        C, c = np.diag([1.0, 0.1, 0.001]), np.zeros(3)
        prev = None
    else:
        x0 = rng.randn(B, ns)
        C, c = np.eye(ns + nc), np.zeros(ns + nc)
        prev = None
    box = box if bounded else None
    return dict(weights=mlp_weights((ns + nc,) + tuple(hid) + (ns,), seed),
                activation=act, passthrough=passthrough, n_state=ns,
                n_ctrl=nc, T=T, cfg=dict(cfg), x0=x0, C=C, c=c,
                u_lower=None if box is None else -box,
                u_upper=None if box is None else box, prev_ctrl=prev)


# The rows past 8 controls of the dense configuration.  No public
# configuration of the repository has more than 4 controls (neither
# mpc_tpu's tests nor benchmarks/configs.py), so they sit where mpc_tpu's
# own gate admits its kernels at T=20 (ops/fused.py:supports and
# fused_bwd.supports_bwd, forward and backward), on the medium-state rows'
# system (benchmarks/configs.py:107-171: a batch-shared LinDx(F, None)
# with a stable A and a 0.1 N input block, C = diag(1.., 0.1..), c = 0,
# lqr_iter=10, eps=0) at their batches and box:
# (n_state, n_ctrl, B, box half-width or None).  'wide-train' is the
# medium imitation row's learner (config 4's Adam(1e-2) on a learned
# batch-shared diagonal cost) at 4 states and 12 controls.
WIDE_ROWS = {
    'wide-3s9c': (3, 9, 2048, 1.0),
    'wide-4s12c': (4, 12, 2048, 1.0),
    'wide-2s16c': (2, 16, 2048, None),
    'wide-train': (4, 12, 1024, 1.0),
}
WIDE_T = 20


def wide_row(label, B=None, T=None, seed=3):
    """A row of WIDE_ROWS at batch B (T may be cut for a test): a dict of
    ``n_state``, ``n_ctrl``, ``T``, the MPCConfig fields ``cfg`` (without
    the sizes), the shared ``F`` [T-1, n_state, n_tau], ``C`` [n_tau,
    n_tau] and ``c`` [n_tau], the starts ``x0`` [B, n_state] and the
    bounds ``u_lower``/``u_upper`` (scalars, or None without a box)."""
    ns, nc, B0, box = WIDE_ROWS[label]
    B = B or B0
    T = T or WIDE_T
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.01 * rng.randn(ns, ns)
    A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    Bm = 0.1 * rng.randn(ns, nc)
    F = np.tile(np.concatenate([A, Bm], 1)[None], (T - 1, 1, 1))
    C = np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)]))
    return dict(n_state=ns, n_ctrl=nc, T=T,
                cfg=dict(lqr_iter=10, eps=0.0, exit_unconverged=False,
                         detach_unconverged=False),
                F=F, C=C, c=np.zeros(ns + nc), x0=rng.randn(B, ns),
                u_lower=None if box is None else -box,
                u_upper=None if box is None else box)
