"""Kernel K1 on the card against its plain PyTorch version.

Needs a CUDA card (and nvcc); skips without one.  tests/conftest.py
imports JAX, which the card's machine does not have, so run this file
there without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: the float32 bang-bang tail of tests/test_fused_fulltile.py
(mean |du| < 1e-4, under 0.5% of entries off by more than 1e-3): nvcc's
FMA contraction is the only arithmetic difference, and it flips a few
switch steps.  At T = T_MAX the two float32 solves drift further apart
(measured mean |du| 2.8e-4 after 3 unconverged iterations over 256
steps), so there each is held against the float64 plain run instead:
the kernel may sit at most twice as far from it as the plain float32
run does.  This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

import mpc_tpu_torch as mt
from mpc_tpu_torch.models import PendulumDx
from mpc_tpu_torch.ops import fused

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _problem(device, B, T, seed=0):
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1),
                      dtype=torch.float32, device=device)
    dx = PendulumDx(device=device)
    q, p = dx.get_true_obj()
    return x0, dx, mt.QuadCost(torch.diag(q), p)


def _cfg(T, **kw):
    base = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=0.0,
                backprop=False, max_linesearch_iter=5)
    base.update(kw)
    return mt.MPCConfig(**base)


def _assert_tail(u, ref):
    d = (u - ref).abs()
    assert float(d.mean()) < 1e-4
    assert float((d > 1e-3).double().mean()) < 0.005


@pytest.mark.parametrize('T,B,bounded', [(5, 1024, True), (4, 1024, False),
                                         (20, 2050, True),
                                         (fused.T_MAX, 128, True)])
def test_k1_matches_plain(cuda, T, B, bounded):
    x0, dx, cost = _problem(cuda, B, T)
    bounds = dict(u_lower=-2.0, u_upper=2.0) if bounded else {}
    ops = fused.k1_operands(_cfg(T), x0, cost, dx, **bounds)
    xk, uk, sk = fused.fused_ilqr(**ops)
    xp, up, sp = fused.fused_solve_plain(**ops)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if T < fused.T_MAX:
        _assert_tail(uk, up)
    else:
        dx64 = PendulumDx(device=cuda, dtype=torch.float64)
        cost64 = mt.QuadCost(cost.C.double(), cost.c.double())
        _, u64, _ = fused.fused_solve_plain(**fused.k1_operands(
            _cfg(T), x0.double(), cost64, dx64, **bounds))
        k_far = float((uk.double() - u64).abs().mean())
        p_far = float((up.double() - u64).abs().mean())
        assert k_far <= 2 * p_far + 1e-6, (k_far, p_far)
    assert torch.equal(sk[2], sp[2])          # n_iter
    assert torch.equal(sk[3], sp[3])          # n_qp_iter


def test_entry_point_launches_k1_on_the_default_device(cuda):
    T, B = 20, 256
    x0, dx, cost = _problem(cuda, B, T)
    before = fused.launch_counts['fused_ilqr']
    sol = mt.batched_solve(_cfg(T), x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert fused.launch_counts['fused_ilqr'] == before + 1
    assert sol.u.device.type == 'cuda'
    assert float(sol.u.abs().max()) <= 2.0
    with pytest.raises(NotImplementedError, match='float64'):
        mt.batched_solve(_cfg(T), x0.double(), cost, dx)
