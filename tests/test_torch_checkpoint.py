"""Training-state checkpoints of the port (mpc_tpu_torch/utils/
checkpoint.py, learning.TrainState) and the models' frames, on the CPU.

- a TrainState (parameters, an Adam ``state_dict`` after two steps, the
  step count) written and read back bitwise, in ``like``'s structure and
  dtypes, and as nested dicts without ``like`` (as the JAX package's
  orbax checkpoint restores without a template);
- a ``like`` whose structure, dtype or shape differs is refused, and
  ``force=False`` refuses to overwrite;
- training resumed from a checkpoint (3 steps, save, load into a fresh
  optimizer, 3 more) is bitwise the uninterrupted 6 steps;
- ``get_frame`` of the pendulum and the cartpole draws the same line as
  the JAX package's models (matplotlib's Agg backend).
"""

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use('Agg')

from mpc_tpu.models import CartpoleDx as JCartpoleDx  # noqa: E402
from mpc_tpu.models import PendulumDx as JPendulumDx  # noqa: E402

import mpc_tpu_torch as mt  # noqa: E402
from mpc_tpu_torch.models import CartpoleDx, PendulumDx  # noqa: E402
from mpc_tpu_torch.utils import load_checkpoint, save_checkpoint  # noqa: E402

Q = np.array([1., 1., 0.1, 0.001])
P = np.array([-1., 0., 0., 0.])


def _theta():
    return {'q_log': torch.log(torch.tensor(Q) + 0.5).requires_grad_(),
            'p': torch.tensor(P).requires_grad_()}


def _imitation(B=8, T=5):
    rng = np.random.RandomState(3)
    th = np.pi * (2 * rng.rand(B) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1))
    u_expert = torch.tensor(rng.randn(T, B, 1))
    cfg = mt.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=0.0,
                       exit_unconverged=False, detach_unconverged=False,
                       linesearch_decay=0.2, max_linesearch_iter=3)
    dx = PendulumDx(device='cpu', dtype=torch.float64)

    def make_step(opt):
        return mt.make_imitation_train_step(
            cfg, opt, lambda t: mt.QuadCost(torch.diag(torch.exp(
                t['q_log'])), t['p']), lambda t: dx, u_lower=-2.0,
            u_upper=2.0, device='cpu')

    return x0, u_expert, make_step


def _trained(steps):
    x0, u_expert, make_step = _imitation()
    theta = _theta()
    opt = torch.optim.Adam(list(theta.values()), lr=1e-2)
    step = make_step(opt)
    for _ in range(steps):
        step(theta, x0, u_expert)
    return theta, opt


def _state(theta, opt, step):
    return mt.TrainState({k: v.detach() for k, v in theta.items()},
                         opt.state_dict(), step)


def _leaves(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def test_roundtrip_bitwise(tmp_path):
    theta, opt = _trained(2)
    state = _state(theta, opt, 7)
    path = save_checkpoint(str(tmp_path / 'ckpt.pt'), state)
    like = _state(*_trained(1), 0)
    got = load_checkpoint(path, like, device='cpu')
    assert isinstance(got, mt.TrainState) and got.step == 7
    a, b = _leaves(state), _leaves(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y
    plain = load_checkpoint(path, device='cpu')
    assert isinstance(plain, dict) and set(plain) == {'theta', 'opt_state',
                                                      'step'}


def test_mismatched_like_is_refused(tmp_path):
    theta, opt = _trained(1)
    path = save_checkpoint(str(tmp_path / 'ckpt.pt'), _state(theta, opt, 1))
    like = _state(theta, opt, 0)
    for bad in (like._replace(theta={'q_log': theta['q_log'].detach()}),
                like._replace(theta=dict(like.theta,
                                         p=like.theta['p'].float())),
                like._replace(theta=dict(like.theta,
                                         p=like.theta['p'][:3])),
                like._replace(step=0.0)):
        with pytest.raises(ValueError, match='checkpoint'):
            load_checkpoint(path, bad, device='cpu')
    with pytest.raises(FileExistsError):
        save_checkpoint(path, like, force=False)


def test_resumed_training_is_bitwise_uninterrupted(tmp_path):
    x0, u_expert, make_step = _imitation()
    theta_ref, _ = _trained(6)

    theta, opt = _trained(3)
    path = save_checkpoint(str(tmp_path / 'ckpt.pt'), _state(theta, opt, 3))
    state = load_checkpoint(path, device='cpu')
    theta = {k: v.clone().requires_grad_() for k, v in
             state['theta'].items()}
    opt = torch.optim.Adam(list(theta.values()), lr=1e-2)
    opt.load_state_dict(state['opt_state'])
    step = make_step(opt)
    for _ in range(6 - state['step']):
        step(theta, x0, u_expert)
    for k in theta:
        assert torch.equal(theta[k], theta_ref[k])


def _line(fig_ax):
    fig, ax = fig_ax
    (line,) = ax.get_lines()
    data = np.stack(line.get_data())
    matplotlib.pyplot.close(fig)
    return data, ax.get_xlim(), ax.get_ylim()


@pytest.mark.parametrize('model', ['pendulum', 'cartpole'])
def test_get_frame_matches_jax(model):
    if model == 'pendulum':
        x = np.array([np.cos(0.7), np.sin(0.7), 0.3])
        port, ref = PendulumDx(device='cpu'), JPendulumDx()
    else:
        x = np.array([0.4, 0.1, np.cos(2.0), np.sin(2.0), -0.2])
        port, ref = CartpoleDx(device='cpu'), JCartpoleDx()
    got = _line(port.get_frame(torch.tensor(x)))
    want = _line(ref.get_frame(x))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1:], want[1:])
