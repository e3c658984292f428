"""Cartpole dynamics (counterpart of mpc_tpu/models/cartpole.py:19-116,
reference mpc/env_dx/cartpole.py:28-124).

5-state (x, dx, cos th, sin th, dth), 1-control cartpole with a force
clamp of +-100 and Euler integration.  ``forward`` is the reference's
step with atan2; the eager solver linearises it with ``torch.func``.
The structure-of-arrays step with a hand-written Jacobian, which a
kernel would run, waits for its K1 configuration (ROADMAP queue 2).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.math import hard_clip
from ..utils.device import resolve_device


class CartpoleDx(nn.Module):
    n_state = 5
    n_ctrl = 1
    force_mag = 100.
    dt = 0.05
    lower, upper = -100., 100.

    # 0  1      2        3   4
    # x dx cos(th) sin(th) dth   (reference cartpole.py:53-56)
    goal_state = (0., 0., 1., 0., 0.)
    goal_weights = (0.1, 0.1, 1., 1., 0.1)
    ctrl_penalty = 0.001

    mpc_eps = 1e-4
    linesearch_decay = 0.5
    max_linesearch_iter = 2

    def __init__(self, params=None, device=None, dtype=torch.float32):
        super().__init__()
        if params is None:
            # gravity, masscart, masspole, length (reference cartpole.py:36-38)
            params = torch.tensor([9.8, 1.0, 0.1, 0.5], dtype=dtype,
                                  device=resolve_device(device))
        else:
            params = torch.as_tensor(params)
            if device is not None:
                params = params.to(resolve_device(device))
        if params.shape != (4,):
            raise ValueError('CartpoleDx params must have shape (4,)')
        self.register_buffer('params', params)

    def forward(self, state, u):
        """Euler step (reference cartpole.py:63-96) on the last axis:
        state [..., 5], u [..., 1] -> [..., 5]."""
        gravity, masscart, masspole, length = self.params.unbind()
        total_mass = masspole + masscart
        polemass_length = masspole * length
        u = hard_clip(u[..., 0], -self.force_mag, self.force_mag)
        x, dx, cos_th, sin_th, dth = state.unbind(-1)
        th = torch.atan2(sin_th, cos_th)

        cart_in = (u + polemass_length * dth ** 2 * sin_th) / total_mass
        th_acc = (gravity * sin_th - cos_th * cart_in) / (
            length * (4. / 3. - masspole * cos_th ** 2 / total_mass))
        xacc = cart_in - polemass_length * th_acc * cos_th / total_mass

        x = x + self.dt * dx
        dx = dx + self.dt * xacc
        th = th + self.dt * dth
        dth = dth + self.dt * th_acc
        return torch.stack(
            [x, dx, torch.cos(th), torch.sin(th), dth], dim=-1)

    def get_frame(self, state, ax=None):
        """Matplotlib rendering of one state [5] (mpc_tpu/models/
        cartpole.py:117-134, reference cartpole.py:98-114): the pole from
        the cart.  Returns (fig, ax).  matplotlib is imported here, at the
        first frame."""
        import matplotlib.pyplot as plt
        state = torch.as_tensor(state).detach().cpu().reshape(-1)
        if state.numel() != 5:
            raise ValueError('get_frame takes one state of 5 entries')
        x, cos_th, sin_th = float(state[0]), float(state[2]), float(state[3])
        length = float(self.params[3])
        th_x, th_y = sin_th * length, cos_th * length
        if ax is None:
            fig, ax = plt.subplots(figsize=(6, 6))
        else:
            fig = ax.get_figure()
        ax.plot((x, x + th_x), (0, th_y), color='k')
        ax.set_xlim((-length * 2, length * 2))
        ax.set_ylim((-length * 2, length * 2))
        return fig, ax

    def get_true_obj(self):
        """Diagonal balance objective (reference cartpole.py:116-124):
        (q, p) with C = diag(q), c = p."""
        kw = dict(dtype=self.params.dtype, device=self.params.device)
        w = torch.tensor(self.goal_weights, **kw)
        q = torch.cat([w, self.ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        px = -torch.sqrt(w) * torch.tensor(self.goal_state, **kw)
        p = torch.cat([px, torch.zeros(self.n_ctrl, **kw)])
        return q, p
