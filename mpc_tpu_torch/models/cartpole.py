"""Cartpole dynamics (counterpart of mpc_tpu/models/cartpole.py:19-116,
reference mpc/env_dx/cartpole.py:28-124).

5-state (x, dx, cos th, sin th, dth), 1-control cartpole with a force
clamp of +-100 and Euler integration.  ``forward`` is the reference's
step with atan2; the eager solver linearises it with ``torch.func``.
``soa_step`` is the angle-addition form (mpc_tpu/models/cartpole.py:
76-103) that the dense kernel's model-step configuration runs
(csrc/cartpole.cuh), and ``soa_jacobian`` its hand-written Jacobian,
which takes the place of the TPU kernels' in-kernel ``jax.linearize``
(mpc_tpu/ops/fused.py:788-815, 1307-1340).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.math import hard_clip, rotate_unit
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

    # -- structure-of-arrays form (what the dense kernel runs) ----------
    def soa_params(self):
        return tuple(self.params.unbind())

    def soa_step(self, xs, u, params):
        """One step on component tensors: xs = (x, dx, cos, sin, dth), u
        the bare control.  Angle addition instead of atan2 (the same
        function on the unit circle, ops/math.py:rotate_unit); the angle
        advances with the OLD dth, as the reference's Euler step does."""
        gravity, masscart, masspole, length = params
        total_mass = masspole + masscart
        polemass_length = masspole * length
        u = hard_clip(u, -self.force_mag, self.force_mag)
        x, dx, cos_th, sin_th, dth = xs
        cart_in = (u + polemass_length * dth ** 2 * sin_th) / total_mass
        th_acc = (gravity * sin_th - cos_th * cart_in) / (
            length * (4. / 3. - masspole * cos_th ** 2 / total_mass))
        xacc = cart_in - polemass_length * th_acc * cos_th / total_mass
        x = x + self.dt * dx
        dx = dx + self.dt * xacc
        new_cos, new_sin = rotate_unit(cos_th, sin_th, dth * self.dt)
        dth = dth + self.dt * th_acc
        return x, dx, new_cos, new_sin, dth

    def soa_jacobian(self, xs, u, params):
        """Jacobian of ``soa_step`` as rows of component tensors,
        F[i][j] = d new_x[i] / d (x, u)[j]; the operation order is the one
        csrc/cartpole.cuh follows.

        The control column follows ``hard_clip``: the full derivative for
        -100 <= u <= 100, endpoints included, and 0 strictly outside.  At
        the degenerate point (cos, sin) = (0, 0) the rotation's inputs are
        constants (ops/math.py:rotate_unit), so its derivative there is
        the path through dth alone."""
        gravity, masscart, masspole, length = params
        x, dx, cos_th, sin_th, dth = xs
        dt, fm = self.dt, self.force_mag
        zero = torch.zeros_like(cos_th)
        one = zero + 1.0
        inside = (u >= -fm) & (u <= fm)
        uc = hard_clip(u, -fm, fm)
        total_mass = masspole + masscart
        polemass_length = masspole * length
        cart_in = (uc + polemass_length * dth ** 2 * sin_th) / total_mass
        den = length * (4. / 3. - masspole * cos_th ** 2 / total_mass)
        th_acc = (gravity * sin_th - cos_th * cart_in) / den
        inv_den = 1.0 / den
        # d cart_in / d (sin, dth, u)
        ci_s = polemass_length * dth ** 2 / total_mass
        ci_w = 2. * polemass_length * dth * sin_th / total_mass
        ci_u = torch.where(inside, 1.0 / total_mass + zero, zero)
        # d den / d cos, then d th_acc / d (cos, sin, dth, u)
        den_c = -(length * (masspole * (2. * cos_th) / total_mass))
        ta_c = (-cart_in - th_acc * den_c) * inv_den
        ta_s = (gravity - cos_th * ci_s) * inv_den
        ta_w = -(cos_th * ci_w) * inv_den
        ta_u = -(cos_th * ci_u) * inv_den
        # d xacc / d (cos, sin, dth, u), xacc = cart_in - k th_acc cos
        k = polemass_length / total_mass
        xa_c = -(k * (ta_c * cos_th + th_acc))
        xa_s = ci_s - k * ta_s * cos_th
        xa_w = ci_w - k * ta_w * cos_th
        xa_u = ci_u - k * ta_u * cos_th
        # the rotation by delta = dth dt, renormalised (pendulum.py's
        # soa_jacobian: a00..a11 at fixed delta)
        delta = dth * dt
        cd, sd = torch.cos(delta), torch.sin(delta)
        r2 = cos_th * cos_th + sin_th * sin_th
        deg = r2 < 1e-30
        c = torch.where(deg, one, cos_th)
        s = torch.where(deg, zero, sin_th)
        inv_r = 1.0 / torch.sqrt(torch.where(deg, one, r2))
        p = c * cd - s * sd
        q = s * cd + c * sd
        new_cos = p * inv_r
        new_sin = q * inv_r
        ir3 = inv_r * inv_r * inv_r
        a00 = torch.where(deg, zero, cd * inv_r - p * c * ir3)
        a01 = torch.where(deg, zero, -sd * inv_r - p * s * ir3)
        a10 = torch.where(deg, zero, sd * inv_r - q * c * ir3)
        a11 = torch.where(deg, zero, cd * inv_r - q * s * ir3)
        dtz = dt + zero
        return [
            [one, dtz, zero, zero, zero, zero],
            [zero, one, dt * xa_c, dt * xa_s, dt * xa_w, dt * xa_u],
            [zero, zero, a00, a01, -new_sin * dt, zero],
            [zero, zero, a10, a11, new_cos * dt, zero],
            [zero, zero, dt * ta_c, dt * ta_s, one + dt * ta_w, dt * ta_u],
        ]

    def step_jacobian(self, x, u):
        """F [..., 5, 6] = d soa_step / d (x, u) at x [..., 5], u [..., 1]."""
        rows = self.soa_jacobian(tuple(x.unbind(-1)), u[..., 0],
                                 self.soa_params())
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

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
