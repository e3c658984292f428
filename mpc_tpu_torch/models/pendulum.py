"""Pendulum dynamics (counterpart of mpc_tpu/models/pendulum.py:18-116).

3-state (cos th, sin th, dth), 1-control pendulum with a torque clamp of
+-2 and Euler integration.  ``forward`` is the reference's atan2 step;
``soa_step`` is the step that kernels K1 and K3 run (csrc/pendulum.cuh;
the simple pendulum in the angle-addition form), and ``soa_jacobian``
its hand-written Jacobian, which takes the place of the JAX kernel's
in-kernel ``jax.linearize`` (mpc_tpu/ops/fused.py:788-815).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.math import hard_clip, rotate_unit
from ..utils.device import resolve_device


class PendulumDx(nn.Module):
    # constants (reference pendulum.py:23-27)
    max_torque = 2.0
    dt = 0.05
    n_state = 3
    n_ctrl = 1

    # cost / solver spec carried on the env object
    goal_state = (1., 0., 0.)
    goal_weights = (1., 1., 0.1)
    ctrl_penalty = 0.001
    lower, upper = -2., 2.
    mpc_eps = 1e-3
    linesearch_decay = 0.2
    max_linesearch_iter = 5

    def __init__(self, params=None, simple=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.simple = simple
        if params is None:
            params = [10., 1., 1.] if simple else [10., 1., 1., 0., 0.]
            params = torch.tensor(params, dtype=dtype,
                                  device=resolve_device(device))
        else:
            params = torch.as_tensor(params)
            if device is not None:
                params = params.to(resolve_device(device))
        if params.shape != ((3,) if simple else (5,)):
            raise ValueError(f'PendulumDx params must have shape '
                             f'{(3,) if simple else (5,)}')
        self.register_buffer('params', params)

    def forward(self, x, u):
        """Euler step (reference pendulum.py:49-84) on the last axis:
        x [..., 3], u [..., 1] -> [..., 3]."""
        if self.simple:
            g, m, l = self.params.unbind()
        else:
            g, m, l, d, b = self.params.unbind()
        u = hard_clip(u[..., 0], -self.max_torque, self.max_torque)
        cos_th, sin_th, dth = x.unbind(-1)
        th = torch.atan2(sin_th, cos_th)
        if self.simple:
            newdth = dth + self.dt * (
                -3. * g / (2. * l) * (-sin_th) + 3. * u / (m * (l * l)))
        else:
            sin_th_bias = torch.sin(th + b)
            newdth = dth + self.dt * (
                -3. * g / (2. * l) * (-sin_th_bias)
                + 3. * u / (m * (l * l)) - d * th)
        newth = th + newdth * self.dt
        return torch.stack(
            [torch.cos(newth), torch.sin(newth), newdth], dim=-1)

    # -- structure-of-arrays form (what kernel K1 runs) -----------------
    def soa_params(self):
        return tuple(self.params.unbind())

    def soa_step(self, xs, u, params):
        """One step on component tensors: xs = (cos, sin, dth), u the
        bare control.  The simple pendulum advances by angle addition
        instead of atan2 (same result on the unit circle, see
        ops/math.py:rotate_unit); the damped, biased one needs the angle
        itself (its damping term is d th) and takes the true atan2, where
        the TPU kernel evaluates a degree-9 polynomial of it
        (mpc_tpu/ops/math.py:atan2, ~1e-7 off; ROADMAP section 3)."""
        cos_th, sin_th, dth = xs
        u = hard_clip(u, -self.max_torque, self.max_torque)
        if not self.simple:
            g, m, l, d, b = params
            th = torch.atan2(sin_th, cos_th)
            newdth = dth + self.dt * (
                -3. * g / (2. * l) * (-torch.sin(th + b))
                + 3. * u / (m * (l * l)) - d * th)
            newth = th + newdth * self.dt
            return torch.cos(newth), torch.sin(newth), newdth
        g, m, l = params
        newdth = dth + self.dt * (
            -3. * g / (2. * l) * (-sin_th) + 3. * u / (m * (l * l)))
        new_cos, new_sin = rotate_unit(cos_th, sin_th, newdth * self.dt)
        return new_cos, new_sin, newdth

    def soa_jacobian(self, xs, u, params):
        """Jacobian of ``soa_step`` as rows of component tensors,
        F[i][j] = d new_x[i] / d (x, u)[j].

        The control column follows ``hard_clip``: the full derivative
        for -2 <= u <= 2, endpoints included, and 0 strictly outside.
        At the degenerate point (0, 0) the rotation's inputs (the simple
        pendulum) or the angle (the damped one: atan2's angle 0) are
        constants, so only the path through dth remains."""
        if not self.simple:
            return self._damped_jacobian(xs, u, params)
        g, m, l = params
        cos_th, sin_th, dth = xs
        dt = self.dt
        mt = self.max_torque
        inside = (u >= -mt) & (u <= mt)
        uc = hard_clip(u, -mt, mt)
        newdth = dth + dt * (
            -3. * g / (2. * l) * (-sin_th) + 3. * uc / (m * (l * l)))
        delta = newdth * dt
        cd, sd = torch.cos(delta), torch.sin(delta)
        r2 = cos_th * cos_th + sin_th * sin_th
        deg = r2 < 1e-30
        zero = torch.zeros_like(cos_th)
        one = torch.ones_like(cos_th)
        c = torch.where(deg, one, cos_th)
        s = torch.where(deg, zero, sin_th)
        inv_r = 1.0 / torch.sqrt(torch.where(deg, one, r2))
        p = c * cd - s * sd
        q = s * cd + c * sd
        new_cos = p * inv_r
        new_sin = q * inv_r
        ir3 = inv_r * inv_r * inv_r
        # d newdth / d sin_th and / d u, then d delta = dt * d newdth
        dn_ds = dt * (3. * g / (2. * l)) + zero
        dn_du = torch.where(inside, dt * (3. / (m * (l * l))) + zero, zero)
        dd_ds = dt * dn_ds
        dd_du = dt * dn_du
        # derivative of the renormalised rotation at fixed delta
        a00 = torch.where(deg, zero, cd * inv_r - p * c * ir3)
        a01 = torch.where(deg, zero, -sd * inv_r - p * s * ir3)
        a10 = torch.where(deg, zero, sd * inv_r - q * c * ir3)
        a11 = torch.where(deg, zero, cd * inv_r - q * s * ir3)
        # d new_cos / d delta = -new_sin, d new_sin / d delta = new_cos
        return [
            [a00, a01 - new_sin * dd_ds, -new_sin * dt, -new_sin * dd_du],
            [a10, a11 + new_cos * dd_ds, new_cos * dt, new_cos * dd_du],
            [zero, dn_ds, one, dn_du],
        ]

    def _damped_jacobian(self, xs, u, params):
        """``soa_jacobian`` of the damped, biased step, in the operation
        order of csrc/pendulum.cuh: th = atan2(s, c) has d th / d (c, s) =
        (-s, c) / (c^2 + s^2), taken as 0 at (0, 0), where atan2 gives
        angle 0 whatever the pair's direction."""
        g, m, l, d, b = params
        cos_th, sin_th, dth = xs
        dt = self.dt
        mt = self.max_torque
        zero = torch.zeros_like(cos_th)
        one = zero + 1.0
        inside = (u >= -mt) & (u <= mt)
        uc = hard_clip(u, -mt, mt)
        th = torch.atan2(sin_th, cos_th)
        newdth = dth + dt * (
            -3. * g / (2. * l) * (-torch.sin(th + b))
            + 3. * uc / (m * (l * l)) - d * th)
        newth = th + newdth * dt
        nc, ns = torch.cos(newth), torch.sin(newth)
        r2 = cos_th * cos_th + sin_th * sin_th
        deg = r2 < 1e-30
        inv_r2 = torch.where(deg, zero, 1.0 / torch.where(deg, one, r2))
        th_c = -sin_th * inv_r2
        th_s = cos_th * inv_r2
        # d newdth / d th and / d u; d newth = d th + dt d newdth
        dn_dth = dt * (3. * g / (2. * l) * torch.cos(th + b) - d)
        dn_du = torch.where(inside, dt * (3. / (m * (l * l))) + zero, zero)
        dnt_dth = 1.0 + dt * dn_dth
        dn_c, dn_s = dn_dth * th_c, dn_dth * th_s
        dt_c, dt_s = dnt_dth * th_c, dnt_dth * th_s
        dt_du = dt * dn_du
        return [
            [-ns * dt_c, -ns * dt_s, -ns * dt, -ns * dt_du],
            [nc * dt_c, nc * dt_s, nc * dt, nc * dt_du],
            [dn_c, dn_s, one, dn_du],
        ]

    def step_jacobian(self, x, u):
        """F [..., 3, 4] = d soa_step / d (x, u) at x [..., 3], u [..., 1]."""
        rows = self.soa_jacobian(tuple(x.unbind(-1)), u[..., 0],
                                 self.soa_params())
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    def get_frame(self, x, ax=None):
        """Matplotlib rendering of one state x [3] (mpc_tpu/models/
        pendulum.py:118-134, reference pendulum.py:86-104): the rod from
        the pivot to the bob.  Returns (fig, ax).  matplotlib is imported
        here, at the first frame."""
        import matplotlib.pyplot as plt
        x = torch.as_tensor(x).detach().cpu().reshape(-1)
        if x.numel() != 3:
            raise ValueError('get_frame takes one state of 3 entries')
        l = float(self.params[2])
        cos_th, sin_th = float(x[0]), float(x[1])
        px, py = sin_th * l, cos_th * l
        if ax is None:
            fig, ax = plt.subplots(figsize=(6, 6))
        else:
            fig = ax.get_figure()
        ax.plot((0, px), (0, py), color='k')
        ax.set_xlim((-l * 1.2, l * 1.2))
        ax.set_ylim((-l * 1.2, l * 1.2))
        return fig, ax

    def get_true_obj(self):
        """Diagonal swing-up objective (reference pendulum.py:106-114):
        (q, p) with C = diag(q), c = p."""
        kw = dict(dtype=self.params.dtype, device=self.params.device)
        w = torch.tensor(self.goal_weights, **kw)
        q = torch.cat([w, self.ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        px = -torch.sqrt(w) * torch.tensor(self.goal_state, **kw)
        p = torch.cat([px, torch.zeros(self.n_ctrl, **kw)])
        return q, p
