"""Elementwise helpers of the pendulum step (counterpart of
mpc_tpu/ops/math.py:39-72), the correctly rounded square root of the
plain versions and the active-set tolerance the fixed points share."""

from __future__ import annotations

import torch

# Active-set identification tolerance at the solution
# (reference mpc/lqr_step.py:325-326).  Interacts with dtype: run f64 for
# gradient-oracle tests; in f32 the clamp produces exact bound values so
# the comparison is still reliable for genuinely active constraints.
ACTIVE_TOL = 1e-8


def sqrt_rn(a):
    """The correctly rounded square root, as CUDA's ``sqrtf`` gives it
    (built without --use_fast_math).  PyTorch's float32 sqrt on the CPU is
    not always (one ulp off in some builds); the float64 root rounded to
    float32 is."""
    if a.dtype == torch.float32:
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def hard_clip(x, lo, hi):
    """Clip whose gradient is 1 on the boundary and 0 strictly outside.

    The JAX package writes this by hand because ``jnp.clip`` splits the
    gradient 0.5/0.5 at a tie.  ``torch.clamp`` already has the wanted
    convention (its backward passes the gradient where lo <= x <= hi), so
    it is used as it is; the tests hold it against the JAX version."""
    return torch.clamp(x, lo, hi)


def rotate_unit(cos_th, sin_th, delta):
    """Advance an angle's (cos, sin) pair by ``delta`` radians.

    Angle addition with a 1/hypot factor that reproduces atan2's implicit
    renormalisation of a drifting pair.  The degenerate point (0, 0)
    follows atan2's convention (angle 0, treated as (1, 0)).  The
    operation order is the one csrc/pendulum.cuh follows."""
    cd, sd = torch.cos(delta), torch.sin(delta)
    r2 = cos_th * cos_th + sin_th * sin_th
    deg = r2 < 1e-30
    c = torch.where(deg, torch.ones_like(cos_th), cos_th)
    s = torch.where(deg, torch.zeros_like(sin_th), sin_th)
    inv_r = 1.0 / torch.sqrt(torch.where(deg, torch.ones_like(r2), r2))
    return (c * cd - s * sd) * inv_r, (s * cd + c * sd) * inv_r
