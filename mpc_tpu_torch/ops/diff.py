"""Constants of the differentiable fixed-point layer (counterpart of
mpc_tpu/ops/diff.py).

Only the active-set tolerance is here so far.  The per-example fixed
point ``make_lqr_fixed_point`` (mpc_tpu/ops/diff.py:34-138) differentiates
through the eager ``lqr_solve``, so it waits for the eager solver
(ROADMAP queue 1 item 3).  The batched fixed point that the kernel path
uses is ``ops.fused_bwd.make_batched_fixed_point``.
"""

# Active-set identification tolerance at the solution
# (reference mpc/lqr_step.py:325-326).  Interacts with dtype: run f64 for
# gradient-oracle tests; in f32 the clamp produces exact bound values so
# the comparison is still reliable for genuinely active constraints.
ACTIVE_TOL = 1e-8
