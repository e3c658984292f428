#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds kernels K1 (mpc_tpu_torch/csrc/fused_ilqr.cu), K2
(mpc_tpu_torch/csrc/fused_kkt_bwd.cu), K3
(mpc_tpu_torch/csrc/fused_ilqr_long.cu), K4
(mpc_tpu_torch/csrc/fused_kkt_bwd_long.cu) and the dense configurations
of K3 and of K2 and K4 (csrc/fused_ilqr_dense.cu,
csrc/fused_kkt_bwd_dense.cu) with nvcc for sm_90a, in parallel, and
drives the port's main paths on the card:

- serving: K1 against its plain PyTorch version, a few batched requests
  of the pendulum swing-up solve (the JAX package's headline workload:
  T=20, lqr_iter=10, B=4096, box bounds +-2, float32) through the
  entry points, the receding-horizon swing-up at B=4096, and K1's time
  against its bound;
- training: K1 against its plain version at config 4's shapes (T=10,
  lqr_iter=5, B=1024 and 8192), K2 against its plain version on the
  same primal (config 4's solution), the imitation train step of config
  4 (B=1024 and 8192, T=10, a learned batch-shared quadratic cost,
  Adam) through make_imitation_train_step, a learner that must cut its
  loss, and K1's and K2's times at config 4 against their bounds;
- long horizons: the long-horizon LQR imitation configuration
  (benchmarks/configs.py:325-372: T=160, B=4096, a batch-shared LinDx
  and a batch-shared QuadCost with a learned c, box bounds +-2,
  lqr_iter=4, float32) at its own sizes: K3 and K4 against their plain
  versions, forward requests through batched_solve, the train step
  through make_imitation_train_step, a learner that must cut its loss,
  and K3's and K4's times against their bounds.

- learned dynamics: the JAX package's bench_nn_dynamics row
  (benchmarks/configs.py:647-678: the reference's default MLP, one
  hidden layer of 100 sigmoid units, B=2048, T=20, lqr_iter=10, box +-2,
  float32) through K3's streamed-weights configuration (MPC_DYN=2,
  csrc/nn.cuh; a warp an example, its hidden units over the lanes with
  their weights in registers, the Jacobian pass a step a lane): K3
  against its plain version, reversed, sliced and B+2 batches, the
  example's slots in the workspace, the cost and mask builds bitwise
  ([compare-nn]), requests through batched_solve ([serve-nn]), K3's time
  against its bound with its geometry ([time-nn]), the phase account of
  its clocked build ([phases-nn]), and gradients of an imitation
  loss to the MLP's weights through K3 and K2 against the eager fixed
  point, with K2 on that path's operands ([grad-nn]).

LinDx problems of other sizes than 3 states and 1 control run in K3's
dense configuration (csrc/fused_ilqr_dense.cu + box_qp.cuh: a warp an
example, the in-kernel projected-Newton box QP for several bounded
controls, the jittered Cholesky for several unbounded ones), at the JAX
package's rows that its kernels serve (benchmarks/configs.py): config
1, TVLQR (3 states, 4 controls, every operand per example, B=128), the
medium-state rows (16 states and 4 controls at B=2048, 24 states and 4
controls at B=1024 and 2048; box +-1, a batch-shared LinDx) and a
5-state, 1-control box LinDx: the kernel against its plain version and
float64, reversed and sliced batches bitwise, TVLQR against the dense
QP ([compare-dense]), requests through batched_solve and MPC, one launch
each ([serve-dense]), and its time from a CUDA graph beside its bound,
the plain version's and its registers ([time-dense]).

The backward of every such LinDx is K2 and K4's dense configuration
(csrc/fused_kkt_bwd_dense.cu: a warp an example for the three chains,
the gradients in a pass parallel over t, shared leaves summed in chunk
order), driven by the medium imitation row (BASELINE.md:483: the medium
rows' system at 20 states and 4 controls, T=20, B=1024, a learned
batch-shared diagonal cost, Adam): the kernel against its plain version
and float64 at 20 and 24 states with shared leaves, 16 states with every
leaf per example and f, TVLQR's size and 5 states, reversed, sliced,
B+2 and repeated launches bitwise ([compare-bwd-dense]); 20 train steps
through make_imitation_train_step, one dense forward and one dense
backward launch a step, the loss falling, TF32 on and off, the step
profiled ([train-dense]); the kernel's time from a CUDA graph beside its
bound, registers and plain version, the forward at the training path's
shape, and a differentiable 24-state solve against the eager fixed point
in the same process ([time-bwd-dense]).

K1 and K3 give each example a team of lanes (ops/fused.py:TEAM): the
compare phases also run what that makes new ([compare-teams]: more step
sizes than lanes, examples of one warp stopping at different
iterations, B = 1 and batches that do not fill a block).

The eager solver (mpc_tpu_torch/solver.py), the route of every problem
the kernels do not take, runs on the card in the [eager-*] phases: the
headline with use_fused='never' against K1 in the same process
([eager-serve]), and the JAX package's configurations that take its jnp
path (benchmarks/configs.py): config 1, TVLQR ([eager-tvlqr]), the
medium-state row with 24 states and 4 controls ([eager-medium]), both
pinned to use_fused='never' and timed beside the dense kernel's route
in the same process, config
3, the cartpole ([eager-cartpole]), and the sequential long-horizon solve
at T=512 ([eager-long]); each float32 against float64 on the card, the
card's float64 against the CPU's, and gradients through the eager fixed
point against K2 ([eager-grad]); the MLP problem through the eager
solver against K3 ([eager-nn]); an affine model and the pseudo-Huber
cost, the card's float64 against the CPU's ([eager-models]).

The nonlinear models in the kernels: config 3, the cartpole
(benchmarks/configs.py:173-202: B=512, T=25, lqr_iter=10, box +-100, 2
step sizes, nothing cut), the cartpole at T=200 and the headline under
slew 0.5 (4 augmented states) in the dense configuration's model-step
build (csrc/soa_model.cuh, cartpole.cuh: the model's step in the
rollouts, its Jacobians in a pass parallel over t), and the damped,
biased pendulum at the headline's sizes in K1 and at T=200 in K3
(MPC_DAMPED): each kernel against its plain version, float64, reversed,
sliced and B+2 batches ([compare-soa]); config 3 through batched_solve
and MPC, a closed loop of 20 steps, and requests of every row, one launch
each ([serve-soa]); the kernels' times from CUDA graphs against their
bounds ([time-soa]); gradients of a config-3 loss through one dense
forward and one dense-backward launch against the eager fixed point on
the same primal, float64 and TF32 ([grad-cartpole]); [eager-cartpole]
then times config 3 on the eager route beside the kernel route.

The pseudo-Huber cost inside the kernels (each kernel's cost build,
MPC_COST = 1, csrc/cost.cuh: the cost quadratised in the Riccati sweep,
the true cost in the line search): the serving row of BASELINE.md:92 and
benchmarks/hw_sweep.py:255-267 (the pendulum, B=2048, T=20, lqr_iter=6,
3 step sizes, w (1, 1, 0.1, 0.1), goal (1, 0, 0, 0), delta 0.9, box +-2)
from hw_sweep's starts and from full +-pi starts in K1, the pendulum at
T=200, the long LinDx system at T=160 and the reference's MLP in K3,
config 3's cartpole and the medium row at 24 states and 4 controls in the
dense configuration, each against its plain version and float64,
reversed, sliced and B+2 batches ([compare-huber]); the serving row
through batched_solve and MPC, one K1 launch a request, beside the eager
route's ms, a closed loop of 20 steps, and requests of every row
([serve-huber]); each row's time from a CUDA graph beside its bound and
the QuadCost build's time at the same shapes ([time-huber]); and the
training row of benchmarks/parity_tpu.py:190-228 (B=256, T=8,
lqr_iter=12): gradients to w, goal, delta and x_init through one K1 and
one K2 launch against the eager fixed point, float64 and central
differences in delta, and a K4 and a dense-backward row ([grad-huber]).

Controls pinned to zero (u_zero_I, each kernel's MPC_HAS_UZ build) and
the trust region delta_u inside the kernels: benchmarks/hw_sweep.py's
'uzero shared', 'uzero batched' (K1, B=2050) and 'delta_u + batched
bounds' (the dense configuration, 3 states and 2 controls) rows, the
batched mask without bounds in K1, tests/test_fused.py's unbounded
3-state, 4-control LinDx with its mask (the masked factor) at B=2050,
the long LinDx system in K3 with a batched mask and delta_u, the MLP row
in K3 with the shared mask, config 3 under delta_u and the headline under
slew 0.5 with the shared mask in the model-step build: each row in a
process of its own under CUDA_LAUNCH_BLOCKING=1, against its plain
version in the float32 tail or by float64, pinned controls 0.0,
reversed, sliced and B+2 batches bitwise ([compare-uz]; the workers are
this script with --uz-worker); requests through batched_solve and MPC
with the mask and with delta_u, one K1 launch each, beside the eager
route's ms, and two requests of every row ([serve-uz]); each row's time
from a CUDA graph beside the same row without mask and delta_u
([time-uz]).

The controller's own surface: make_closed_loop at bench_closed_loop's
sizes (benchmarks/configs.py:375-417; B = 1, 16, 256 and 4096, one K1
launch a step, bitwise the host loop of [swingup], the swing-up through
it; [closed-loop]); a slew-rate penalty on a double integrator, whose
augmented LinDx of three states K3 takes ([slew-k3]: K3 against its
plain version, requests, gradients through the eager fixed point); the
slew-augmented pendulum in a closed loop on the eager route, pinned
there with use_fused='never' ([slew-eager]); bench_long_horizon's two arms, the O(log T) Riccati scan
against the sequential recursion, and the scan in the long
configuration's float64 gradients ([pscan]); MPC(verbose=1) and
ANALYTIC_CHECK on the card ([verbose]).

Learned dynamics at any size in the dense configuration's MLP build
(MPC_MODEL 4, csrc/nn_dense.cuh: the weights in a block's shared memory,
the step a unit a lane, the Jacobian as the reverse product of the layers
in a pass over t before each sweep), at the rows of
mpc_tpu_torch/utils/problems.MLP_ROWS: bench_nn_dynamics under slew 0.5
(4 augmented states), the two-hidden-layer (64, 64) model of
examples/gym_pendulum_approximate.py at B=2048 and B=1, and one hidden
layer of 100 units at 8 states and 4 controls, with a box and without:
each row in a process of its own under CUDA_LAUNCH_BLOCKING=1, then
against its plain version in the float32 tail or by float64, reversed,
sliced and B+2 batches bitwise ([compare-mlp]; the workers are this
script with --mlp-worker); requests through batched_solve and MPC, one
launch each, beside the eager route's ms ([serve-mlp]); each row's time
from a CUDA graph beside its bound, with K3's MLP configuration on
bench_nn_dynamics as the reference point ([time-mlp]); gradients of the
8-state row to the MLP's weights and x_init through one dense forward
and one dense backward against the eager fixed point ([grad-mlp]).

More than 8 controls in both dense kernels (csrc/box_qp_smem.cuh: the
control block's factor, its solves and the box QP across the warp's
lanes), at the rows of mpc_tpu_torch/utils/problems.WIDE_ROWS (the
medium rows' system at 3s9c and 4s12c with box +-1 and at 2s16c
unbounded, T=20, B=2048; the 4s12c learner at B=1024): the gate's
corners (1s9c, 1s31c, 4s28c, 23s9c; with bounds, with f, with the mask;
the backward with and without the active set) built and launched a
process each under CUDA_LAUNCH_BLOCKING=1 ([build]; --corner-worker);
the rows, a batched mask and delta_u at 3s9c and an MLP at 2s9c against
the plain version in the float32 tail or by float64 with reversed,
sliced and B+2 batches bitwise ([compare-dense]; --wide-worker);
requests through batched_solve and MPC, one launch each, beside the
eager route ([serve-dense]); each row's time from a CUDA graph beside
its bound ([time-dense]); the backward at 4s12c same-primal against its
plain version ([compare-bwd-dense]) and timed ([time-bwd-dense]); the
learner's 20 steps, one dense forward and one dense backward a step, the
loss falling ([train-dense]).

The phase account of both dense kernels ([phases-dense]; alone:
python3 chip_smoke.py --phases-dense [ROW ...]): each kernel's clocked
build (MPC_PHASE_CLOCKS, csrc/phase_clock.cuh) at the forward's 24s4c,
5s1c, wide-4s12c, wide-2s16c (B=2048), TVLQR (B=128), the model-step
build's config 3 and cartpole at T=200 (B=512) and slew-augmented
headline (B=4096), mlp-deep, mlp-slew and mlp-multictrl (B=2048) and the
backward's 20s4c and 4s12c (B=1024): each phase's share
of a warp's cycles (the Jacobian pass, staging a step's operands, W, Q,
the control solve's factor, QP trips and gains, the cost-to-go, the
trial rollouts), the backward's gradient pass and chunk-order sums by
CUDA events.

The kernels are torch.library ops (mpc_tpu_torch/ops/custom.py), so the
port's artifacts and scale-out run on the card too, each against the live
path: the headline exported with torch.export and answered by a fresh
process that imports torch and the ops only ([export-serve], bitwise, one
K1 launch a request, exported against live host to host); one artifact
padded to B=4096 at b = 1, 1000, 4096 ([export-flex]); an artifact
traced on CPU tensors and moved to the card ([export-host]); the long
configuration's request through K3 ([export-long]); gradient programs
through K1 and K2 (config 4) and through K3 and K4 (the long
configuration's dL/dc) ([export-grad]); the closed loop at B=256, 10
steps ([export-loop]); solve_sharded of the headline over four shards on
the one card, bitwise ([sharded]); config 4's sharded train step against
the unsharded one ([train-sharded]) and over two gloo processes on the
card ([pod]); a run resumed from a checkpoint in a fresh process,
bitwise ([checkpoint]).  The worker processes are this script with
--serve-worker, --pod-worker, --resume-worker, --uz-worker,
--mlp-worker, --wide-worker, --corner-worker or --wide-train-worker.

It prints one JSON line of kernel numbers, one of the artifact and
scale-out times, one of the eager phases, the card's name and power
limit, and a last JSON line with the device.  Every phase raises on
failure; the script then exits nonzero.  It exits nonzero without a
result when no card is visible or when the package is not beside it.
It imports nothing of JAX or mpc_tpu.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the headline configuration (bench.py:47-69)
B, T = 4096, 20
HEADLINE = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=10, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=5)
# K1 against its plain version in float32: the bang-bang tail of
# tests/test_fused_fulltile.py (a few switch steps flip between two
# float32 solves; FMA contraction in nvcc is the only arithmetic
# difference)
TAIL_MEAN, TAIL_ENTRY, TAIL_SHARE = 1e-4, 1e-3, 0.005
# swing-up success share at B=4096, from a CPU rehearsal of the same
# seed and loop at B=64 (64 of 64 within 0.1 of cos th = 1) less a margin
# for float32 on the card (PERF.md)
SWINGUP_MIN_SHARE = 0.95
# config 4, imitation learning (benchmarks/configs.py:257-322): the
# differentiable solve of the pendulum at T=10 through K1 and K2
TRAIN_T = 10
TRAIN = dict(n_state=3, n_ctrl=1, T=TRAIN_T, lqr_iter=5, eps=0.0,
             exit_unconverged=False, detach_unconverged=False,
             backprop=True, linesearch_decay=0.2, max_linesearch_iter=3)
# K2 against its plain version in float32 on the same primal: largest
# |difference| over each gradient's largest entry.  K2 has no branch
# that float rounding can flip (the active set is an input), so the
# only difference is nvcc's FMA contraction; the JAX package holds its
# own kernel to 5e-4 (tests/test_fused_bwd.py).
BWD_TOL = 1e-4
# the learner of examples/pod_imitation.py:84-104 at T=10 must bring its
# loss below this share of its first value within LEARN_STEPS steps;
# from a CPU rehearsal of the same seed and loop at B=64 on the plain
# versions (best / first 0.156, PERF.md), with a margin of about 2x
LEARN_STEPS = 30
LEARN_MAX_RATIO = 0.3
# the long-horizon imitation configuration (benchmarks/configs.py:325-372)
LONG_T, LONG_B = 160, 4096
LONG = dict(n_state=3, n_ctrl=1, T=LONG_T, lqr_iter=4, eps=0.0,
            exit_unconverged=False, detach_unconverged=False,
            backprop=True, linesearch_decay=0.2, max_linesearch_iter=3)
# K3 against its plain version in float32 on that configuration.  After
# its 4 iterations the solve is still moving (median full-step norm 17
# in a float64 run: the active set of the box keeps changing until
# about iteration 12), and the cost is nearly flat in u (R = 0.01,
# B = 0.01), so where a trial cost ties the current one to round-off two
# float32 solves take different step sizes and their controls part, as
# the pendulum's do.  Held like the pendulum's tail, at this
# configuration's own measured level (PERF.md), and against a float64
# plain run.
LONG_TAIL_MEAN, LONG_TAIL_SHARE = 1e-4, 0.005
# the pendulum past K1's horizon limit, as
# tests/test_fused_stream.py:test_streamed_cost_pendulum_matches_jnp
# runs the streaming kernel: 2 iterations of 2 step sizes
PEND_LONG_T, PEND_LONG_B = 384, 1024
# the long learner: the expert solves with c = LEARN_LONG_C at every
# step, the learner starts from c = 0; 16 iterations converge the solve,
# so the fixed point's gradient is the loss's.  From a CPU rehearsal of
# the same seed and loop at B=16 on the plain versions (PERF.md)
LEARN_LONG_C = (0.5, -0.5, 0.2, 0.02)
LEARN_LONG_ITER, LEARN_LONG_STEPS, LEARN_LONG_MAX_RATIO = 16, 20, 0.5
# H100 SXM peaks (NVIDIA datasheet): float32 outside the tensor cores,
# and HBM bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


# (time, phase tag) of each line logged, for [timeline]
_LOGGED = [(time.perf_counter(), None, '')]


def log(*a):
    print(*a, flush=True)
    text = ' '.join(map(str, a))
    end = text.find(']')
    _LOGGED.append((time.perf_counter(),
                    text[:end + 1] if text.startswith('[') and 0 < end < 40
                    else None, text[:60]))


def timeline():
    """Seconds by phase tag: each gap between two logged lines goes to the
    tag of the line that ends it, or to the last tag before an untagged
    (indented) line.  Sorted, the largest first."""
    secs, tag = {}, '[start]'
    for (t0, *_), (t1, t, _) in zip(_LOGGED, _LOGGED[1:]):
        tag = t or tag
        secs[tag] = secs.get(tag, 0.0) + t1 - t0
    return sorted(secs.items(), key=lambda kv: -kv[1])


def longest_waits(k=12):
    """The ``k`` longest gaps between two logged lines: (seconds, the
    start of the line that ended the gap)."""
    return sorted(((b[0] - a[0], b[2]) for a, b in zip(_LOGGED, _LOGGED[1:])),
                  reverse=True)[:k]


def card_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def x0_batch(n, seed, torch, device):
    import numpy as np
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    x = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)
    return torch.tensor(x, dtype=torch.float32, device=device)


def problem(torch, device, dtype=None):
    from mpc_tpu_torch import QuadCost
    from mpc_tpu_torch.models import PendulumDx
    dtype = dtype or torch.float32
    dx = PendulumDx(device=device, dtype=dtype)
    q, p = dx.get_true_obj()
    return dx, QuadCost(torch.diag(q), p)


def tail(u, ref):
    d = (u - ref).abs()
    return float(d.mean()), float((d > TAIL_ENTRY).double().mean()), \
        float(d.max())


def check_tail(what, u, ref, limits=(TAIL_MEAN, TAIL_SHARE)):
    """Log the tail of |u - ref| and hold it to ``limits`` (mean, share
    above TAIL_ENTRY); None only logs it."""
    mean, share, mx = tail(u, ref)
    log(f'  {what}: mean |du| {mean:.3e}, share |du|>1e-3 {share:.5f}, '
        f'max |du| {mx:.3e}')
    if limits and not (mean < limits[0] and share < limits[1]):
        raise AssertionError(f'{what}: outside the float32 tail (mean |du| '
                             f'< {limits[0]}, share < {limits[1]})')
    return mx


DENSE_KERNELS = ('fused_ilqr_dense', 'fused_kkt_bwd_dense')
# nvcc processes at once beside the phases before [compare-dense]: all 8
# cores building (at the lowest priority) slowed those phases by a third
# on the H100's host; four build the rest within them
BACKGROUND_BUILDS = 4


def phase_build(background=False):
    """Build every kernel the phases run, one nvcc for each build, all
    started together, and report registers and spills.  Where
    ``background``, only the builds of the phases before [compare-dense]
    are waited for here: the others run at the lowest priority beside
    those phases, and ``phase_build_report`` waits for them and then
    reports."""
    from mpc_tpu_torch.ops import (_build, fused, fused_bwd, fused_bwd_dense,
                                   fused_dense)
    specs = [('fused_ilqr', fused.kernel_defines(T, True)),
             ('fused_ilqr', fused.kernel_defines(TRAIN_T, True))]
    specs += [('fused_kkt_bwd',
               fused_bwd.kernel_defines(TRAIN_T, has_I, cost_shared))
              for cost_shared in (True, False) for has_I in (True, False)]
    # K3 on LinDx and on the pendulum ([compare-teams]' 10 step sizes)
    specs += [('fused_ilqr_long', fused.long_kernel_defines(
        lindx, True, n_alpha=1 if lindx else TEAMS_K3_ALPHAS))
              for lindx in (True, False)]
    # K3's MLP build: sigmoid with bounds, relu without, and the clocked
    # builds of [phases-nn]; K2 at the MLP path's T
    specs += [('fused_ilqr_long', fused.long_kernel_defines(False, True,
                                                            'sigmoid')),
              ('fused_ilqr_long', fused.long_kernel_defines(False, False,
                                                            'relu')),
              ('fused_kkt_bwd', fused_bwd.kernel_defines(NN_T, True, True))]
    specs += [s for s in phases_nn_build_specs() if s not in specs]
    specs += [('fused_kkt_bwd_long',
               fused_bwd.long_kernel_defines(cost_shared, dyn_shared))
              for cost_shared in (True, False) for dyn_shared in (True, False)]
    # the dense configuration at each size the dense phases run, and at
    # the gate's corners (n_state + n_ctrl = 32; n_ctrl = 8), whose
    # registers and spills below are the gate's evidence
    specs += [('fused_ilqr_dense', fused_dense.dense_kernel_defines(
        ns, nc, label != 'tvlqr', label == 'tvlqr'))
              for label, ns, nc in sorted({r[:3] for r in DENSE_ROWS})]
    specs += [('fused_ilqr_dense', fused_dense.dense_kernel_defines(
        ns, nc, True, False)) for ns, nc in ((28, 4), (24, 8))]
    # K2 and K4's dense configuration at each row of [compare-bwd-dense]
    # (the medium imitation row among them) and at the gate's corners
    specs += [('fused_kkt_bwd_dense', fused_bwd_dense.bwd_dense_kernel_defines(
        ns, nc, *bwd_dense_case(label)))
        for label, ns, nc in sorted({r[:3] for r in BWD_DENSE_ROWS})]
    specs += [('fused_kkt_bwd_dense', fused_bwd_dense.bwd_dense_kernel_defines(
        ns, nc, True, False)) for ns, nc in ((28, 4), (24, 8))]
    # the nonlinear models: the dense configuration's model-step build for
    # the cartpole and the slew-augmented pendulums and cartpole (each in
    # the workspace layout of its SOA_ROWS rows, the others' in global
    # memory), K1 and K3 on the damped pendulum
    specs += soa_build_specs()
    specs += [('fused_ilqr', fused.kernel_defines(T, True, damped=True)),
              ('fused_ilqr_long', fused.long_kernel_defines(
                  False, True, damped=True,
                  n_alpha=HEADLINE['max_linesearch_iter']))]
    # the pseudo-Huber cost: each kernel's cost build (MPC_COST = 1) at the
    # rows of [compare-huber] and [grad-huber], and K2 on per-example C
    specs += [('fused_ilqr', fused.kernel_defines(t_, True, huber=True))
              for t_ in (T, HUBER_GRAD['T'])]
    specs += [('fused_ilqr_long', fused.long_kernel_defines(
        lindx, True, act, huber=True)) for lindx, act in (
            (False, None), (True, None), (False, 'sigmoid'))]
    specs += [('fused_ilqr_dense', fused_dense.dense_kernel_defines(
        5, 1, True, False, 'cartpole', huber=True,
        ws_shared=fused_dense.k3d_launch(CARTPOLE['T'], CARTPOLE_B, 5, 1, 1,
                                         True)['ws_shared'])),
              ('fused_ilqr_dense', fused_dense.dense_kernel_defines(
                  24, 4, True, False, huber=True)),
              ('fused_kkt_bwd', fused_bwd.kernel_defines(HUBER_GRAD['T'],
                                                         True, False))]
    # u_zero_I and delta_u: each UZ_ROWS row's mask build (MPC_HAS_UZ = 1)
    # and its build without the mask, the [time-uz] baseline
    specs += [s for s in uz_build_specs() if s not in specs]
    # the dense configuration's MLP build at each MLP_CASES row
    specs += [s for s in mlp_build_specs() if s not in specs]
    # past 8 controls: each WIDE_CASES case's build, the wide backward and
    # the gate's corners (1s9c, 1s31c, 4s28c, 23s9c), whose registers and
    # spills below stand for the control solve across the warp's lanes
    specs += [s for s in wide_build_specs() if s not in specs]
    # the phase accounts' clocked builds ([phases-dense], [phases-k3])
    specs += [s for s in phases_build_specs() if s not in specs]
    specs += [s for s in phases_k3_build_specs() if s not in specs]
    t0 = time.perf_counter()
    if not background:
        return phase_build_report((specs, _build.start(specs), t0))
    # the phases before [compare-dense] run only the builds listed before
    # the first dense one
    cut = next(i for i, s in enumerate(specs) if s[0] in DENSE_KERNELS)
    _build.build(specs[:cut])
    log(f'[build] nvcc {" ".join(_build.NVCC_FLAGS)}: {cut} builds of K1-K4 '
        f'for the phases before [compare-dense] '
        f'({time.perf_counter() - t0:.1f} s); the other {len(specs) - cut} '
        f'go on beside those phases, {BACKGROUND_BUILDS} at a time')
    return specs, _build.start(specs[cut:], niceness=19,
                               jobs=BACKGROUND_BUILDS), t0


def phase_build_report(started):
    """Wait for ``phase_build``'s builds, then report each library's
    registers, spills and stack and the launch geometry of each shape
    the phases drive."""
    from mpc_tpu_torch.ops import (_build, fused, fused_bwd, fused_bwd_dense,
                                   fused_dense)
    specs, builds, t0 = started
    t1 = time.perf_counter()
    _build.finish(builds)
    log(f'[build] nvcc {" ".join(_build.NVCC_FLAGS)}: {len(specs)} builds, '
        f'{time.perf_counter() - t0:.1f} s from the first; waited '
        f'{time.perf_counter() - t1:.1f} s here')
    paths = [_build._library_path(n, d) for n, d in specs]
    for (name, defines), path in zip(specs, paths):
        log(f'  {os.path.relpath(path, HERE)} {defines}')
        for line in _build.ptxas_report(name, defines).splitlines():
            if 'registers' in line or 'spill' in line or 'stack' in line:
                log(f'  ptxas: {line.strip()}')
    for what, geo in (
            ('K1 headline', fused.k1_launch(T, B, 5)),
            ('K1 config 4, B=1024', fused.k1_launch(TRAIN_T, 1024, 3)),
            ('K3 long', fused.k3_launch(LONG_T, LONG_B, 3)),
            (f'K3 MLP, H={NN_H}', fused.k3_launch(NN_T, NN_B, 3, NN_H)),
            ('K2 config 4, B=1024', fused_bwd.k2_launch(TRAIN_T, 1024)),
            ('K2 config 4, B=8192', fused_bwd.k2_launch(TRAIN_T, 8192)),
            ('K4 long', fused_bwd.k4_launch(LONG_T, LONG_B)),
            (f'K4 past K4_T_RESIDENT = {fused_bwd.K4_T_RESIDENT}',
             fused_bwd.k4_launch(fused_bwd.K4_T_RESIDENT + 1, 2050)),
            *((f'dense {label} {ns}s{nc}c, B={n}', fused_dense.k3d_launch(
                TVLQR['T'] if label == 'tvlqr' else MEDIUM['T'], n, ns, nc,
                10)) for label, ns, nc, n in DENSE_ROWS),
            *((f'dense backward {label} {ns}s{nc}c, B={n}',
               fused_bwd_dense.k4d_launch(
                   TVLQR['T'] if label == 'tvlqr' else MEDIUM['T'], n, ns,
                   nc)) for label, ns, nc, n in BWD_DENSE_ROWS),
            *((f'SoA {label} ({kernel}), B={n}, T={T_}',
               fused_dense.k3d_launch(T_, n, 4 if model == 'slew' else 5, 1,
                                      CARTPOLE['max_linesearch_iter'] if
                                      model == 'cartpole' else 5, True)
               if kernel == 'dense' else fused.k1_launch(T_, n, 5)
               if kernel == 'K1' else fused.k3_launch(T_, n, 5, lindx=False))
              for label, model, T_, n, kernel in SOA_ROWS)):
        log(f'  launch, {what}: {geo}')
    # the model-step build at each of its rows: registers, spills, the
    # workspace's layout, blocks an SM and waves at the row's batch
    import torch
    for label, _, T_, n, kernel in SOA_ROWS:
        if kernel == 'dense':
            defines, geo = dense_defines(soa_operands(
                torch, torch.device('cpu'), label, n=1)[0], n)
            log(f'  model-step build, {label}, B={n}, T={T_}: '
                + residency(design('fused_ilqr_dense', defines, geo), geo))


def design(name, defines, geo):
    """What a kernel's design is, for its entry of the kernels line: the
    launch geometry and the registers ptxas reports (the most of the
    library's kernels)."""
    import re
    from mpc_tpu_torch.ops import _build
    regs = re.findall(r'Used (\d+) registers',
                      _build.ptxas_report(name, defines))
    spills = re.findall(r'(\d+) bytes spill stores',
                        _build.ptxas_report(name, defines))
    return {'team_lanes': geo['team'], 'warps_a_block': geo['warps'],
            'examples_a_block': geo['examples'], 'blocks': geo['blocks'],
            'shared_memory_bytes': geo['smem_bytes'],
            'workspace_bytes': geo.get('workspace_bytes', 0),
            'registers': max(map(int, regs)),
            'spill_store_bytes': max(map(int, spills))}


def residency(des, geo):
    """A dense build's registers, spills, workspace layout, blocks an SM
    (by registers and by shared memory) and waves of its launch, from its
    ``design`` entry and launch geometry."""
    from mpc_tpu_torch.ops import fused_dense as fd
    by_regs = fd.blocks_by_registers(des['registers'])
    by_smem = fd.blocks_an_sm(geo['smem_bytes'])
    return (f'registers {des["registers"]}, spill stores '
            f'{des["spill_store_bytes"]} bytes; workspace '
            f'{"shared" if geo.get("ws_shared") else "global"}, '
            f'{geo["smem_bytes"]} bytes of shared memory a block; blocks an '
            f'SM {by_regs} by registers, {by_smem} by shared memory; '
            f'{geo["blocks"]} blocks, '
            f'{fd.waves(geo["blocks"], min(by_regs, by_smem))} wave(s)')


def hold_equidistance(what, uk, up, u64):
    """The kernel's controls may sit at most twice as far from the
    float64 plain run's as the plain float32 run's do."""
    k_far = tail(uk.double(), u64)[0]
    p_far = tail(up.double(), u64)[0]
    log(f'  mean |du| to the f64 plain run: kernel {k_far:.3e}, '
        f'plain f32 {p_far:.3e}')
    if k_far > 2 * p_far + 1e-6:
        raise AssertionError(f'{what}: the kernel sits further from float64 '
                             'than the plain float32 run')


def batch_subset(torch, ops, keep):
    """A forward kernel's operands for the examples ``keep`` (an index
    tensor): x0 and every operand with a batch extent gathered, shared
    ones (batch extent 1) kept."""
    B = ops['x0'].shape[0]
    keep = keep.to(ops['x0'].device)
    out = dict(ops, x0=ops['x0'][keep].contiguous())
    for k in ('F', 'f', 'C', 'c', 'u0', 'lb', 'ub', 'uz'):
        a = ops.get(k)
        if a is not None and a.shape[1] == B:
            out[k] = a[:, keep].contiguous()
    return out


def hold_k1(torch, what, ops, ops64, kernel=None, plain=None,
            limits=(TAIL_MEAN, TAIL_SHARE), counts=False):
    """A forward kernel (K1 unless ``kernel`` and ``plain`` name another
    and its plain version) against its plain version on the same
    operands: finite, within the float32 tail ``limits``
    (None: judged against float64 alone), the same n_iter, no further
    from the float64 plain run on ``ops64`` than the plain float32 run,
    bitwise equal on the reversed batch (every batched operand reversed
    with it) and, where ``counts``, with the
    plain run's step-size counts (``hold_counts``).
    Returns the kernel's (x, u, stats) and max |du|."""
    from mpc_tpu_torch.ops import fused
    kernel = kernel or fused.fused_ilqr
    plain = plain or fused.fused_solve_plain
    xk, uk, sk = kernel(**ops)
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    for t in (xk, uk, sk):
        if not torch.isfinite(t).all():
            raise AssertionError(f'{what}: the kernel returned non-finite '
                                 'values')
    mx = check_tail(f'{what} (f32)', uk, up, limits)
    if not torch.equal(sk[2], sp[2]):
        raise AssertionError(f'{what}: n_iter differs between kernel and '
                             'plain')
    cost_gap = float((sk[0] - sp[0]).abs().max())
    log(f'  max |cost kernel - cost plain| {cost_gap:.3e} (largest |cost| '
        f'{float(sp[0].abs().max()):.3e}), max |dx| '
        f'{float((xk - xp).abs().max()):.3e}')
    hold_equidistance(what, uk, up, u64)
    # batch reversal: no example reads another's data
    B = ops['x0'].shape[0]
    r = kernel(**batch_subset(torch, ops, torch.arange(B - 1, -1, -1)))
    if not (torch.equal(r[1].flip(1), uk) and torch.equal(r[0].flip(1), xk)
            and torch.equal(r[2].flip(1), sk)):
        raise AssertionError(f'{what}: reversed batch is not bitwise equal')
    log('  reversed batch: bitwise equal')
    if counts:
        hold_counts(torch, what, sk, sp, mixed=False)
    return (xk, uk, sk), mx


def phase_compare(torch, device, n=B):
    """K1 against fused_solve_plain on the card at the serving headline;
    returns max |du|."""
    from mpc_tpu_torch import MPCConfig
    from mpc_tpu_torch.ops import fused
    cfg = MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    dx64, cost64 = problem(torch, device, torch.float64)
    log(f'[compare] K1 vs its plain version, B={n}')

    def ops(x0, **kw):
        return fused.k1_operands(cfg, x0, kw.pop('cost', cost), dx,
                                 u_lower=kw.pop('lb', -2.0),
                                 u_upper=kw.pop('ub', 2.0))

    x0 = x0_batch(n, 0, torch, device)
    o64 = fused.k1_operands(cfg, x0.double(), cost64, dx64, u_lower=-2.0,
                            u_upper=2.0)
    (xk, uk, sk), mx = hold_k1(torch, 'K1 vs plain', ops(x0), o64)
    # batched cost / bounds layouts: batch stride 16 and 1 instead of 0
    from mpc_tpu_torch import QuadCost
    cb = QuadCost(cost.C.expand(T, n, 4, 4), cost.c.expand(T, n, 4))
    lbB = torch.full((T, n, 1), -2.0, device=device)
    rb = fused.fused_ilqr(**ops(x0, cost=cb, lb=lbB, ub=-lbB))
    if not (torch.equal(rb[1], uk) and torch.equal(rb[2], sk)):
        raise AssertionError('batched layouts differ from shared ones')
    log('  batched cost and bounds: bitwise equal to shared')
    # ragged tail: 2050 = 256 blocks of 8 examples and 2 more
    x2 = x0_batch(2050, 1, torch, device)
    _, u2, s2 = fused.fused_ilqr(**ops(x2))
    _, u2p, s2p = fused.fused_solve_plain(**ops(x2))
    mx = max(mx, check_tail('K1 vs plain, B=2050', u2, u2p))
    if not torch.equal(s2[2], s2p[2]):
        raise AssertionError('n_iter differs at B=2050')
    return mx


def phase_serve(torch, device, n_requests=8, n=B):
    """Serve distinct B=4096 request batches through batched_solve and
    MPC; returns the K1 launches counted in this phase."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    ctrl = mt.MPC(3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=10, eps=0.0,
                  exit_unconverged=False, detach_unconverged=False,
                  backprop=False, linesearch_decay=0.2,
                  max_linesearch_iter=5, device=device)
    requests = [x0_batch(n, 100 + i, torch, 'cpu')
                for i in range(2 * n_requests)]
    # warm-up request (first use loads the library)
    mt.batched_solve(cfg, requests[0].to(device), cost, dx, u_lower=-2.0,
                     u_upper=2.0, device=device).u.cpu()
    fused.reset_launch_counts()
    lat = []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        x0 = req.to(device)
        if i < n_requests:
            sol = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0,
                                   u_upper=2.0, device=device)
            u, costs = sol.u, sol.costs
        else:
            _, u, costs = ctrl(x0, cost, dx)
        u = u.cpu()
        lat.append(time.perf_counter() - t0)
    launches = fused.launch_counts['fused_ilqr']
    log(f'[serve] {len(requests)} requests of B={n} '
        f'({n_requests} batched_solve, {n_requests} MPC)')
    log('  latency ms: ' + ' '.join(f'{1e3 * v:.3f}' for v in lat))
    log(f'  median {1e3 * sorted(lat)[len(lat) // 2]:.3f} ms, '
        f'{n * len(lat) / sum(lat):.0f} solves/s, K1 launches {launches}')
    if device.type == 'cuda' and launches < len(requests):
        raise AssertionError('served requests did not all launch K1')
    # the last answer holds up: its states are the rollout of its
    # controls and its costs are their objective
    xr = rollout(dx, x0, u.to(device))
    cr = trajectory_cost(cost, xr, u.to(device))
    gap = float((cr - costs).abs().max() / costs.abs().max())
    log(f'  last answer: relative cost gap to its own rollout {gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0
            and gap < 1e-3):
        raise AssertionError('served controls are not a feasible solve')
    return launches


def phase_swingup(torch, device, n=B, steps=100):
    """The pendulum's receding-horizon swing-up from random starts."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    dx, cost = problem(torch, device)
    x = x0_batch(n, 0, torch, device)
    u_init = None
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        ctrl = mt.MPC(3, 1, T, u_lower=-2., u_upper=2., lqr_iter=50,
                      n_batch=n, u_init=u_init,
                      grad_method=mt.GradMethods.AUTO_DIFF, eps=1e-2,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, linesearch_decay=0.2,
                      max_linesearch_iter=5, device=device)
        xs, us, costs = ctrl(x, cost, dx)
        x = dx(x, us[0])
        u_init = torch.cat([us[1:], torch.zeros_like(us[:1])], 0)
    share = float((x[:, 0] > 0.9).double().mean())
    wall = time.perf_counter() - t0
    log(f'[swingup] B={n}, {steps} steps, {wall:.2f} s, K1 launches '
        f'{fused.launch_counts["fused_ilqr"]}: share within 0.1 of '
        f'cos th = 1: {share:.4f} (threshold {SWINGUP_MIN_SHARE}), '
        f'mean final cost {float(costs.mean()):.4f}')
    if not torch.isfinite(x).all() or share < SWINGUP_MIN_SHARE:
        raise AssertionError('swing-up did not reach its success share')
    return share


def phase_time(torch, device, reps=50):
    """K1 with CUDA events over many launches after warm-up, its bound,
    and the plain version on the card."""
    from mpc_tpu_torch import MPCConfig
    from mpc_tpu_torch.ops import fused
    cfg = MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    ops = fused.k1_operands(cfg, x0_batch(B, 2, torch, device), cost, dx,
                            u_lower=-2.0, u_upper=2.0)
    for _ in range(3):
        _, _, stats = fused.fused_ilqr(**ops)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fused.fused_ilqr(**ops)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    start.record()
    fused.fused_solve_plain(**ops)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    n_it = float(stats[2].double().sum())
    n_trials = float(stats[5].double().sum())
    flops = fused.k1_flops(T, 3, 1, n_it, n_trials, batch=B)
    nbytes = fused.k1_bytes(ops)
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f'[time] K1 B={B}: {ms:.4f} ms ({reps} launches), plain '
        f'{plain_ms:.2f} ms; {flops:.4e} operations '
        f'({n_trials / B:.2f} trials/solve), {nbytes} bytes; bound '
        f'{max(t_ops, t_bytes):.5f} ms by '
        f'{"operations" if t_ops >= t_bytes else "bytes"}; '
        f'{B / ms * 1e3:.0f} solves/s')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


# ---------------------------------------------------------------------------
# the training path: config 4 through K1 and K2
# ---------------------------------------------------------------------------

def sync(torch, device):
    if device.type == 'cuda':
        torch.cuda.synchronize()


def config4_data(n, torch, device, seed=3):
    """x0 [n, 3] and clipped-normal expert controls [T, n, 1] from one
    RandomState, as benchmarks/configs.py:277-283."""
    import numpy as np
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)
    u_exp = np.clip(rng.randn(TRAIN_T, n, 1), -2, 2)
    return (torch.tensor(x0, dtype=torch.float32, device=device),
            torch.tensor(u_exp, dtype=torch.float32, device=device))


def learned_cost(torch, device, q_log, p):
    """Config 4's learnable batch-shared diagonal cost."""
    import mpc_tpu_torch as mt
    theta = {'q_log': torch.nn.Parameter(q_log.to(device)),
             'p': torch.nn.Parameter(p.to(device))}

    def make_cost(th):
        return mt.QuadCost(torch.diag(torch.exp(th['q_log'])), th['p'])
    return theta, make_cost


def config4_theta(torch, device, dtype=None):
    dx, _ = problem(torch, device, dtype)
    q, p = dx.get_true_obj()
    return learned_cost(torch, device, torch.log(q + 1e-3), p)


def config4_k1_operands(torch, device, n, dtype=None):
    """K1's operands on the training path: config 4's first n examples
    under the cost theta starts from."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    dtype = dtype or torch.float32
    dx, _ = problem(torch, device, dtype)
    theta, make_cost = config4_theta(torch, device, dtype)
    x0, _ = config4_data(n, torch, device)
    with torch.no_grad():
        return fused.k1_operands(mt.MPCConfig(**TRAIN), x0.to(dtype),
                                 make_cost(theta), dx, u_lower=-2.0,
                                 u_upper=2.0)


def phase_compare_train(torch, device):
    """K1 against fused_solve_plain at the training path's shapes
    (config 4: T=10, lqr_iter=5, max_linesearch_iter=3, the learned cost
    theta starts from, B=1024 and 8192); returns max |du|."""
    from mpc_tpu_torch.ops import fused
    mx = 0.0
    for n in (1024, 8192):
        log(f'[compare-train] K1 vs its plain version on config 4, B={n}')
        ops = config4_k1_operands(torch, device, n)
        ops64 = config4_k1_operands(torch, device, n, torch.float64)
        mx = max(mx, hold_k1(torch, f'K1 vs plain, T={TRAIN_T}', ops,
                             ops64)[1])
    return mx


def bwd_operands(torch, device, n, seed=11):
    """K2's operands at config 4's solution: x*, u* from K1 on n
    examples, the cost, the dynamics' Jacobians, the active set, and
    seeded random cotangents."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused, fused_bwd
    from mpc_tpu_torch.solver import linearize_dynamics
    dx, _ = problem(torch, device)
    ops = config4_k1_operands(torch, device, n)
    with torch.no_grad():
        xs, us, _ = fused.fused_ilqr(**ops)
        F, _ = linearize_dynamics(dx, xs, us, mt.GradMethods.AUTO_DIFF)
    bound = torch.tensor(2.0, device=device)
    rng = np.random.RandomState(seed)
    return dict(C=ops['C'], c=ops['c'], F=F.contiguous(), x_star=xs,
                u_star=us,
                dl_dx=torch.tensor(rng.randn(TRAIN_T, n, 3),
                                   dtype=torch.float32, device=device),
                dl_du=torch.tensor(rng.randn(TRAIN_T, n, 1),
                                   dtype=torch.float32, device=device),
                I_mask=fused_bwd.active_set(us, -bound, bound))


def bwd_case(ops, cost_shared, has_I):
    """The operands of one K2 build: shared or batched cost, with or
    without the active set."""
    T, n = ops['u_star'].shape[:2]
    o = dict(ops)
    if not cost_shared:
        o['C'] = o['C'].expand(T, n, 4, 4).contiguous()
        o['c'] = o['c'].expand(T, n, 4).contiguous()
    if not has_I:
        o['I_mask'] = None
    return o


def flip_batch(ops, torch):
    out = {}
    for k, v in ops.items():
        batched = v is not None and v.dim() >= 2 and v.shape[1] > 1
        out[k] = v.flip(1).contiguous() if batched else v
    return out


BWD_NAMES = ('dx_init', 'dC', 'dc', 'dF', 'df')


def hold_bwd(torch, label, what, kernel, plain, o, **kw):
    """A backward kernel (``label`` K2 or K4) against its plain version
    on the same operands ``o``: every gradient finite and of the plain
    version's shape, within BWD_TOL of it relative to its largest entry,
    and no further from a float64 plain run than twice the plain float32
    run.  A gradient that does not exist (None) is skipped.  Returns the
    kernel's outputs and the largest |difference|."""
    kk = kernel(**o, **kw)
    pp = plain(**o, **kw)
    o64 = {k: (v.double() if v is not None else None) for k, v in o.items()}
    p64 = plain(**o64, **kw)
    max_err, rels, far = 0.0, [], []
    for name, a, b, r in zip(BWD_NAMES, kk, pp, p64):
        if a is None and b is None:
            continue
        if a is None or b is None or a.shape != b.shape \
                or not torch.isfinite(a).all():
            raise AssertionError(f'{what}: {label} {name} is missing, has '
                                 'the wrong shape or is not finite')
        scale = float(b.abs().max()) or 1.0
        err = float((a - b).abs().max())
        max_err = max(max_err, err)
        rels.append((name, err / scale))
        k_far = float((a.double() - r).abs().mean())
        p_far = float((b.double() - r).abs().mean())
        far.append((name, k_far, p_far))
        if k_far > 2 * p_far + 1e-7 * scale:
            raise AssertionError(f'{what}: {label} {name} sits further from '
                                 'float64 than the plain float32 run')
    log(f'  {what}: max |{label} - plain| / scale ' + ' '.join(
        f'{nm} {r:.2e}' for nm, r in rels))
    log(f'    mean |. - f64|, {label} / plain: ' + ' '.join(
        f'{nm} {k:.2e}/{p:.2e}' for nm, k, p in far))
    if max(r for _, r in rels) > BWD_TOL:
        raise AssertionError(f'{what}: {label} differs from its plain '
                             f'version by more than {BWD_TOL}')
    return kk, max_err


def hold_bwd_slices(torch, label, what, kernel, o, full, sizes=(1, 7, 33),
                    **kw):
    """The first n examples alone (n = 1, and batches that do not fill a
    block) must give, bitwise, the per-example outputs (dx_init, and
    dC, dc, dF, df where their leaf is batched) that the same examples
    give inside the batch of ``full``; reduced outputs are held by
    ``hold_bwd`` and the repeated launches."""
    B = o['x_star'].shape[1]
    for n in sizes:
        part = {k: (v[:, :n].contiguous() if v is not None and v.dim() >= 2
                    and v.shape[1] == B else v) for k, v in o.items()}
        alone = kernel(**part, **kw)
        for name, a, f in zip(BWD_NAMES, alone, full):
            if f is None:
                continue
            if name == 'dx_init':
                same = torch.equal(a, f[:n])
            elif f.dim() >= 3 and f.shape[1] == B:
                # one example of a batched leaf comes back as a shared
                # one's: its "sum" over the batch
                same = torch.equal(a.reshape(f[:, :n].shape), f[:, :n])
            else:
                continue
            if not same:
                raise AssertionError(f'{what}: {label} {name} of B={n} alone '
                                     'differs from the same examples inside '
                                     f'B={B}')
    log(f'    B in {sizes} alone: per-example outputs bitwise equal to the '
        f'same examples inside B={B}')


def bwd_random_operands(torch, device, T, n, seed=0):
    """A random problem for the backward kernels with shared C, c and F:
    SPD C, contractive dynamics (so the costate stays finite in float32
    over long horizons), ~30% of the controls pinned on a bound, as
    tests/test_torch_gpu.py's backward problems."""
    import numpy as np
    rng = np.random.RandomState(seed)
    Cr = rng.randn(T, 1, 4, 4)
    C = np.einsum('tbij,tbkj->tbik', Cr, Cr) + np.eye(4)
    F = 0.05 * rng.randn(T - 1, 1, 3, 4)
    F[..., :3] += 0.9 * np.eye(3)
    us = rng.randn(T, n, 1)
    pinned = rng.rand(T, n, 1) < 0.3
    arrays = dict(C=C, c=rng.randn(T, 1, 4), F=F, x_star=rng.randn(T, n, 3),
                  u_star=np.where(pinned, np.sign(us), us),
                  dl_dx=rng.randn(T, n, 3), dl_du=rng.randn(T, n, 1),
                  I_mask=pinned.astype(np.float64))
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def phase_compare_bwd(torch, device, n=1024):
    """K2 against fused_kkt_backward_plain on the card, same-primal;
    returns the largest |difference|."""
    from mpc_tpu_torch.ops import fused_bwd
    log(f'[compare-bwd] K2 vs its plain version at config 4\'s solution, '
        f'B={n}')
    base = bwd_operands(torch, device, n)
    log(f'  active controls: '
        f'{float(base["I_mask"].mean()):.3f} of T*B')
    max_err = 0.0

    def check(what, o):
        nonlocal max_err
        kk, err = hold_bwd(torch, 'K2', what, fused_bwd.fused_kkt_backward,
                           fused_bwd.fused_kkt_backward_plain, o)
        max_err = max(max_err, err)
        return kk

    for cost_shared in (True, False):
        for has_I in (True, False):
            o = bwd_case(base, cost_shared, has_I)
            what = (f'{"shared" if cost_shared else "batched"} cost, '
                    f'{"with" if has_I else "without"} active set')
            kk = check(what, o)
            if not has_I:
                continue
            # batch reversal: no example reads another's data
            back = fused_bwd.fused_kkt_backward(**flip_batch(o, torch))
            per_example = [(kk[0], back[0].flip(0)), (kk[3], back[3].flip(1)),
                           (kk[4], back[4].flip(1))]
            if not cost_shared:
                per_example += [(kk[1], back[1].flip(1)),
                                (kk[2], back[2].flip(1))]
            if not all(torch.equal(a, b) for a, b in per_example):
                raise AssertionError(f'{what}: reversed batch is not '
                                     'bitwise equal')
            log('    reversed batch: bitwise equal on per-example outputs')
            if cost_shared:
                again = fused_bwd.fused_kkt_backward(**o)
                if not (torch.equal(again[1], kk[1])
                        and torch.equal(again[2], kk[2])):
                    raise AssertionError('reduced dC/dc differ between two '
                                         'launches')
                log('    two launches: reduced dC, dc bitwise equal')
    base = bwd_operands(torch, device, 2050)
    for cost_shared in (True, False):
        o = bwd_case(base, cost_shared, True)
        what = (f'B=2050, {"shared" if cost_shared else "batched"} cost, '
                'with active set')
        hold_bwd_slices(torch, 'K2', what, fused_bwd.fused_kkt_backward, o,
                        check(what, o))
    phase_tf32(torch, 'config 4 training-step loss and gradients',
               lambda: train_grads(torch, device, n))
    return max_err


def train_grads(torch, device, n):
    import mpc_tpu_torch as mt
    dx, _ = problem(torch, device)
    theta, make_cost = config4_theta(torch, device)
    x0, u_exp = config4_data(n, torch, device)
    loss = mt.imitation_loss(theta, mt.MPCConfig(**TRAIN), x0, u_exp,
                             make_cost, lambda th: dx, u_lower=-2.0,
                             u_upper=2.0, device=device)
    loss.backward()
    return [loss.detach()] + [theta[k].grad for k in sorted(theta)]


def phase_tf32(torch, what, grads_fn):
    """A training-step loss and gradient (``grads_fn()``) with TF32
    matrix products allowed and forbidden: phase 2 is elementwise, so
    the bits must not move."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        grads = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            grads.append(grads_fn())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if not all(torch.equal(a, b) for a, b in zip(*grads)):
        raise AssertionError('TF32 on and off give different gradients')
    log(f'  TF32 on and off: {what} bitwise equal')


def phase_train(torch, device, n, steps=20, warmup=3):
    """Config 4's train step through make_imitation_train_step: median
    step time over ``steps`` host-timed, synchronised steps after
    warm-up.  Returns the K1 and K2 launches, with the counts set to 0
    just before the timed steps and read just after."""
    from mpc_tpu_torch.ops import fused, fused_bwd
    step, theta, x0, u_exp = config4_train_step(torch, device, n)
    for _ in range(warmup):
        step(theta, x0, u_exp)
    sync(torch, device)
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    lat, losses = [], []
    for _ in range(steps):
        k1 = fused.launch_counts['fused_ilqr']
        k2 = fused_bwd.launch_counts['fused_kkt_bwd']
        t0 = time.perf_counter()
        loss = step(theta, x0, u_exp)
        sync(torch, device)
        lat.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if device.type == 'cuda' and (
                fused.launch_counts['fused_ilqr'] == k1
                or fused_bwd.launch_counts['fused_kkt_bwd'] == k2):
            raise AssertionError('a train step did not launch K1 and K2')
    k1 = fused.launch_counts['fused_ilqr']
    k2 = fused_bwd.launch_counts['fused_kkt_bwd']
    med = sorted(lat)[len(lat) // 2]
    log(f'[train] config 4, B={n}, T={TRAIN_T}: {steps} steps, median '
        f'{1e3 * med:.3f} ms ({min(lat) * 1e3:.3f}-{max(lat) * 1e3:.3f}), '
        f'{n / med:.0f} examples/s; K1 launches {k1}, K2 launches {k2}; '
        f'loss {losses[0]:.5f} -> {losses[-1]:.5f}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('the training loss is not finite')
    return k1, k2


def phase_learn(torch, device, n=1024):
    """The learner of examples/pod_imitation.py:84-104 at T=10: the
    expert solves with the true cost, the learner starts from a wrong
    diagonal cost and must cut the imitation loss."""
    import mpc_tpu_torch as mt
    cfg = mt.MPCConfig(**TRAIN)
    dx, true_cost = problem(torch, device)
    x0 = x0_batch(n, 0, torch, device)
    with torch.no_grad():
        u_exp = mt.batched_solve(cfg, x0, true_cost, dx, u_lower=-2.0,
                                 u_upper=2.0, device=device).u
    q, p = dx.get_true_obj()
    theta, make_cost = learned_cost(torch, device, torch.log(0.2 * q + 0.3),
                                    torch.zeros_like(p))
    step = mt.make_imitation_train_step(
        cfg, torch.optim.Adam(theta.values(), lr=5e-2), make_cost,
        lambda th: dx, u_lower=-2.0, u_upper=2.0, device=device)
    losses = [float(step(theta, x0, u_exp)) for _ in range(LEARN_STEPS)]
    ratio = min(losses) / losses[0]
    log(f'[learn] B={n}, {LEARN_STEPS} steps of Adam(5e-2): loss '
        + ' '.join(f'{v:.4g}' for v in losses[::3])
        + f'; best / first {ratio:.4f} (threshold {LEARN_MAX_RATIO})')
    if not (all(math.isfinite(v) for v in losses)
            and ratio < LEARN_MAX_RATIO):
        raise AssertionError('the learner did not cut its loss')
    return losses


def config4_train_step(torch, device, n):
    """(step, theta, x0, u_expert) of config 4's train step."""
    import mpc_tpu_torch as mt
    dx, _ = problem(torch, device)
    theta, make_cost = config4_theta(torch, device)
    x0, u_exp = config4_data(n, torch, device)
    step = mt.make_imitation_train_step(
        mt.MPCConfig(**TRAIN), torch.optim.Adam(theta.values(), lr=1e-2),
        make_cost, lambda th: dx, u_lower=-2.0, u_upper=2.0, device=device)
    return step, theta, x0, u_exp


def phase_profile_train(torch, device, what, train_step, steps=5):
    """Where a train step's time goes (``train_step`` = (step, theta, x0,
    u_expert)): torch.profiler over a few steps after warm-up.  Prints
    the wall time per step, the device's busy time per step (the sum of
    the times of its kernels and copies, which do not overlap on one
    stream), their number per step and the largest by device time."""
    from torch.profiler import ProfilerActivity, profile
    step, theta, x0, u_exp = train_step
    for _ in range(3):
        step(theta, x0, u_exp)
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(theta, x0, u_exp)
        sync(torch, device)
        wall = (time.perf_counter() - t0) / steps
    # device kernels and copies; a user annotation (Adam's
    # record_function) spans kernels and is not one
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / steps
    log(f'[profile] {what} train step, B={x0.shape[0]}: wall '
        f'{wall * 1e3:.3f} ms a step, device operations '
        f'{len(kernels) / steps:.0f} a step, busy {busy:.3f} ms a step')
    if not kernels:
        log('  the profiler saw no device operations: idle share not '
            'measured')
        return
    log(f'  device idle share {1 - busy / (wall * 1e3):.3f}')
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        log(f'  {us / steps:9.1f} us a step  {name[:90]}')


def event_ms(torch, fn):
    """Device time of one call of ``fn`` between CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_ms(torch, launch, reps=10, per_graph=20):
    """The device's time for one call of ``launch``: ``per_graph`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA
    events after warm-up, so that the time is the device's and not the
    Python wrapper's (a call of a wrapper costs about as much host time
    as a kernel takes at the training sizes).  Also returns the time of
    a call from Python, eager."""
    for _ in range(5):
        launch()
    n = reps * per_graph

    def eager():
        for _ in range(n):      # results dropped, so their memory is reused
            launch()
    eager_ms = event_ms(torch, eager) / n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            launch()
    graph.replay()
    ms = event_ms(torch, lambda: [graph.replay() for _ in range(reps)]) / n
    return ms, eager_ms


def bound(flops, nbytes):
    """The least time the card could take: operations over the float32
    peak or bytes over the memory rate, whichever is longer (ms), and
    which it is."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def phase_time_train(torch, device, n=1024):
    """K1 at the training path's shape (config 4, B=n) timed from a CUDA
    graph, its bound from this run's iterations and trial rollouts, and
    the plain version on the card."""
    from mpc_tpu_torch.ops import fused
    ops = config4_k1_operands(torch, device, n)
    _, _, stats = fused.fused_ilqr(**ops)
    ms, eager_ms = graph_ms(torch, lambda: fused.fused_ilqr(**ops))
    plain_ms = event_ms(torch, lambda: fused.fused_solve_plain(**ops))
    n_it = float(stats[2].double().sum())
    n_trials = float(stats[5].double().sum())
    flops = fused.k1_flops(TRAIN_T, 3, 1, n_it, n_trials, batch=n)
    nbytes = fused.k1_bytes(ops)
    bound_ms, by = bound(flops, nbytes)
    log(f'[time-train] K1 config 4, B={n}, T={TRAIN_T}: {ms:.4f} ms (from '
        f'a CUDA graph; {eager_ms:.4f} ms a call from Python), plain '
        f'{plain_ms:.2f} ms; {flops:.4e} operations ({n_it / n:.2f} '
        f'iterations, {n_trials / n:.2f} trials/solve), {nbytes} bytes; '
        f'bound {bound_ms:.5f} ms by {by}')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def phase_time_bwd(torch, device, n):
    """K2 (shared cost with the active set, as on the training path)
    timed from a CUDA graph, its bound, and the plain version on the
    card."""
    from mpc_tpu_torch.ops import fused_bwd
    o = bwd_operands(torch, device, n)
    ms, eager_ms = graph_ms(torch, lambda: fused_bwd.fused_kkt_backward(**o))
    plain_ms = event_ms(torch,
                        lambda: fused_bwd.fused_kkt_backward_plain(**o))
    flops = fused_bwd.k2_flops(TRAIN_T, n, True)
    nbytes = fused_bwd.k2_bytes(o['C'], o['c'], o['F'], o['x_star'],
                                o['I_mask'])
    bound_ms, by = bound(flops, nbytes)
    log(f'[time-bwd] K2 B={n}, T={TRAIN_T}: {ms:.4f} ms (from a CUDA '
        f'graph; {eager_ms:.4f} ms a call from Python), plain '
        f'{plain_ms:.2f} ms; {flops:.4e} operations, {nbytes} bytes; '
        f'bound {bound_ms:.5f} ms by {by}')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


# ---------------------------------------------------------------------------
# the long-horizon path: LinDx, T=160, through K3 and K4
# ---------------------------------------------------------------------------

def long_data(torch, device, dtype=None):
    """The long-horizon imitation configuration's data, made with numpy
    as benchmarks/configs.py:341-351: the shared F [T-1, 3, 4] and C
    [T, 4, 4], x0 [B, 3] and the expert's controls [T, B, 1] from one
    RandomState(5)."""
    import numpy as np
    dtype = dtype or torch.float32
    rng = np.random.RandomState(5)
    A = np.eye(3, dtype=np.float32)
    A[0, 1] = 0.01
    Fsh = np.concatenate([A, 0.01 * np.ones((3, 1), np.float32)], 1)
    F = np.broadcast_to(Fsh, (LONG_T - 1, 3, 4)).copy()
    C = np.broadcast_to(np.diag([1., 1., 0.1, 0.01]).astype(np.float32),
                        (LONG_T, 4, 4)).copy()
    x0 = rng.randn(LONG_B, 3).astype(np.float32)
    u_exp = 0.1 * rng.randn(LONG_T, LONG_B, 1).astype(np.float32)
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in (F, C, x0, u_exp))


def long_problem(torch, device, n=LONG_B, dtype=None, c=None, **cfg_kw):
    """(cfg, x0 [n, 3], cost, dynamics, u_expert) of the long-horizon
    configuration on its first n examples, with the learned c at its
    start (zero) unless given."""
    import mpc_tpu_torch as mt
    F, C, x0, u_exp = long_data(torch, device, dtype)
    if c is None:
        c = torch.zeros(LONG_T, 4, dtype=F.dtype, device=device)
    return (mt.MPCConfig(**dict(LONG, **cfg_kw)), x0[:n].contiguous(),
            mt.QuadCost(C, c), mt.LinDx(F, None), u_exp[:, :n].contiguous())


def long_k3_operands(torch, device, n=LONG_B, dtype=None):
    from mpc_tpu_torch.ops import fused
    cfg, x0, cost, dyn, _ = long_problem(torch, device, n, dtype)
    return fused.k3_operands(cfg, x0, cost, dyn, u_lower=-2.0, u_upper=2.0)


def phase_compare_long(torch, device):
    """K3 against fused_solve_long_plain on the card at the long-horizon
    configuration's full size, at B=2050, with every shared operand
    broadcast to batched, and on the pendulum past K1's horizon limit;
    returns max |du| of the LinDx cases."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    long_kw = dict(kernel=fused.fused_ilqr_long,
                   plain=fused.fused_solve_long_plain)
    limits = (LONG_TAIL_MEAN, LONG_TAIL_SHARE)
    log(f'[compare-long] K3 vs its plain version, LinDx, T={LONG_T}, '
        f'B={LONG_B}')
    ops = long_k3_operands(torch, device)
    ops64 = long_k3_operands(torch, device, dtype=torch.float64)
    (xk, uk, sk), mx = hold_k1(torch, 'K3 vs plain', ops, ops64,
                               limits=limits, **long_kw)
    log(f'  controls on a bound: {float((uk.abs() >= 2.0).double().mean()):.3f}'
        f' of T*B; trial rollouts a solve {float(sk[5].mean()):.2f}')
    # every shared operand broadcast to batched: batch strides 16, 4, 12
    # and 1 instead of 0
    n = LONG_B
    batched = dict(ops, C=ops['C'].expand(LONG_T, n, 4, 4).contiguous(),
                   c=ops['c'].expand(LONG_T, n, 4).contiguous(),
                   F=ops['F'].expand(LONG_T - 1, n, 3, 4).contiguous(),
                   lb=ops['lb'].expand(LONG_T, n).contiguous(),
                   ub=ops['ub'].expand(LONG_T, n).contiguous())
    rb = fused.fused_ilqr_long(**batched)
    if not (torch.equal(rb[0], xk) and torch.equal(rb[1], uk)
            and torch.equal(rb[2], sk)):
        raise AssertionError('batched layouts differ from shared ones')
    log('  batched cost, dynamics and bounds: bitwise equal to shared')
    # ragged tail: 2050 = 64 blocks of 32 and 2 examples
    hold_k1(torch, 'K3 vs plain, B=2050',
            long_k3_operands(torch, device, 2050),
            long_k3_operands(torch, device, 2050, torch.float64),
            limits=limits, **long_kw)
    # the pendulum past K1's T_MAX.  Over 384 steps two float32 solves
    # of the pendulum drift apart (mean |du| 2.9e-3 here, PERF.md), so
    # each is judged against the float64 plain run and not by the tail
    cfg = mt.MPCConfig(**dict(HEADLINE, T=PEND_LONG_T, lqr_iter=2,
                              max_linesearch_iter=2))
    log(f'[compare-long] K3 vs its plain version, pendulum, T={PEND_LONG_T}, '
        f'B={PEND_LONG_B}')
    pend = []
    for dtype in (torch.float32, torch.float64):
        dx, cost = problem(torch, device, dtype)
        x0 = x0_batch(PEND_LONG_B, 4, torch, device).to(dtype)
        pend.append(fused.k3_operands(cfg, x0, cost, dx, u_lower=-2.0,
                                      u_upper=2.0))
    hold_k1(torch, 'K3 vs plain, pendulum', *pend, limits=None, **long_kw)
    return mx


# the cases the teams of K1 and K3 make new
TEAMS_T = 40            # the long configuration cut to 40 steps
# shares of examples with the plain version's n_iter and with its summed
# selected index + 1
TEAMS_SAME_ITER, TEAMS_SAME_TRIALS = 0.99, 0.98
# a line-search tie moves the controls where the iteration's full-step
# norm exceeds TEAMS_REAL_STEP; at most TEAMS_MAX_TIED of a problem's
# examples may be left out for such a tie
TEAMS_REAL_STEP, TEAMS_MAX_TIED = 1e-3, 0.1
# step sizes of the cheap-control pendulum's search through K1 and K3:
# past the width of a team, which is 4 lanes in K1 and on K3's pendulum as
# wide as its search up to 8 (fused._k3_team), so 10 there
TEAMS_K1_ALPHAS, TEAMS_K3_ALPHAS = 6, 10


def same_share(a, b):
    return float((a == b).double().mean())


def hold_slices(torch, what, kernel, ops, full, sizes=(1, 7, 33)):
    """The first n examples solved alone (n = 1, and batches that do not
    fill a block) must be bitwise what they are inside the full batch
    ``full``: an example's result depends on nothing beside it."""
    for n in sizes:
        r = kernel(**batch_subset(torch, ops, torch.arange(n)))
        if not (torch.equal(r[0], full[0][:, :n])
                and torch.equal(r[1], full[1][:, :n])
                and torch.equal(r[2], full[2][:, :n])):
            raise AssertionError(f'{what}: B={n} alone differs from the '
                                 'same examples inside the full batch')
    log(f'  {what}: B in {sizes} alone bitwise equal to the full batch\'s '
        'first examples')


def hold_f64(what, uk, up, u64):
    """Where two float32 solves part (examples that stop an iteration
    apart, long searches), the kernel is judged against the float64
    plain run: no further from it than twice the plain float32 run."""
    check_tail(f'{what} (f32)', uk, up, None)
    hold_equidistance(what, uk, up, u64)


def hold_counts(torch, what, sk, sp, mixed, trials=True):
    """The counts of a kernel run against the plain run's: n_iter equal
    in TEAMS_SAME_ITER of the examples (a full-step norm within round-off
    of eps may fall on the other side) and, where ``trials``, the summed
    selected index + 1 in TEAMS_SAME_TRIALS.  The latter holds only while
    the steps are real: near convergence a trial cost ties the current
    one to round-off, either step size is right, and the share is only
    logged.  Where asked, n_iter must really be mixed."""
    it_same, tr_same = same_share(sk[2], sp[2]), same_share(sk[5], sp[5])
    log(f'  {what}: n_iter {float(sk[2].min()):.0f} to '
        f'{float(sk[2].max()):.0f} (equal to plain in {it_same:.4f}), '
        f'selected index + 1 summed: most {float(sk[5].max()):.0f} (equal '
        f'in {tr_same:.4f})')
    if it_same < TEAMS_SAME_ITER or (trials
                                     and tr_same < TEAMS_SAME_TRIALS):
        raise AssertionError(f'{what}: counts differ from the plain '
                             'version\'s')
    if mixed and not float(sk[2].min()) < float(sk[2].max()):
        raise AssertionError(f'{what}: the examples did not stop at '
                             'different iterations')


def tied_examples(torch, trace, horizon, min_step=0.0):
    """The examples whose line search decided a tie of float32 round-off
    somewhere: a trial cost within ``horizon`` ulps of the current cost
    (each is a sum of ``horizon`` terms, rounded once a term), read from
    the decisions ``trace`` of a float64 plain run, where the gap is the
    true one.  Either side of such a decision is right in float32.  With
    ``min_step``, only ties in an iteration whose full-step norm exceeds
    it: the ones that move the controls."""
    ulp = torch.finfo(torch.float32).eps
    tied = torch.zeros_like(trace[0][4])
    for _, _, old, cost_a, tried, full_du in trace:
        tied |= (tried & (full_du > min_step)
                 & ((cost_a - old).abs() <= horizon * ulp * old.abs()))
    return tied


def hold_lindx_search(torch, what, ops, ops64, horizon, show=3):
    """K3 on a LinDx problem with more step sizes than a team has lanes.
    Its line search goes past the first step size only where a trial
    cost ties the current one to round-off (a converged example, or a
    step along which the cost is flat), and there the kernel and the
    plain version may decide differently, both rightly.  Every example
    whose counts differ must hold such a tie (``tied_examples``); those
    that differ after a tie at a real step are shown, decision by
    decision; every example without a tie at a real step is held against
    the float64 plain run."""
    from mpc_tpu_torch.ops import fused
    rk = fused.fused_ilqr_long(**ops)
    tr32, tr64 = [], []
    rp = fused.fused_solve_long_plain(**ops, trace=tr32)
    r64 = fused.fused_solve_long_plain(**ops64, trace=tr64)
    tied_any = tied_examples(torch, tr64, horizon)
    tied = tied_examples(torch, tr64, horizon, min_step=TEAMS_REAL_STEP)
    differ = rk[2][5] != rp[2][5]
    log(f'  {what}: {int(tied_any.sum())} of {tied.numel()} examples decide '
        f'a tie of round-off somewhere, {int(tied.sum())} at a real step '
        f'(full-step norm > {TEAMS_REAL_STEP}); counts differ from the plain '
        f'run\'s in {int(differ.sum())} examples, {int((differ & tied).sum())}'
        ' of them with a tie at a real step')
    # the kernel's counts and best cost after each iteration: solves cut
    # after 1, 2, ... iterations
    n_iter = ops['lqr_iter']
    upto = [fused.fused_ilqr_long(**dict(ops, lqr_iter=i))[2]
            for i in range(1, n_iter)] + [rk[2]]
    parted = (rk[1] - rp[1]).abs().amax((0, 2)) > TAIL_ENTRY
    log(f'  controls part by more than {TAIL_ENTRY} in {int(parted.sum())} '
        f'examples, {int((parted & tied).sum())} of them with a tie at a '
        'real step')
    for b in torch.nonzero((differ & tied) | parted)[:show, 0].tolist():
        log(f'  example {b}: max |du| kernel - plain '
            f'{float((rk[1] - rp[1])[:, b].abs().max()):.3e}')
        for it in range(n_iter):
            k_idx = float(upto[it][5][b] - (upto[it - 1][5][b] if it else 0))
            rows32 = [r for r in tr32 if r[0] == it and bool(r[4][b])]
            rows64 = [r for r in tr64 if r[0] == it and bool(r[4][b])]
            if not rows32:
                continue
            log(f'    iteration {it}: selected index + 1: kernel {k_idx:.0f}, '
                f'plain f32 {len(rows32)}, plain f64 {len(rows64)}; kernel '
                f'best cost {float(upto[it][0][b]):.9g}; plain f32 current '
                f'cost {float(rows32[0][2][b]):.9g}, trials '
                + ' '.join(f'{float(r[3][b]):.9g}' for r in rows32)
                + '; f64 (trial - current) / |current| '
                + ' '.join(f'{float((r[3][b] - r[2][b]) / r[2][b].abs()):.2e}'
                           for r in rows64))
    if bool((differ & ~tied_any).any()):
        raise AssertionError(f'{what}: counts differ from the plain '
                             'version\'s where no decision was a tie')
    if float(tied.double().mean()) > TEAMS_MAX_TIED:
        raise AssertionError(f'{what}: too many ties to hold the rest')
    keep = ~tied
    hold_f64(f'{what}, untied examples', rk[1][:, keep], rp[1][:, keep],
             r64[1][:, keep])
    if not torch.equal(rk[2][2], rp[2][2]):
        raise AssertionError(f'{what}: n_iter differs')


def phase_compare_teams(torch, device):
    """What a team of lanes per example makes new, K1 and K3 against
    their plain versions: examples of one warp that stop at different
    iterations (eps > 0), more step sizes than lanes, B = 1 and batches
    that do not fill a block."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    log(f'[compare-teams] teams of {fused.TEAM} lanes (K3\'s pendulum: as '
        f'wide as its step sizes, up to {fused.K3_PEND_TEAM})')
    dx, cost = problem(torch, device)
    dx64, cost64 = problem(torch, device, torch.float64)
    # K1, the headline with eps = 1e-2: mixed stopping inside a warp
    n = 1024
    x0 = x0_batch(n, 6, torch, device)
    cfg = mt.MPCConfig(**dict(HEADLINE, eps=1e-2, lqr_iter=12))
    ops = fused.k1_operands(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0)
    rk, rp = fused.fused_ilqr(**ops), fused.fused_solve_plain(**ops)
    _, u64, _ = fused.fused_solve_plain(**fused.k1_operands(
        cfg, x0.double(), cost64, dx64, u_lower=-2.0, u_upper=2.0))
    hold_f64('K1, eps=1e-2', rk[1], rp[1], u64)
    hold_counts(torch, 'K1, eps=1e-2', rk[2], rp[2], mixed=True,
                trials=False)
    hold_slices(torch, 'K1', fused.fused_ilqr, ops, rk)
    # K3 on the long configuration cut to TEAMS_T steps
    F, C, x0l, _ = long_data(torch, device)
    F64, C64, x064, _ = long_data(torch, device, torch.float64)
    n = 256

    def k3_ops(dtype, **kw):
        f_, c_, x_ = (F, C, x0l) if dtype == torch.float32 else (F64, C64,
                                                                 x064)
        cfg = mt.MPCConfig(**dict(LONG, T=TEAMS_T, backprop=False, **kw))
        return fused.k3_operands(
            cfg, x_[:n].contiguous(),
            mt.QuadCost(c_[:TEAMS_T], torch.zeros(TEAMS_T, 4, dtype=dtype,
                                                  device=device)),
            mt.LinDx(f_[:TEAMS_T - 1], None), u_lower=-2.0, u_upper=2.0)

    ops = k3_ops(torch.float32, eps=1e-2, lqr_iter=8)
    rk = fused.fused_ilqr_long(**ops)
    rp = fused.fused_solve_long_plain(**ops)
    _, u64, _ = fused.fused_solve_long_plain(
        **k3_ops(torch.float64, eps=1e-2, lqr_iter=8))
    hold_f64(f'K3, T={TEAMS_T}, eps=1e-2', rk[1], rp[1], u64)
    hold_counts(torch, 'K3, eps=1e-2', rk[2], rp[2], mixed=True,
                trials=False)
    hold_slices(torch, 'K3', fused.fused_ilqr_long, ops, rk)
    six = dict(max_linesearch_iter=6, linesearch_decay=0.5)
    hold_lindx_search(torch, f'K3, LinDx, T={TEAMS_T}, 6 step sizes',
                      k3_ops(torch.float32, **six),
                      k3_ops(torch.float64, **six), TEAMS_T)
    # step sizes of decay 0.5 on a cheap-control pendulum with wide bounds
    # (TEAMS_K1_ALPHAS, TEAMS_K3_ALPHAS), where from the second iteration
    # on the full step overshoots: rounds of the line search past the
    # team's width with real steps.  Through K1 at the headline's T and
    # through K3 at TEAMS_T; judged against float64.  (A single step size
    # is a case of tests/test_torch_gpu.py.)
    q, p = dx.get_true_obj()
    scale = torch.tensor([1.0, 1.0, 0.1, 0.1], device=device)
    x0 = x0_batch(1024, 6, torch, device)
    for name, horizon, operands, kernel, plain, n_alpha, width in (
            ('K1', T, fused.k1_operands, fused.fused_ilqr,
             fused.fused_solve_plain, TEAMS_K1_ALPHAS, fused.TEAM),
            ('K3', TEAMS_T, fused.k3_operands, fused.fused_ilqr_long,
             fused.fused_solve_long_plain, TEAMS_K3_ALPHAS,
             fused.k3_launch(TEAMS_T, 1, TEAMS_K3_ALPHAS,
                             lindx=False)['team'])):
        what = f'{name}, pendulum, T={horizon}, {n_alpha} step sizes'
        cfg = mt.MPCConfig(**dict(
            HEADLINE, T=horizon, lqr_iter=3, linesearch_decay=0.5,
            max_linesearch_iter=n_alpha))
        both = [operands(
            cfg, x0.to(dt), mt.QuadCost(torch.diag((q * scale).to(dt)),
                                        p.to(dt)), d, u_lower=-20.0,
            u_upper=20.0) for dt, d in ((torch.float32, dx),
                                        (torch.float64, dx64))]
        (_, _, sk), _ = hold_k1(torch, what, *both, kernel=kernel,
                                plain=plain, limits=None, counts=True)
        # one iteration's count is the difference of two solves that
        # differ by that iteration
        upto = [kernel(**dict(both[0], lqr_iter=i))[2][5] for i in (1, 2)]
        past = torch.stack([upto[1] - upto[0], sk[5] - upto[1]]) > width
        log(f'  iterations 2 and 3: step sizes past the team\'s width '
            f'({width} lanes) in {float(past.any(0).double().mean()):.4f} '
            'of the examples')
        if not bool(past.any()):
            raise AssertionError(f'{what}: no example searched past the '
                                 'team\'s width: the rounds were not '
                                 'exercised')


def bwd_long_operands(torch, device, n=LONG_B, seed=12):
    """K4's operands at the long configuration's solution: x*, u* from
    K3 on n examples, the shared cost and dynamics, the active set, and
    seeded random cotangents."""
    import numpy as np
    from mpc_tpu_torch.ops import fused, fused_bwd
    ops = long_k3_operands(torch, device, n)
    xs, us, _ = fused.fused_ilqr_long(**ops)
    bound = torch.tensor(2.0, device=device)
    rng = np.random.RandomState(seed)
    return dict(C=ops['C'], c=ops['c'], F=ops['F'], x_star=xs, u_star=us,
                dl_dx=torch.tensor(rng.randn(LONG_T, n, 3),
                                   dtype=torch.float32, device=device),
                dl_du=torch.tensor(rng.randn(LONG_T, n, 1),
                                   dtype=torch.float32, device=device),
                I_mask=fused_bwd.active_set(us, -bound, bound))


def bwd_long_case(ops, cost_shared, dyn_shared, has_I=True):
    """The operands of one K4 layout: shared or batched cost, shared or
    batched dynamics, with or without the active set."""
    T, n = ops['u_star'].shape[:2]
    o = bwd_case(ops, cost_shared, has_I)
    if not dyn_shared:
        o['F'] = o['F'].expand(T - 1, n, 3, 4).contiguous()
    return o


def phase_compare_bwd_long(torch, device):
    """K4 against fused_kkt_backward_long_plain on the card, same-primal
    (K3's solution of the long configuration); returns the largest
    |difference|."""
    from mpc_tpu_torch.ops import fused_bwd
    log(f'[compare-bwd-long] K4 vs its plain version at the long '
        f'configuration\'s solution, T={LONG_T}, B={LONG_B}')
    names = BWD_NAMES
    base = bwd_long_operands(torch, device)
    log(f'  active controls: {float(base["I_mask"].mean()):.3f} of T*B')
    max_err = 0.0

    def check(what, o, has_f):
        nonlocal max_err
        kk, err = hold_bwd(torch, 'K4', what,
                           fused_bwd.fused_kkt_backward_long,
                           fused_bwd.fused_kkt_backward_long_plain, o,
                           has_f=has_f)
        if (kk[4] is None) != (not has_f):
            raise AssertionError(f'{what}: df must exist exactly when f does')
        max_err = max(max_err, err)
        return kk

    for cost_shared in (True, False):
        for dyn_shared in (True, False):
            o = bwd_long_case(base, cost_shared, dyn_shared)
            what = (f'{"shared" if cost_shared else "batched"} cost, '
                    f'{"shared" if dyn_shared else "batched"} dynamics')
            kk = check(f'{what}, no f', o, False)
            # batch reversal: no example reads another's data
            back = fused_bwd.fused_kkt_backward_long(**flip_batch(o, torch),
                                                     has_f=False)
            per_example = [(kk[0], back[0].flip(0))]
            if not cost_shared:
                per_example += [(kk[1], back[1].flip(1)),
                                (kk[2], back[2].flip(1))]
            if not dyn_shared:
                per_example += [(kk[3], back[3].flip(1))]
            if not all(torch.equal(a, b) for a, b in per_example):
                raise AssertionError(f'{what}: reversed batch is not '
                                     'bitwise equal')
            log('    reversed batch: bitwise equal on per-example outputs')
            if cost_shared or dyn_shared:
                again = fused_bwd.fused_kkt_backward_long(**o, has_f=True)
                twice = fused_bwd.fused_kkt_backward_long(**o, has_f=True)
                reduced = ([1, 2] if cost_shared else []) + (
                    [3, 4] if dyn_shared else [])
                if not all(torch.equal(again[i], twice[i]) for i in reduced) \
                        or not all(torch.equal(again[i], kk[i])
                                   for i in reduced if kk[i] is not None):
                    raise AssertionError('reduced gradients differ between '
                                         'two launches')
                log('    two launches: reduced '
                    + ', '.join(names[i] for i in reduced)
                    + ' bitwise equal')
    shared = bwd_long_case(base, True, True)
    check('shared cost, shared dynamics, with f', shared, True)
    check('shared cost, shared dynamics, no f, without active set',
          bwd_long_case(base, True, True, has_I=False), False)
    base = bwd_long_operands(torch, device, 2050)
    for shared in (True, False):
        o = bwd_long_case(base, shared, shared)
        what = f'B=2050, {"shared" if shared else "batched"} cost and dynamics'
        hold_bwd_slices(torch, 'K4', what, fused_bwd.fused_kkt_backward_long,
                        o, check(f'{what}, with f', o, True), has_f=True)
    # the state in shared memory up to K4_T_RESIDENT, past it in the
    # workspace in global memory
    for T in (fused_bwd.K4_T_RESIDENT, fused_bwd.K4_T_RESIDENT + 1):
        geo = fused_bwd.k4_launch(T, 2050)
        where = 'shared memory' if geo['resident'] else 'global memory'
        rand = bwd_random_operands(torch, device, T, 2050)
        for shared in (True, False):
            check(f'T={T} (state in {where}), random problem, '
                  f'{"shared" if shared else "batched"} cost and dynamics',
                  bwd_long_case(rand, shared, shared), True)
    phase_tf32(torch, 'long training-step loss and gradients',
               lambda: long_train_grads(torch, device))
    return max_err


def long_theta(torch, device):
    """The long configuration's learnable batch-shared c, starting at
    zero, and the cost it makes."""
    import mpc_tpu_torch as mt
    _, C, _, _ = long_data(torch, device)
    theta = {'c': torch.nn.Parameter(torch.zeros(LONG_T, 4, device=device))}
    return theta, lambda th: mt.QuadCost(C, th['c'])


def long_train_step(torch, device, cfg=None, lr=1e-2):
    """(step, theta, x0, u_expert) of the long configuration's train step
    through make_imitation_train_step: Adam on the learned c."""
    import mpc_tpu_torch as mt
    F, _, x0, u_exp = long_data(torch, device)
    dyn = mt.LinDx(F, None)
    theta, make_cost = long_theta(torch, device)
    step = mt.make_imitation_train_step(
        cfg or mt.MPCConfig(**LONG), torch.optim.Adam(theta.values(), lr=lr),
        make_cost, lambda th: dyn, u_lower=-2.0, u_upper=2.0, device=device)
    return step, theta, x0, u_exp


def long_train_grads(torch, device):
    import mpc_tpu_torch as mt
    F, _, x0, u_exp = long_data(torch, device)
    theta, make_cost = long_theta(torch, device)
    loss = mt.imitation_loss(theta, mt.MPCConfig(**LONG), x0, u_exp,
                             make_cost, lambda th: mt.LinDx(F, None),
                             u_lower=-2.0, u_upper=2.0, device=device)
    loss.backward()
    return [loss.detach(), theta['c'].grad]


def phase_serve_long(torch, device, n_requests=4):
    """The serving half of the long configuration: distinct B=4096
    forward requests (backprop=False), host to host, through
    batched_solve; returns the K3 launches counted in this phase."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    cfg, x0, cost, dyn, _ = long_problem(torch, device, backprop=False)
    requests = [torch.tensor(np.random.RandomState(200 + i).randn(LONG_B, 3),
                             dtype=torch.float32)
                for i in range(n_requests)]
    mt.batched_solve(cfg, x0, cost, dyn, u_lower=-2.0, u_upper=2.0,
                     device=device).u.cpu()          # warm-up
    fused.reset_launch_counts()
    lat = []
    for req in requests:
        t0 = time.perf_counter()
        x0 = req.to(device)
        sol = mt.batched_solve(cfg, x0, cost, dyn, u_lower=-2.0, u_upper=2.0,
                               device=device)
        u = sol.u.cpu()
        lat.append(time.perf_counter() - t0)
    launches = fused.launch_counts['fused_ilqr_long']
    log(f'[serve-long] {len(requests)} requests of B={LONG_B}, T={LONG_T}: '
        'latency ms ' + ' '.join(f'{1e3 * v:.3f}' for v in lat)
        + f'; median {1e3 * sorted(lat)[len(lat) // 2]:.3f} ms, '
        f'{LONG_B * len(lat) / sum(lat):.0f} solves/s, K3 launches '
        f'{launches}, K1 launches {fused.launch_counts["fused_ilqr"]}')
    if launches != len(requests) or fused.launch_counts['fused_ilqr']:
        raise AssertionError('each served request must launch K3 once and '
                             'K1 not at all')
    # the last answer holds up: its states are the rollout of its
    # controls and its costs are their objective
    xr = rollout(dyn, x0, u.to(device))
    cr = trajectory_cost(cost, xr, u.to(device))
    gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
    x_gap = float((xr - sol.x).abs().max())
    log(f'  last answer: relative cost gap to its own rollout {gap:.2e}, '
        f'max |x - rollout| {x_gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0
            and gap < 1e-3 and x_gap < 1e-3):
        raise AssertionError('served controls are not a feasible solve')
    return launches


def phase_train_long(torch, device, steps=20, warmup=3):
    """The long configuration's train step: median step time over
    ``steps`` host-timed, synchronised steps after warm-up.  Each step
    must launch K3 and K4 exactly once and K1, K2 not at all.  Returns
    the K3 and K4 launches, with the counts set to 0 just before the
    timed steps and read just after."""
    from mpc_tpu_torch.ops import fused, fused_bwd
    step, theta, x0, u_exp = long_train_step(torch, device)
    first = float(step(theta, x0, u_exp))
    for _ in range(warmup - 1):
        step(theta, x0, u_exp)
    sync(torch, device)
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    lat, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step(theta, x0, u_exp)
        sync(torch, device)
        lat.append(time.perf_counter() - t0)
        losses.append(float(loss))
        counts = dict(fused.launch_counts, **fused_bwd.launch_counts)
        if device.type == 'cuda' and counts != {
                'fused_ilqr': 0, 'fused_kkt_bwd': 0, 'fused_ilqr_dense': 0,
                'fused_kkt_bwd_dense': 0, 'fused_ilqr_long': i + 1,
                'fused_kkt_bwd_long': i + 1}:
            raise AssertionError('a long train step must launch K3 and K4 '
                                 f'once each and K1, K2 never: {counts}')
    k3 = fused.launch_counts['fused_ilqr_long']
    k4 = fused_bwd.launch_counts['fused_kkt_bwd_long']
    med = sorted(lat)[len(lat) // 2]
    log(f'[train-long] B={LONG_B}, T={LONG_T}: {steps} steps of Adam(1e-2) '
        f'on c, median {1e3 * med:.3f} ms ({min(lat) * 1e3:.3f}-'
        f'{max(lat) * 1e3:.3f}), {LONG_B / med:.0f} examples/s; K3 launches '
        f'{k3}, K4 launches {k4}, K1 and K2 none; loss first {first:.5f}, '
        f'after {warmup + steps} steps {losses[-1]:.5f} (lowest '
        f'{min(losses):.5f})')
    if not all(math.isfinite(v) for v in [first] + losses):
        raise AssertionError('the long training loss is not finite')
    return k3, k4


def phase_learn_long(torch, device, n=1024):
    """A learner on the long path: the expert solves the long problem
    with c = LEARN_LONG_C at every step, the learner starts from c = 0
    and must cut the imitation loss.  The solves run LEARN_LONG_ITER
    iterations, enough to converge, so that the fixed point's gradient
    is the loss's (the configuration's own 4 iterations stop mid-way,
    and its loss is then no smooth function of c)."""
    import mpc_tpu_torch as mt
    cfg, x0, cost, dyn, _ = long_problem(torch, device, n,
                                         lqr_iter=LEARN_LONG_ITER)
    c_true = torch.tensor(LEARN_LONG_C, device=device).expand(LONG_T, 4)
    with torch.no_grad():
        u_exp = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c_true), dyn,
                                 u_lower=-2.0, u_upper=2.0, device=device).u
    step, theta, _, _ = long_train_step(torch, device, cfg)
    losses = [float(step(theta, x0, u_exp)) for _ in range(LEARN_LONG_STEPS)]
    ratio = min(losses) / losses[0]
    log(f'[learn-long] B={n}, T={LONG_T}, lqr_iter={LEARN_LONG_ITER}, '
        f'{LEARN_LONG_STEPS} steps of Adam(1e-2): loss '
        + ' '.join(f'{v:.4g}' for v in losses[::2])
        + f'; best / first {ratio:.4f} (threshold {LEARN_LONG_MAX_RATIO})')
    if not (all(math.isfinite(v) for v in losses)
            and ratio < LEARN_LONG_MAX_RATIO):
        raise AssertionError('the long learner did not cut its loss')
    return losses


def phase_time_long(torch, device):
    """K3 at the long configuration's full size timed from a CUDA graph,
    its bound from this run's iterations and trial rollouts, and the
    plain version on the card."""
    from mpc_tpu_torch.ops import fused
    ops = long_k3_operands(torch, device)
    _, _, stats = fused.fused_ilqr_long(**ops)
    ms, eager_ms = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops),
                            reps=5, per_graph=4)
    plain_ms = event_ms(torch, lambda: fused.fused_solve_long_plain(**ops))
    n_it = float(stats[2].double().sum())
    n_trials = float(stats[5].double().sum())
    flops = fused.k3_flops(LONG_T, 3, 1, n_it, n_trials, batch=LONG_B,
                           lindx=True, has_f=False)
    nbytes = fused.k3_bytes(ops)
    bound_ms, by = bound(flops, nbytes)
    log(f'[time-long] K3 B={LONG_B}, T={LONG_T}: {ms:.4f} ms (from a CUDA '
        f'graph; {eager_ms:.4f} ms a call from Python), plain '
        f'{plain_ms:.2f} ms; {flops:.4e} operations ({n_it / LONG_B:.2f} '
        f'iterations, {n_trials / LONG_B:.2f} trials/solve), {nbytes} '
        f'bytes; bound {bound_ms:.5f} ms by {by}; '
        f'{LONG_B / ms * 1e3:.0f} solves/s')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def kernel_device_us(torch, launch, n=20):
    """The device time one call of ``launch`` spends in each CUDA kernel,
    by the kernel's name (us), from torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / n for e in prof.key_averages()
            if e.device_time_total > 0}


def phase_time_bwd_long(torch, device):
    """K4 (shared cost, shared dynamics, no f, with the active set, as
    on the long training path) timed from a CUDA graph, its main kernel
    and its block-order sums apart (torch.profiler), its bound, and the
    plain version on the card."""
    from mpc_tpu_torch.ops import fused_bwd
    o = bwd_long_operands(torch, device)

    def launch():
        return fused_bwd.fused_kkt_backward_long(**o, has_f=False)
    ms, eager_ms = graph_ms(torch, launch, reps=5, per_graph=4)
    split = kernel_device_us(torch, launch)
    main_ms = sum(v for k, v in split.items() if 'kkt_bwd_kernel' in k) / 1e3
    sums_ms = sum(v for k, v in split.items()
                  if 'reduce_partials' in k) / 1e3
    plain_ms = event_ms(
        torch,
        lambda: fused_bwd.fused_kkt_backward_long_plain(**o, has_f=False))
    flops = fused_bwd.k4_flops(LONG_T, LONG_B, True, True, has_f=False)
    nbytes = fused_bwd.k4_bytes(o['C'], o['c'], o['F'], o['x_star'],
                                o['I_mask'], has_f=False)
    bound_ms, by = bound(flops, nbytes)
    log(f'[time-bwd-long] K4 B={LONG_B}, T={LONG_T}: {ms:.4f} ms (from a '
        f'CUDA graph; {eager_ms:.4f} ms a call from Python; main kernel '
        f'{main_ms:.4f} ms, block-order sums {sums_ms:.4f} ms from '
        f'torch.profiler), plain {plain_ms:.2f} ms; {flops:.4e} operations, '
        f'{nbytes} bytes; bound {bound_ms:.5f} ms by {by}')
    return dict(ms=ms, main_ms=main_ms, sums_ms=sums_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


# ---------------------------------------------------------------------------
# the learned-dynamics path: the reference's default MLP through K3's
# streamed-weights configuration (MPC_DYN=2) and K2
# ---------------------------------------------------------------------------

# the JAX package's learned-dynamics row (benchmarks/configs.py:647-678,
# bench_nn_dynamics): NNDynamics with the reference's default
# hidden_sizes=[100] (mpc/dynamics.py:9-13), sigmoid, passthrough, the
# pendulum's swing-up cost, box +-2, nothing cut
NN_B, NN_T, NN_H = 2048, 20, 100
NN = dict(n_state=3, n_ctrl=1, T=NN_T, lqr_iter=10, eps=0.0,
          exit_unconverged=False, detach_unconverged=False, backprop=False,
          linesearch_decay=0.2, max_linesearch_iter=3)
# the gradient phase's batch and its learner's target scale
NN_GRAD_B = 1024
# [compare-nn]'s rows whose example slots are in the workspace
# (fused.k3_nn_launch): past the horizon a block of 100 units holds while
# an SM keeps its 4 blocks (99 steps), and a width past the units a lane
# keeps in registers whose weights alone fill the block (the gate is
# 7263); each (T, H, B, lqr_iter), sigmoid, box +-2
NN_WORKSPACE_ROWS = ((430, NN_H, 256, 4), (NN_T, 7000, 256, 4))


def nn_problem(torch, device, n=NN_B, act='sigmoid', dtype=None, seed=4,
               hidden=NN_H, **cfg_kw):
    """(cfg, x0 [n, 3], cost, model) of bench_nn_dynamics: the MLP drawn
    in float32 from a seeded generator (cast for float64, so both
    precisions solve one problem), pendulum starts from RandomState(seed)
    and the swing-up cost."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PendulumDx
    dtype = dtype or torch.float32
    model = mt.NNDynamics.init(3, 1, (hidden,), act,
                               generator=torch.Generator().manual_seed(0),
                               device=device).to(dtype)
    rng = np.random.RandomState(seed)
    th = np.pi * (2 * rng.rand(n) - 1)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1),
                      dtype=dtype, device=device)
    q, p = PendulumDx(device=device, dtype=dtype).get_true_obj()
    cfg = mt.MPCConfig(**dict(NN, grad_method=mt.GradMethods.AUTO_DIFF,
                              **cfg_kw))
    return cfg, x0, mt.QuadCost(torch.diag(q), p), model


def nn_k3_operands(torch, device, n=NN_B, act='sigmoid', dtype=None,
                   bounded=True, seed=4, hidden=NN_H, **cfg_kw):
    from mpc_tpu_torch.ops import fused
    cfg, x0, cost, model = nn_problem(torch, device, n, act, dtype, seed,
                                      hidden, **cfg_kw)
    lim = dict(u_lower=-2.0, u_upper=2.0) if bounded else {}
    return fused.k3_operands(cfg, x0, cost, model, **lim)


def phase_compare_nn(torch, device):
    """K3's MLP configuration against its plain version at the full size
    of bench_nn_dynamics: the float32 tail, the float64 plain run, the
    reversed batch, and B = 1, 7, 33 and 2048 alone against the same
    examples inside a batch of 2050, bitwise; then relu without bounds
    at B=1024 and the NN_WORKSPACE_ROWS rows (the example's slots in the
    workspace), each judged against the float64 plain run, reversed
    bitwise; then the cost and mask builds (HUBER_ROWS' and UZ_ROWS'
    'MLP', held against their plain versions in [compare-huber] and
    [compare-uz]) reversed and at B=2050 sliced, bitwise.  Returns max
    |du| of the bench problem and the plain version's ms there."""
    from mpc_tpu_torch.ops import fused
    long_kw = dict(kernel=fused.fused_ilqr_long,
                   plain=fused.fused_solve_long_plain)
    log(f'[compare-nn] K3 MLP (sigmoid, H={NN_H}) vs its plain version, '
        f'B={NN_B}, T={NN_T}, lqr_iter=10, box +-2')
    ops = nn_k3_operands(torch, device)
    plain_ms = event_ms(torch, lambda: fused.fused_solve_long_plain(**ops))
    (xk, uk, sk), mx = hold_k1(
        torch, 'K3 MLP vs plain', ops,
        nn_k3_operands(torch, device, dtype=torch.float64), **long_kw)
    on_box = float((uk.abs() >= 2.0).double().mean())
    log(f'  controls on a bound: {on_box:.3f} of T*B; selected index + 1 a '
        f'solve {float(sk[5].mean()):.2f}; plain version {plain_ms:.1f} ms')
    # B=2050: 512 full blocks and 2 examples; its first 2048 are the
    # bench batch
    wide = nn_k3_operands(torch, device, NN_B + 2)
    hold_slices(torch, 'K3 MLP, B=2050', fused.fused_ilqr_long, wide,
                fused.fused_ilqr_long(**wide), sizes=(1, 7, 33, NN_B))
    log(f'[compare-nn] K3 MLP (relu, no bounds) vs its plain version, '
        f'B=1024: judged against the float64 plain run')
    relu = nn_k3_operands(torch, device, 1024, 'relu', bounded=False)
    (_, ur, _), _ = hold_k1(
        torch, 'K3 MLP relu vs plain', relu,
        nn_k3_operands(torch, device, 1024, 'relu', torch.float64,
                       bounded=False), limits=None, **long_kw)
    log(f'  largest |u| {float(ur.abs().max()):.3e}')
    for T_, H, n, iters in NN_WORKSPACE_ROWS:
        geo = fused.k3_launch(T_, n, 3, H)
        log(f'[compare-nn] K3 MLP (sigmoid, H={H}), B={n}, T={T_}, '
            f'lqr_iter={iters}: the example\'s slots in the workspace '
            f'({geo["workspace_bytes"]} bytes; {geo["smem_bytes"]} bytes of '
            'shared memory a block), judged against the float64 plain run')
        if geo['slots'] == 0:
            raise AssertionError('the row\'s slots are resident')
        kw = dict(hidden=H, T=T_, lqr_iter=iters)
        hold_k1(torch, f'K3 MLP H={H}, T={T_} vs plain',
                nn_k3_operands(torch, device, n, **kw),
                nn_k3_operands(torch, device, n, dtype=torch.float64, **kw),
                limits=None, **long_kw)
    for what, o in (('cost', huber_operands(torch, device, 'MLP')[0]),
                    ('mask', uz_operands(torch, device, 'MLP')[0])):
        full = fused.fused_ilqr_long(**o)
        r = fused.fused_ilqr_long(**batch_subset(
            torch, o, torch.arange(NN_B - 1, -1, -1)))
        if not all(torch.equal(a.flip(1), b) for a, b in zip(r, full)):
            raise AssertionError(f'K3 MLP {what} build: reversed batch is '
                                 'not bitwise equal')
        log(f'[compare-nn] K3 MLP {what} build, B={NN_B}: reversed batch '
            'bitwise equal')
        # B=2050, the mask build with the row's shared mask
        o2 = huber_operands(torch, device, 'MLP', n=NN_B + 2)[0] \
            if what == 'cost' else dict(
                nn_k3_operands(torch, device, NN_B + 2), uz=o['uz'])
        hold_slices(torch, f'K3 MLP {what} build, B={NN_B + 2}',
                    fused.fused_ilqr_long, o2, fused.fused_ilqr_long(**o2),
                    sizes=(1, 33, NN_B))
    return mx, plain_ms


def phase_serve_nn(torch, device, n_requests=8):
    """Requests of bench_nn_dynamics through batched_solve under the
    default 'auto': host to host, each launching K3 once and nothing
    else; returns the K3 launches and the median request ms."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    cfg, x0, cost, model = nn_problem(torch, device)
    requests = []
    for i in range(n_requests):
        th = np.pi * (2 * np.random.RandomState(300 + i).rand(NN_B) - 1)
        requests.append(torch.tensor(
            np.stack([np.cos(th), np.sin(th), np.zeros(NN_B)], 1),
            dtype=torch.float32))
    kw = dict(u_lower=-2.0, u_upper=2.0, device=device)
    mt.batched_solve(cfg, x0, cost, model, **kw).u.cpu()      # warm-up
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    lat = []
    for req in requests:
        t0 = time.perf_counter()
        x = req.to(device)
        sol = mt.batched_solve(cfg, x, cost, model, **kw)
        u = sol.u.cpu()
        lat.append(time.perf_counter() - t0)
    launches = fused.launch_counts['fused_ilqr_long']
    med = sorted(lat)[len(lat) // 2]
    log(f'[serve-nn] {n_requests} requests of B={NN_B}, T={NN_T}, MLP '
        f'H={NN_H}: latency ms ' + ' '.join(f'{1e3 * v:.3f}' for v in lat)
        + f'; median {1e3 * med:.3f} ms, {NN_B / med:.0f} solves/s; K3 '
        f'launches {launches}, K1 {fused.launch_counts["fused_ilqr"]}, '
        f'eager solves {solver.eager_counts["eager_solve"]}; {card_line()}')
    if (launches != n_requests or fused.launch_counts['fused_ilqr']
            or solver.eager_counts['eager_solve']):
        raise AssertionError('each request must launch K3 once and nothing '
                             'else')
    with torch.no_grad():
        xr = rollout(model, x, u.to(device))
        cr = trajectory_cost(cost, xr, u.to(device))
    gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
    log(f'  last answer: relative cost gap to its own rollout {gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0 and gap < 1e-3):
        raise AssertionError('served controls are not a feasible solve')
    return launches, 1e3 * med


def phase_time_nn(torch, device, plain_ms):
    """K3's MLP build at the full size from a CUDA graph against its
    bound, with its launch geometry (fused.k3_nn_launch: a warp an
    example), registers, spills, blocks an SM and waves."""
    from mpc_tpu_torch.ops import fused
    ops = nn_k3_operands(torch, device)
    ref = fused.fused_ilqr_long(**ops)
    if not all(torch.equal(a, b) for a, b in
               zip(ref, fused.fused_ilqr_long(**ops))):
        raise AssertionError('K3 MLP: two launches differ')
    stats = ref[2]
    n_it = float(stats[2].double().sum())
    n_trials = float(stats[5].double().sum())
    flops = fused.k3_flops(NN_T, 3, 1, n_it, n_trials, batch=NN_B,
                           lindx=False,
                           nn_ops=fused.nn_op_counts(NN_H, 'sigmoid', True))
    nbytes = fused.k3_bytes(ops)
    bound_ms, by = bound(flops, nbytes)
    ms, eager_ms = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops),
                            reps=5, per_graph=4)
    geo = nn_defines(ops)[1]
    log(f'[time-nn] K3 MLP B={NN_B}, T={NN_T}, H={NN_H}: {ms:.4f} ms (from '
        f'a CUDA graph; {eager_ms:.4f} ms a call from Python); a warp an '
        f'example, {nn_residency(torch, ops)}; {flops:.4e} operations '
        f'({n_it / NN_B:.2f} iterations, {n_trials / NN_B:.2f} trials/solve), '
        f'{nbytes} bytes; bound {bound_ms:.5f} ms by {by} '
        f'({ms / bound_ms:.1f}x); plain {plain_ms:.1f} ms; '
        f'{NN_B / ms * 1e3:.0f} solves/s; {card_line()}')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                blocks=geo['blocks'], warps_a_block=geo['warps'])


def nn_imitation(torch, device, n, primal=None):
    """An imitation loss of bench_nn_dynamics at B=n with gradients to the
    MLP's weights, x_init, C and c: through the kernels (K3, then K2), or,
    given the Solution ``primal`` of the kernels' phase 1, through the
    eager fixed point on it.  Returns the loss and the gradients, and the
    kernels' Solution."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    cfg, x0, cost, model = nn_problem(torch, device, n, backprop=True)
    x0 = x0.requires_grad_()
    C, c = (a.clone().requires_grad_() for a in cost)
    u_exp = torch.tensor(0.5 * np.random.RandomState(7).randn(NN_T, n, 1),
                         dtype=torch.float32, device=device)
    lb = torch.tensor(-2.0, device=device)
    sol = None
    if primal is None:
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(C, c), model,
                               u_lower=-2.0, u_upper=2.0, device=device)
        x, u = sol.x, sol.u
    else:
        x, u = solver.fixed_point_phase(cfg, x0, mt.QuadCost(C, c), model,
                                        primal.x, primal.u, lb, -lb,
                                        primal.converged)
    loss = ((u - u_exp) ** 2).mean() + 0.1 * (x ** 2).mean()
    loss.backward()
    grads = [p.grad for p in model.parameters()] + [x0.grad, C.grad, c.grad]
    return [loss.detach()] + grads, sol


def nn_bwd_operands(torch, device, sol, n=NN_GRAD_B, seed=13):
    """K2's operands on the MLP's path: the solution ``sol`` of K3, the
    shared cost, the MLP's per-example linearisation there, the active
    set and seeded random cotangents."""
    import numpy as np
    from mpc_tpu_torch.ops import fused_bwd
    from mpc_tpu_torch.solver import linearize_dynamics
    cfg, _, cost, model = nn_problem(torch, device, n)
    with torch.no_grad():
        F, _ = linearize_dynamics(model, sol.x, sol.u, cfg.grad_method)
    bound = torch.tensor(2.0, device=device)
    rng = np.random.RandomState(seed)
    return dict(C=cost.C.expand(NN_T, 1, 4, 4).contiguous(),
                c=cost.c.expand(NN_T, 1, 4).contiguous(),
                F=F.contiguous(), x_star=sol.x.detach().contiguous(),
                u_star=sol.u.detach().contiguous(),
                dl_dx=torch.tensor(rng.randn(NN_T, n, 3),
                                   dtype=torch.float32, device=device),
                dl_du=torch.tensor(rng.randn(NN_T, n, 1),
                                   dtype=torch.float32, device=device),
                I_mask=fused_bwd.active_set(sol.u.detach(), -bound, bound))


def phase_grad_nn(torch, device, n=NN_GRAD_B):
    """Gradients of an imitation loss to the MLP's weights, x_init, C and
    c through K3 and K2, against the eager fixed point on the same primal
    (BWD_TOL relative to each gradient's largest entry), and with TF32
    on and off (bitwise); K2 on this path's operands against its plain
    version (``hold_bwd``) and timed from a CUDA graph against its
    bound.  Returns the K3 and K2 launches of one differentiable solve,
    the largest gradient error and K2's entry."""
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused, fused_bwd
    log(f'[grad-nn] bench_nn_dynamics, B={n}, T={NN_T}: gradients through '
        'K3 and K2 vs the eager fixed point on the same primal')
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()
    solver.reset_eager_counts()
    kk, sol = nn_imitation(torch, device, n)
    k3 = fused.launch_counts['fused_ilqr_long']
    k2 = fused_bwd.launch_counts['fused_kkt_bwd']
    if (k3, k2, fused.launch_counts['fused_ilqr'],
            fused_bwd.launch_counts['fused_kkt_bwd_long'],
            solver.eager_counts['eager_solve'],
            solver.eager_counts['eager_fixed_point']) != (1, 1, 0, 0, 0, 0):
        raise AssertionError('a differentiable MLP solve must launch K3 and '
                             'K2 once each and nothing else')
    ref, _ = nn_imitation(torch, device, n, sol._replace(
        x=sol.x.detach(), u=sol.u.detach()))
    err = 0.0
    for name, g, r in zip(('W1', 'b1', 'W2', 'b2', 'x_init', 'C', 'c'),
                          kk[1:], ref[1:]):
        e = rel_err(g, r)
        err = max(err, e)
        log(f'  {name}: max |K2 route - eager| / max |eager| {e:.3e}')
    if not (err < BWD_TOL and all(torch.isfinite(g).all() for g in kk[1:])
            and float(kk[1].abs().max()) > 0):
        raise AssertionError('MLP gradients through K2 are off the eager '
                             'fixed point')
    phase_tf32(torch, 'MLP loss and gradients through K3 and K2',
               lambda: nn_imitation(torch, device, n)[0])
    o = nn_bwd_operands(torch, device, sol, n)
    log(f'[grad-nn] K2 vs its plain version on the MLP\'s linearisation, '
        f'B={n}: active controls {float(o["I_mask"].mean()):.3f} of T*B')
    _, k2_err = hold_bwd(torch, 'K2', 'MLP path', fused_bwd.fused_kkt_backward,
                         fused_bwd.fused_kkt_backward_plain, o)
    ms, eager_ms = graph_ms(torch, lambda: fused_bwd.fused_kkt_backward(**o))
    plain_ms = event_ms(torch,
                        lambda: fused_bwd.fused_kkt_backward_plain(**o))
    flops = fused_bwd.k2_flops(NN_T, n, True)
    nbytes = fused_bwd.k2_bytes(o['C'], o['c'], o['F'], o['x_star'],
                                o['I_mask'])
    bound_ms, by = bound(flops, nbytes)
    log(f'[grad-nn] K2 B={n}, T={NN_T}: {ms:.4f} ms (from a CUDA graph; '
        f'{eager_ms:.4f} ms a call from Python), plain {plain_ms:.2f} ms; '
        f'{flops:.4e} operations, {nbytes} bytes; bound {bound_ms:.5f} ms '
        f'by {by}')
    return k3, k2, err, dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=by)


def phase_eager_nn(torch, device, records, k3_ms, reps=3):
    """bench_nn_dynamics through the eager solver (use_fused='never') on
    the card in this process: ms a solve and the kernels' speed-up over
    it (their median request, host to host, in [serve-nn]), and K3 held
    within the float32 tail of it."""
    import dataclasses
    import mpc_tpu_torch as mt
    log(f'[eager-nn] bench_nn_dynamics B={NN_B}, T={NN_T}: the eager solver '
        'vs K3')
    cfg, x0, cost, model = nn_problem(torch, device, use_fused='never')
    kw = dict(u_lower=-2.0, u_upper=2.0, device=device)
    (runs, ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(cfg, x0, cost, model, **kw),
        reps))
    cfg_k = dataclasses.replace(cfg, use_fused='auto')
    uk = mt.batched_solve(cfg_k, x0, cost, model, **kw).u
    mx = check_tail('K3 vs eager (f32)', uk, runs[-1].u)
    log(f'  {n_eager} eager solves, median {ms:.1f} ms ({NN_B / ms * 1e3:.0f} '
        f'solves/s); K3 request {k3_ms:.3f} ms: {ms / k3_ms:.0f}x; '
        f'{card_line()}')
    eager_record(records, 'eager-nn', f'bench_nn_dynamics, MLP H={NN_H}, '
                 f'B={NN_B}, T={NN_T}, float32', n_eager, mx,
                 'K3 on the same problem', 'f32 tail as K1', ms)


def phase_eager_models(torch, device, records, n=512):
    """An affine model and the pseudo-Huber cost through the eager solver
    on the card in float64, held against the CPU's float64 where the
    decisions match (``hold_tied``)."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.utils.convert import (affine_from_numpy,
                                             pseudo_huber_from_numpy)
    rng = np.random.RandomState(9)
    A = np.eye(3) + 0.1 * rng.randn(3, 3)
    Bm, cA = 0.2 * rng.randn(3, 2), 0.1 * rng.randn(3)
    xa = rng.randn(n, 3)
    Ca = np.tile(np.diag([1., 0.5, 0.3, 0.1, 0.2]), (10, 1, 1))
    ca = 0.2 * rng.randn(10, n, 5)
    th = np.pi * (2 * rng.rand(n) - 1)
    xp = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)
    base = dict(lqr_iter=10, exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=4,
                use_fused='never')
    cases = [
        ('affine, 2 controls, box +-0.4', mt.MPCConfig(3, 2, 10, eps=1e-10,
                                                       **base),
         lambda dev: (torch.tensor(xa, device=dev),
                      mt.QuadCost(torch.tensor(Ca, device=dev),
                                  torch.tensor(ca, device=dev)),
                      affine_from_numpy(A, Bm, cA, device=dev)), 0.4),
        ('pendulum with the pseudo-Huber cost, box +-2',
         mt.MPCConfig(3, 1, 20, eps=1e-3,
                      grad_method=mt.GradMethods.AUTO_DIFF, **base),
         lambda dev: (torch.tensor(xp, device=dev),
                      pseudo_huber_from_numpy(np.array([1., 1., 0.1, 0.01]),
                                              np.array([1., 0., 0., 0.]), 0.5,
                                              device=dev),
                      mt.models.PendulumDx(params=torch.tensor(
                          [10., 1., 1.], dtype=torch.float64), device=dev)),
         2.0)]
    for what, cfg, make, lim in cases:
        log(f'[eager-models] {what}, B={n}, T={cfg.T}: card f64 vs CPU f64')
        runs = []
        for dev in (device, torch.device('cpu')):
            x, cost, dyn = make(dev)
            trace = []
            solver.reset_eager_counts()
            t0 = time.perf_counter()
            sol = solver.eager_batched_solve(cfg, x, cost, dyn, u_lower=-lim,
                                             u_upper=lim, trace=trace)
            sync(torch, device)
            runs.append((sol, trace, 1e3 * (time.perf_counter() - t0),
                         solver.eager_counts['eager_solve']))
        (sk, tk, ms, n_eager), (sc, tc, _, _) = runs
        _, err, tied = hold_tied(torch, 'card vs CPU', sk, tk, sc, tc)
        log(f'  {float((sk.u.abs() == lim).double().mean()):.3f} of the '
            f'controls on the box; the card {ms:.1f} ms a solve')
        eager_record(records, 'eager-models', f'{what}, B={n}, T={cfg.T}, '
                     'float64', n_eager, err, 'the same on the CPU (examples '
                     'whose decisions match)', f'{EAGER_F64_TOL} relative',
                     ms)


# ---------------------------------------------------------------------------
# the eager solver ([eager-*]): every problem the kernels do not take
# ---------------------------------------------------------------------------

# the JAX package's own configurations that take its jnp path
# (benchmarks/configs.py): config 1, TVLQR (49-105); the medium-state jnp
# row, 24 states and 4 controls (107-171); config 3, the cartpole
# (173-202); the sequential arm of the long-horizon solve (596-644)
TVLQR = dict(n_state=3, n_ctrl=4, T=5, lqr_iter=10, eps=0.0,
             exit_unconverged=False, detach_unconverged=False,
             backprop=False, use_fused='never')
TVLQR_B = 128
MEDIUM = dict(n_state=24, n_ctrl=4, T=20, lqr_iter=10, eps=0.0,
              exit_unconverged=False, detach_unconverged=False,
              backprop=False, use_fused='never')
MEDIUM_B = 2048
CARTPOLE = dict(n_state=5, n_ctrl=1, T=25, lqr_iter=10, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.5, max_linesearch_iter=2,
                use_fused='never')
CARTPOLE_B = 512
LONG_EAGER = dict(n_state=3, n_ctrl=1, T=512, lqr_iter=5, eps=0.0,
                  exit_unconverged=False, detach_unconverged=False,
                  backprop=False, linesearch_decay=0.2, max_linesearch_iter=3,
                  parallel_riccati=False, use_fused='never')
LONG_EAGER_B = 16
# the card's float64 against the CPU's float64 on the same examples,
# relative to the largest |u| (and to each gradient's largest entry):
# the two differ only in the order of their sums (and libm).  Where an
# iterate is close to converged, a line search's trial cost can equal the
# current one to round-off, and PNQP's free set can hang on a gradient
# at a bound that is zero to round-off; two runs then rightly take
# different step sizes or Newton counts there, and their controls part
# by up to that step.  So the tolerance holds the examples whose
# decisions (the eager trace: active, alpha and n_qp at every iteration)
# are equal on both, and the examples that part are shown, held to
# costs equal within TIE_COST_TOL (the flat cost of a tie) and to a
# share below PARTED_SHARE.  The CPU against itself with the states and
# controls permuted (the same problem, other sums) is the witness, run
# beside the check (a CPU rehearsal at B=1024: 1.6% and 0.8% of the
# examples part, at iterations 2-4, the rest within 5.2e-15; the card's
# readings in PERF.md section 6).
EAGER_F64_TOL = 1e-10
EAGER_CPU_B = 256          # the headline's slice solved on the CPU too
TIE_COST_TOL = 1e-12
PARTED_SHARE = 0.05
# an unconstrained float32 solve against the float64 one (TVLQR) and
# against the dense QP, relative to the largest |u| (CPU rehearsal at
# B=128: 2.6e-6)
TVLQR_F32_TOL = 1e-3
# the pendulum at T=512 after 5 iterations is far from converged (step
# norms 3-80) and its open-loop rollout is chaotic: float32 and float64
# controls part (a CPU rehearsal at B=16: mean |du| 1e-3, max 0.75), so
# the two are held by the costs each reaches, relative to the float64
# one (the rehearsal: 1.1e-2; on an H100 2.005e-2)
LONG_COST_GAP = 0.05
# the same at T=512, card f64 against CPU f64: no decision parts, but each
# of 512 steps of an unconverged open-loop rollout adds its last-bit
# differences.  The CPU against itself with one ulp added to every
# step's state (the witness, in the phase) moves u by 1.1e-10 and the
# costs by 4.7e-12 (a CPU rehearsal); one ulp on x0 alone moves u by
# 1.5e-13.
LONG_F64_TOL = 1e-9
LONG_F64_COST_TOL = 1e-10


def eager_record(records, phase, config, solves, err, reference, tolerance,
                 ms):
    records.append({'phase': phase, 'config': config, 'route': 'eager',
                    'eager_solves': solves, 'max_err': err,
                    'reference': reference, 'tolerance': tolerance,
                    'median_ms': ms})


def rel_err(a, ref):
    ref = ref.double().cpu()
    return float((a.double().cpu() - ref).abs().max() / ref.abs().max())


def timed(torch, device, fn, reps):
    """``fn()`` ``reps`` times, each ending in a synchronise: the results
    and the median host time in ms."""
    out, ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        out.append(fn())
        sync(torch, device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, sorted(ms)[len(ms) // 2]


def same_bits(what, torch, pairs):
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f'{what}: not bitwise equal')
    log(f'  {what}: bitwise equal')


def eager_counted(torch, fn):
    """``fn()`` with the eager counts and the kernels' launch counts set
    to 0 just before and read just after: (result, eager solves)."""
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused
    solver.reset_eager_counts()
    fused.reset_launch_counts()
    out = fn()
    if any(fused.launch_counts.values()):
        raise AssertionError('an eager solve launched a kernel')
    return out, solver.eager_counts['eager_solve']


def phase_eager_serve(torch, device, records, reps=3):
    """The headline with use_fused='never' against K1 (the eager half of
    the same-process A/B) and both against a float64 eager run."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    log(f'[eager-serve] headline B={B}, T={T}: eager solver vs K1')
    dx, cost = problem(torch, device)
    dx64, cost64 = problem(torch, device, torch.float64)
    x0 = x0_batch(B, 0, torch, device)
    kw = dict(u_lower=-2.0, u_upper=2.0, device=device)
    eager_cfg = mt.MPCConfig(**dict(HEADLINE, use_fused='never'))
    (runs, eager_ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(eager_cfg, x0, cost, dx, **kw),
        reps))
    ue = runs[-1].u
    fused.reset_launch_counts()
    k1, k1_ms = timed(torch, device, lambda: mt.batched_solve(
        mt.MPCConfig(**HEADLINE), x0, cost, dx, **kw), 2 * reps)
    if device.type == 'cuda' and fused.launch_counts['fused_ilqr'] != 2 * reps:
        raise AssertionError('the kernel route did not launch K1')
    uk = k1[-1].u
    u64 = mt.batched_solve(mt.MPCConfig(**dict(HEADLINE, use_fused='never')),
                           x0.double(), cost64, dx64, **kw).u
    err = check_tail('eager f32 vs K1', ue, uk)
    check_tail('eager f32 vs eager f64', ue, u64)
    check_tail('K1 vs eager f64', uk, u64)
    # the card's float64 against the CPU's, both eager, on a slice
    from mpc_tpu_torch import solver
    cpu, k = torch.device('cpu'), EAGER_CPU_B
    traced = []
    for dev in (device, cpu):
        dxd, costd = problem(torch, dev, torch.float64)
        tr = []
        traced += [solver.eager_batched_solve(
            eager_cfg, x0[:k].double().to(dev), costd, dxd, trace=tr,
            u_lower=-2.0, u_upper=2.0), tr]
    _, e64, _ = hold_tied(torch, f'card f64 vs CPU f64, B={k}', *traced)
    log(f'  {card_line()}: median host ms, eager {eager_ms:.3f} '
        f'({B / eager_ms * 1e3:.0f} solves/s, {n_eager} eager solves), '
        f'K1 {k1_ms:.3f} ({B / k1_ms * 1e3:.0f} solves/s); eager / K1 '
        f'{eager_ms / k1_ms:.1f}')
    eager_record(records, 'eager-serve', f'headline, B={B}, T={T}, float32',
                 n_eager, err, 'K1 (and the float64 eager run); card '
                 f'f64 vs CPU f64 (B={k}) {e64:.2e}',
                 f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
                 f'<{TAIL_SHARE}', eager_ms)
    records[-1]['k1_median_ms'] = k1_ms


def tvlqr_problem(torch, device, dtype, n, seed=1):
    """Config 1's random batched TVLQR (benchmarks/configs.py:49-68):
    per-example C = R R^T, c, F = (I + 0.1 N | 0.5 N), f and x0."""
    import numpy as np
    import mpc_tpu_torch as mt
    ns, nc, T_ = TVLQR['n_state'], TVLQR['n_ctrl'], TVLQR['T']
    rng = np.random.RandomState(seed)
    C = rng.randn(T_, n, ns + nc, ns + nc)
    C = np.einsum('tbij,tbkj->tbik', C, C)
    c = rng.randn(T_, n, ns + nc)
    F = np.concatenate([np.eye(ns) + 0.1 * rng.randn(T_ - 1, n, ns, ns),
                        0.5 * rng.randn(T_ - 1, n, ns, nc)], 3)
    f = rng.randn(T_ - 1, n, ns)
    x0 = rng.randn(n, ns)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    return (t(x0), mt.QuadCost(t(C), t(c)), mt.LinDx(t(F), t(f)),
            dict(C=C, c=c, F=F, f=f, x0=x0))


def dense_lqr_u(C, c, F, f, x0):
    """The unconstrained LQR of one example as a dense QP in the controls
    (the states eliminated), solved in numpy float64: u [T, n_ctrl]."""
    import numpy as np
    T_, nt = c.shape
    ns = F.shape[1]
    nc = nt - ns
    nu = T_ * nc
    M, m = np.zeros((ns, nu)), np.asarray(x0, float)
    H, g = np.zeros((nu, nu)), np.zeros(nu)
    for t in range(T_):
        Mx = np.zeros((nt, nu))
        Mx[:ns] = M
        Mx[ns:, t * nc:(t + 1) * nc] = np.eye(nc)
        mx = np.concatenate([m, np.zeros(nc)])
        H += Mx.T @ C[t] @ Mx
        g += Mx.T @ (C[t] @ mx + c[t])
        if t < T_ - 1:
            M, m = F[t] @ Mx, F[t] @ mx + f[t]
    return np.linalg.solve(0.5 * (H + H.T), -g).reshape(T_, nc)


def kernel_route_ms(torch, device, cfg_kw, x0, cost, dyn, reps, **bk):
    """The kernel route's median host ms on an eager phase's own problem
    (use_fused='auto': K3's dense configuration), in the same process;
    it must launch the dense kernel once a solve."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    cfg = mt.MPCConfig(**dict(cfg_kw, use_fused='auto'))
    mt.batched_solve(cfg, x0, cost, dyn, device=device, **bk)  # warm-up
    fused.reset_launch_counts()
    _, ms = timed(torch, device, lambda: mt.batched_solve(
        cfg, x0, cost, dyn, device=device, **bk), reps)
    if device.type == 'cuda' and \
            fused.launch_counts['fused_ilqr_dense'] != reps:
        raise AssertionError('the kernel route did not launch the dense '
                             'kernel once a solve')
    return ms


def phase_eager_tvlqr(torch, device, records, reps=3):
    import numpy as np
    import mpc_tpu_torch as mt
    log(f'[eager-tvlqr] config 1: TVLQR, B={TVLQR_B}, T={TVLQR["T"]}, '
        f'{TVLQR["n_state"]} states, {TVLQR["n_ctrl"]} controls, '
        'per-example C, c, F, f')
    cfg = mt.MPCConfig(**TVLQR)
    x0, cost, dyn, arr = tvlqr_problem(torch, device, torch.float32, TVLQR_B)
    x64, cost64, dyn64, _ = tvlqr_problem(torch, device, torch.float64,
                                          TVLQR_B)
    (runs, ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(cfg, x0, cost, dyn,
                                                device=device), reps))
    u32 = runs[-1].u
    u64 = mt.batched_solve(cfg, x64, cost64, dyn64, device=device).u
    dense = torch.tensor(np.stack([
        dense_lqr_u(arr['C'][:, b], arr['c'][:, b], arr['F'][:, b],
                    arr['f'][:, b], arr['x0'][b]) for b in range(TVLQR_B)], 1))
    e64, e32, e32_64 = rel_err(u64, dense), rel_err(u32, dense), \
        rel_err(u32, u64)
    k_ms = kernel_route_ms(torch, device, TVLQR, x0, cost, dyn, reps)
    log(f'  max |du| / max |u|: f64 vs dense QP {e64:.3e}, f32 vs dense '
        f'{e32:.3e}, f32 vs f64 {e32_64:.3e}; {n_eager} eager solves, '
        f'median {ms:.3f} ms ({TVLQR_B / ms * 1e3:.0f} solves/s); the '
        f'kernel route (dense configuration) {k_ms:.3f} ms, eager / kernel '
        f'{ms / k_ms:.1f}; {card_line()}')
    if not (e64 < 1e-8 and e32 < TVLQR_F32_TOL and e32_64 < TVLQR_F32_TOL):
        raise AssertionError('TVLQR: the eager solve is off the dense QP')
    eager_record(records, 'eager-tvlqr', f'config 1, B={TVLQR_B}, T=5, '
                 '3s/4c, float32', n_eager, e32_64,
                 'float64 eager run and a numpy float64 dense QP',
                 f'{TVLQR_F32_TOL} relative (f64 vs dense 1e-8)', ms)
    records[-1]['kernel_median_ms'] = k_ms
    phase_tf32(torch, 'TVLQR forward (pseudo-inverse)',
               lambda: list(mt.batched_solve(cfg, x0, cost, dyn,
                                             device=device)[:6]))


def medium_problem(torch, device, dtype, n, seed=3, ns=None, nc=None):
    """The medium-state rows (benchmarks/configs.py:141-151), 24 states
    and 4 controls unless given: a batch-shared LinDx(F, None) with a
    stable A, a diagonal QuadCost."""
    import numpy as np
    import mpc_tpu_torch as mt
    ns, nc = ns or MEDIUM['n_state'], nc or MEDIUM['n_ctrl']
    T_ = MEDIUM['T']
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.01 * rng.randn(ns, ns)
    A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    Bm = 0.1 * rng.randn(ns, nc)
    F = np.tile(np.concatenate([A, Bm], 1)[None], (T_ - 1, 1, 1))
    C = np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)]))
    x0 = rng.randn(n, ns)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    return t(x0), mt.QuadCost(t(C), t(np.zeros(ns + nc))), mt.LinDx(t(F))


def phase_eager_medium(torch, device, records):
    import mpc_tpu_torch as mt
    n = MEDIUM_B
    log(f'[eager-medium] 24 states, 4 controls, T=20, B={n}, box +-1 '
        '(the medium-state jnp row)')
    cfg = mt.MPCConfig(**MEDIUM)
    x0, cost, dyn = medium_problem(torch, device, torch.float32, n)
    kw = dict(u_lower=-1.0, u_upper=1.0, device=device)

    def solve(x, c=cost, d=dyn, dev=device):
        return mt.batched_solve(cfg, x, c, d, **dict(kw, device=dev))

    # timed once (host-bound, ten seconds a solve)
    (runs, ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: solve(x0), 1))
    sol = runs[-1]
    # the reversed batch and slices alone against the same examples inside
    # the batch, at three iterations (the per-example arithmetic of all ten)
    short = mt.MPCConfig(**dict(MEDIUM, lqr_iter=3))
    full3 = mt.batched_solve(short, x0, cost, dyn, **kw)
    rev = mt.batched_solve(short, x0.flip(0), cost, dyn, **kw)
    same_bits('reversed batch (3 iterations)', torch, [
        (rev.u.flip(1), full3.u), (rev.x.flip(1), full3.x),
        (rev.n_iter.flip(0), full3.n_iter),
        (rev.n_qp_iter.flip(0), full3.n_qp_iter)])
    at = n // 8
    for k in (1, 7, 33):
        part = mt.batched_solve(short, x0[at:at + k], cost, dyn, **kw)
        same_bits(f'B={k} alone vs inside B={n} (3 iterations)', torch, [
            (part.u, full3.u[:, at:at + k]), (part.x, full3.x[:, at:at + k]),
            (part.n_qp_iter, full3.n_qp_iter[at:at + k])])
    x64, cost64, dyn64 = medium_problem(torch, device, torch.float64, n)
    s64 = solve(x64, cost64, dyn64)
    mx = check_tail('f32 vs f64', sol.u, s64.u)
    cpu = torch.device('cpu')
    xc, costc, dync = medium_problem(torch, cpu, torch.float64, n=64)
    sc = solve(xc, costc, dync, cpu)
    e = rel_err(s64.u[:, :64], sc.u)
    # PNQP's Newton counts may part where a gradient at a bound is zero to
    # round-off (its sign picks the free set, not the solution)
    qp_differ = int((s64.n_qp_iter[:64].cpu() != sc.n_qp_iter).sum())
    log(f'  card f64 vs CPU f64, B=64: max |du| / max |u| {e:.3e}, n_iter '
        f'{"equal" if torch.equal(s64.n_iter[:64].cpu(), sc.n_iter) else "DIFFER"}'
        f', n_qp_iter differs in {qp_differ} examples')
    if not (e < EAGER_F64_TOL
            and torch.equal(s64.n_iter[:64].cpu(), sc.n_iter)):
        raise AssertionError('medium: the card\'s float64 is off the CPU\'s')
    active = float((sol.u.abs() == 1.0).double().mean())
    k_ms = kernel_route_ms(torch, device, MEDIUM, x0, cost, dyn, 3,
                           u_lower=-1.0, u_upper=1.0)
    log(f'  {active:.3f} of the controls on the box; {n_eager} eager '
        f'solves, median {ms:.1f} ms ({n / ms * 1e3:.1f} solves/s); the '
        f'kernel route (dense configuration) {k_ms:.3f} ms, eager / kernel '
        f'{ms / k_ms:.0f}; {card_line()}')
    eager_record(records, 'eager-medium', f'24s/4c, B={n}, T=20, box, '
                 'float32', n_eager, mx, 'float64 eager run on the card; '
                 'card f64 vs CPU f64 (B=64) '
                 f'{e:.2e}', f'f32 tail as K1; f64 {EAGER_F64_TOL}', ms)
    records[-1]['kernel_median_ms'] = k_ms


def cartpole_problem(torch, device, dtype, n, seed=2, angle=0.5):
    """Config 3 (benchmarks/configs.py:173-202): the cartpole from small
    angles (uniform in +-``angle``), its diagonal balance objective, box
    +-100."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import CartpoleDx
    rng = np.random.RandomState(seed)
    th = angle * (2 * rng.rand(n) - 1)
    z = np.zeros(n)
    x0 = torch.tensor(np.stack([z, z, np.cos(th), np.sin(th), z], 1),
                      dtype=dtype, device=device)
    dx = CartpoleDx(device=device, dtype=dtype)
    q, p = dx.get_true_obj()
    return x0, mt.QuadCost(torch.diag(q), p), dx


def phase_eager_cartpole(torch, device, records):
    """Config 3 through the eager solver (use_fused='never'), float32
    against float64, timed beside the kernel route's request (the dense
    configuration's model-step build) in the same process."""
    import mpc_tpu_torch as mt
    log(f'[eager-cartpole] config 3: CartpoleDx, B={CARTPOLE_B}, T=25, '
        'AUTO_DIFF through torch.func, box +-100, use_fused=\'never\'')
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **CARTPOLE)
    kw = dict(u_lower=-100.0, u_upper=100.0, device=device)
    x0, cost, dx = cartpole_problem(torch, device, torch.float32,
                                    CARTPOLE_B)
    (runs, ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(cfg, x0, cost, dx, **kw), 3))
    x64, cost64, dx64 = cartpole_problem(torch, device, torch.float64,
                                         CARTPOLE_B)
    s64 = mt.batched_solve(cfg, x64, cost64, dx64, **kw)
    mx = check_tail('f32 vs f64', runs[-1].u, s64.u)
    k_ms = kernel_route_ms(torch, device, CARTPOLE, x0, cost, dx, 3,
                           u_lower=-100.0, u_upper=100.0)
    log(f'  {n_eager} eager solves, median {ms:.1f} ms '
        f'({CARTPOLE_B / ms * 1e3:.0f} solves/s); the kernel route (the '
        f'dense configuration\'s model-step build) {k_ms:.3f} ms, eager / '
        f'kernel {ms / k_ms:.0f}; {card_line()}')
    if n_eager != 3:
        raise AssertionError('config 3 under use_fused=\'never\' must run '
                             'the eager solver')
    eager_record(records, 'eager-cartpole', f'config 3, B={CARTPOLE_B}, '
                 'T=25, float32', n_eager, mx, 'float64 eager run',
                 f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
                 f'<{TAIL_SHARE}', ms)
    records[-1]['kernel_median_ms'] = k_ms


def phase_eager_long(torch, device, records):
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    n, T_ = LONG_EAGER_B, LONG_EAGER['T']
    log(f'[eager-long] the pendulum at T={T_}, B={n}, unconstrained, '
        'parallel_riccati=False (the sequential arm)')
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **LONG_EAGER)
    rng = np.random.RandomState(9)
    th = np.pi * (2 * rng.rand(n) - 1)
    x = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)

    def inputs(dtype, dev):
        dx, cost = problem(torch, dev, dtype)
        return torch.tensor(x, dtype=dtype, device=dev), cost, dx

    x0, cost, dx = inputs(torch.float32, device)
    (runs, ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(cfg, x0, cost, dx,
                                                device=device), 1))
    s32 = runs[-1]
    # float64 on the card and on the CPU, each with its decisions traced;
    # the witness is the CPU with every step's state moved by one ulp
    cpu = torch.device('cpu')
    (s64, t64), (sc, tc), (sw, tw) = [
        (solver.eager_batched_solve(cfg, x0_, cost_, dx_, trace=tr), tr)
        for (x0_, cost_, dx_), tr in (
            (inputs(torch.float64, device), []),
            (inputs(torch.float64, cpu), []),
            (inputs(torch.float64, cpu)[:2] + (ulp_pendulum(torch),), []))]
    _, err, _ = hold_tied(torch, 'card f64 vs CPU f64', s64, t64, sc, tc,
                          LONG_F64_TOL, LONG_F64_COST_TOL)
    hold_tied(torch, 'witness, CPU vs CPU one ulp a step', sc, tc, sw, tw,
              LONG_F64_TOL, LONG_F64_COST_TOL)
    check_tail('f32 vs f64 (not held)', s32.u, s64.u, None)
    gap = float(((s32.costs.double() - s64.costs).abs()
                 / s64.costs.abs()).max())
    log(f'  cost f32 vs f64: largest relative gap {gap:.3e}; '
        f'{n_eager} eager solve, {ms:.1f} ms ({n / ms * 1e3:.1f} '
        f'solves/s), {card_line()}')
    if not (torch.isfinite(s32.u).all() and gap < LONG_COST_GAP):
        raise AssertionError('long: the float32 solve is off the float64 '
                             'one')
    eager_record(records, 'eager-long', f'pendulum, T={T_}, B={n}, '
                 'float32', n_eager, gap, 'float64 eager run (costs); '
                 f'card f64 vs CPU f64 {err:.2e}',
                 f'{LONG_COST_GAP} relative cost gap; f64 {LONG_F64_TOL}',
                 ms)
    # the sequential arm of [pscan]
    return (s32, s64, ms, (x0, cost, dx), inputs(torch.float64, device))


def ulp_pendulum(torch):
    """The simple pendulum in float64 on the CPU with every step's new
    state moved by one ulp, up or down by a fixed pattern of its digits:
    the size of a last-bit difference in each step's sin, cos, atan2 and
    sums, as the card's and the CPU's libraries give them."""
    from mpc_tpu_torch.models import PendulumDx

    class UlpPendulum(PendulumDx):
        def forward(self, x, u):
            y = super().forward(x, u)
            up = torch.frac(y.abs() * 1e7) < 0.5
            return torch.nextafter(y, torch.where(up, torch.inf, -torch.inf)
                                   .to(y.dtype))

    return UlpPendulum(device='cpu', dtype=torch.float64)


# the 4-control box LinDx problems of [eager-grad]: a third of the
# controls end on the box at a c scale of 0.2, 0.82 of them at 2
BOX4_C_SCALES = (0.2, 2.0)
# the witness's permutation of the states and of the controls
BOX4_PERM = ((3, 0, 5, 1, 4, 2), (2, 0, 3, 1))


def box4_problem(torch, device, dtype, n, seed=21, c_scale=0.2, perm=None):
    """A 4-control box LinDx problem for the gradients: 6 states, T=10,
    a batch-shared F, per-example c (scaled by ``c_scale``), f and x0,
    box +-1, 5 iterations.  ``perm`` (states, controls) permutes the
    problem's coordinates: the same problem, summed in another order."""
    import numpy as np
    import mpc_tpu_torch as mt
    ns, nc, T_ = 6, 4, 10
    rng = np.random.RandomState(seed)
    A = np.eye(ns) + 0.05 * rng.randn(ns, ns)
    A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    F = np.tile(np.concatenate([A, 0.3 * rng.randn(ns, nc)], 1)[None],
                (T_ - 1, 1, 1))
    C = np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)]))
    arrays = dict(F=F, C=C, c=c_scale * rng.randn(T_, n, ns + nc),
                  f=0.1 * rng.randn(T_ - 1, n, ns), x0=rng.randn(n, ns),
                  w=rng.randn(T_, n, nc))
    if perm is not None:
        ps = np.asarray(perm[0])
        pt = np.concatenate([ps, ns + np.asarray(perm[1])])
        arrays.update(F=F[:, ps][:, :, pt], C=C[pt][:, pt],
                      c=arrays['c'][..., pt], f=arrays['f'][..., ps],
                      x0=arrays['x0'][:, ps], w=arrays['w'][..., perm[1]])
    leaves = {k: torch.tensor(v, dtype=dtype, device=device,
                              requires_grad=k != 'w')
              for k, v in arrays.items()}
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T_, lqr_iter=5, eps=0.0,
                       exit_unconverged=False, detach_unconverged=False,
                       backprop=True, use_fused='never')
    return cfg, leaves


def box4_solve(torch, device, dtype, n, c_scale=0.2, perm=None,
               trace=None):
    """The box problem's eager solve with its fixed point attached (the
    route batched_solve takes for it), tracing its decisions."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    cfg, L = box4_problem(torch, device, dtype, n, c_scale=c_scale,
                          perm=perm)
    sol = solver.eager_batched_solve(
        cfg, L['x0'], mt.QuadCost(L['C'], L['c']), mt.LinDx(L['F'], L['f']),
        u_lower=-1.0, u_upper=1.0, differentiable=True, trace=trace)
    return sol, L


def box4_backward(sol, L, keep=None):
    """The gradients of (w u).sum() + 0.5 |x|^2 over the examples in
    ``keep`` (all when None): [u] + the leaves' gradients."""
    m = 1.0 if keep is None else keep.to(sol.u.device, sol.u.dtype)[
        None, :, None]
    ((m * L['w'] * sol.u).sum() + 0.5 * (m * sol.x ** 2).sum()).backward()
    return [sol.u.detach()] + [L[k].grad for k in ('x0', 'C', 'c', 'F', 'f')]


def box4_grads(torch, device, dtype, n):
    """u and the gradients through the eager solver and its fixed point,
    through the entry point (batched_solve)."""
    import mpc_tpu_torch as mt
    cfg, L = box4_problem(torch, device, dtype, n)
    sol = mt.batched_solve(cfg, L['x0'], mt.QuadCost(L['C'], L['c']),
                           mt.LinDx(L['F'], L['f']), u_lower=-1.0,
                           u_upper=1.0, device=device)
    return box4_backward(sol, L)


def parted_examples(torch, ta, tb):
    """The examples whose eager decisions differ between two traces
    (``solver.eager_batched_solve(trace=...)``): active, alpha or n_qp at
    any iteration.  bool [B] on the CPU."""
    cpu = [{k: v.cpu() for k, v in d.items()} for d in ta], \
        [{k: v.cpu() for k, v in d.items()} for d in tb]
    parted = torch.zeros_like(cpu[0][0]['active'])
    for a, b in zip(*cpu):
        parted |= (a['active'] != b['active']) | (a['active'] & (
            (a['alpha'] != b['alpha']) | (a['n_qp'] != b['n_qp'])))
    for extra in cpu[0][len(tb):] + cpu[1][len(ta):]:
        parted |= extra['active']
    return parted


def first_parting(torch, ta, tb, parted):
    """For each parted example (at most 4): the first iteration whose
    decisions differ and what differs there."""
    out = []
    for e in torch.nonzero(parted).flatten()[:4].tolist():
        for i, (a, b) in enumerate(zip(ta, tb)):
            what = [k for k in ('active', 'alpha', 'n_qp')
                    if a[k][e].item() != b[k][e].item()]
            if what:
                out.append(f'example {e} at iteration {i}: ' + ', '.join(
                    f'{k} {a[k][e].item():.6g}/{b[k][e].item():.6g}'
                    for k in what))
                break
    return out


def hold_tied(torch, what, sa, ta, sb, tb, tol=EAGER_F64_TOL,
              cost_tol=TIE_COST_TOL):
    """Hold two float64 eager solves of one problem (solutions and
    traces): the examples with the same decisions within ``tol`` of the
    largest |u|, every example's cost within ``cost_tol`` (relative; for
    the parted ones the flat cost of a tie) and the parted share below
    PARTED_SHARE.  Returns (keep, the untied error, the tied examples'
    largest |du| / max |u|)."""
    parted = parted_examples(torch, ta, tb)
    keep = ~parted
    ua, ub = sa.u.detach().double().cpu(), sb.u.detach().double().cpu()
    scale = ub.abs().max()
    err = float((ua[:, keep] - ub[:, keep]).abs().max() / scale)
    tied = float((ua[:, parted] - ub[:, parted]).abs().max() / scale) \
        if parted.any() else 0.0
    ca, cb = sa.costs.double().cpu(), sb.costs.double().cpu()
    cost_gap = float(((ca - cb).abs() / cb.abs()).max())
    share = float(parted.double().mean())
    log(f'  {what}: {int(parted.sum())} of {parted.numel()} examples part '
        f'({share:.4f}); the rest max |du| / max |u| {err:.3e}, the parted '
        f'{tied:.3e}; largest relative cost gap {cost_gap:.3e}')
    for line in first_parting(torch, ta, tb, parted):
        log(f'    {line}')
    if not (err < tol and cost_gap < cost_tol and share < PARTED_SHARE):
        raise AssertionError(f'{what}: the solves differ beyond their ties')
    return keep, err, tied


def phase_eager_grad(torch, device, records, n=1024):
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused_bwd
    from mpc_tpu_torch.ops.diff import make_lqr_fixed_point
    log(f'[eager-grad] (a) config 4, T={TRAIN_T}, B={n}: the eager fixed '
        'point vs K2 on the same primal')
    o = bwd_operands(torch, device, n)
    kk = fused_bwd.fused_kkt_backward(**o, has_f=False)
    leaves = [t.detach().clone().requires_grad_() for t in
              (torch.zeros(n, 3, device=device), o['C'], o['c'], o['F'])]
    bnd = torch.tensor(2.0, device=device).expand(TRAIN_T, 1, 1)
    solver.reset_eager_counts()

    def eager_bwd():
        for t in leaves:
            t.grad = None
        x, u = make_lqr_fixed_point(3, True, False).apply(
            leaves[0], leaves[1], leaves[2], leaves[3], None, -bnd, bnd,
            o['x_star'], o['u_star'])
        ((x * o['dl_dx']).sum() + (u * o['dl_du']).sum()).backward()
        return [t.grad.clone() for t in leaves]

    (runs, ms) = timed(torch, device, eager_bwd, 3)
    err_a = 0.0
    for name, g, ref in zip(('dx_init', 'dC', 'dc', 'dF'), runs[-1], kk[:4]):
        e = rel_err(g.reshape(ref.shape), ref)
        err_a = max(err_a, e)
        log(f'  {name}: max |eager - K2| / max |K2| {e:.3e}')
    if err_a > BWD_TOL:
        raise AssertionError('the eager fixed point is off K2')
    log(f'  eager backward median {ms:.3f} ms, {card_line()}')
    eager_record(records, 'eager-grad', f'config 4, B={n}, T={TRAIN_T}, '
                 'float32, same primal', 0, err_a, 'K2',
                 f'{BWD_TOL} relative per gradient', ms)

    cpu = torch.device('cpu')
    names = ('dx_init', 'dC', 'dc', 'dF', 'df')
    for c_scale in BOX4_C_SCALES:
        log(f'[eager-grad] (b) 4 controls, box LinDx, B={n}, c scale '
            f'{c_scale}: card f64 vs CPU f64, solve and gradients')
        tk, tc, tw = [], [], []
        solver.reset_eager_counts()
        t0 = time.perf_counter()
        sk, Lk = box4_solve(torch, device, torch.float64, n, c_scale,
                            trace=tk)
        sync(torch, device)
        ms = 1e3 * (time.perf_counter() - t0)
        n_eager = solver.eager_counts['eager_solve']
        sc, Lc = box4_solve(torch, cpu, torch.float64, n, c_scale, trace=tc)
        keep, err_u, tied = hold_tied(torch, 'card vs CPU', sk, tk, sc, tc)
        # the witness: the CPU against itself on the permuted problem
        with torch.no_grad():
            sw, _ = box4_solve(torch, cpu, torch.float64, n, c_scale,
                               perm=BOX4_PERM, trace=tw)
        uw = torch.empty_like(sw.u)
        uw[..., list(BOX4_PERM[1])] = sw.u
        hold_tied(torch, 'witness, CPU vs CPU permuted', sc, tc,
                  sw._replace(u=uw), tw)
        # gradients of the loss over the examples that did not part
        gk, gc = box4_backward(sk, Lk, keep), box4_backward(sc, Lc, keep)
        err_b = err_u
        for name, a, b in zip(names, gk[1:], gc[1:]):
            e = rel_err(a, b)
            err_b = max(err_b, e)
            log(f'  {name} (the examples that do not part): card f64 vs '
                f'CPU f64 {e:.3e}')
        if err_b > EAGER_F64_TOL:
            raise AssertionError('box LinDx: the card\'s float64 gradients '
                                 'are off the CPU\'s')
        active = float((gk[0].abs() == 1.0).double().mean())
        log(f'  {active:.3f} of the controls on the box; {n_eager} eager '
            f'solve with its fixed point on the card, {ms:.1f} ms')
        eager_record(records, 'eager-grad', f'4 controls, box LinDx, B={n}, '
                     f'T=10, c scale {c_scale}, float64 solve and '
                     'gradients', n_eager, err_b,
                     'the same on the CPU (examples whose decisions '
                     f'match; {int((~keep).sum())} part, by up to '
                     f'{tied:.2e})', f'{EAGER_F64_TOL} relative', ms)
    log('[eager-grad] (c) TF32 on and off')
    phase_tf32(torch, '4-control box LinDx float32 solve and gradients',
               lambda: box4_grads(torch, device, torch.float32, n))


# ---------------------------------------------------------------------------
# the controller's own surface: the closed loop, slew penalties, the
# O(log T) Riccati scan, verbose and ANALYTIC_CHECK
# ---------------------------------------------------------------------------

# bench_closed_loop (benchmarks/configs.py:375-417): the headline's solve
# (AUTO_DIFF, lqr_iter=10, eps=0, box +-2, decay 0.2, 5 step sizes) for
# 100 environment steps at B = 1, 16, 256, and at the headline's 4096
# ---------------------------------------------------------------------------
# K3's dense configuration: LinDx at any state and control size
# ---------------------------------------------------------------------------

# the JAX package's rows that its kernels serve (benchmarks/configs.py):
# config 1, TVLQR (:49-105; 3 states, 4 controls, every operand per
# example, unbounded, B=128) and the medium-state rows (:107-171; a
# batch-shared LinDx(F, None), a diagonal C, box +-1, T=20, lqr_iter=10);
# and a box LinDx of the cartpole's size, 5 states and 1 control, on the
# medium rows' system (the closed-form 1-D box QP)
DENSE_ROWS = (
    # label, n_state, n_ctrl, B
    ('tvlqr', 3, 4, TVLQR_B),
    ('medium', 16, 4, 2048),
    ('medium', 24, 4, 1024),
    ('medium', 24, 4, 2048),
    ('box', 5, 1, 2048),
)
# the row whose request stream [serve-dense] drives beside TVLQR's, and
# the kernels line's entry: 24 states, 4 controls at B=2048
DENSE_MAIN = DENSE_ROWS[3]
DENSE_REQUESTS = 4


def dense_problem(torch, device, label, ns, nc, n, dtype=None, seed=None):
    """(cfg, x0, cost, dynamics, bounds) of a DENSE_ROWS row at its own
    sizes on the first n examples; the kernel route (use_fused='auto')."""
    import mpc_tpu_torch as mt
    dtype = dtype or torch.float32
    if label == 'tvlqr':
        x0, cost, dyn, _ = tvlqr_problem(torch, device, dtype, n,
                                         seed=1 if seed is None else seed)
        return (mt.MPCConfig(**dict(TVLQR, use_fused='auto')), x0, cost,
                dyn, {})
    x0, cost, dyn = medium_problem(torch, device, dtype, n,
                                   seed=3 if seed is None else seed, ns=ns,
                                   nc=nc)
    cfg = mt.MPCConfig(**dict(MEDIUM, n_state=ns, n_ctrl=nc,
                              use_fused='auto'))
    return cfg, x0, cost, dyn, dict(u_lower=-1.0, u_upper=1.0)


def dense_operands(torch, device, label, ns, nc, n, dtype=None):
    from mpc_tpu_torch.ops import fused_dense
    cfg, x0, cost, dyn, bk = dense_problem(torch, device, label, ns, nc, n,
                                           dtype)
    return fused_dense.k3d_operands(cfg, x0, cost, dyn, **bk)


def phase_compare_dense(torch, device):
    """The dense configuration against fused_solve_dense_plain on the
    card at each DENSE_ROWS row's own size (hold_k1: the LinDx float32
    tail, n_iter, float64 equidistance, the reversed batch with every
    batched operand); at TVLQR and the main row also B = 1, 7, 33 alone
    and the batch with two more examples (more blocks) bitwise; TVLQR
    also against the dense QP of [eager-tvlqr] (dense_lqr_u).  Returns
    the largest max |du| and each row's plain float32 run's device ms."""
    import numpy as np
    from mpc_tpu_torch.ops import fused_dense as fd
    worst, plain_ms = 0.0, {}
    for label, ns, nc, n in DENSE_ROWS:
        what = f'{label} {ns}s{nc}c, B={n}'
        log(f'[compare-dense] dense kernel vs its plain version, {what}')
        ops = dense_operands(torch, device, label, ns, nc, n)
        ops64 = dense_operands(torch, device, label, ns, nc, n, torch.float64)
        times = []
        full, mx = hold_k1(torch, what, ops, ops64,
                           kernel=fd.fused_ilqr_dense,
                           plain=timed_plain(torch,
                                             fd.fused_solve_dense_plain,
                                             times),
                           limits=(LONG_TAIL_MEAN, LONG_TAIL_SHARE))
        plain_ms[(label, ns, nc, n)] = times[0]
        worst = max(worst, mx)
        if label == 'tvlqr':
            _, _, _, arr = tvlqr_problem(torch, device, torch.float32, n)
            dense = torch.tensor(np.stack([
                dense_lqr_u(arr['C'][:, b], arr['c'][:, b], arr['F'][:, b],
                            arr['f'][:, b], arr['x0'][b]) for b in range(n)],
                1))
            e = rel_err(full[1], dense)
            log(f'  vs the dense QP (numpy float64): max |du| / max |u| '
                f'{e:.3e}')
            if not e < TVLQR_F32_TOL:
                raise AssertionError('TVLQR: the dense kernel is off the '
                                     'dense QP')
        if (label, ns, nc, n) in (DENSE_ROWS[0], DENSE_MAIN):
            hold_slices(torch, what, fd.fused_ilqr_dense, ops, full)
            r = fd.fused_ilqr_dense(**batch_subset(torch, ops, torch.cat(
                [torch.arange(n), torch.arange(2)])))
            if not all(torch.equal(r[i][:, :n], full[i])
                       and torch.equal(r[i][:, n:], full[i][:, :2])
                       for i in range(3)):
                raise AssertionError(f'{what}: B={n + 2} differs from B={n}')
            log(f'  {what}: B={n + 2} bitwise equal to B={n}')
        log(f'  controls on the box '
            f'{float((full[1].abs() == 1.0).double().mean()):.3f}; '
            f'n_qp_iter a solve {float(full[2][3].double().mean()):.1f}, '
            f'trials a solve {float(full[2][5].double().mean()):.2f}')
    return worst, plain_ms


def phase_serve_dense(torch, device):
    """Requests through the entry points: DENSE_REQUESTS distinct batches
    through batched_solve and one through MPC for TVLQR and for the main
    medium-state row, host to host, every count set to 0 before and read
    after: one dense launch a request and nothing else.  The last
    answers hold up: x is the rollout of u, costs their objective, u in
    its box; TVLQR's u is the dense QP's.  Returns the launches by row
    and the median request ms."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    launches, req_ms = {}, {}
    for label, ns, nc, n in (DENSE_ROWS[0], DENSE_MAIN):
        cfg, x0, cost, dyn, bk = dense_problem(torch, device, label, ns, nc, n)
        requests = [torch.tensor(np.random.RandomState(300 + i).randn(n, ns),
                                 dtype=torch.float32)
                    for i in range(DENSE_REQUESTS)]
        mt.batched_solve(cfg, x0, cost, dyn, device=device, **bk).u.cpu()
        ctrl = mt.MPC(ns, nc, cfg.T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, device=device, **bk)
        reset_all_counts()
        solver.reset_eager_counts()
        lat = []
        for req in requests:
            t0 = time.perf_counter()
            x = req.to(device)
            sol = mt.batched_solve(cfg, x, cost, dyn, device=device, **bk)
            u = sol.u.cpu()
            lat.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        xm, um, _ = ctrl(requests[0].to(device), cost, dyn)
        um = um.cpu()
        lat_mpc = 1e3 * (time.perf_counter() - t0)
        counts = {k: v for k, v in all_counts().items() if v}
        n_req = len(requests) + 1
        ms = median(lat)
        log(f'[serve-dense] {label} {ns}s{nc}c, B={n}: {len(requests)} '
            'batched_solve requests, latency ms '
            + ' '.join(f'{v:.3f}' for v in lat) + f', median {ms:.3f} '
            f'({n / ms * 1e3:.0f} solves/s); MPC {lat_mpc:.3f} ms; launches '
            f'{counts}, eager solves {solver.eager_counts["eager_solve"]}')
        if solver.eager_counts['eager_solve'] or (
                device.type == 'cuda'
                and counts != {'fused_ilqr_dense': n_req}):
            raise AssertionError('each request must launch the dense kernel '
                                 'once and nothing else')
        if not torch.equal(um, mt.batched_solve(
                cfg, requests[0].to(device), cost, dyn, device=device,
                **bk).u.cpu()):
            raise AssertionError('MPC and batched_solve answer differently')
        xr = rollout(dyn, x, u.to(device))
        cr = trajectory_cost(cost, xr, u.to(device))
        gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
        x_gap = float((xr - sol.x).abs().max() / sol.x.abs().max())
        log(f'  last answer: relative cost gap to its own rollout {gap:.2e}, '
            f'max |x - rollout| / max |x| {x_gap:.2e}')
        box = float(bk.get('u_upper', float('inf')))
        if not (torch.isfinite(u).all() and u.abs().max() <= box
                and gap < 1e-3 and x_gap < 1e-3):
            raise AssertionError('served controls are not a feasible solve')
        launches[label] = n_req
        req_ms[label] = ms
    return launches, req_ms


def dense_entries(rows, launches, req_ms, err):
    """The kernels line's entries of the dense configuration: the main
    medium-state row (it replaces _make_kernel_long's configuration) and
    TVLQR (config 1, which the JAX package runs in _make_kernel), each
    with its [serve-dense] launches and its [time-dense] row; every row
    under 'rows'."""
    from mpc_tpu_torch.ops import fused_dense as fd
    by_row = {r['row']: r for r in rows}
    out = []
    for (label, ns, nc, n), path, line in (
            (DENSE_MAIN, 'medium-state serving', 1126),
            (DENSE_ROWS[0], 'tvlqr serving', 617)):
        r = by_row[f'{label} {ns}s{nc}c B={n}']
        T_ = TVLQR['T'] if label == 'tvlqr' else MEDIUM['T']
        out.append({
            'name': 'fused_ilqr_dense' + (' (tvlqr)' if label == 'tvlqr'
                                          else ''),
            'path': path, 'route': 'cuda',
            'source': 'mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
            'headers': ['mpc_tpu_torch/csrc/box_qp.cuh'],
            'replaces': f'mpc_tpu/ops/fused.py:{line}',
            'design': design('fused_ilqr_dense', fd.dense_kernel_defines(
                ns, nc, label != 'tvlqr', label == 'tvlqr'),
                fd.k3d_launch(T_, n, ns, nc, 10)),
            'launches': launches[label], 'max_abs_err': err,
            'tolerance': f'mean|du|<{LONG_TAIL_MEAN}, '
                         f'share(|du|>{TAIL_ENTRY})<{LONG_TAIL_SHARE}; '
                         'at most 2x the plain f32 distance from f64',
            'library_ms': None, 'request_ms': req_ms[label],
            **{k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')},
            'rows': rows if label != 'tvlqr' else [r]})
    return out


def time_dense_row(torch, what, ops, tag='time-dense', plain_ms=None):
    """The dense kernel on ``ops`` timed from a CUDA graph, its bound
    from this run's iterations, trial rollouts and QP trips, its
    registers and spills (ptxas), and the plain version on the card
    (timed here unless ``plain_ms`` gives its time in this run): the
    row's numbers."""
    from mpc_tpu_torch.ops import fused_dense as fd
    T_, n, nc = ops['u0'].shape
    ns = ops['x0'].shape[1]
    _, _, st = fd.fused_ilqr_dense(**ops)
    ms, eager_ms = graph_ms(torch, lambda: fd.fused_ilqr_dense(**ops),
                            reps=3, per_graph=4)
    has_bounds = ops['lb'] is not None
    sums = [float(st[i].double().sum()) for i in (2, 3, 5)]
    flops = fd.k3d_flops(T_, ns, nc, sums[0], sums[2], batch=n,
                         has_f=ops['f'] is not None, has_bounds=has_bounds,
                         n_qp=sums[1] if nc > 1 and has_bounds else 0)
    nbytes = fd.k3d_bytes(ops)
    bound_ms, by = bound(flops, nbytes)
    des = design('fused_ilqr_dense',
                 fd.dense_kernel_defines(ns, nc, has_bounds,
                                         ops['f'] is not None),
                 fd.k3d_launch(T_, n, ns, nc, len(ops['alphas'])))
    pms = plain_ms if plain_ms is not None else event_ms(
        torch, lambda: fd.fused_solve_dense_plain(**ops))
    log(f'[{tag}] {what}, B={n}, T={T_}: {ms:.4f} ms '
        f'(from a CUDA graph; {eager_ms:.4f} ms a call from Python), '
        f'plain {pms:.1f} ms; {flops:.4e} operations '
        f'({sums[0] / n:.2f} iterations, {sums[2] / n:.2f} trials, '
        f'{sums[1] / n:.1f} QP trips a solve), {nbytes} bytes; bound '
        f'{bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
        f'{n / ms * 1e3:.0f} solves/s; registers {des["registers"]}, '
        f'spill stores {des["spill_store_bytes"]} bytes, shared memory '
        f'{des["shared_memory_bytes"]} bytes a block; {card_line()}')
    return dict(row=f'{what} B={n}', ms=ms, plain_ms=pms, bound_ms=bound_ms,
                bound_by=by, registers=des['registers'],
                spill_store_bytes=des['spill_store_bytes'])


def phase_time_dense(torch, device, plain_ms):
    """The dense kernel at each DENSE_ROWS row (``time_dense_row``; the
    plain version's device ms from [compare-dense], ``plain_ms``).
    Returns the rows."""
    return [time_dense_row(torch, f'{label} {ns}s{nc}c', dense_operands(
        torch, device, label, ns, nc, n), plain_ms=plain_ms[row])
        for row in DENSE_ROWS for label, ns, nc, n in (row,)]


# ---------------------------------------------------------------------------
# K2 and K4's dense configuration: the backward at any state and control
# size, and the medium imitation row trained on the card
# ---------------------------------------------------------------------------

# the medium imitation row (the JAX package's BASELINE.md:483: "fused
# forward + fused KKT backward"), defined from the repo's pieces: the
# medium rows' system (benchmarks/configs.py:141-151) at 20 states and 4
# controls, T=20, lqr_iter=10, eps=0, box +-1, B=1024, float32, and a
# learned batch-shared diagonal cost with config 4's structure
# (benchmarks/configs.py:257-322: q_log and p, Adam(1e-2)); the expert
# solves the true cost diag(1.., 0.1..), c = 0, on the kernel route
TRAIN_DENSE = dict(MEDIUM, n_state=20, n_ctrl=4, backprop=True,
                   use_fused='auto')
TRAIN_DENSE_B = 1024
TRAIN_DENSE_STEPS = 20
# the learner's start: the true diagonal with log-normal noise of 0.5 and
# a linear term of 0.3 N, both from RandomState(12).  phase_train_dense
# itself, rehearsed on the CPU (the plain versions; card_line replaced,
# TRAIN_DENSE_B set to 64 and 256, the threshold lifted), ends its 20
# steps at 0.4822 and 0.4889 of the first loss (PERF.md); the card's run
# must end below 0.7 of it, a margin for float32 on the card and B=1024
DENSE_THETA_SEED, DENSE_THETA_LOG, DENSE_THETA_P = 12, 0.5, 0.3
TRAIN_DENSE_MAX_RATIO = 0.7
# [compare-bwd-dense]'s rows (label, n_state, n_ctrl, B): the medium
# imitation row and 24 states, both with the box, shared cost and shared
# F at the dense forward's solution; 16 states and 4 controls with every
# leaf per example and f (benchmarks/hw_sweep.py:420-478's problem);
# TVLQR's size, unbounded, at its forward's solution; 5 states and 1
# control with the box
BWD_DENSE_ROWS = (
    ('medium', 20, 4, TRAIN_DENSE_B), ('medium', 24, 4, 1024),
    ('batched', 16, 4, 1024), ('tvlqr', 3, 4, TVLQR_B), ('box', 5, 1, 2048))
BWD_DENSE_MAIN = BWD_DENSE_ROWS[0]


def bwd_dense_case(label):
    """(has_I, has_f) of a BWD_DENSE_ROWS row."""
    return label != 'tvlqr', label in ('tvlqr', 'batched')


def bwd_dense_operands(torch, device, label, ns, nc, n, seed=14):
    """The dense backward's operands of a BWD_DENSE_ROWS row: x*, u* from
    the dense forward kernel on the row's problem (the medium rows, the
    5-state box row and TVLQR; the active set from the box), or
    hw_sweep's random per-example problem; seeded random cotangents.
    Returns (operands, keyword arguments)."""
    import numpy as np
    from mpc_tpu_torch.ops import fused_bwd, fused_dense as fd
    has_I, has_f = bwd_dense_case(label)
    rng = np.random.RandomState(seed)
    t = (lambda a: torch.tensor(a, dtype=torch.float32, device=device))
    if label == 'batched':
        # benchmarks/hw_sweep.py:430-447, at n examples
        T_, nt = MEDIUM['T'], ns + nc
        r = np.random.RandomState(13)
        Cr = r.randn(T_, n, nt, nt)
        C = np.einsum('tbij,tbkj->tbik', Cr, Cr) / nt + np.eye(nt)
        c = r.randn(T_, n, nt)
        F = 0.3 / np.sqrt(ns) * r.randn(T_ - 1, n, ns, nt)
        F[..., :ns] += 0.9 * np.eye(ns)
        r.randn(T_ - 1, n, ns)                  # f: no values in the backward
        xs, us = r.randn(T_, n, ns), r.randn(T_, n, nc)
        m = r.rand(T_, n, nc) < 0.3
        us = np.where(m, np.sign(us), us)
        o = dict(C=t(C), c=t(c), F=t(F), x_star=t(xs), u_star=t(us),
                 I_mask=t(m.astype(np.float64)))
    else:
        ops = dense_operands(torch, device, label, ns, nc, n)
        xs, us, _ = fd.fused_ilqr_dense(**ops)
        o = dict(C=ops['C'], c=ops['c'], F=ops['F'], x_star=xs, u_star=us,
                 I_mask=fused_bwd.active_set(us, ops['lb'], ops['ub'])
                 if has_I else None)
    T_ = o['x_star'].shape[0]
    o['dl_dx'] = t(rng.randn(T_, n, ns))
    o['dl_du'] = t(rng.randn(T_, n, nc))
    return o, dict(has_f=has_f, f_shared=o['F'].shape[1] == 1)


def phase_compare_bwd_dense(torch, device):
    """The dense backward against fused_kkt_backward_dense_plain on the
    card, same-primal, at each BWD_DENSE_ROWS row (hold_bwd: BWD_TOL and
    the float64 equidistance); at the main row (shared leaves) and the
    per-example row also the reversed batch, B = 1, 7, 33 alone and the
    batch with two more examples bitwise on the per-example outputs, and
    a second launch bitwise on every output.  Returns the largest
    |difference|."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    worst = 0.0
    for label, ns, nc, n in BWD_DENSE_ROWS:
        what = f'{label} {ns}s{nc}c, B={n}'
        log(f'[compare-bwd-dense] dense backward vs its plain version, '
            f'{what}')
        o, kw = bwd_dense_operands(torch, device, label, ns, nc, n)
        if o['I_mask'] is not None:
            log(f'  active controls: {float(o["I_mask"].mean()):.3f} of T*B')
        kk, err = hold_bwd(torch, 'K4d', what, fbd.fused_kkt_backward_dense,
                           fbd.fused_kkt_backward_dense_plain, o, **kw)
        worst = max(worst, err)
        if (label, ns, nc, n) not in (BWD_DENSE_MAIN, BWD_DENSE_ROWS[2]):
            continue
        again = fbd.fused_kkt_backward_dense(**o, **kw)
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(again, kk)):
            raise AssertionError(f'{what}: a second launch differs')
        log('    a second launch: every output bitwise equal')
        # the outputs with a batch axis: dC, dc, dF of batched leaves, df
        # of a batched f
        per_example = [i for i, batched in (
            (1, o['C'].shape[1] == n), (2, o['c'].shape[1] == n),
            (3, o['F'].shape[1] == n),
            (4, kw['has_f'] and not kw['f_shared'])) if batched]
        back = fbd.fused_kkt_backward_dense(**flip_batch(o, torch), **kw)
        if not (torch.equal(back[0].flip(0), kk[0]) and all(
                torch.equal(back[i].flip(1), kk[i]) for i in per_example)):
            raise AssertionError(f'{what}: reversed batch is not bitwise '
                                 'equal')
        log('    reversed batch: bitwise equal on per-example outputs')
        hold_bwd_slices(torch, 'K4d', what, fbd.fused_kkt_backward_dense, o,
                        kk, **kw)
        more = fbd.fused_kkt_backward_dense(**batch_subset_bwd(
            torch, o, torch.cat([torch.arange(n), torch.arange(2)])), **kw)
        if not (torch.equal(more[0][:n], kk[0]) and all(
                torch.equal(more[i][:, :n], kk[i]) for i in per_example)):
            raise AssertionError(f'{what}: B={n + 2} differs from B={n}')
        log(f'    B={n + 2}: per-example outputs bitwise equal to B={n}')
    return worst


def batch_subset_bwd(torch, o, keep):
    """A backward's operands for the examples ``keep``: every operand
    with a batch extent gathered, shared ones kept."""
    B = o['x_star'].shape[1]
    keep = keep.to(o['x_star'].device)
    return {k: (v[:, keep].contiguous() if v is not None and v.dim() >= 2
                and v.shape[1] == B else v) for k, v in o.items()}


def dense_learner(torch, device, wide=False):
    """The medium imitation row's learner at B = TRAIN_DENSE_B (with
    ``wide`` at utils/problems.WIDE_ROWS['wide-train'], 4 states and 12
    controls): cfg, theta, make_cost, the LinDx, x0 and the expert's
    controls (the kernel route's solve of the true cost)."""
    import dataclasses
    import numpy as np
    import mpc_tpu_torch as mt
    if wide:
        cfg, x0, true_cost, dyn, _ = wide_problem(torch, device,
                                                  'wide-train')
        cfg = dataclasses.replace(cfg, backprop=True)
        ns, nc = cfg.n_state, cfg.n_ctrl
    else:
        ns, nc = TRAIN_DENSE['n_state'], TRAIN_DENSE['n_ctrl']
        cfg = mt.MPCConfig(**TRAIN_DENSE)
        x0, true_cost, dyn = medium_problem(torch, device, torch.float32,
                                            TRAIN_DENSE_B, ns=ns, nc=nc)
    with torch.no_grad():
        u_exp = mt.batched_solve(cfg, x0, true_cost, dyn, u_lower=-1.0,
                                 u_upper=1.0, device=device).u
    q = np.r_[np.ones(ns), 0.1 * np.ones(nc)]
    rng = np.random.RandomState(DENSE_THETA_SEED)
    q_log = torch.tensor(np.log(q) + DENSE_THETA_LOG * rng.randn(ns + nc),
                         dtype=torch.float32)
    p = torch.tensor(DENSE_THETA_P * rng.randn(ns + nc), dtype=torch.float32)
    theta, make_cost = learned_cost(torch, device, q_log, p)
    return dict(cfg=cfg, theta=theta, make_cost=make_cost, dyn=dyn, x0=x0,
                u_exp=u_exp)


def dense_train_grads(torch, device):
    import mpc_tpu_torch as mt
    ln = dense_learner(torch, device)
    loss = mt.imitation_loss(ln['theta'], ln['cfg'], ln['x0'], ln['u_exp'],
                             ln['make_cost'], lambda th: ln['dyn'],
                             u_lower=-1.0, u_upper=1.0, device=device)
    loss.backward()
    return [loss.detach()] + [ln['theta'][k].grad for k in sorted(
        ln['theta'])]


def phase_train_dense(torch, device, record, held=None):
    """The medium imitation row's train step through
    make_imitation_train_step (with ``held``, the paths of
    ``wide_train_worker``'s saved plain runs, the same learner at
    'wide-train', 4 states and 12 controls, its launches recorded under
    'train-dense-wide'): the dense forward held to its plain
    version at the learner's start (hold_k1), then TRAIN_DENSE_STEPS
    host-timed, synchronised steps, each launching the dense forward and
    the dense backward once and nothing else (every count set to 0 just
    before a step and read just after, ``counted``), no eager solve or
    fixed point, the loss ending below TRAIN_DENSE_MAX_RATIO of its
    first; for the medium row also TF32 on and off the same gradients and
    where the step's time goes (``phase_profile_train``).  Returns the
    forward's error, the step times and the launches."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused_dense as fd
    wide = held is not None
    ln = dense_learner(torch, device, wide)
    ns, nc = ln['cfg'].n_state, ln['cfg'].n_ctrl
    n = TRAIN_DENSE_B
    key = 'train-dense-wide' if wide else 'train-dense'
    what = (f'wide-train {ns}s{nc}c, B={n}' if wide
            else f'the medium imitation row {ns}s{nc}c, B={n}')
    log(f'[train-dense] {what}, T={ln["cfg"].T}: the dense forward vs '
        'its plain version at the learner\'s start')
    with torch.no_grad():
        cost = ln['make_cost'](ln['theta'])
        ops = fd.k3d_operands(ln['cfg'], ln['x0'], cost, ln['dyn'],
                              u_lower=-1.0, u_upper=1.0)
        cost64 = mt.QuadCost(cost.C.double(), cost.c.double())
        ops64 = fd.k3d_operands(ln['cfg'], ln['x0'].double(), cost64,
                                mt.LinDx(ln['dyn'].F.double()),
                                u_lower=-1.0, u_upper=1.0)
    times = []
    plain = timed_plain(torch, fd.fused_solve_dense_plain, times)
    if wide:
        # the plain runs on these operands, made by wide_train_worker
        runs = [torch.load(held[m]) for m in ('f32', 'f64')]
        for m in held:
            os.remove(held[m])
        times.append(runs[0]['plain_ms'])
        outs = iter([tuple(a.to(device) for a in r['out']) for r in runs])

        def plain(**_):
            return next(outs)
    _, fwd_err = hold_k1(torch, what, ops, ops64, kernel=fd.fused_ilqr_dense,
                         plain=plain,
                         limits=(LONG_TAIL_MEAN, LONG_TAIL_SHARE))
    step = mt.make_imitation_train_step(
        ln['cfg'], torch.optim.Adam(ln['theta'].values(), lr=1e-2),
        ln['make_cost'], lambda th: ln['dyn'], u_lower=-1.0, u_upper=1.0,
        device=device)
    expect = {'fused_ilqr_dense': 1, 'fused_kkt_bwd_dense': 1}
    solver.reset_eager_counts()
    lat, losses = [], []
    for _ in range(TRAIN_DENSE_STEPS):
        t0 = time.perf_counter()
        loss = counted(device, record, key, expect,
                       lambda: step(ln['theta'], ln['x0'], ln['u_exp']))
        sync(torch, device)
        lat.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    eager = dict(solver.eager_counts)
    launches = {k: record.get(k, {}).get(key, 0) for k in expect}
    ratio = losses[-1] / losses[0]
    med = median(lat)
    log(f'[train-dense] {TRAIN_DENSE_STEPS} steps of Adam(1e-2) on q_log, '
        f'p: median {med:.3f} ms a step ({min(lat):.3f}-{max(lat):.3f}), '
        f'{n / med * 1e3:.0f} examples/s; launches {launches}, eager '
        f'{eager}; loss ' + ' '.join(f'{v:.4g}' for v in losses[::4])
        + f' -> {losses[-1]:.4g}; last / first {ratio:.4f} (threshold '
        f'{TRAIN_DENSE_MAX_RATIO}); {card_line()}')
    if any(eager.values()):
        raise AssertionError('the medium train step ran an eager solve or '
                             'fixed point')
    if device.type == 'cuda' and launches != {
            k: TRAIN_DENSE_STEPS for k in expect}:
        raise AssertionError(f'[train-dense] launches {launches}')
    if not (all(math.isfinite(v) for v in losses)
            and ratio < TRAIN_DENSE_MAX_RATIO):
        raise AssertionError(f'{what}: the learner did not cut its loss')
    if wide:
        return dict(fwd_err=fwd_err, step_ms=med, launches=launches,
                    fwd_ops=ops, loss_ratio=ratio, fwd_plain_ms=times[0])
    phase_tf32(torch, 'medium training-step loss and gradients',
               lambda: dense_train_grads(torch, device))
    phase_profile_train(torch, device, 'medium',
                        (step, ln['theta'], ln['x0'], ln['u_exp']))
    return dict(fwd_err=fwd_err, step_ms=med, launches=launches,
                fwd_ops=ops, loss_ratio=ratio, fwd_plain_ms=times[0])


def diff_solve_ms(torch, device, ns, nc, n, eager_bwd, reps=3):
    """A differentiable solve of the medium rows' problem at ns, nc (the
    gradient of a seeded weighted sum of u to c), host to host on the
    kernel route: the dense forward, then the dense backward or, with
    ``eager_bwd``, the eager fixed point (the backward's admission test
    made to refuse it).  Returns the median ms, the last gradient and the
    launches and eager fixed points of the timed calls."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused_bwd
    cfg = mt.MPCConfig(**dict(TRAIN_DENSE, n_state=ns, n_ctrl=nc))
    x0, cost, dyn = medium_problem(torch, device, torch.float32, n, ns=ns,
                                   nc=nc)
    w = torch.tensor(np.random.RandomState(15).randn(cfg.T, n, nc),
                     dtype=torch.float32, device=device)
    c = cost.c.clone().requires_grad_(True)

    def run():
        c.grad = None
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), dyn,
                               u_lower=-1.0, u_upper=1.0, device=device)
        (sol.u * w).sum().backward()
        return c.grad.clone()

    admit = fused_bwd.scope_gap_bwd
    if eager_bwd:
        fused_bwd.scope_gap_bwd = (lambda *a: 'timing the eager fixed point')
    try:
        run()                                   # warm-up
        reset_all_counts()
        solver.reset_eager_counts()
        grads, ms = timed(torch, device, run, reps)
        counts = {k: v for k, v in all_counts().items() if v}
        fixed = solver.eager_counts['eager_fixed_point']
    finally:
        fused_bwd.scope_gap_bwd = admit
    return ms, grads[-1], counts, fixed


def phase_time_bwd_dense(torch, device, train):
    """The dense backward at 20 and 24 states, 4 controls, B=1024 on the
    main row's operands (shared leaves, the active set), timed from a
    CUDA graph, its three kernels apart (torch.profiler), its bound from
    k4d_flops and k4d_bytes, its registers and spills, the plain version
    on the card; the dense forward on the training path's operands
    (``time_dense_row``); and the 24s4c differentiable solve host to
    host on the kernel route against the eager fixed point in the same
    process.  Returns the backward's rows, the forward's row and the
    solve's ms."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    rows = []
    for label, ns, nc, n in BWD_DENSE_ROWS[:2]:
        o, kw = bwd_dense_operands(torch, device, label, ns, nc, n)

        def launch():
            return fbd.fused_kkt_backward_dense(**o, **kw)
        ms, eager_ms = graph_ms(torch, launch)
        split = kernel_device_us(torch, launch)
        parts = {name: sum(v for k, v in split.items() if name in k) / 1e3
                 for name in ('chains', 'grads', 'sums')}
        pms = event_ms(torch, lambda: fbd.fused_kkt_backward_dense_plain(
            **o, **kw))
        T_ = o['x_star'].shape[0]
        flops = fbd.k4d_flops(T_, n, ns, nc, has_I=o['I_mask'] is not None,
                              has_f=kw['has_f'], reduced=('C', 'c', 'F'))
        nbytes = fbd.k4d_bytes(o['C'], o['c'], o['F'], o['x_star'],
                               o['u_star'], o['I_mask'], **kw)
        bound_ms, by = bound(flops, nbytes)
        des = design('fused_kkt_bwd_dense', fbd.bwd_dense_kernel_defines(
            ns, nc, *bwd_dense_case(label)),
            fbd.k4d_launch(T_, n, ns, nc))
        log(f'[time-bwd-dense] {ns}s{nc}c, B={n}, T={T_}: {ms:.4f} ms (from '
            f'a CUDA graph; {eager_ms:.4f} ms a call from Python; chains '
            f'{parts["chains"]:.4f}, gradients {parts["grads"]:.4f}, '
            f'chunk-order sums {parts["sums"]:.4f} ms from torch.profiler), '
            f'plain {pms:.1f} ms; {flops:.4e} operations, {nbytes} bytes; '
            f'bound {bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
            f'registers {des["registers"]}, spill stores '
            f'{des["spill_store_bytes"]} bytes, shared memory '
            f'{des["shared_memory_bytes"]} bytes a block; {card_line()}')
        rows.append(dict(row=f'{label} {ns}s{nc}c B={n}', ms=ms,
                         plain_ms=pms, bound_ms=bound_ms, bound_by=by,
                         chains_ms=parts['chains'], grads_ms=parts['grads'],
                         sums_ms=parts['sums'], registers=des['registers'],
                         spill_store_bytes=des['spill_store_bytes']))
    fwd = time_dense_row(torch, 'medium training 20s4c (the learner\'s '
                         'start)', train['fwd_ops'], tag='time-bwd-dense',
                         plain_ms=train['fwd_plain_ms'])
    ns, nc, n = 24, 4, 1024
    k_ms, gk, k_counts, k_fixed = diff_solve_ms(torch, device, ns, nc, n,
                                                False)
    e_ms, ge, e_counts, e_fixed = diff_solve_ms(torch, device, ns, nc, n,
                                                True)
    rel = float((gk - ge).abs().max() / ge.abs().max())
    log(f'[time-bwd-dense] a differentiable {ns}s{nc}c solve, B={n}, host to '
        f'host: {k_ms:.3f} ms on the kernel route (launches {k_counts}), '
        f'{e_ms:.3f} ms with the eager fixed point (launches {e_counts}, '
        f'{e_fixed} eager fixed points), eager / kernel {e_ms / k_ms:.1f}; '
        f'max |d grad| / max |grad| between the two {rel:.2e}; '
        f'{card_line()}')
    if device.type == 'cuda' and (
            k_counts != {'fused_ilqr_dense': 3, 'fused_kkt_bwd_dense': 3}
            or k_fixed or e_counts != {'fused_ilqr_dense': 3}
            or e_fixed != 3):
        raise AssertionError('the routes of the timed differentiable solves')
    # two float32 algorithms of the same fixed point on the same primal
    # (the eager one adds 1e-11 to the masked block)
    if not rel < 1e-3:
        raise AssertionError('the dense backward and the eager fixed point '
                             'disagree')
    return rows, fwd, dict(kernel_ms=k_ms, eager_ms=e_ms, grad_rel=rel)


def bwd_dense_entries(rows, fwd_row, train, diff_solve, err):
    """The kernels line's entries of the medium training path
    ([train-dense]): the dense backward (it replaces _make_bwd_kernel and
    _make_bwd_kernel_long at these sizes) at the medium imitation row,
    every [time-bwd-dense] row under 'rows', and the dense forward at
    that path's own shape, each with its launches in [train-dense]."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd, fused_dense as fd
    label, ns, nc, n = BWD_DENSE_MAIN
    T_ = TRAIN_DENSE['T']
    main = rows[0]
    return [
        {'name': 'fused_kkt_bwd_dense', 'path': 'medium training',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_kkt_bwd_dense.cu',
         'headers': ['mpc_tpu_torch/csrc/box_qp.cuh'],
         'replaces': 'mpc_tpu/ops/fused_bwd.py:251',
         'also_replaces': 'mpc_tpu/ops/fused_bwd.py:413',
         'design': design('fused_kkt_bwd_dense', fbd.bwd_dense_kernel_defines(
             ns, nc, *bwd_dense_case(label)),
             fbd.k4d_launch(T_, n, ns, nc)),
         'launches': train['launches']['fused_kkt_bwd_dense'],
         'max_abs_err': err,
         'tolerance': f'max|K4d-plain|/max|plain|<{BWD_TOL} per gradient; '
                      'at most 2x the plain f32 distance from f64',
         'library_ms': None, 'train_step_ms': train['step_ms'],
         'loss_last_over_first': train['loss_ratio'],
         'diff_solve_24s4c': diff_solve,
         **{k: main[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')},
         'rows': rows},
        {'name': 'fused_ilqr_dense (training)', 'path': 'medium training',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
         'headers': ['mpc_tpu_torch/csrc/box_qp.cuh'],
         'replaces': 'mpc_tpu/ops/fused.py:1126',
         'design': design('fused_ilqr_dense', fd.dense_kernel_defines(
             ns, nc, True, False), fd.k3d_launch(T_, n, ns, nc, 10)),
         'launches': train['launches']['fused_ilqr_dense'],
         'max_abs_err': train['fwd_err'],
         'tolerance': f'mean|du|<{LONG_TAIL_MEAN}, '
                      f'share(|du|>{TAIL_ENTRY})<{LONG_TAIL_SHARE}; '
                      'at most 2x the plain f32 distance from f64',
         'library_ms': None,
         **{k: fwd_row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                    'bound_by')}}]


# ---------------------------------------------------------------------------
# More than 8 controls: the dense forward and backward with the control
# block's factor and the box QP across the warp's lanes (csrc/box_qp_smem.cuh)
# ---------------------------------------------------------------------------

# the serving rows (utils/problems.WIDE_ROWS: the medium rows' system where
# mpc_tpu's gate admits its kernels past 8 controls at T=20) and the
# training row; the kernels line's entry is the main row's
WIDE_SERVE = ('wide-3s9c', 'wide-4s12c', 'wide-2s16c')
WIDE_MAIN = 'wide-4s12c'
WIDE_REQUESTS = 4
WIDE_UZ_DELTA = 0.3
# the MLP of [compare-dense]'s wide MLP row: 2 states, 9 controls, one
# hidden layer of 32 sigmoid units with the passthrough (the reference's
# MLP form, mpc/dynamics.py:9-13), box +-1, on the wide rows' T and B
WIDE_MLP = (2, 9, (32,), 'sigmoid', True)
# [compare-dense]'s wide cases: (label, WIDE_ROWS row or 'mlp', a batched
# u_zero_I and delta_u, gate).  The gate is fixed here, before the first
# full run: the float32 tail of the medium rows (LONG_TAIL_*) for the
# LinDx rows; float64 where a mask's kinks or an MLP part two float32
# solves (as UZ_ROWS and MLP_CASES gate their masked and stiff rows).
WIDE_CASES = (
    ('wide-3s9c', 'wide-3s9c', False, 'tail'),
    ('wide-4s12c', 'wide-4s12c', False, 'tail'),
    ('wide-2s16c', 'wide-2s16c', False, 'tail'),
    ('wide-3s9c uz delta', 'wide-3s9c', True, 'float64'),
    ('wide-mlp 2s9c', 'mlp', False, 'float64'),
)
# the gate's corners past 8 controls: (n_state, n_ctrl); each forward build
# with bounds, without bounds but with f, and with bounds and the mask;
# each backward build with the active set, and without it but with f
WIDE_CORNERS = ((1, 9), (1, 31), (4, 28), (23, 9))
WIDE_CORNER_T, WIDE_CORNER_B = 3, 33
WIDE_TRAIN_STEPS = 20
WIDE_TRAIN_MAX_RATIO = 0.7


def wide_case(label):
    return next(r for r in WIDE_CASES if r[0] == label)


def wide_problem(torch, device, label, dtype=None, n=None):
    """(cfg, x0, cost, dynamics, bounds) of a WIDE_CASES case or a WIDE_ROWS
    row at its own sizes (or on its first n examples), on the kernel route,
    from problems.wide_row's numpy seed."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils.convert import nn_dynamics_from_numpy
    from mpc_tpu_torch.utils.problems import mlp_weights, wide_row
    dtype = dtype or torch.float32
    row, uz = label, False
    if label in {c[0] for c in WIDE_CASES}:
        _, row, uz, _ = wide_case(label)
    r = wide_row('wide-3s9c' if row == 'mlp' else row, n)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    T_, B_ = r['T'], r['x0'].shape[0]
    bk = {} if r['u_lower'] is None else dict(u_lower=r['u_lower'],
                                              u_upper=r['u_upper'])
    kw = dict(r['cfg'], backprop=False, use_fused='auto')
    if row == 'mlp':
        ns, nc, hid, act, passthrough = WIDE_MLP
        rng = np.random.RandomState(41)
        dyn = nn_dynamics_from_numpy(
            mlp_weights((ns + nc,) + hid + (ns,), 41), act, passthrough,
            device=device).to(dtype)
        x0 = t(rng.randn(B_, ns))
        cost = mt.QuadCost(t(np.diag(rng.uniform(0.2, 1.0, ns + nc))),
                           t(0.2 * rng.randn(ns + nc)))
        kw['grad_method'] = mt.GradMethods.AUTO_DIFF
    else:
        ns, nc = r['n_state'], r['n_ctrl']
        x0, cost, dyn = (t(r['x0']), mt.QuadCost(t(r['C']), t(r['c'])),
                         mt.LinDx(t(r['F'])))
    if uz:
        bk['u_zero_I'] = t((np.random.RandomState(43).rand(T_, B_, nc)
                            < 0.3).astype(np.float64))
        kw['delta_u'] = WIDE_UZ_DELTA
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T_, **kw)
    return cfg, x0, cost, dyn, bk


def wide_operands(torch, device, label, dtype=None, n=None):
    from mpc_tpu_torch.ops import fused_dense as fd
    cfg, x0, cost, dyn, bk = wide_problem(torch, device, label, dtype, n)
    return fd.k3d_operands(cfg, x0, cost, dyn, **bk)


def dense_defines(ops, n=None):
    """(defines, launch geometry) of the dense build a forward's operands
    run (any model, cost, mask or f), at their batch or, where ``ops``
    are a cut of the row, at the row's ``n`` examples (the model-step
    build's workspace layout depends on the batch)."""
    from mpc_tpu_torch.ops import fused_dense as fd
    T_, n0, nc = ops['u0'].shape
    ns = ops['x0'].shape[1]
    model, slew, spec = None, False, None
    if ops.get('model') is not None:
        model, slew = fd.dense_model(ops['model'])
        spec = fd.mlp_spec(ops['model'])
    geo = fd.k3d_launch(T_, n or n0, ns, nc, len(ops['alphas']),
                        model is not None, spec[0] if spec else None)
    return (fd.dense_kernel_defines(ns, nc, ops['lb'] is not None,
                                    ops['f'] is not None, model, slew,
                                    huber=ops.get('cost_params') is not None,
                                    has_uz=ops.get('uz') is not None,
                                    mlp=spec, ws_shared=geo['ws_shared']),
            geo)


def corner_problem(torch, device, kind, ns, nc, a, b, dtype=None):
    """A gate corner's small problem: ``kind`` 'fwd' (the forward's
    operands; ``a`` bounds, ``b`` f, bounds with 'uz' as ``a`` the mask
    too) or 'bwd' (the backward's operands at a random primal with ~30%
    of the controls on the box; ``a`` the active set, ``b`` f).  T =
    WIDE_CORNER_T, B = WIDE_CORNER_B, the medium rows' system with a
    linear cost term, lqr_iter 1."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused_bwd, fused_dense as fd
    dtype = dtype or torch.float32
    T_, n = WIDE_CORNER_T, WIDE_CORNER_B
    rng = np.random.RandomState(ns * 37 + nc)
    nt = ns + nc
    A = np.eye(ns) + 0.05 * rng.randn(ns, ns)
    A /= max(1.0, np.max(np.abs(np.linalg.eigvals(A))))
    F = np.tile(np.concatenate([A, 0.3 * rng.randn(ns, nc)], 1)[None],
                (T_ - 1, 1, 1))
    C = np.diag(np.concatenate([np.ones(ns), 0.1 * np.ones(nc)]))
    c = 0.5 * rng.randn(nt)
    f = 0.1 * rng.randn(T_ - 1, ns) if b else None
    t = (lambda v: None if v is None else torch.tensor(v, dtype=dtype,
                                                      device=device))
    bounded = kind == 'bwd' or a
    bk = dict(u_lower=-0.5, u_upper=0.5) if bounded else {}
    if kind == 'fwd' and a == 'uz':
        bk['u_zero_I'] = t((rng.rand(T_, n, nc) < 0.3).astype(np.float64))
    cfg = mt.MPCConfig(n_state=ns, n_ctrl=nc, T=T_, lqr_iter=1, eps=0.0,
                       exit_unconverged=False, detach_unconverged=False,
                       backprop=False)
    ops = fd.k3d_operands(cfg, t(3 * rng.randn(n, ns)), mt.QuadCost(t(C),
                                                                   t(c)),
                          mt.LinDx(t(F), t(f)), **bk)
    if kind == 'fwd':
        return ops
    # the backward at a random primal with ~30% of the controls on the box
    us = np.clip(0.4 * rng.randn(T_, n, nc), -0.5, 0.5)
    us = np.where(rng.rand(T_, n, nc) < 0.3, 0.5 * np.sign(us), us)
    us = t(us)
    return dict(C=ops['C'], c=ops['c'], F=ops['F'],
                x_star=t(rng.randn(T_, n, ns)), u_star=us,
                I_mask=fused_bwd.active_set(us, ops['lb'], ops['ub'])
                if a else None, dl_dx=t(rng.randn(T_, n, ns)),
                dl_du=t(rng.randn(T_, n, nc))), dict(has_f=bool(b),
                                                     f_shared=True)


def wide_corner_specs():
    """The builds of the gate's corners past 8 controls: (kind, ns, nc, a,
    b, (name, defines))."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    from mpc_tpu_torch.ops import fused_dense as fd
    out = []
    for ns, nc in WIDE_CORNERS:
        for a, b in ((True, False), (False, True), ('uz', False)):
            out.append(('fwd', ns, nc, a, b, (
                'fused_ilqr_dense', fd.dense_kernel_defines(
                    ns, nc, bool(a), b, has_uz=a == 'uz'))))
        for a, b in ((True, False), (False, True)):
            out.append(('bwd', ns, nc, a, b, (
                'fused_kkt_bwd_dense', fbd.bwd_dense_kernel_defines(
                    ns, nc, a, b))))
    return out


def wide_build_specs():
    """Every build the wide phases run: the cases of [compare-dense], the
    backward of [compare-bwd-dense] and [train-dense], the corners."""
    import torch
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    specs = []
    for label, *_ in WIDE_CASES:
        s = ('fused_ilqr_dense', dense_defines(wide_operands(
            torch, torch.device('cpu'), label, n=1))[0])
        if s not in specs:
            specs.append(s)
    for has_f in (False, True):
        s = ('fused_kkt_bwd_dense', fbd.bwd_dense_kernel_defines(
            4, 12, True, has_f))
        if s not in specs:
            specs.append(s)
    return specs + [c[-1] for c in wide_corner_specs()
                    if c[-1] not in specs]


def corner_check(torch, device, index):
    """One corner build past 8 controls (``wide_corner_specs``), in a
    process run under CUDA_LAUNCH_BLOCKING=1: one launch, finite, the
    reversed batch and B = 1 alone bitwise, a pinned control exactly 0.
    The plain versions past 20 controls take minutes under
    CUDA_LAUNCH_BLOCKING=1 (a box QP trip is thousands of small kernels),
    so the corners meet them in tests/test_torch_gpu.py, and here the
    main path's rows in [compare-dense]."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    from mpc_tpu_torch.ops import fused_dense as fd
    kind, ns, nc, a, b, (name, defines) = wide_corner_specs()[int(index)]
    what = (f'corner {kind} {ns}s{nc}c '
            + ' '.join(f'{k}={v}' for k, v in sorted(defines.items())
                       if k in ('MPC_HAS_BOUNDS', 'MPC_HAS_F', 'MPC_HAS_UZ',
                                'MPC_HAS_I')))
    t0 = time.perf_counter()
    reset_all_counts()
    if kind == 'fwd':
        ops = corner_problem(torch, device, kind, ns, nc, a, b)
        if dense_defines(ops)[0] != defines:
            raise AssertionError(f'{what}: not its build')
        full = fd.fused_ilqr_dense(**ops)
        counts = dict(all_counts())
        if not all(torch.isfinite(v).all() for v in full):
            raise AssertionError(f'{what}: not finite')
        r = fd.fused_ilqr_dense(**batch_subset(
            torch, ops, torch.arange(WIDE_CORNER_B - 1, -1, -1)))
        if not all(torch.equal(x.flip(1), y) for x, y in zip(r, full)):
            raise AssertionError(f'{what}: reversed batch is not bitwise '
                                 'equal')
        hold_slices(torch, what, fd.fused_ilqr_dense, ops, full, (1,))
        uz_pinned_zero(what, ops, full[1])
    else:
        o, kw = corner_problem(torch, device, kind, ns, nc, a, b)
        full = fbd.fused_kkt_backward_dense(**o, **kw)
        counts = dict(all_counts())
        if not all(torch.isfinite(v).all() for v in full if v is not None):
            raise AssertionError(f'{what}: not finite')
        back = fbd.fused_kkt_backward_dense(**flip_batch(o, torch), **kw)
        if not torch.equal(back[0].flip(0), full[0]):
            raise AssertionError(f'{what}: reversed batch is not bitwise '
                                 'equal')
        hold_bwd_slices(torch, 'K4d', what, fbd.fused_kkt_backward_dense, o,
                        full, (1,), **kw)
    if device.type == 'cuda' and sum(counts.values()) != 1:
        raise AssertionError(f'{what}: not one launch: {counts}')
    log(f'  {what}: one launch, finite, reversed batch and B=1 bitwise; '
        f'{time.perf_counter() - t0:.1f} s')


def collect_log():
    """Make ``log`` of a worker process keep its lines for the JSON line
    the worker prints last, and print each one as it comes, so that a
    worker that faults shows how far it got.  Returns the list."""
    lines = []

    def keep(*a):
        lines.append(' '.join(map(str, a)))
        print(lines[-1], flush=True)
    globals()['log'] = keep
    return lines


def blocking_worker(device):
    """[build]'s and [compare-dense]'s checks past 8 controls that run
    under CUDA_LAUNCH_BLOCKING=1, one after another in this one process,
    so that a load through a wrong address faults at its own launch:
    ``corner_check`` of every corner build, then ``wide_bits`` of every
    WIDE_CASES case.  Prints a JSON line: each case's digest and the log
    lines."""
    import torch
    lines = collect_log()
    device = torch.device(device)
    t0 = time.perf_counter()
    for i in range(len(wide_corner_specs())):
        print(f'# corner {i}', flush=True)
        corner_check(torch, device, i)
    t1 = time.perf_counter()
    digests = {label: wide_bits(torch, device, label)
               for label, *_ in WIDE_CASES}
    print(json.dumps({'digests': digests, 'lines': lines,
                      'seconds': [t1 - t0, time.perf_counter() - t1]}))


def wide_train_worker(device, mode, path):
    """The plain version at wide-train's learner's start (the operands
    [train-dense] holds the dense forward to), in float32 (``mode``
    'f32', its device ms timed) or float64, saved to ``path`` for
    ``phase_train_dense``: at 4 states and 12 controls it takes minutes,
    so it runs beside [compare-dense]'s workers.  Prints a JSON line."""
    import torch
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused_dense as fd
    device = torch.device(device)
    t0 = time.perf_counter()
    ln = dense_learner(torch, device, wide=True)
    with torch.no_grad():
        cost = ln['make_cost'](ln['theta'])
        if mode == 'f64':
            cost = mt.QuadCost(cost.C.double(), cost.c.double())
        f64 = mode == 'f64'
        ops = fd.k3d_operands(ln['cfg'], ln['x0'].double() if f64
                              else ln['x0'], cost,
                              mt.LinDx(ln['dyn'].F.double()) if f64
                              else ln['dyn'], u_lower=-1.0, u_upper=1.0)
        times = []
        out = timed_plain(torch, fd.fused_solve_dense_plain, times)(**ops)
    torch.save({'out': [a.cpu() for a in out], 'plain_ms': times[0]}, path)
    print(json.dumps({'mode': mode, 'plain_ms': times[0],
                      'seconds': time.perf_counter() - t0}))


def bitwise_worker(torch, device, what, ops, kernel=None):
    """A forward kernel's launch (the dense one unless ``kernel`` names
    another) in a worker process under CUDA_LAUNCH_BLOCKING=1, so that a
    load through a wrong address faults at its own launch: once, finite,
    pinned controls exactly 0.0, the reversed batch, B = 1, 7, 33 alone
    (where the batch has that many) and the batch with two more examples
    bitwise.  Returns the outputs."""
    from mpc_tpu_torch.ops import fused_dense as fd
    n = ops['x0'].shape[0]
    dense = kernel is None
    kernel = kernel or fd.fused_ilqr_dense
    reset_all_counts()
    full = kernel(**ops)
    if device.type == 'cuda':
        torch.cuda.synchronize()
        if sum(all_counts().values()) != 1 or (
                dense and all_counts()['fused_ilqr_dense'] != 1):
            raise AssertionError(f'{what}: not one launch: {all_counts()}')
    if not all(torch.isfinite(a).all() for a in full):
        raise AssertionError(f'{what}: the kernel returned non-finite values')
    uz_pinned_zero(what, ops, full[1])
    r = kernel(**batch_subset(torch, ops, torch.arange(n - 1, -1, -1)))
    if not all(torch.equal(a.flip(1), b) for a, b in zip(r, full)):
        raise AssertionError(f'{what}: reversed batch is not bitwise equal')
    sizes = tuple(s for s in (1, 7, 33) if s < n)
    if sizes:
        hold_slices(torch, what, kernel, ops, full, sizes)
    r = kernel(**batch_subset(torch, ops, torch.cat(
        [torch.arange(n), torch.arange(min(2, n))])))
    if not all(torch.equal(r[i][:, :n], full[i])
               and torch.equal(r[i][:, n:], full[i][:, :min(2, n)])
               for i in range(3)):
        raise AssertionError(f'{what}: B={n + min(2, n)} differs from B={n}')
    return full


def wide_bits(torch, device, label):
    """``bitwise_worker``'s checks of one WIDE_CASES case (run under
    CUDA_LAUNCH_BLOCKING=1).  Returns the digest of the kernel's
    outputs."""
    t0 = time.perf_counter()
    ops = wide_operands(torch, device, label)
    n = ops['x0'].shape[0]
    what = f'{label}, B={n}'
    full = bitwise_worker(torch, device, what, ops)
    log(f'  {what}: one launch, reversed and B={n + 2} bitwise equal; '
        f'{time.perf_counter() - t0:.1f} s')
    return uz_digest(full)


def hold_wide(torch, device, label, runs):
    """[compare-dense] past 8 controls: one WIDE_CASES case's kernel
    against its plain version (``runs``, from ``plain_worker``) by the
    case's gate: the float32 tail of the medium rows with n_iter equal,
    or at most twice the plain float32 run's distance from a float64
    plain run; its box and mask held.  Returns the kernel's outputs and
    the case's summary (max |du|, gate, the plain float32 run's device
    ms)."""
    from mpc_tpu_torch.ops import fused_dense as fd
    ops = wide_operands(torch, device, label)
    what = f'{label}, B={ops["x0"].shape[0]}'
    log(f'[compare-dense] {what}: the kernel vs its plain version')
    gate = wide_case(label)[3]
    full = fd.fused_ilqr_dense(**ops)
    xk, uk, sk = full
    times = []
    plain = preloaded(torch, runs, times)
    _, up, sp = plain(**ops)
    _, u64, _ = plain(**wide_operands(torch, device, label, torch.float64))
    mean, share, mx = tail(uk, up)
    same_iter = same_share(sk[2], sp[2])
    if gate == 'tail':
        check_tail(f'{what} (f32)', uk, up, (LONG_TAIL_MEAN, LONG_TAIL_SHARE))
        if same_iter != 1.0:
            raise AssertionError(f'{what}: n_iter differs')
    else:
        check_tail(f'{what} (f32)', uk, up, None)
    hold_equidistance(what, uk, up, u64)
    if ops['ub'] is not None and float(uk.abs().max()) > float(
            ops['ub'].max()):
        raise AssertionError(f'{what}: a control outside its box')
    uz_pinned_zero(what, ops, uk)
    log(f'  {what}: gate {gate}; n_iter equal in {same_iter:.4f} of the '
        f'examples, a solve {float(sk[2].double().mean()):.2f}, trials a '
        f'solve {float(sk[5].double().mean()):.2f}, QP trips a solve '
        f'{float(sk[3].double().mean()):.1f} (plain '
        f'{float(sp[3].double().mean()):.1f}); controls on the box '
        f'{float((uk.abs() == 1.0).double().mean()):.3f}; max |u - f64|: '
        f'kernel {float((uk.double() - u64).abs().max()):.3e}, plain '
        f'{float((up.double() - u64).abs().max()):.3e}; plain '
        f'{times[0]:.1f} ms')
    return what, full, dict(gate=gate, max_abs_err=mx, mean=mean,
                            share=share, same_iter=same_iter,
                            plain_ms=times[0])


def phase_compare_wide(torch, device):
    """[build]'s corner builds past 8 controls and [compare-dense] past 8
    controls, their processes all at once: one process under
    CUDA_LAUNCH_BLOCKING=1 (``blocking_worker``: each corner build, then
    each WIDE_CASES case's bitwise checks); each case's plain version in
    float32 and in float64, a process each (``plain_worker``); and the
    plain versions at wide-train's learner's start in float32 and float64
    (``wide_train_worker``) for [train-dense].  Here each case's kernel
    gives the bits of the CUDA_LAUNCH_BLOCKING=1 process and meets its
    plain version (``hold_wide``).  Returns each case's summary (max
    |du|, gate, the plain float32 run's device ms) and the paths of the
    saved plain runs."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, 'build', 'chip_smoke')
    os.makedirs(root, exist_ok=True)
    held = {m: os.path.join(root, f'wide_train_{m}.pt')
            for m in ('f32', 'f64')}
    k = len(WIDE_CASES)
    log(f'[compare-dense] past 8 controls: {k} cases; the corner builds and '
        'the cases\' bitwise checks in one process under '
        'CUDA_LAUNCH_BLOCKING=1, the plain versions in processes beside it')
    blocking = start_workers([['--blocking-worker', device.type]],
                             [{'CUDA_LAUNCH_BLOCKING': '1'}])
    train = start_workers([['--wide-train-worker', device.type, m, held[m]]
                           for m in held])
    plain = start_plain(device, 'wide', [c[0] for c in WIDE_CASES],
                        2 * len(WIDE_CASES))
    (bits,) = join_workers(blocking)
    for line in bits['lines']:
        log(line)
    log(f'[build] {len(wide_corner_specs())} corner builds past 8 controls '
        f'({bits["seconds"][0]:.1f} s), then the bitwise checks of '
        f'[compare-dense]\'s {k} cases ({bits["seconds"][1]:.1f} s), one '
        'process under CUDA_LAUNCH_BLOCKING=1 beside the plain versions: '
        f'{time.perf_counter() - t0:.1f} s')
    runs = plain_runs(torch, device, plain)
    res = {}
    for label, *_ in WIDE_CASES:
        what, full, res[label] = hold_wide(torch, device, label, runs[label])
        if uz_digest(full) != bits['digests'][label]:
            raise AssertionError(f'{what}: not the bits of its '
                                 'CUDA_LAUNCH_BLOCKING=1 process')
    join_workers(train)
    log(f'[compare-dense] past 8 controls: {k} cases (the bitwise checks '
        'under CUDA_LAUNCH_BLOCKING=1, the plain versions a process each) '
        'and wide-train\'s plain runs, all at once: '
        f'{time.perf_counter() - t0:.1f} s')
    return res, held


def phase_serve_wide(torch, device):
    """[serve-dense] past 8 controls: each WIDE_SERVE row through the entry
    points, every count set to 0 before and read after: WIDE_REQUESTS
    distinct batches through batched_solve (new starts from the row's
    seeds) and one through MPC, host to host, one dense launch a request
    and no eager solve, MPC bitwise batched_solve, the last answer x the
    rollout of u, costs their objective, u in its box; at WIDE_MAIN beside
    it the eager route's (use_fused='never') ms of the first request (some
    ten seconds a row).  Returns the launches, request ms and eager ms by
    row."""
    import dataclasses
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    from mpc_tpu_torch.utils.problems import wide_row
    out = {'launches': {}, 'request_ms': {}, 'mpc_ms': {}, 'eager_ms': {}}
    for label in WIDE_SERVE:
        cfg, x0, cost, dyn, bk = wide_problem(torch, device, label)
        n = x0.shape[0]
        reqs = [torch.tensor(wide_row(label, n, seed=300 + i)['x0'],
                             dtype=torch.float32)
                for i in range(WIDE_REQUESTS)]
        mt.batched_solve(cfg, x0, cost, dyn, device=device, **bk).u.cpu()
        ctrl = mt.MPC(cfg.n_state, cfg.n_ctrl, cfg.T, lqr_iter=cfg.lqr_iter,
                      eps=cfg.eps, exit_unconverged=False,
                      detach_unconverged=False, backprop=False,
                      device=device, **bk)

        def serve():
            lat, sols = [], []
            for req in reqs:
                t0 = time.perf_counter()
                sol = mt.batched_solve(cfg, req.to(device), cost, dyn,
                                       device=device, **bk)
                u = sol.u.cpu()
                lat.append(1e3 * (time.perf_counter() - t0))
                sols.append((sol, u))
            t0 = time.perf_counter()
            um = ctrl(reqs[0].to(device), cost, dyn)[1].cpu()
            return lat, sols, um, 1e3 * (time.perf_counter() - t0)

        (lat, sols, um, mpc_ms), counts, n_eager = soa_counted(torch, serve)
        ms = median(lat)
        log(f'[serve-dense] {label}, B={n}: {WIDE_REQUESTS} batched_solve '
            'requests, latency ms ' + ' '.join(f'{v:.3f}' for v in lat) +
            f', median {ms:.3f} ({n / ms * 1e3:.0f} solves/s); MPC '
            f'{mpc_ms:.3f} ms; launches {counts}, eager solves {n_eager}')
        if n_eager or (device.type == 'cuda' and counts != {
                'fused_ilqr_dense': WIDE_REQUESTS + 1}):
            raise AssertionError(f'{label}: each request must launch the '
                                 'dense kernel once and nothing else')
        if not torch.equal(um, sols[0][1]):
            raise AssertionError(f'{label}: MPC and batched_solve answer '
                                 'differently')
        sol, u = sols[-1][0], sols[-1][1].to(device)
        xr = rollout(dyn, reqs[-1].to(device), u)
        cr = trajectory_cost(cost, xr, u)
        gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
        x_gap = float((xr - sol.x).abs().max() / sol.x.abs().max())
        box = float(bk.get('u_upper', math.inf))
        log(f'  last answer: relative cost gap to its own rollout {gap:.2e}, '
            f'max |x - rollout| / max |x| {x_gap:.2e}, max |u| '
            f'{float(u.abs().max()):.3f}')
        if not (torch.isfinite(u).all() and float(u.abs().max()) <= box
                and gap < 1e-3 and x_gap < 1e-3):
            raise AssertionError(f'{label}: a served answer is not a '
                                 'feasible solve')
        out['launches'][label] = WIDE_REQUESTS + 1
        out['request_ms'][label], out['mpc_ms'][label] = ms, mpc_ms
        if label != WIDE_MAIN:
            continue
        never = dataclasses.replace(cfg, use_fused='never')
        (eager, eager_ms), n_eager = eager_counted(torch, lambda: timed(
            torch, device, lambda: mt.batched_solve(
                never, reqs[0].to(device), cost, dyn, device=device,
                **bk).u, 1))
        log(f'  the eager route (use_fused=\'never\') of the first request: '
            f'{eager_ms:.1f} ms ({eager_ms / ms:.0f}x the kernel route), '
            f'eager solves {n_eager}, max |u - kernel route\'s| '
            f'{float((eager[0].cpu() - sols[0][1]).abs().max()):.3e}; '
            f'{card_line()}')
        out['eager_ms'][label] = eager_ms
    return out


def phase_time_wide(torch, device, compare):
    """[time-dense] past 8 controls: each WIDE_SERVE row from a CUDA graph
    beside its bound (``time_dense_row``: k3d_flops from this run's
    iterations, trials and QP trips; a trip counts the arithmetic the
    shared-memory QP runs for one step size, the same as the register
    one's), the plain version's device time from [compare-dense]
    (``compare``), registers and spills.  Returns the rows."""
    return [time_dense_row(torch, label, wide_operands(torch, device, label),
                           plain_ms=compare[label]['plain_ms'])
            for label in WIDE_SERVE]


def wide_bwd_operands(torch, device, n=None, seed=14):
    """The dense backward's operands at the main wide row (4s12c, B=1024
    unless given): x*, u* from the dense forward on the row's problem, the
    active set from its box, seeded random cotangents."""
    import numpy as np
    from mpc_tpu_torch.ops import fused_bwd, fused_dense as fd
    ops = wide_operands(torch, device, WIDE_MAIN,
                        n=n or TRAIN_DENSE_B)
    xs, us, _ = fd.fused_ilqr_dense(**ops)
    rng = np.random.RandomState(seed)
    T_, n, ns = xs.shape
    nc = us.shape[-1]
    t = (lambda a: torch.tensor(a, dtype=torch.float32, device=device))
    return dict(C=ops['C'], c=ops['c'], F=ops['F'], x_star=xs, u_star=us,
                I_mask=fused_bwd.active_set(us, ops['lb'], ops['ub']),
                dl_dx=t(rng.randn(T_, n, ns)),
                dl_du=t(rng.randn(T_, n, nc))), dict(has_f=False,
                                                      f_shared=True)


def phase_compare_bwd_wide(torch, device):
    """[compare-bwd-dense] past 8 controls: the dense backward at 4s12c,
    B=1024, same-primal against its plain version (hold_bwd), a second
    launch bitwise, the reversed batch, B = 1, 7, 33 alone and B + 2
    bitwise on the per-example outputs.  Returns the largest
    |difference|."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    o, kw = wide_bwd_operands(torch, device)
    n = o['x_star'].shape[1]
    what = f'{WIDE_MAIN}, B={n}'
    log(f'[compare-bwd-dense] dense backward vs its plain version, {what}; '
        f'active controls {float(o["I_mask"].mean()):.3f} of T*B')
    kk, err = hold_bwd(torch, 'K4d', what, fbd.fused_kkt_backward_dense,
                       fbd.fused_kkt_backward_dense_plain, o, **kw)
    again = fbd.fused_kkt_backward_dense(**o, **kw)
    if not all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(again, kk)):
        raise AssertionError(f'{what}: a second launch differs')
    back = fbd.fused_kkt_backward_dense(**flip_batch(o, torch), **kw)
    if not torch.equal(back[0].flip(0), kk[0]):
        raise AssertionError(f'{what}: reversed batch is not bitwise equal')
    hold_bwd_slices(torch, 'K4d', what, fbd.fused_kkt_backward_dense, o, kk,
                    **kw)
    more = fbd.fused_kkt_backward_dense(**batch_subset_bwd(
        torch, o, torch.cat([torch.arange(n), torch.arange(2)])), **kw)
    if not torch.equal(more[0][:n], kk[0]):
        raise AssertionError(f'{what}: B={n + 2} differs from B={n}')
    log(f'    a second launch bitwise, reversed batch and B={n + 2} bitwise '
        'on dx_init')
    return err


def phase_time_bwd_wide(torch, device):
    """[time-bwd-dense] past 8 controls: the dense backward at 4s12c,
    B=1024, from a CUDA graph, its three kernels apart, its bound
    (k4d_flops, k4d_bytes), registers and spills, the plain version.
    Returns the row."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    o, kw = wide_bwd_operands(torch, device)
    T_, n, ns = o['x_star'].shape
    nc = o['u_star'].shape[-1]

    def launch():
        return fbd.fused_kkt_backward_dense(**o, **kw)
    ms, eager_ms = graph_ms(torch, launch)
    split = kernel_device_us(torch, launch)
    parts = {name: sum(v for k, v in split.items() if name in k) / 1e3
             for name in ('chains', 'grads', 'sums')}
    pms = event_ms(torch, lambda: fbd.fused_kkt_backward_dense_plain(
        **o, **kw))
    flops = fbd.k4d_flops(T_, n, ns, nc, has_I=True, has_f=False,
                          reduced=('C', 'c', 'F'))
    nbytes = fbd.k4d_bytes(o['C'], o['c'], o['F'], o['x_star'],
                           o['u_star'], o['I_mask'], **kw)
    bound_ms, by = bound(flops, nbytes)
    des = design('fused_kkt_bwd_dense', fbd.bwd_dense_kernel_defines(
        ns, nc, True, False), fbd.k4d_launch(T_, n, ns, nc))
    log(f'[time-bwd-dense] {WIDE_MAIN} {ns}s{nc}c, B={n}, T={T_}: '
        f'{ms:.4f} ms (from a CUDA graph; {eager_ms:.4f} ms a call from '
        f'Python; chains {parts["chains"]:.4f}, gradients '
        f'{parts["grads"]:.4f}, chunk-order sums {parts["sums"]:.4f} ms '
        f'from torch.profiler), plain {pms:.1f} ms; {flops:.4e} operations, '
        f'{nbytes} bytes; bound {bound_ms:.5f} ms by {by} '
        f'({ms / bound_ms:.1f}x); registers {des["registers"]}, spill '
        f'stores {des["spill_store_bytes"]} bytes, shared memory '
        f'{des["shared_memory_bytes"]} bytes a block; {card_line()}')
    return dict(row=f'{WIDE_MAIN} {ns}s{nc}c B={n}', ms=ms, plain_ms=pms,
                bound_ms=bound_ms, bound_by=by, chains_ms=parts['chains'],
                grads_ms=parts['grads'], sums_ms=parts['sums'],
                registers=des['registers'],
                spill_store_bytes=des['spill_store_bytes'])


def wide_entries(torch, compare, serve, rows, bwd_err, bwd_row, train,
                 fwd_row):
    """The kernels line's entries past 8 controls: the dense forward on the
    wide serving path (the main row's [serve-dense] launches and
    [time-dense] row; every wide row under 'rows') and, on the wide
    training path ([train-dense] at wide-train), the dense backward and
    the dense forward at that path's shape."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd, fused_dense as fd
    by_row = {r['row'].split(' B=')[0]: r for r in rows}
    main = by_row[WIDE_MAIN]
    r = wide_operands(torch, torch.device('cpu'), WIDE_MAIN, n=1)
    T_, _, nc = r['u0'].shape
    ns = r['x0'].shape[1]
    n_serve = int(main['row'].split(' B=')[1])
    headers = ['mpc_tpu_torch/csrc/box_qp.cuh',
               'mpc_tpu_torch/csrc/box_qp_smem.cuh']
    tol = (f'mean|du|<{LONG_TAIL_MEAN}, '
           f'share(|du|>{TAIL_ENTRY})<{LONG_TAIL_SHARE}; '
           'at most 2x the plain f32 distance from f64')
    return [
        {'name': 'fused_ilqr_dense (wide)', 'path': 'wide serving',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
         'headers': headers, 'replaces': 'mpc_tpu/ops/fused.py:1126',
         'design': design('fused_ilqr_dense', fd.dense_kernel_defines(
             ns, nc, True, False), fd.k3d_launch(T_, n_serve, ns, nc, 10)),
         'launches': serve['launches'][WIDE_MAIN],
         'launches_by_row': serve['launches'],
         'max_abs_err': max(v['max_abs_err'] for v in compare.values()),
         'tolerance': tol, 'library_ms': None,
         'request_ms': serve['request_ms'], 'eager_ms': serve['eager_ms'],
         **{k: main[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')},
         'rows': rows},
        {'name': 'fused_kkt_bwd_dense (wide training)',
         'path': 'wide training', 'route': 'cuda',
         'source': 'mpc_tpu_torch/csrc/fused_kkt_bwd_dense.cu',
         'headers': headers, 'replaces': 'mpc_tpu/ops/fused_bwd.py:251',
         'also_replaces': 'mpc_tpu/ops/fused_bwd.py:413',
         'design': design('fused_kkt_bwd_dense',
                          fbd.bwd_dense_kernel_defines(ns, nc, True, False),
                          fbd.k4d_launch(T_, TRAIN_DENSE_B, ns, nc)),
         'launches': train['launches']['fused_kkt_bwd_dense'],
         'max_abs_err': bwd_err,
         'tolerance': f'max|K4d-plain|/max|plain|<{BWD_TOL} per gradient; '
                      'at most 2x the plain f32 distance from f64',
         'library_ms': None, 'train_step_ms': train['step_ms'],
         'loss_last_over_first': train['loss_ratio'],
         **{k: bwd_row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                    'bound_by')}},
        {'name': 'fused_ilqr_dense (wide training)', 'path': 'wide training',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
         'headers': headers, 'replaces': 'mpc_tpu/ops/fused.py:1126',
         'design': design('fused_ilqr_dense', fd.dense_kernel_defines(
             ns, nc, True, False), fd.k3d_launch(T_, TRAIN_DENSE_B, ns, nc,
                                                 10)),
         'launches': train['launches']['fused_ilqr_dense'],
         'max_abs_err': train['fwd_err'], 'tolerance': tol,
         'library_ms': None,
         **{k: fwd_row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                    'bound_by')}}]


# ---------------------------------------------------------------------------
# The nonlinear models in the kernels: the cartpole (config 3) and the
# slew-augmented models in the dense configuration's model-step build, the
# damped pendulum in K1 and K3
# ---------------------------------------------------------------------------

# the damped, biased pendulum's (g, m, l, d, b)
SOA_DAMPED = (10.0, 1.0, 1.0, 0.1, 0.05)
SOA_LONG_T = 200
# (label, model, T, B, kernel): config 3 (benchmarks/configs.py:173-202)
# and the cartpole at T=200 in the dense configuration; the damped
# pendulum at the headline's sizes in K1 and at T=200 in K3; the headline
# under slew_rate_penalty=0.5 (4 augmented states) in the dense
# configuration
SOA_ROWS = (
    ('config 3', 'cartpole', 25, CARTPOLE_B, 'dense'),
    (f'cartpole T={SOA_LONG_T}', 'cartpole', SOA_LONG_T, CARTPOLE_B, 'dense'),
    ('damped', 'damped', T, B, 'K1'),
    (f'damped T={SOA_LONG_T}', 'damped', SOA_LONG_T, B, 'K3'),
    ('slew 0.5', 'slew', T, B, 'dense'),
)
SOA_MAIN = SOA_ROWS[0]
SOA_REQUESTS = 4
SOA_LOOP_STEPS = 20
SOA_GRAD_B = CARTPOLE_B
# The cartpole's controls span +-100 (100x the pendulum's +-2 and 200x
# the unit scale of the float32 tail's TAIL_ENTRY), and its objective
# weighs a control by 0.001, so a float32 round-off tie of the line search
# leaves two solves apart by ~1e-3 of the range where the pendulum's part
# by ~1e-3 absolute.  Its tail is held relative to that range: mean |du|
# and the share above TAIL_ENTRY, both of |du| / CART_U_SCALE.
CART_U_SCALE = 100.0


def soa_problem(torch, device, label, dtype=None, n=None):
    """(cfg, x0, cost, dynamics, bounds, prev_ctrl) of a SOA_ROWS row at
    its own sizes (or on its first n examples), on the kernel route."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PendulumDx
    dtype = dtype or torch.float32
    _, model, T_, n0, _ = next(r for r in SOA_ROWS if r[0] == label)
    n = n or n0
    if model == 'cartpole':
        x0, cost, dx = cartpole_problem(torch, device, dtype, n)
        cfg = mt.MPCConfig(**dict(CARTPOLE, T=T_, use_fused='auto'),
                           grad_method=mt.GradMethods.AUTO_DIFF)
        return cfg, x0, cost, dx, dict(u_lower=-100.0, u_upper=100.0), None
    box = dict(u_lower=-2.0, u_upper=2.0)
    if model == 'damped':
        dx = PendulumDx(params=torch.tensor(SOA_DAMPED, dtype=dtype,
                                            device=device), simple=False)
        q, p = dx.get_true_obj()
        return (mt.MPCConfig(**dict(HEADLINE, T=T_)),
                x0_batch(n, 5, torch, device).to(dtype),
                mt.QuadCost(torch.diag(q), p), dx, box, None)
    dx, cost = problem(torch, device, dtype)
    prev = torch.tensor(np.random.RandomState(33).uniform(-1, 1, (n, 1)),
                        dtype=dtype, device=device)
    return (mt.MPCConfig(**dict(HEADLINE, T=T_, slew_rate_penalty=0.5)),
            x0_batch(n, 7, torch, device).to(dtype), cost, dx, box, prev)


def soa_operands(torch, device, label, dtype=None, n=None):
    """A SOA_ROWS row's kernel operands, its kernel and plain version."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    cfg, x0, cost, dx, bk, prev = soa_problem(torch, device, label, dtype, n)
    kernel = next(r for r in SOA_ROWS if r[0] == label)[4]
    if kernel == 'dense':
        if prev is not None:
            cfg, x0, cost, dx = fused.slew_problem(cfg, x0, cost, dx, prev)
        return (fd.k3d_operands(cfg, x0, cost, dx, **bk),
                fd.fused_ilqr_dense, fd.fused_solve_dense_plain)
    if kernel == 'K1':
        return (fused.k1_operands(cfg, x0, cost, dx, **bk),
                fused.fused_ilqr, fused.fused_solve_plain)
    return (fused.k3_operands(cfg, x0, cost, dx, **bk),
            fused.fused_ilqr_long, fused.fused_solve_long_plain)


def soa_build_specs():
    """The model-step builds the nonlinear models' phases run: each dense
    SOA_ROWS row's in both workspace layouts (the one its batch takes, the
    other forced by [time-soa]), and the slew-augmented damped pendulum
    and cartpole in global memory."""
    import torch
    from mpc_tpu_torch.ops import fused_dense as fd
    specs = []
    for label, _, T_, n, kernel in SOA_ROWS:
        if kernel == 'dense':
            # and in the other layout, which [time-soa] times beside
            d = dense_defines(soa_operands(torch, torch.device('cpu'), label,
                                           n=1)[0], n)[0]
            other = dict(d, MPC_WS_SHARED=1)
            if 'MPC_WS_SHARED' in d:
                other.pop('MPC_WS_SHARED')
            for s in (('fused_ilqr_dense', d), ('fused_ilqr_dense', other)):
                if s not in specs:
                    specs.append(s)
    specs += [('fused_ilqr_dense', fd.dense_kernel_defines(
        ns, 1, True, False, model, True)) for ns, model in (
            (4, 'damped_pendulum'), (6, 'cartpole'))]
    return specs


def soa_limits(label):
    """The float32 tail of a row: the pendulum's; the cartpole's at the
    long configuration's level, relative to its control range
    (CART_U_SCALE); None for the damped pendulum past K1's horizon, held
    against float64 alone (``hold_long_pendulum``)."""
    _, model, T_, _, _ = next(r for r in SOA_ROWS if r[0] == label)
    if model == 'cartpole':
        return (LONG_TAIL_MEAN, LONG_TAIL_SHARE)
    return None if model == 'damped' and T_ > T else (TAIL_MEAN, TAIL_SHARE)


def hold_long_pendulum(torch, what, ops, ops64, kernel, plain):
    """A long pendulum horizon, where two float32 solves drift apart
    (PEND_LONG_T's note; on an NVIDIA H100 80GB HBM3 at 700 W the damped
    pendulum at T=200 parts by mean |du| 8.6e-3, 3.3% of entries past
    1e-3): the tail shown, the kernel held against the float64 plain run
    (at most twice the plain float32 run's distance), the counts as the
    teams' compare holds them (n_iter equal in TEAMS_SAME_ITER of the
    examples), the reversed batch bitwise.  Returns the kernel's
    outputs and max |du|."""
    xk, uk, sk = kernel(**ops)
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    if not all(torch.isfinite(t).all() for t in (xk, uk, sk)):
        raise AssertionError(f'{what}: the kernel returned non-finite values')
    hold_f64(what, uk, up, u64)
    hold_counts(torch, what, sk, sp, mixed=False, trials=False)
    B_ = ops['x0'].shape[0]
    r = kernel(**batch_subset(torch, ops, torch.arange(B_ - 1, -1, -1)))
    if not all(torch.equal(a.flip(1), b) for a, b in zip(r, (xk, uk, sk))):
        raise AssertionError(f'{what}: reversed batch is not bitwise equal')
    log('  reversed batch: bitwise equal')
    return (xk, uk, sk), float((uk - up).abs().max())


def phase_compare_soa(torch, device):
    """Each SOA_ROWS row's kernel against its plain version on the card
    (hold_k1: the float32 tail, n_iter equal, at most twice the plain
    float32 run's distance from a float64 plain run, the reversed batch
    bitwise), B = 1, 7, 33 alone and the batch with two more examples
    bitwise.  The cartpole's controls are held divided by CART_U_SCALE.
    Returns max |du| and the plain float32 run's device ms, by row."""
    max_du, plain_ms = {}, {}
    t0 = time.perf_counter()
    runs = plain_runs(torch, device, start_plain(
        device, 'soa', [r[0] for r in SOA_ROWS], 4))
    log(f'[compare-soa] the plain versions, each row in float32 and in '
        f'float64, over 4 processes at once: {time.perf_counter() - t0:.1f} '
        's')
    for label, model, T_, n, kname in SOA_ROWS:
        what = f'{label} ({kname}), B={n}, T={T_}'
        log(f'[compare-soa] {what}: kernel vs its plain version')
        t0 = time.perf_counter()
        ops, kernel, _ = soa_operands(torch, device, label)
        ops64, _, _ = soa_operands(torch, device, label, torch.float64)
        times = []
        plain = preloaded(torch, runs[label], times)
        scale = CART_U_SCALE if model == 'cartpole' else 1.0
        if soa_limits(label) is None:
            full, mx = hold_long_pendulum(torch, what, ops, ops64, kernel,
                                          plain)
        elif scale != 1.0:
            def scaled(fn):
                def run(**o):
                    x, u, s = fn(**o)
                    return x, u / scale, s
                return run
            full, mx = hold_k1(torch, what, ops, ops64,
                               kernel=scaled(kernel), plain=scaled(plain),
                               limits=soa_limits(label))
        else:
            full, mx = hold_k1(torch, what, ops, ops64, kernel=kernel,
                               plain=plain, limits=soa_limits(label))
        plain_ms[label] = times[0]
        max_du[label] = mx * scale
        if scale != 1.0:
            full = kernel(**ops)
        hold_slices(torch, what, kernel, ops, full)
        r = kernel(**batch_subset(torch, ops, torch.cat(
            [torch.arange(n), torch.arange(2)])))
        if not all(torch.equal(r[i][:, :n], full[i])
                   and torch.equal(r[i][:, n:], full[i][:, :2])
                   for i in range(3)):
            raise AssertionError(f'{what}: B={n + 2} differs from B={n}')
        box = 100.0 if model == 'cartpole' else 2.0
        log(f'  {what}: B={n + 2} bitwise equal to B={n}; controls on the '
            f'box {float((full[1].abs() == box).double().mean()):.3f}, '
            f'n_iter a solve {float(full[2][2].double().mean()):.2f}, trials '
            f'a solve {float(full[2][5].double().mean()):.2f}; plain '
            f'{times[0]:.1f} ms; {time.perf_counter() - t0:.1f} s')
    return max_du, plain_ms


def soa_counted(torch, fn):
    """``fn()`` with every count set to 0 just before and read just after:
    (result, the nonzero launch counts, eager solves)."""
    from mpc_tpu_torch import solver
    reset_all_counts()
    solver.reset_eager_counts()
    out = fn()
    return (out, {k: v for k, v in all_counts().items() if v},
            solver.eager_counts['eager_solve'])


def phase_serve_soa(torch, device):
    """The rows through the entry points, every count set to 0 before and
    read after: config 3 as SOA_REQUESTS distinct batches through
    batched_solve and one through MPC (host to host, one dense launch a
    request and no eager solve), a closed loop of SOA_LOOP_STEPS steps
    through make_closed_loop (one dense launch a step, bitwise the host
    loop of batched_solve), and two requests of each other row (one launch
    of its kernel each).  The last config-3 answer holds up: x the
    rollout of u, costs its objective, u in its box.  Returns the
    launches by row, config 3's median request ms, MPC's ms and the
    loop's ms a step."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    out = {'launches': {}}
    cfg, x0, cost, dx, bk, _ = soa_problem(torch, device, 'config 3')
    n = x0.shape[0]
    reqs = []
    for i in range(SOA_REQUESTS):
        th = 0.5 * (2 * np.random.RandomState(400 + i).rand(n) - 1)
        z = np.zeros(n)
        reqs.append(torch.tensor(np.stack([z, z, np.cos(th), np.sin(th), z],
                                          1), dtype=torch.float32))
    mt.batched_solve(cfg, x0, cost, dx, device=device, **bk).u.cpu()
    ctrl = mt.MPC(5, 1, cfg.T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                  linesearch_decay=cfg.linesearch_decay,
                  max_linesearch_iter=cfg.max_linesearch_iter,
                  grad_method=mt.GradMethods.AUTO_DIFF,
                  exit_unconverged=False, detach_unconverged=False,
                  backprop=False, device=device, **bk)

    def serve():
        lat, sols = [], []
        for req in reqs:
            t0 = time.perf_counter()
            sol = mt.batched_solve(cfg, req.to(device), cost, dx,
                                   device=device, **bk)
            u = sol.u.cpu()
            lat.append(1e3 * (time.perf_counter() - t0))
            sols.append((sol, u))
        t0 = time.perf_counter()
        um = ctrl(reqs[0].to(device), cost, dx)[1].cpu()
        return lat, sols, um, 1e3 * (time.perf_counter() - t0)

    (lat, sols, um, mpc_ms), counts, n_eager = soa_counted(torch, serve)
    n_req = SOA_REQUESTS + 1
    ms = median(lat)
    log(f'[serve-soa] config 3, B={n}: {SOA_REQUESTS} batched_solve requests, '
        'latency ms ' + ' '.join(f'{v:.3f}' for v in lat) + f', median '
        f'{ms:.3f} ({n / ms * 1e3:.0f} solves/s); MPC {mpc_ms:.3f} ms; '
        f'launches {counts}, eager solves {n_eager}')
    if n_eager or (device.type == 'cuda'
                   and counts != {'fused_ilqr_dense': n_req}):
        raise AssertionError('each config-3 request must launch the dense '
                             'kernel once and nothing else')
    if not torch.equal(um, sols[0][1]):
        raise AssertionError('MPC and batched_solve answer differently')
    sol, u = sols[-1]
    x = reqs[-1].to(device)
    xr = rollout(dx, x, u.to(device))
    cr = trajectory_cost(cost, xr, u.to(device))
    gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
    x_gap = float((xr - sol.x).abs().max() / sol.x.abs().max())
    log(f'  last answer: relative cost gap to its own rollout {gap:.2e}, '
        f'max |x - rollout| / max |x| {x_gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 100.0
            and gap < 1e-3 and x_gap < 1e-3):
        raise AssertionError('served controls are not a feasible solve')
    out['launches']['config 3'] = n_req
    out['request_ms'], out['mpc_ms'] = ms, mpc_ms
    # the closed loop: one launch a step, bitwise the host loop
    roll = mt.make_closed_loop(cfg, cost, dx, device=device, **bk)
    roll(x0, 2)
    (lp, counts, n_eager) = soa_counted(torch, lambda: host_ms(
        torch, device, lambda: roll(x0, SOA_LOOP_STEPS)))
    loop_ms, loop = lp
    x, u_warm, xs, us = x0, torch.zeros(cfg.T, n, 1, device=device), [x0], []
    for _ in range(SOA_LOOP_STEPS):
        s = mt.batched_solve(cfg, x, cost, dx, u_init=u_warm, device=device,
                             **bk)
        x = dx(x, s.u[0])
        u_warm = torch.cat([s.u[1:], torch.zeros_like(s.u[:1])])
        xs.append(x)
        us.append(s.u[0])
    same_bits(f'make_closed_loop, {SOA_LOOP_STEPS} steps at B={n}, vs the '
              'host loop, xs and us', torch,
              [(loop['xs'], torch.stack(xs)), (loop['us'], torch.stack(us))])
    log(f'  closed loop: {loop_ms:.1f} ms for {SOA_LOOP_STEPS} steps '
        f'({1e3 * loop_ms / SOA_LOOP_STEPS:.0f} us a step), launches '
        f'{counts}, eager solves {n_eager}; {card_line()}')
    if n_eager or (device.type == 'cuda' and counts != {
            'fused_ilqr_dense': SOA_LOOP_STEPS}):
        raise AssertionError('each closed-loop step must launch the dense '
                             'kernel once and nothing else')
    out['loop_us_per_step'] = 1e3 * loop_ms / SOA_LOOP_STEPS
    out['launches']['closed loop'] = SOA_LOOP_STEPS
    # two requests of each other row, one launch of its kernel each
    kname = {'dense': 'fused_ilqr_dense', 'K1': 'fused_ilqr',
             'K3': 'fused_ilqr_long'}
    for label, _, T_, n_, kernel in SOA_ROWS[1:]:
        cfg_, x0_, cost_, dx_, bk_, prev = soa_problem(torch, device, label)
        (sols_, counts, n_eager) = soa_counted(torch, lambda: [
            mt.batched_solve(cfg_, x0_, cost_, dx_, prev_ctrl=prev,
                             device=device, **bk_).u.cpu() for _ in range(2)])
        log(f'[serve-soa] {label}, B={n_}, T={T_}: two requests, launches '
            f'{counts}, eager solves {n_eager}')
        if n_eager or (device.type == 'cuda'
                       and counts != {kname[kernel]: 2}) \
                or not torch.isfinite(sols_[-1]).all():
            raise AssertionError(f'{label}: each request must launch its '
                                 'kernel once and nothing else')
        out['launches'][label] = 2
    return out


def soa_flops(ops, label, stats):
    """The operations of a SOA_ROWS row's solve from this run's counts,
    and the bytes it must move."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    kernel = next(r for r in SOA_ROWS if r[0] == label)[4]
    sums = [float(stats[i].double().sum()) for i in (2, 3, 5)]
    n = ops['x0'].shape[0]
    T_ = ops['u0'].shape[0]
    if kernel == 'dense':
        ns = ops['x0'].shape[1]
        name, _ = fd.dense_model(ops['model'])
        return (fd.k3d_flops(T_, ns, 1, sums[0], sums[2], batch=n,
                             model_ops=fd.model_op_counts(name)),
                fd.k3d_bytes(ops))
    if kernel == 'K1':
        return (fused.k1_flops(T_, 3, 1, sums[0], sums[2], batch=n,
                               damped=True), fused.k1_bytes(ops))
    return (fused.k3_flops(T_, 3, 1, sums[0], sums[2], batch=n, lindx=False,
                           damped=True), fused.k1_bytes(ops))


def soa_design(ops, label):
    """The design entry (geometry, registers, spills) of a row's build."""
    from mpc_tpu_torch.ops import fused
    kernel = next(r for r in SOA_ROWS if r[0] == label)[4]
    T_, n = ops['u0'].shape[:2]
    n_alpha = len(ops['alphas'])
    if kernel == 'dense':
        return design('fused_ilqr_dense', *dense_defines(ops))
    if kernel == 'K1':
        return design('fused_ilqr', fused.kernel_defines(T_, True, True),
                      fused.k1_launch(T_, n, n_alpha))
    return design('fused_ilqr_long', *nn_defines(ops))


def phase_time_soa(torch, device, plain_ms):
    """Each SOA_ROWS row's kernel timed from a CUDA graph, its bound from
    this run's iterations and trial rollouts (k3d_flops with the model's
    operation counts, k1_flops and k3_flops with the damped pendulum's),
    its registers and spills, beside the plain version's ms of
    [compare-soa].  Returns the rows."""
    rows = []
    for label, model, T_, n, kname in SOA_ROWS:
        ops, kernel, _ = soa_operands(torch, device, label)
        _, _, st = kernel(**ops)
        ms, eager_ms = graph_ms(torch, lambda: kernel(**ops), reps=3,
                                per_graph=4)
        flops, nbytes = soa_flops(ops, label, st)
        bound_ms, by = bound(flops, nbytes)
        des = soa_design(ops, label)
        log(f'[time-soa] {label} ({kname}), B={n}, T={T_}: {ms:.4f} ms (from '
            f'a CUDA graph; {eager_ms:.4f} ms a call from Python), plain '
            f'{plain_ms[label]:.1f} ms; {flops:.4e} operations '
            f'({float(st[2].double().mean()):.2f} iterations, '
            f'{float(st[5].double().mean()):.2f} trials a solve), {nbytes} '
            f'bytes; bound {bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
            f'{n / ms * 1e3:.0f} solves/s; '
            + (residency(des, dense_defines(ops)[1]) if kname == 'dense' else
               f'registers {des["registers"]}, spill stores '
               f'{des["spill_store_bytes"]} bytes') + f'; {card_line()}')
        rows.append(dict(row=f'{label} B={n} T={T_}', ms=ms,
                         plain_ms=plain_ms[label], bound_ms=bound_ms,
                         bound_by=by, registers=des['registers'],
                         spill_store_bytes=des['spill_store_bytes'],
                         design=des))
        if kname == 'dense':
            # the model-step build with its workspace in the other memory
            # (fused_dense.dense_ws_shared replaced for the timing), the
            # same bits
            from mpc_tpu_torch.ops import fused_dense as fd
            shared = dense_defines(ops)[1]['ws_shared']
            chosen = fd.dense_ws_shared
            fd.dense_ws_shared = lambda *a: not shared
            try:
                other = kernel(**ops)
                ms_other, _ = graph_ms(torch, lambda: kernel(**ops), reps=3,
                                       per_graph=4)
                des_other = soa_design(ops, label)
            finally:
                fd.dense_ws_shared = chosen
            if not all(torch.equal(a, b)
                       for a, b in zip(other, kernel(**ops))):
                raise AssertionError(f'{label}: the layouts differ')
            log(f'  {label}: the workspace in '
                f'{"global" if shared else "shared"} memory (forced) '
                f'{ms_other:.4f} ms, bitwise the same; registers '
                f'{des_other["registers"]}, spill stores '
                f'{des_other["spill_store_bytes"]} bytes')
            rows[-1]['other_layout_ms'] = ms_other
    return rows


def cartpole_grads(torch, device, n, primal=None, dtype=None):
    """A loss of a differentiable config-3 solve at B=n with gradients to
    CartpoleDx.params, x_init and c: through the kernels (the dense
    configuration's forward, the dense backward), or, given the Solution
    ``primal`` of the kernels' phase 1, through the eager fixed point on
    it (in ``dtype``).  Returns [loss, d params, d x_init, d c] and the
    kernels' Solution."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.models import CartpoleDx
    dtype = dtype or torch.float32
    cfg = mt.MPCConfig(**dict(CARTPOLE, backprop=True, use_fused='auto'),
                       grad_method=mt.GradMethods.AUTO_DIFF)
    x0, cost, dx = cartpole_problem(torch, device, dtype, n)
    prm = dx.params.clone().requires_grad_()
    dx = CartpoleDx(params=prm)
    x0 = x0.requires_grad_()
    c = cost.c.clone().requires_grad_()
    cost = mt.QuadCost(cost.C, c)
    u_exp = torch.tensor(0.3 * np.random.RandomState(17).randn(cfg.T, n, 1),
                         dtype=dtype, device=device)
    sol = None
    if primal is None:
        sol = mt.batched_solve(cfg, x0, cost, dx, u_lower=-100.0,
                               u_upper=100.0, device=device)
        x, u = sol.x, sol.u
    else:
        lb = torch.tensor(-100.0, dtype=dtype, device=device)
        x, u = solver.fixed_point_phase(cfg, x0, cost, dx,
                                        primal.x.to(dtype),
                                        primal.u.to(dtype), lb, -lb,
                                        primal.converged)
    loss = ((u / CART_U_SCALE - u_exp) ** 2).mean() + 0.1 * (x ** 2).mean()
    loss.backward()
    return [loss.detach(), prm.grad, x0.grad, c.grad], sol


def phase_grad_cartpole(torch, device, n=SOA_GRAD_B):
    """Gradients of a config-3 loss to CartpoleDx.params, x_init and c
    through one dense forward and one dense-backward launch: against the
    eager fixed point on the same converged trajectory and against the
    float64 eager fixed point on it (each within BWD_TOL relative to the
    gradient's largest entry: the two backward algorithms differ, so the
    float32 eager one is no yardstick of distance from float64), and
    with TF32 on and off (bitwise).  Returns the launches of the solve and the
    largest gradient error."""
    from mpc_tpu_torch.ops import fused_bwd
    log(f'[grad-cartpole] config 3, B={n}: gradients to the cartpole\'s '
        'parameters, x_init and c through the dense configuration and the '
        'dense backward')
    (kk, sol), counts, n_eager = soa_counted(
        torch, lambda: cartpole_grads(torch, device, n))
    from mpc_tpu_torch import solver
    if solver.eager_counts['eager_fixed_point'] or n_eager or (
            device.type == 'cuda' and counts != {
                'fused_ilqr_dense': 1, 'fused_kkt_bwd_dense': 1}):
        raise AssertionError('a differentiable cartpole solve must launch '
                             'the dense forward and the dense backward once '
                             f'each and nothing else: {counts}')
    log(f'  launches {counts}, eager solves {n_eager}; converged '
        f'{float(sol.converged.double().mean()):.3f}, n_iter a solve '
        f'{float(sol.n_iter.double().mean()):.2f}')
    primal = sol._replace(x=sol.x.detach(), u=sol.u.detach())
    ref, _ = cartpole_grads(torch, device, n, primal)
    ref64, _ = cartpole_grads(torch, device, n, primal, torch.float64)
    err = 0.0
    for name, g, r, r64 in zip(('params', 'x_init', 'c'), kk[1:], ref[1:],
                               ref64[1:]):
        e = rel_err(g, r)
        err = max(err, e)
        e64 = rel_err(g, r64)
        log(f'  {name}: max |dense backward - eager| / max |eager| {e:.3e}; '
            f'max |dense backward - f64 eager| / max |f64 eager| {e64:.3e} '
            f'(eager f32: {rel_err(r, r64):.3e})')
        if not (torch.isfinite(g).all() and float(g.abs().max()) > 0):
            raise AssertionError(f'{name}: gradient not finite or zero')
        if not e64 < BWD_TOL:
            raise AssertionError(f'{name}: the kernels\' gradient is off the '
                                 'float64 fixed point')
        err = max(err, e64)
    if not err < BWD_TOL:
        raise AssertionError('cartpole gradients through the dense backward '
                             'are off the eager fixed point')
    phase_tf32(torch, 'config-3 loss and gradients through the dense '
               'forward and backward',
               lambda: cartpole_grads(torch, device, n)[0])
    return counts, err


def soa_entries(rows, serve, grad_counts, grad_err, err, eager):
    """The kernels line's entries of this slice: the model-step build at
    config 3 (serving, and the gradient path's launches, and beside its
    request the eager route's ms and the kernel route's in that phase,
    ``eager`` the [eager-cartpole] record) and under slew, K1 and K3 on
    the damped pendulum, each with its row's max |du| (``err`` by row);
    every row under 'rows'."""
    by_row = {r['row'].split(' B=')[0]: r for r in rows}
    tol = (f'pendulum: mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
           f'<{TAIL_SHARE}; cartpole: the same of |du|/{CART_U_SCALE} at '
           f'{LONG_TAIL_MEAN}, {LONG_TAIL_SHARE}; every row at most 2x the '
           f'plain f32 distance from f64, the damped pendulum at '
           f'T={SOA_LONG_T} by that alone')
    out = []
    for label, name, source, line, path in (
            ('config 3', 'fused_ilqr_dense (cartpole)',
             'fused_ilqr_dense.cu', 617, 'config 3 serving'),
            ('slew 0.5', 'fused_ilqr_dense (slew pendulum)',
             'fused_ilqr_dense.cu', 617, 'slew serving'),
            ('damped', 'fused_ilqr (damped pendulum)', 'fused_ilqr.cu', 617,
             'damped serving'),
            (f'damped T={SOA_LONG_T}', 'fused_ilqr_long (damped pendulum)',
             'fused_ilqr_long.cu', 1126, 'damped long horizon')):
        r = by_row[label]
        e = {'name': name, 'path': path, 'route': 'cuda',
             'source': f'mpc_tpu_torch/csrc/{source}',
             'headers': ['mpc_tpu_torch/csrc/pendulum.cuh'],
             'replaces': f'mpc_tpu/ops/fused.py:{line}',
             'design': r['design'], 'launches': serve['launches'][label],
             'max_abs_err': err[label], 'tolerance': tol, 'library_ms': None,
             **{k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')}}
        if 'dense' in source:
            e['headers'] += ['mpc_tpu_torch/csrc/soa_model.cuh',
                             'mpc_tpu_torch/csrc/cartpole.cuh',
                             'mpc_tpu_torch/csrc/box_qp.cuh']
        if label == 'config 3':
            e.update(request_ms=serve['request_ms'],
                     eager_ms=eager['median_ms'],
                     kernel_route_ms_beside_eager=eager['kernel_median_ms'],
                     loop_us_per_step=serve['loop_us_per_step'],
                     launches_closed_loop=serve['launches']['closed loop'],
                     launches_grad_cartpole=grad_counts,
                     grad_err_vs_eager=grad_err,
                     rows=[{k: v for k, v in x.items() if k != 'design'}
                           for x in rows])
        out.append(e)
    return out


# the pseudo-Huber cost in the kernels' cost build (MPC_COST = 1,
# csrc/cost.cuh): the JAX package's rows that run it
HUBER_DELTA = 0.9
# the serving row (BASELINE.md:92; benchmarks/hw_sweep.py:58-65, 255-267):
# the pendulum, its cost (w, goal) below, 6 iterations, 3 step sizes
HUBER = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=6, eps=0.0,
             exit_unconverged=False, detach_unconverged=False,
             backprop=False, linesearch_decay=0.2, max_linesearch_iter=3)
HUBER_W, HUBER_GOAL = (1.0, 1.0, 0.1, 0.1), (1.0, 0.0, 0.0, 0.0)
HUBER_B = 2048
# (label, problem, T, B, kernel): the serving row from hw_sweep's starts
# (theta uniform in +-0.4) and from the headline's full +-pi, which reach
# the cost's linear tails, each also at B+2 = 2050 (hw_sweep's partial
# block); the pendulum at T=200 and the long LinDx system
# (benchmarks/configs.py:325-372) at T=160 in K3; the reference's MLP
# (H=100, bench_nn_dynamics) in K3's MLP build; config 3's cartpole
# (:173-202) in the dense model-step build, and the same from starts near
# its goal (HUBER_CART_NEAR); the medium row at 24 states and 4 controls
# (:107-171) in the dense LinDx build.  Each but the serving row takes w
# the diagonal of its own QuadCost and goal its target.
HUBER_ROWS = (
    ('serving hw_sweep', 'sweep', T, HUBER_B, 'K1'),
    ('serving full', 'full', T, HUBER_B, 'K1'),
    ('pendulum T=200', 'pendulum', SOA_LONG_T, B, 'K3'),
    ('long LinDx', 'lindx', LONG_T, LONG_B, 'K3'),
    ('MLP', 'mlp', NN_T, NN_B, 'K3'),
    ('config 3', 'cartpole', CARTPOLE['T'], CARTPOLE_B, 'dense'),
    ('config 3 near goal', 'cartpole_near', CARTPOLE['T'], CARTPOLE_B,
     'dense'),
    ('medium 24s4c', 'medium', MEDIUM['T'], MEDIUM_B, 'dense'),
)
# Config 3's starts put its controls in the cost's linear tails and on
# the box, where H_uu = w_u / s^3 is ~1e-9 and the solve hardly reads the
# cost's curvature.  From angles uniform in +-HUBER_CART_NEAR no control
# reaches the box and H_uu stays near w_u, so that row holds the model-step
# cost build's H and g to the float32 tail, its controls unscaled.
HUBER_CART_NEAR = 0.05
HUBER_REQUESTS = 4
HUBER_LOOP_STEPS = 20
# the training row (benchmarks/parity_tpu.py:190-228): B=256, T=8, 12
# iterations, theta uniform in +-0.3, loss sum(u^2); d loss / d delta
# against central differences of step 1e-2 within 5%
HUBER_GRAD = dict(HUBER, T=8, lqr_iter=12, backprop=True)
HUBER_GRAD_B = 256
HUBER_FD_STEP, HUBER_FD_TOL = 1e-2, 0.05
# the K4 row: the long LinDx system (benchmarks/configs.py:341-351, its
# batch-shared F) past T_MAX_BWD, w the diagonal of its QuadCost, goal 0:
# K3's cost build forward, K4 backward.  (The pendulum there is no
# yardstick: after 12 iterations at T=190 its solve is far from converged
# and d loss / d x_init of the fixed point differs between a float32 and a
# float64 eager run by 4e4 of its scale, in a CPU rehearsal.)
HUBER_K4_T = 190


def huber_problem(torch, device, label, dtype=None, n=None, quad=False):
    """(cfg, x0, cost, dynamics, bounds) of a HUBER_ROWS row at its own
    sizes (or on its first n examples): the pseudo-Huber cost, or with
    ``quad`` the QuadCost of the same weights and target (C = diag(w),
    c = -w goal), the QuadCost build's problem at the same shapes."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PseudoHuberCost
    dtype = dtype or torch.float32
    _, prob, T_, n0, _ = next(r for r in HUBER_ROWS if r[0] == label)
    n = n or n0
    box = dict(u_lower=-2.0, u_upper=2.0)
    w, goal = HUBER_W, HUBER_GOAL
    if prob in ('sweep', 'full', 'pendulum'):
        dx, _ = problem(torch, device, dtype)
        rng = np.random.RandomState({'sweep': 7, 'full': 8}.get(prob, 9))
        th = (0.4 if prob == 'sweep' else np.pi) * (2 * rng.rand(n) - 1)
        x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1),
                          dtype=dtype, device=device)
        cfg = mt.MPCConfig(**dict(HUBER, T=T_))
        if prob == 'pendulum':
            w = tuple(float(v) for v in dx.get_true_obj()[0])
    elif prob == 'lindx':
        cfg, x0, cost, dx, _ = long_problem(torch, device, n, dtype)
        w, goal = tuple(float(v) for v in cost.C[0].diagonal()), (0.0,) * 4
    elif prob == 'mlp':
        cfg, x0, cost, dx = nn_problem(torch, device, n, dtype=dtype)
        w = tuple(float(v) for v in cost.C.diagonal())
    elif prob in ('cartpole', 'cartpole_near'):
        x0, cost, dx = cartpole_problem(
            torch, device, dtype, n,
            angle=HUBER_CART_NEAR if prob == 'cartpole_near' else 0.5)
        cfg = mt.MPCConfig(**dict(CARTPOLE, use_fused='auto'),
                           grad_method=mt.GradMethods.AUTO_DIFF)
        w = tuple(float(v) for v in cost.C.diagonal())
        goal = tuple(dx.goal_state) + (0.0,)
        box = dict(u_lower=-100.0, u_upper=100.0)
    else:
        x0, cost, dx = medium_problem(torch, device, dtype, n)
        cfg = mt.MPCConfig(**dict(MEDIUM, use_fused='auto'))
        w, goal = tuple(float(v) for v in cost.C.diagonal()), (0.0,) * 28
        box = dict(u_lower=-1.0, u_upper=1.0)
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    if quad:
        cost = mt.QuadCost(torch.diag(t(w)), -t(w) * t(goal))
    else:
        cost = PseudoHuberCost(t(w), t(goal), t(HUBER_DELTA))
    return cfg, x0, cost, dx, box


def huber_operands(torch, device, label, dtype=None, n=None, quad=False):
    """A HUBER_ROWS row's kernel operands, its kernel and plain version."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    cfg, x0, cost, dx, bk = huber_problem(torch, device, label, dtype, n,
                                          quad)
    kernel = next(r for r in HUBER_ROWS if r[0] == label)[4]
    if kernel == 'dense':
        return (fd.k3d_operands(cfg, x0, cost, dx, **bk),
                fd.fused_ilqr_dense, fd.fused_solve_dense_plain)
    if kernel == 'K1':
        return (fused.k1_operands(cfg, x0, cost, dx, **bk),
                fused.fused_ilqr, fused.fused_solve_plain)
    return (fused.k3_operands(cfg, x0, cost, dx, **bk),
            fused.fused_ilqr_long, fused.fused_solve_long_plain)


def huber_judged_by_f64(label):
    """The rows whose two float32 solves part beyond the tail and are
    judged against float64 alone: the pendulum at T=200 (a long horizon,
    PEND_LONG_T's note); the cartpole, whose control weight of 0.001
    leaves the cost's linear tails almost no curvature (H_uu = w_u /
    s^3), so that its bang-bang controls tie at round-off (on an NVIDIA
    H100 80GB HBM3 at 700 W the plain float32 run itself sits 0.10 of a
    control from float64, mean |du|, at B=512); and the long LinDx
    system, whose 4 iterations stop while the box's active set still
    moves (LONG's note) and where a few examples' line searches tie (on
    the same card: mean |du| 4.2e-4, 0.05% of entries past 1e-3, max |du|
    4, a flip across the box)."""
    return label in ('pendulum T=200', 'config 3', 'long LinDx')


def hold_huber_f64(torch, what, ops, ops64, kernel, plain):
    """A row of ``huber_judged_by_f64``: finite, the tail shown, the
    kernel no further from the float64 plain run than twice the plain
    float32 run, n_iter equal, the reversed batch bitwise.  Returns max
    |du|."""
    xk, uk, sk = kernel(**ops)
    xp, up, sp = plain(**ops)
    _, u64, _ = plain(**ops64)
    if not all(torch.isfinite(t).all() for t in (xk, uk, sk)):
        raise AssertionError(f'{what}: the kernel returned non-finite values')
    hold_f64(what, uk, up, u64)
    if not torch.equal(sk[2], sp[2]):
        raise AssertionError(f'{what}: n_iter differs between kernel and '
                             'plain')
    B_ = ops['x0'].shape[0]
    r = kernel(**batch_subset(torch, ops, torch.arange(B_ - 1, -1, -1)))
    if not all(torch.equal(a.flip(1), b) for a, b in zip(r, (xk, uk, sk))):
        raise AssertionError(f'{what}: reversed batch is not bitwise equal')
    log('  reversed batch: bitwise equal')
    return float((uk - up).abs().max())


def phase_compare_huber(torch, device):
    """Each HUBER_ROWS row's cost build against its plain version on the
    card (hold_k1: the float32 tail, n_iter equal, at most twice the plain
    float32 run's distance from a float64 plain run, the reversed batch
    bitwise; the rows of ``huber_judged_by_f64`` by float64 alone, n_iter
    equal), B = 1, 7, 33 alone and the batch with two more examples
    bitwise.  The cartpole's controls are held divided by CART_U_SCALE.
    Returns max |du| and the plain float32 run's device ms, by row."""
    max_du, plain_ms = {}, {}
    t0 = time.perf_counter()
    runs = plain_runs(torch, device, start_plain(
        device, 'huber', [r[0] for r in HUBER_ROWS], 6))
    log(f'[compare-huber] the plain versions, each row in float32 and in '
        f'float64, over 6 processes at once: {time.perf_counter() - t0:.1f} '
        's')
    for label, prob, T_, n, kname in HUBER_ROWS:
        what = f'{label} ({kname}), B={n}, T={T_}'
        log(f'[compare-huber] {what}: the cost build vs its plain version')
        t0 = time.perf_counter()
        ops, kernel, _ = huber_operands(torch, device, label)
        ops64, _, _ = huber_operands(torch, device, label, torch.float64)
        if ops['C'] is not None or ops['cost_params'] is None:
            raise AssertionError(f'{what}: not the cost build\'s operands')
        times = []
        plain = preloaded(torch, runs[label], times)
        scale = CART_U_SCALE if prob == 'cartpole' else 1.0

        def scaled(fn):
            def run(**o):
                x, u, s = fn(**o)
                return x, u / scale, s
            return run
        if huber_judged_by_f64(label):
            mx = hold_huber_f64(torch, what, ops, ops64, scaled(kernel),
                                scaled(plain))
        else:
            _, mx = hold_k1(torch, what, ops, ops64, kernel=kernel,
                            plain=plain)
        plain_ms[label] = times[0]
        max_du[label] = mx * scale
        full = kernel(**ops)
        hold_slices(torch, what, kernel, ops, full)
        r = kernel(**batch_subset(torch, ops, torch.cat(
            [torch.arange(n), torch.arange(2)])))
        if not all(torch.equal(r[i][:, :n], full[i])
                   and torch.equal(r[i][:, n:], full[i][:, :2])
                   for i in range(3)):
            raise AssertionError(f'{what}: B={n + 2} differs from B={n}')
        box = 100.0 if prob.startswith('cartpole') else (
            1.0 if prob == 'medium' else 2.0)
        if prob.startswith('cartpole'):
            s3 = (1.0 + (full[1] / HUBER_DELTA) ** 2) ** 1.5
            log(f'  H_uu = w_u / s^3 at the solution: median '
                f'{float((ops["cost_params"][5] / s3).median()):.3e}')
        log(f'  {what}: B={n + 2} bitwise equal to B={n}; controls on the '
            f'box {float((full[1].abs() == box).double().mean()):.3f}, '
            f'n_iter a solve {float(full[2][2].double().mean()):.2f}, trials '
            f'a solve {float(full[2][5].double().mean()):.2f}; plain '
            f'{times[0]:.1f} ms; {time.perf_counter() - t0:.1f} s')
    return max_du, plain_ms


def phase_serve_huber(torch, device):
    """The serving row through the entry points, every count set to 0
    before and read after: HUBER_REQUESTS batches from full +-pi starts
    through batched_solve and one through MPC (host to host, one K1
    launch a request, no eager solve), beside the eager route's ms of the
    same request in this process (use_fused='never'); a closed loop of
    HUBER_LOOP_STEPS steps through make_closed_loop (one K1 launch a step,
    bitwise the host loop); two requests of each other row (one launch of
    its kernel each).  Returns the launches by row, the request's ms, the
    eager route's and the loop's us a step."""
    import dataclasses
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.solver import trajectory_cost
    out = {'launches': {}}
    cfg, x0, cost, dx, bk = huber_problem(torch, device, 'serving full')
    n = x0.shape[0]
    reqs = [x0_batch(n, 500 + i, torch, torch.device('cpu'))
            for i in range(HUBER_REQUESTS)]
    mt.batched_solve(cfg, x0, cost, dx, device=device, **bk).u.cpu()
    ctrl = mt.MPC(3, 1, cfg.T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                  linesearch_decay=cfg.linesearch_decay,
                  max_linesearch_iter=cfg.max_linesearch_iter,
                  exit_unconverged=False, detach_unconverged=False,
                  backprop=False, device=device, **bk)

    def serve():
        lat, sols = [], []
        for req in reqs:
            t0 = time.perf_counter()
            sol = mt.batched_solve(cfg, req.to(device), cost, dx,
                                   device=device, **bk)
            u = sol.u.cpu()
            lat.append(1e3 * (time.perf_counter() - t0))
            sols.append((sol, u))
        t0 = time.perf_counter()
        um = ctrl(reqs[0].to(device), cost, dx)[1].cpu()
        return lat, sols, um, 1e3 * (time.perf_counter() - t0)

    (lat, sols, um, mpc_ms), counts, n_eager = soa_counted(torch, serve)
    ms = median(lat)
    log(f'[serve-huber] serving row, B={n}: {HUBER_REQUESTS} batched_solve '
        'requests, latency ms ' + ' '.join(f'{v:.3f}' for v in lat) +
        f', median {ms:.3f} ({n / ms * 1e3:.0f} solves/s); MPC '
        f'{mpc_ms:.3f} ms; launches {counts}, eager solves {n_eager}')
    if n_eager or (device.type == 'cuda'
                   and counts != {'fused_ilqr': HUBER_REQUESTS + 1}):
        raise AssertionError('each serving request must launch K1 once and '
                             'nothing else')
    if not torch.equal(um, sols[0][1]):
        raise AssertionError('MPC and batched_solve answer differently')
    sol, u = sols[-1]
    tc = trajectory_cost(cost, sol.x, u.to(device))
    gap = float((tc - sol.costs).abs().max() / sol.costs.abs().max())
    log(f'  last answer: relative gap of its cost to the true cost of its '
        f'trajectory {gap:.2e}')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0
            and gap < 1e-4):
        raise AssertionError('served controls are not a feasible solve')
    # the eager route of the same request, in this process
    never = dataclasses.replace(cfg, use_fused='never')
    (eager_u, eager_ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(
            never, reqs[0].to(device), cost, dx, device=device, **bk).u, 2))
    log(f'  the eager route (use_fused=\'never\') of the first request: '
        f'{eager_ms:.1f} ms ({eager_ms / ms:.0f}x the kernel route), eager '
        f'solves {n_eager}, max |u - kernel route\'s| '
        f'{float((eager_u[0].cpu() - sols[0][1]).abs().max()):.3e}; '
        f'{card_line()}')
    out['launches']['serving'] = HUBER_REQUESTS + 1
    out['request_ms'], out['mpc_ms'], out['eager_ms'] = ms, mpc_ms, eager_ms
    # the closed loop: one launch a step, bitwise the host loop
    roll = mt.make_closed_loop(cfg, cost, dx, device=device, **bk)
    roll(x0, 2)
    (lp, counts, n_eager) = soa_counted(torch, lambda: host_ms(
        torch, device, lambda: roll(x0, HUBER_LOOP_STEPS)))
    loop_ms, loop = lp
    x, u_warm, xs, us = x0, torch.zeros(cfg.T, n, 1, device=device), [x0], []
    for _ in range(HUBER_LOOP_STEPS):
        s = mt.batched_solve(cfg, x, cost, dx, u_init=u_warm, device=device,
                             **bk)
        x = dx(x, s.u[0])
        u_warm = torch.cat([s.u[1:], torch.zeros_like(s.u[:1])])
        xs.append(x)
        us.append(s.u[0])
    same_bits(f'make_closed_loop, {HUBER_LOOP_STEPS} steps at B={n}, vs the '
              'host loop, xs and us', torch,
              [(loop['xs'], torch.stack(xs)), (loop['us'], torch.stack(us))])
    log(f'  closed loop: {loop_ms:.1f} ms for {HUBER_LOOP_STEPS} steps '
        f'({1e3 * loop_ms / HUBER_LOOP_STEPS:.0f} us a step), launches '
        f'{counts}, eager solves {n_eager}; {card_line()}')
    if n_eager or (device.type == 'cuda' and counts != {
            'fused_ilqr': HUBER_LOOP_STEPS}):
        raise AssertionError('each closed-loop step must launch K1 once and '
                             'nothing else')
    out['loop_us_per_step'] = 1e3 * loop_ms / HUBER_LOOP_STEPS
    out['launches']['closed loop'] = HUBER_LOOP_STEPS
    # two requests of each other row, one launch of its kernel each
    kname = {'dense': 'fused_ilqr_dense', 'K1': 'fused_ilqr',
             'K3': 'fused_ilqr_long'}
    for label, _, T_, n_, kernel in HUBER_ROWS:
        if label == 'serving full':
            continue
        cfg_, x0_, cost_, dx_, bk_ = huber_problem(torch, device, label)
        (sols_, counts, n_eager) = soa_counted(torch, lambda: [
            mt.batched_solve(cfg_, x0_, cost_, dx_, device=device,
                             **bk_).u.cpu() for _ in range(2)])
        log(f'[serve-huber] {label}, B={n_}, T={T_}: two requests, launches '
            f'{counts}, eager solves {n_eager}')
        if n_eager or (device.type == 'cuda'
                       and counts != {kname[kernel]: 2}) \
                or not torch.isfinite(sols_[-1]).all():
            raise AssertionError(f'{label}: each request must launch its '
                                 'kernel once and nothing else')
        out['launches'][label] = 2
    return out


def huber_flops(ops, label, stats):
    """The operations of a HUBER_ROWS row's solve from this run's counts
    (the cost build's, or the QuadCost build's where ``ops`` has C), and
    the bytes it must move."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    _, prob, _, _, kernel = next(r for r in HUBER_ROWS if r[0] == label)
    huber = ops['cost_params'] is not None
    sums = [float(stats[i].double().sum()) for i in (2, 3, 5)]
    n = ops['x0'].shape[0]
    T_ = ops['u0'].shape[0]
    if kernel == 'dense':
        ns, nc = ops['x0'].shape[1], ops['u0'].shape[2]
        model_ops = None
        if ops['model'] is not None:
            model_ops = fd.model_op_counts(fd.dense_model(ops['model'])[0])
        return (fd.k3d_flops(T_, ns, nc, sums[0], sums[2], batch=n,
                             n_qp=sums[1] if nc > 1 else 0,
                             model_ops=model_ops, huber=huber),
                fd.k3d_bytes(ops))
    if kernel == 'K1':
        return (fused.k1_flops(T_, 3, 1, sums[0], sums[2], batch=n,
                               huber=huber), fused.k1_bytes(ops))
    nn_ops = None
    if prob == 'mlp':
        nn_ops = fused.nn_op_counts(NN_H, 'sigmoid', True)
    return (fused.k3_flops(T_, 3, 1, sums[0], sums[2], batch=n,
                           lindx=prob == 'lindx', nn_ops=nn_ops,
                           huber=huber), fused.k1_bytes(ops))


def huber_design(ops, label):
    """The design entry (geometry, registers, spills) of a row's cost
    build."""
    from mpc_tpu_torch.ops import fused
    _, prob, _, _, kernel = next(r for r in HUBER_ROWS if r[0] == label)
    T_, n = ops['u0'].shape[:2]
    n_alpha = len(ops['alphas'])
    if kernel == 'dense':
        return design('fused_ilqr_dense', *dense_defines(ops))
    if kernel == 'K1':
        return design('fused_ilqr', fused.kernel_defines(T_, True,
                                                         huber=True),
                      fused.k1_launch(T_, n, n_alpha))
    return design('fused_ilqr_long', *nn_defines(ops))


def phase_time_huber(torch, device, plain_ms):
    """Each HUBER_ROWS row's cost build timed from a CUDA graph, its bound
    from this run's iterations and trial rollouts (k1_flops, k3_flops,
    k3d_flops with huber=True) and bytes, its registers and spills, beside
    the plain version's ms of [compare-huber] and the QuadCost build's ms
    at the same shapes (C = diag(w), c = -w goal) in this run.  Returns the
    rows."""
    rows = []
    for label, _, T_, n, kname in HUBER_ROWS:
        ops, kernel, _ = huber_operands(torch, device, label)
        _, _, st = kernel(**ops)
        ms, eager_ms = graph_ms(torch, lambda: kernel(**ops), reps=3,
                                per_graph=4)
        opq, kq, _ = huber_operands(torch, device, label, quad=True)
        _, _, stq = kq(**opq)
        quad_ms, _ = graph_ms(torch, lambda: kq(**opq), reps=3, per_graph=4)
        flops, nbytes = huber_flops(ops, label, st)
        bound_ms, by = bound(flops, nbytes)
        des = huber_design(ops, label)
        log(f'[time-huber] {label} ({kname}), B={n}, T={T_}: {ms:.4f} ms '
            f'(from a CUDA graph; {eager_ms:.4f} ms a call from Python), the '
            f'QuadCost build {quad_ms:.4f} ms ({ms / quad_ms:.2f}x; '
            f'{float(stq[2].double().mean()):.2f} iterations, '
            f'{float(stq[5].double().mean()):.2f} trials a solve), plain '
            f'{plain_ms[label]:.1f} ms; {flops:.4e} operations '
            f'({float(st[2].double().mean()):.2f} iterations, '
            f'{float(st[5].double().mean()):.2f} trials a solve), {nbytes} '
            f'bytes; bound {bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
            f'{n / ms * 1e3:.0f} solves/s; registers {des["registers"]}, '
            f'spill stores {des["spill_store_bytes"]} bytes; {card_line()}')
        rows.append(dict(row=f'{label} B={n} T={T_}', ms=ms, quad_ms=quad_ms,
                         plain_ms=plain_ms[label], bound_ms=bound_ms,
                         bound_by=by, registers=des['registers'],
                         spill_store_bytes=des['spill_store_bytes'],
                         design=des))
    return rows


def huber_grads(torch, device, T_, n, delta=HUBER_DELTA, primal=None,
                dtype=None, model='pendulum', grad=True):
    """The training row's loss sum(u^2) at horizon T_ and batch n and its
    gradients to w, goal, delta and x_init: through the kernels (the cost
    build's forward, then K2, K4 or the dense backward on per-example C),
    or, given the Solution ``primal`` of the kernels' phase 1, through
    the eager fixed point on it (in ``dtype``).  ``model`` 'cartpole'
    takes config 3's cartpole, 'lindx' the long LinDx system at T_ (its
    shared F repeated), each with its QuadCost's diagonal as w and its
    target as goal.  Without ``grad`` the loss of a forward solve alone.
    Returns [loss, d w, d goal, d delta, d x_init] and the Solution."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.models import PseudoHuberCost
    dtype = dtype or torch.float32
    t = (lambda a: torch.tensor(a, dtype=dtype, device=device))
    if model == 'cartpole':
        x0, cost, dx = cartpole_problem(torch, device, dtype, n)
        cfg = mt.MPCConfig(**dict(CARTPOLE, backprop=grad, use_fused='auto',
                                  T=T_), grad_method=mt.GradMethods.AUTO_DIFF)
        w0 = cost.C.diagonal().clone()
        goal0 = t(tuple(dx.goal_state) + (0.0,))
        box, scale = 100.0, CART_U_SCALE
    elif model == 'lindx':
        F, C, x0, _ = long_data(torch, device, dtype)
        dx = mt.LinDx(F[0].expand(T_ - 1, 3, 4).contiguous())
        x0 = x0[:n].contiguous()
        cfg = mt.MPCConfig(**dict(HUBER_GRAD, T=T_, backprop=grad))
        w0, goal0 = C[0].diagonal().clone(), t((0.0,) * 4)
        box, scale = 2.0, 1.0
    else:
        rng = np.random.RandomState(10)
        th = 0.3 * (2 * rng.rand(n) - 1)
        x0 = t(np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1))
        dx, _ = problem(torch, device, dtype)
        cfg = mt.MPCConfig(**dict(HUBER_GRAD, T=T_, backprop=grad))
        w0, goal0 = t(HUBER_W), t(HUBER_GOAL)
        box, scale = 2.0, 1.0
    leaves = [w0, goal0, t(delta), x0]
    if grad:
        leaves = [a.clone().requires_grad_() for a in leaves]
    w, goal, d, x = leaves
    cost = PseudoHuberCost(w, goal, d)
    sol = None
    if primal is None:
        sol = mt.batched_solve(cfg, x, cost, dx, u_lower=-box, u_upper=box,
                               device=device)
        xs, us = sol.x, sol.u
    else:
        lb = t(-box)
        xs, us = solver.fixed_point_phase(cfg, x, cost, dx,
                                          primal.x.to(dtype),
                                          primal.u.to(dtype), lb, -lb,
                                          primal.converged)
    loss = ((us / scale) ** 2).sum()
    if not grad:
        return [loss.detach()], sol
    loss.backward()
    return [loss.detach()] + [a.grad for a in leaves], sol


def huber_cartpole_bwd_operands(torch, device, sol, n, dtype=None):
    """The dense backward's operands of the config-3 gradient row at the
    kernels' solution ``sol``: the pseudo-Huber cost quadratised per
    example (C [T, B, 6, 6], c = g - H tau), the cartpole linearised
    there (F [T-1, B, 5, 6], f), the box's active set and the loss's
    cotangents (d sum((u / CART_U_SCALE)^2) / du, none on x): what phase 2
    hands the kernel (in ``dtype``, float32 by default).  Returns
    (operands, keyword arguments)."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PseudoHuberCost
    from mpc_tpu_torch.ops import fused_bwd
    from mpc_tpu_torch.solver import linearize_dynamics, quadratize_cost
    dtype = dtype or torch.float32
    _, cost, dx = cartpole_problem(torch, device, dtype, n)
    goal = torch.tensor(tuple(dx.goal_state) + (0.0,), dtype=dtype,
                        device=device)
    hc = PseudoHuberCost(cost.C.diagonal().clone(), goal,
                         torch.tensor(HUBER_DELTA, dtype=dtype,
                                      device=device))
    xs, us = sol.x.detach().to(dtype), sol.u.detach().to(dtype)
    C, c, _ = quadratize_cost(hc, xs, us)
    F, _ = linearize_dynamics(dx, xs, us, mt.GradMethods.AUTO_DIFF)
    box = torch.tensor(100.0, dtype=dtype, device=device)
    o = dict(C=C.contiguous(), c=c.contiguous(), F=F.contiguous(),
             x_star=xs, u_star=us, dl_dx=torch.zeros_like(xs),
             dl_du=2.0 * us / CART_U_SCALE ** 2,
             I_mask=fused_bwd.active_set(us, -box, box))
    return o, dict(has_f=True, f_shared=False)


def kkt_x_init_grad(torch, C, F, pinned, r):
    """d (r . tau) / d x_init of the differential LQR problem of each
    example by one dense solve of its KKT system (batched, in C's dtype):
    min 0.5 tau^T C tau over tau = (x, u) [T, n_tau] subject to x_0 =
    x_init, x_{t+1} = F_t tau_t and u_t = 0 where ``pinned`` [T, B, nc];
    an oracle that shares no code with the backwards.  A control that is
    not pinned keeps its constraint row empty, with a 1 on its
    multiplier's diagonal, so every example's system has one size.  The
    gradient is the multiplier of x_0 = x_init in the solve with
    right-hand side (r, 0).  C [T, B, nt, nt], F [T-1, B, ns, nt], r [T,
    B, nt]; returns [B, ns]."""
    T, B, nt, _ = C.shape
    ns = F.shape[2]
    nc = nt - ns
    N, m = T * nt, T * nt
    K = C.new_zeros(B, N + m, N + m)
    eye = torch.eye(ns, dtype=C.dtype, device=C.device)
    A = C.new_zeros(B, m, N)
    A[:, :ns, :ns] = eye
    for t in range(T):
        K[:, t * nt:(t + 1) * nt, t * nt:(t + 1) * nt] = C[t]
        if t < T - 1:
            rows = slice((t + 1) * ns, (t + 2) * ns)
            A[:, rows, (t + 1) * nt:(t + 1) * nt + ns] = eye
            A[:, rows, t * nt:(t + 1) * nt] -= F[t]
        for j in range(nc):
            k = T * ns + t * nc + j
            p = pinned[t, :, j].to(C.dtype)
            A[:, k, t * nt + ns + j] = p
            K[:, N + k, N + k] = 1.0 - p
    K[:, N:, :N] = A
    K[:, :N, N:] = A.transpose(1, 2)
    rhs = torch.cat([r.transpose(0, 1).reshape(B, N), r.new_zeros(B, m)], 1)
    return torch.linalg.solve(K, rhs)[:, N:N + ns]


def phase_grad_huber(torch, device):
    """The training row's gradients to w, goal, delta and x_init through
    one cost-build K1 launch and one K2 launch: against the eager fixed
    point on the same primal and against the float64 eager fixed point on
    it (each within BWD_TOL of the gradient's largest entry), d loss /
    d delta against central differences of the kernels' forward solves
    (HUBER_FD_STEP, within HUBER_FD_TOL: parity_tpu's check [5]), TF32 on
    and off bitwise.  Then a K4 row (the long LinDx system at T =
    HUBER_K4_T, past T_MAX_BWD: K3's cost build and K4) and a
    dense-backward row (config 3's cartpole: the
    dense model-step cost build and the dense backward), each with one
    launch of each and against the eager fixed point on its primal.  At
    config 3 the gradient to x_init is held against a direct float64
    solve of each example's KKT system at the kernels' primal
    (kkt_x_init_grad, within BWD_TOL), and against the eager fixed point
    within BWD_TOL plus the eager route's own distance from that solve in
    float64: the eager fixed point, as mpc_tpu's jnp path does, adds
    1e-11 to the free diagonal of the masked control block
    (linalg.masked_free_matrix), and in the cost's linear tails (H_uu =
    w_u / s^3 ~1e-9) the block falls to ~1e-7 at the horizon's end, where
    that term moves the gradient by ~4e-4 of its scale; the dense
    backward and mpc_tpu's K2 solve it without
    (tests/test_torch_huber.py::
    test_dense_backward_is_the_exact_kkt_where_the_jnp_path_regularises).
    The dense backward is also held against its plain version on the
    operands phase 2 gave it (hold_bwd).  Returns the launches by row and
    the largest gradient error."""
    from mpc_tpu_torch import solver
    names = ('w', 'goal', 'delta', 'x_init')
    launches, err = {}, 0.0
    for label, T_, n, model, want in (
            ('training', HUBER_GRAD['T'], HUBER_GRAD_B, 'pendulum',
             {'fused_ilqr': 1, 'fused_kkt_bwd': 1}),
            (f'K4 LinDx T={HUBER_K4_T}', HUBER_K4_T, HUBER_GRAD_B, 'lindx',
             {'fused_ilqr_long': 1, 'fused_kkt_bwd_long': 1}),
            ('config 3', CARTPOLE['T'], CARTPOLE_B, 'cartpole',
             {'fused_ilqr_dense': 1, 'fused_kkt_bwd_dense': 1})):
        log(f'[grad-huber] {label}, B={n}, T={T_}: gradients to w, goal, '
            'delta and x_init through the cost build and its backward')
        (kk, sol), counts, n_eager = soa_counted(
            torch, lambda: huber_grads(torch, device, T_, n, model=model))
        if solver.eager_counts['eager_fixed_point'] or n_eager or (
                device.type == 'cuda' and counts != want):
            raise AssertionError(f'{label}: a differentiable pseudo-Huber '
                                 f'solve must launch {want} and nothing '
                                 f'else: {counts}')
        log(f'  launches {counts}, eager solves {n_eager}; converged '
            f'{float(sol.converged.double().mean()):.3f}, n_iter a solve '
            f'{float(sol.n_iter.double().mean()):.2f}')
        primal = sol._replace(x=sol.x.detach(), u=sol.u.detach())
        ref, _ = huber_grads(torch, device, T_, n, primal=primal,
                             model=model)
        ref64, _ = huber_grads(torch, device, T_, n, primal=primal,
                               dtype=torch.float64, model=model)
        for name, g, r, r64 in zip(names, kk[1:], ref[1:], ref64[1:]):
            e, e64 = rel_err(g, r), rel_err(g, r64)
            log(f'  {name}: max |kernels - eager| / max |eager| {e:.3e}; '
                f'vs f64 eager {e64:.3e} (eager f32: {rel_err(r, r64):.3e})')
            if not (torch.isfinite(g).all() and float(g.abs().max()) > 0):
                raise AssertionError(f'{label} {name}: gradient not finite '
                                     'or zero')
            if label == 'config 3' and name == 'x_init':
                continue                        # held below, by the KKT
            if not (e < BWD_TOL and e64 < BWD_TOL):
                raise AssertionError(f'{label} {name}: the kernels\' '
                                     'gradient is off the eager fixed point')
            err = max(err, e, e64)
        launches[label] = counts
        if label == 'config 3':
            from mpc_tpu_torch.ops import fused_bwd_dense as fbd
            o64, _ = huber_cartpole_bwd_operands(torch, device, sol, n,
                                                 torch.float64)
            kkt = kkt_x_init_grad(
                torch, o64['C'], o64['F'], o64['I_mask'] > 0.5,
                torch.cat([o64['dl_dx'], o64['dl_du']], -1))
            e_kkt, e_eager = rel_err(kk[4], kkt), rel_err(kk[4], ref[4])
            reg = rel_err(ref64[4], kkt)
            log(f'  x_init: max |kernels - KKT f64| / max |KKT| {e_kkt:.3e} '
                f'(limit {BWD_TOL}); the eager fixed point in float64 sits '
                f'{reg:.3e} from the KKT (its 1e-11 on the masked block), '
                f'in float32 {rel_err(ref[4], kkt):.3e}; kernels vs eager '
                f'{e_eager:.3e} (limit {reg + BWD_TOL:.3e})')
            if not (e_kkt < BWD_TOL and e_eager < reg + BWD_TOL):
                raise AssertionError(f'{label} x_init: the kernels\' '
                                     'gradient is off the KKT solve')
            err = max(err, e_kkt)
            o, kw = huber_cartpole_bwd_operands(torch, device, sol, n)
            log(f'  x_init: the dense backward vs its plain version on '
                f'phase 2\'s operands (active controls '
                f'{float(o["I_mask"].mean()):.3f} of T*B)')
            hold_bwd(torch, 'K4d', f'{label} pseudo-Huber',
                     fbd.fused_kkt_backward_dense,
                     fbd.fused_kkt_backward_dense_plain, o, **kw)
        if label != 'training':
            continue
        # d loss / d delta against central differences of forward solves
        lo, _ = huber_grads(torch, device, T_, n, HUBER_DELTA - HUBER_FD_STEP,
                            grad=False)
        hi, _ = huber_grads(torch, device, T_, n, HUBER_DELTA + HUBER_FD_STEP,
                            grad=False)
        fd = float(hi[0] - lo[0]) / (2 * HUBER_FD_STEP)
        g = float(kk[3])
        rel = abs(g - fd) / max(abs(fd), 1e-9)
        log(f'  d loss / d delta: kernels {g:.4f}, central differences '
            f'{fd:.4f} (step {HUBER_FD_STEP}), relative {rel:.2e}')
        if not rel < HUBER_FD_TOL:
            raise AssertionError('d loss / d delta is off the central '
                                 'differences')
        launches['fd_rel'] = rel
        phase_tf32(torch, 'the training row\'s loss and gradients through '
                   'K1\'s cost build and K2',
                   lambda: huber_grads(torch, device, T_, n)[0])
    return launches, err


def huber_entries(rows, serve, grads, grad_err, err):
    """The kernels line's entries of this slice: the cost build of K1 at
    the serving row (its launches there, the closed loop's and the
    training row's, the request's ms beside the eager route's), of K3 at
    the pendulum, LinDx and MLP rows and of the dense configuration at
    config 3 and the medium row; each with its row's max |du| (``err``
    by row), ms, the QuadCost build's ms, bound and plain ms."""
    by_row = {r['row'].split(' B=')[0]: r for r in rows}
    tol = (f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})<{TAIL_SHARE}, '
           f'n_iter equal, at most 2x the plain f32 distance from f64; the '
           f'pendulum at T={SOA_LONG_T}, the long LinDx and config 3 (|du|/'
           f'{CART_U_SCALE}) by the last two alone')
    out = []
    for label, name, source, line, headers in (
            ('serving hw_sweep', 'fused_ilqr (pseudo-Huber)', 'fused_ilqr.cu',
             617, ['pendulum.cuh']),
            ('serving full', 'fused_ilqr (pseudo-Huber, full starts)',
             'fused_ilqr.cu', 617, ['pendulum.cuh']),
            ('pendulum T=200', 'fused_ilqr_long (pseudo-Huber pendulum)',
             'fused_ilqr_long.cu', 1126, ['pendulum.cuh']),
            ('long LinDx', 'fused_ilqr_long (pseudo-Huber LinDx)',
             'fused_ilqr_long.cu', 1126, []),
            ('MLP', 'fused_ilqr_long (pseudo-Huber MLP)',
             'fused_ilqr_long.cu', 1252, ['nn.cuh']),
            ('config 3', 'fused_ilqr_dense (pseudo-Huber cartpole)',
             'fused_ilqr_dense.cu', 617,
             ['soa_model.cuh', 'cartpole.cuh', 'box_qp.cuh']),
            ('config 3 near goal',
             'fused_ilqr_dense (pseudo-Huber cartpole near the goal)',
             'fused_ilqr_dense.cu', 617,
             ['soa_model.cuh', 'cartpole.cuh', 'box_qp.cuh']),
            ('medium 24s4c', 'fused_ilqr_dense (pseudo-Huber 24s4c)',
             'fused_ilqr_dense.cu', 1126, ['box_qp.cuh'])):
        r = by_row[label]
        e = {'name': name, 'path': f'pseudo-Huber {label}', 'route': 'cuda',
             'source': f'mpc_tpu_torch/csrc/{source}',
             'headers': [f'mpc_tpu_torch/csrc/{h}'
                         for h in ['cost.cuh'] + headers],
             'replaces': f'mpc_tpu/ops/fused.py:{line}',
             'design': r['design'],
             'launches': serve['launches'][
                 'serving' if label == 'serving full' else label],
             'max_abs_err': err[label], 'tolerance': tol, 'library_ms': None,
             'quadcost_build_ms': r['quad_ms'],
             **{k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')}}
        if label == 'serving full':
            e.update(request_ms=serve['request_ms'],
                     eager_ms=serve['eager_ms'],
                     loop_us_per_step=serve['loop_us_per_step'],
                     launches_closed_loop=serve['launches']['closed loop'],
                     launches_grad_huber=grads,
                     grad_err_vs_eager=grad_err,
                     rows=[{k: v for k, v in x.items() if k != 'design'}
                           for x in rows])
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# controls pinned to zero (each kernel's MPC_HAS_UZ build) and the trust
# region delta_u: [compare-uz], [serve-uz], [time-uz]
# ---------------------------------------------------------------------------

# benchmarks/hw_sweep.py's solver settings (base_cfg, :59-66): 6
# iterations, 3 step sizes, eps 0; its batch of three TPU tiles
UZ_SWEEP = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=6, eps=0.0,
                exit_unconverged=False, detach_unconverged=False,
                backprop=False, linesearch_decay=0.2, max_linesearch_iter=3)
UZ_B = 2050
UZ_DELTA = 0.3
# config 3's trust region: a tenth of its +-100 box
UZ_CART_DELTA = 10.0
# (label, problem, T, B, kernel, mask, delta_u, gate): hw_sweep's 'uzero
# shared' (the pendulum, box +-2, every example's control pinned at t =
# 3..5, :68-80) and 'uzero batched' (15% of the controls pinned at
# random, :83-95) in K1, and the same batched mask without bounds; its
# 'delta_u + batched bounds' (3 states, 2 controls, batched C, c, F and
# bounds, :145-170) in the dense configuration; tests/test_fused.py:
# 224-240's unbounded 3-state, 4-control LinDx with its shared mask (the
# masked factor) there; the long LinDx system (LONG) in K3 with a batched
# mask and delta_u; the MLP row (NN) in K3's MLP build with the shared
# mask; config 3 in the model-step build under delta_u; the headline
# under slew 0.5 (4 augmented states, SOA_ROWS) with the shared mask.
# The gate ([compare-uz]) is the float32 tail where the row was measured
# inside it on the H100, float64 where two float32 solves part beyond it
# (the MLP and the slew rows, PERF.md).
UZ_ROWS = (
    ('uzero shared', 'sweep', T, UZ_B, 'K1', 'shared', None, 'tail'),
    ('uzero batched', 'sweep', T, UZ_B, 'K1', 'batched', None, 'tail'),
    ('uzero unbounded', 'unbounded', T, UZ_B, 'K1', 'batched', None,
     'tail'),
    ('delta_u 3s2c', 'sweep3s2c', 8, UZ_B, 'dense', None, UZ_DELTA, 'tail'),
    ('uzero 3s4c unbounded', 'lindx3s4c', 4, UZ_B, 'dense', 'shared', None,
     'tail'),
    ('long LinDx', 'lindx', LONG_T, LONG_B, 'K3', 'batched', UZ_DELTA,
     'tail'),
    ('MLP', 'mlp', NN_T, NN_B, 'K3', 'shared', None, 'float64'),
    ('config 3', 'cartpole', CARTPOLE['T'], CARTPOLE_B, 'dense', None,
     UZ_CART_DELTA, 'tail'),
    ('headline slew', 'slew', T, B, 'dense', 'shared', None, 'float64'),
)
UZ_REQUESTS = 4


def uz_row(label):
    return next(r for r in UZ_ROWS if r[0] == label)


def uz_problem(torch, device, label, dtype=None, n=None, plain=False):
    """(cfg, x0, cost, dynamics, bounds with the mask, prev_ctrl) of a
    UZ_ROWS row on its first n examples, on the kernel route; ``plain``
    the same row without its mask and trust region."""
    import dataclasses
    import numpy as np
    import mpc_tpu_torch as mt
    dtype = dtype or torch.float32
    _, prob, T_, n0, _, mask, delta, _ = uz_row(label)
    n = n or n0
    t = (lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device))
    bk, prev, nc = dict(u_lower=-2.0, u_upper=2.0), None, 1
    rng = np.random.RandomState(1 if mask == 'batched' else 0)
    if prob in ('sweep', 'unbounded'):
        dx, cost = problem(torch, device, dtype)
        th = np.pi * (2 * rng.rand(n0) - 1)
        x0 = t(np.stack([np.cos(th), np.sin(th), np.zeros(n0)], 1))
        cfg = mt.MPCConfig(**UZ_SWEEP)
        if prob == 'unbounded':
            bk = {}
    elif prob == 'sweep3s2c':
        from mpc_tpu_torch.utils.problems import hw_sweep_delta_u
        nc = 2
        F, C, c, x0, lb, ub = hw_sweep_delta_u(T_, n0)
        cost, dx, x0 = mt.QuadCost(t(C), t(c)), mt.LinDx(t(F)), t(x0)
        bk = dict(u_lower=t(lb), u_upper=t(ub))
        cfg = mt.MPCConfig(**dict(UZ_SWEEP, n_ctrl=nc, T=T_, lqr_iter=8,
                                  pnqp_iter=20))
    elif prob == 'lindx3s4c':
        # tests/test_fused.py:97-113
        ns, nc = 3, 4
        nt = ns + nc
        rng = np.random.RandomState(0)
        R = rng.randn(T_, n0, nt, nt)
        C = np.einsum('tbij,tbkj->tbik', R, R) + 0.5 * np.eye(nt)
        c = rng.randn(T_, n0, nt)
        F = np.concatenate([np.tile(np.eye(ns), (T_ - 1, n0, 1, 1))
                            + 0.1 * rng.randn(T_ - 1, n0, ns, ns),
                            0.5 * rng.randn(T_ - 1, n0, ns, nc)], 3)
        f = 0.1 * rng.randn(T_ - 1, n0, ns)
        x0 = t(rng.randn(n0, ns))
        cost, dx = mt.QuadCost(t(C), t(c)), mt.LinDx(t(F), t(f))
        bk = {}
        cfg = mt.MPCConfig(**dict(UZ_SWEEP, n_ctrl=nc, T=T_, lqr_iter=2,
                                  max_linesearch_iter=2))
    elif prob == 'lindx':
        cfg, x0, cost, dx, _ = long_problem(torch, device, n0, dtype,
                                            backprop=False)
    elif prob == 'mlp':
        cfg, x0, cost, dx = nn_problem(torch, device, n0, dtype=dtype)
    elif prob == 'cartpole':
        x0, cost, dx = cartpole_problem(torch, device, dtype, n0)
        cfg = mt.MPCConfig(**dict(CARTPOLE, use_fused='auto'),
                           grad_method=mt.GradMethods.AUTO_DIFF)
        bk = dict(u_lower=-100.0, u_upper=100.0)
    else:
        cfg, x0, cost, dx, bk, prev = soa_problem(torch, device, 'slew 0.5',
                                                  dtype, n0)
    uz = None
    if mask == 'shared':
        uz = np.zeros((T_, nc), bool)
        if prob == 'lindx3s4c':
            uz[0, 1] = uz[2, 3] = True
        else:
            uz[3:6] = True
        uz = torch.tensor(uz, device=device)
    elif mask == 'batched':
        uz = torch.tensor(rng.rand(T_, n0, nc) < 0.15, device=device)[:, :n]
    x0 = x0[:n].contiguous()
    bk = {k: v if not torch.is_tensor(v) else v[:, :n].contiguous()
          for k, v in bk.items()}
    if prev is not None:
        prev = prev[:n].contiguous()
    if torch.is_tensor(cost.C) and cost.C.dim() == 4:
        cost = mt.QuadCost(cost.C[:, :n], cost.c[:, :n])
    if isinstance(dx, mt.LinDx) and dx.F.dim() == 4:
        dx = mt.LinDx(dx.F[:, :n], None if dx.f is None else dx.f[:, :n])
    if plain:
        return cfg, x0, cost, dx, bk, prev
    return (dataclasses.replace(cfg, delta_u=delta), x0, cost, dx,
            dict(bk, u_zero_I=uz), prev)


def uz_operands(torch, device, label, dtype=None, n=None, plain=False):
    """A UZ_ROWS row's kernel operands (with its mask ``uz`` and
    ``delta_u``, or without them where ``plain``), its kernel and plain
    version."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    cfg, x0, cost, dx, bk, prev = uz_problem(torch, device, label, dtype, n,
                                             plain)
    kernel = uz_row(label)[4]
    if kernel == 'dense':
        if prev is not None:
            cfg, x0, cost, dx = fused.slew_problem(cfg, x0, cost, dx, prev)
        return (fd.k3d_operands(cfg, x0, cost, dx, **bk),
                fd.fused_ilqr_dense, fd.fused_solve_dense_plain)
    if kernel == 'K1':
        return (fused.k1_operands(cfg, x0, cost, dx, **bk),
                fused.fused_ilqr, fused.fused_solve_plain)
    return (fused.k3_operands(cfg, x0, cost, dx, **bk),
            fused.fused_ilqr_long, fused.fused_solve_long_plain)


def uz_pinned_zero(what, ops, u):
    """Every control the mask pins is exactly 0.0."""
    if ops.get('uz') is None:
        return
    uu = u if u.dim() == ops['uz'].dim() else u[..., 0]
    pinned = (ops['uz'] > 0.5).expand_as(uu)
    if bool(pinned.any()) and float(uu[pinned].abs().max()) != 0.0:
        raise AssertionError(f'{what}: a pinned control is not 0.0')
    log(f'  {what}: {int(pinned.sum())} pinned controls exactly 0.0')


def uz_digest(outs):
    """A digest of a solve's outputs' bytes (x, u, stats)."""
    import hashlib
    h = hashlib.sha256()
    for a in outs:
        h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def uz_worker(device, *labels):
    """[compare-uz]'s process for the UZ_ROWS rows ``labels`` (one define
    set each), one after another, run under CUDA_LAUNCH_BLOCKING=1, so
    that a load through an absent operand faults at its own launch: the
    kernel launched once, finite, pinned controls exactly 0.0, the
    reversed batch, B = 1, 7, 33 alone and the batch with two more
    examples bitwise.  Prints a JSON line: each row's digest of its
    outputs and its log lines."""
    import torch
    device = torch.device(device)
    out = []
    for label in labels:
        print(f'# {label}', flush=True)
        lines = collect_log()
        t0 = time.perf_counter()
        _, _, T_, n, kname, _, _, _ = uz_row(label)
        what = f'{label} ({kname}), B={n}, T={T_}'
        ops, kernel, _ = uz_operands(torch, device, label)
        full = bitwise_worker(torch, device, what, ops, kernel)
        log(f'  {what}: one launch, reversed and B={n + 2} bitwise equal; '
            f'{time.perf_counter() - t0:.1f} s')
        out.append({'label': label, 'digest': uz_digest(full),
                    'lines': lines})
    print(json.dumps(out))


def phase_compare_uz(torch, device):
    """Each UZ_ROWS row (each define set) first in a process under
    CUDA_LAUNCH_BLOCKING=1 (``uz_worker``, the rows one after another),
    beside the rows' plain runs (``plain_worker``); then here, each row's kernel (the worker's bits) against its plain version
    by the row's gate: the float32 tail (mean |du| < TAIL_MEAN, share past
    TAIL_ENTRY < TAIL_SHARE, n_iter equal), or for the rows where two
    float32 solves part beyond it (a mask's kinks amplify their divergence
    ~30x, benchmarks/hw_sweep.py:42-56) the float64 rule (n_iter equal in
    TEAMS_SAME_ITER of the examples); on every row at most twice the plain
    float32 run's distance from a float64 plain run.  The cartpole's controls
    are held divided by CART_U_SCALE.  Returns each row's summary (max
    |du|, gate, the plain float32 run's device ms)."""
    t0 = time.perf_counter()
    bits = start_workers([['--uz-worker', device.type,
                           *(r[0] for r in UZ_ROWS)]],
                         [{'CUDA_LAUNCH_BLOCKING': '1'}])
    pending = start_plain(device, 'uz', [r[0] for r in UZ_ROWS], 3)
    (out,) = join_workers(bits)
    runs = plain_runs(torch, device, pending)
    log(f'[compare-uz] {len(UZ_ROWS)} rows in one process under '
        f'CUDA_LAUNCH_BLOCKING=1, and their plain versions, each row in '
        f'float32 and in float64, over 3 processes, all at once: '
        f'{time.perf_counter() - t0:.1f} s')
    res = {}
    for row, summary in zip(UZ_ROWS, out):
        label, prob, T_, n, kname, _, _, gate = row
        what = f'{label} ({kname}), B={n}, T={T_}'
        log(f'[compare-uz] {what}: the kernel vs its plain version')
        for line in summary['lines']:
            log(line)
        t1 = time.perf_counter()
        ops, kernel, _ = uz_operands(torch, device, label)
        ops64, _, _ = uz_operands(torch, device, label, torch.float64)
        scale = CART_U_SCALE if prob == 'cartpole' else 1.0
        xk, uk, sk = kernel(**ops)
        if uz_digest((xk, uk, sk)) != summary['digest']:
            raise AssertionError(f'{what}: not the bits of its '
                                 'CUDA_LAUNCH_BLOCKING=1 process')
        times = []
        plain = preloaded(torch, runs[label], times)
        _, up, sp = plain(**ops)
        _, u64, _ = plain(**ops64)
        us, ups, u64s = uk / scale, up / scale, u64 / scale
        mean, share, mx = tail(us, ups)
        same_iter = same_share(sk[2], sp[2])
        if gate == 'tail':
            check_tail(f'{what} (f32)', us, ups)
            if same_iter != 1.0:
                raise AssertionError(f'{what}: n_iter differs')
        else:
            check_tail(f'{what} (f32)', us, ups, None)
            if same_iter < TEAMS_SAME_ITER:
                raise AssertionError(f'{what}: n_iter equal in '
                                     f'{same_iter:.4f} of the examples')
        hold_equidistance(what, us, ups, u64s)
        log(f'  {what}: gate {gate}; n_iter equal in {same_iter:.4f} of the '
            f'examples, a solve {float(sk[2].double().mean()):.2f}, trials a '
            f'solve {float(sk[5].double().mean()):.2f}; plain {times[0]:.1f} '
            f'ms; {time.perf_counter() - t1:.1f} s')
        res[label] = dict(gate=gate, max_abs_err=mx * scale, mean=mean,
                          share=share, plain_ms=times[0])
    log(f'[compare-uz] {time.perf_counter() - t0:.1f} s')
    return res


def phase_serve_uz(torch, device):
    """Requests through the entry points, every count set to 0 before and
    read after: UZ_REQUESTS batched_solve requests of the K1 row 'uzero
    shared' with its mask and one through MPC (one K1 launch each, no
    eager solve, pinned controls 0.0, MPC bitwise batched_solve), then the
    same with delta_u = UZ_DELTA and no mask, each beside the eager
    route's ms of its first request in this process (use_fused='never');
    two requests of each other row (one launch of its kernel each).
    Returns the launches by row and the request and eager ms."""
    import dataclasses
    import mpc_tpu_torch as mt
    out = {'launches': {}}
    for label, knob in (('uzero shared', 'mask'), ('delta_u', 'delta_u')):
        cfg, x0, cost, dx, bk, _ = uz_problem(torch, device, 'uzero shared')
        if knob == 'delta_u':
            cfg = dataclasses.replace(cfg, delta_u=UZ_DELTA)
            bk = dict(bk, u_zero_I=None)
        n = x0.shape[0]
        reqs = [x0_batch(n, 600 + i, torch, torch.device('cpu'))
                for i in range(UZ_REQUESTS)]
        mt.batched_solve(cfg, x0, cost, dx, device=device, **bk).u.cpu()
        ctrl = mt.MPC(3, 1, cfg.T, u_lower=bk['u_lower'],
                      u_upper=bk['u_upper'], u_zero_I=bk['u_zero_I'],
                      delta_u=cfg.delta_u, lqr_iter=cfg.lqr_iter,
                      eps=cfg.eps, linesearch_decay=cfg.linesearch_decay,
                      max_linesearch_iter=cfg.max_linesearch_iter,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, device=device)

        def serve():
            lat, us = [], []
            for req in reqs:
                t0 = time.perf_counter()
                u = mt.batched_solve(cfg, req.to(device), cost, dx,
                                     device=device, **bk).u.cpu()
                lat.append(1e3 * (time.perf_counter() - t0))
                us.append(u)
            t0 = time.perf_counter()
            um = ctrl(reqs[0].to(device), cost, dx)[1].cpu()
            return lat, us, um, 1e3 * (time.perf_counter() - t0)

        (lat, us, um, mpc_ms), counts, n_eager = soa_counted(torch, serve)
        ms = median(lat)
        log(f'[serve-uz] {knob}, K1, B={n}: {UZ_REQUESTS} batched_solve '
            'requests, latency ms ' + ' '.join(f'{v:.3f}' for v in lat) +
            f', median {ms:.3f}; MPC {mpc_ms:.3f} ms; launches {counts}, '
            f'eager solves {n_eager}')
        if n_eager or (device.type == 'cuda'
                       and counts != {'fused_ilqr': UZ_REQUESTS + 1}):
            raise AssertionError(f'[serve-uz] {knob}: each request must '
                                 'launch K1 once and nothing else')
        if not torch.equal(um, us[0]):
            raise AssertionError(f'[serve-uz] {knob}: MPC and batched_solve '
                                 'answer differently')
        ops = {'uz': None if bk['u_zero_I'] is None
               else bk['u_zero_I'].to(torch.float32).cpu()}
        for u in us:
            if not (torch.isfinite(u).all() and u.abs().max() <= 2.0):
                raise AssertionError(f'[serve-uz] {knob}: an answer is not '
                                     'finite in the box')
            uz_pinned_zero(f'[serve-uz] {knob}', ops, u)
        never = dataclasses.replace(cfg, use_fused='never')
        (eager_u, eager_ms), n_eager = eager_counted(torch, lambda: timed(
            torch, device, lambda: mt.batched_solve(
                never, reqs[0].to(device), cost, dx, device=device,
                **bk).u, 2))
        log(f'  the eager route (use_fused=\'never\') of the first request: '
            f'{eager_ms:.1f} ms ({eager_ms / ms:.0f}x the kernel route), '
            f'eager solves {n_eager}, max |u - kernel route\'s| '
            f'{float((eager_u[0].cpu() - us[0]).abs().max()):.3e}; '
            f'{card_line()}')
        out['launches'][label] = UZ_REQUESTS + 1
        out[f'{knob}_request_ms'], out[f'{knob}_mpc_ms'] = ms, mpc_ms
        out[f'{knob}_eager_ms'] = eager_ms
    kname = {'dense': 'fused_ilqr_dense', 'K1': 'fused_ilqr',
             'K3': 'fused_ilqr_long'}
    for label, _, T_, n_, kernel, _, _, _ in UZ_ROWS:
        if label == 'uzero shared':
            continue
        cfg_, x0_, cost_, dx_, bk_, prev_ = uz_problem(torch, device, label)
        (us_, counts, n_eager) = soa_counted(torch, lambda: [
            mt.batched_solve(cfg_, x0_, cost_, dx_, prev_ctrl=prev_,
                             device=device, **bk_).u.cpu()
            for _ in range(2)])
        log(f'[serve-uz] {label}, B={n_}, T={T_}: two requests, launches '
            f'{counts}, eager solves {n_eager}')
        if n_eager or (device.type == 'cuda'
                       and counts != {kname[kernel]: 2}) \
                or not torch.isfinite(us_[-1]).all():
            raise AssertionError(f'{label}: each request must launch its '
                                 'kernel once and nothing else')
        out['launches'][label] = 2
    return out


def uz_flops(ops, label, stats):
    """The operations of a UZ_ROWS row's solve from this run's counts, with
    the trust region's bounds u -+ delta_u where ``ops`` has one and the
    dense configuration's masked factor where it has a mask, and the
    bytes it must move."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    _, prob, _, _, kernel, _, _, _ = uz_row(label)
    delta_u = ops['delta_u'] is not None
    sums = [float(stats[i].double().sum()) for i in (2, 3, 5)]
    n = ops['x0'].shape[0]
    T_ = ops['u0'].shape[0]
    if kernel == 'dense':
        ns, nc = ops['x0'].shape[1], ops['u0'].shape[2]
        model_ops = None
        if ops['model'] is not None:
            model_ops = fd.model_op_counts(fd.dense_model(ops['model'])[0])
        return (fd.k3d_flops(T_, ns, nc, sums[0], sums[2], batch=n,
                             has_f=ops['f'] is not None,
                             n_qp=sums[1] if nc > 1 else 0,
                             model_ops=model_ops,
                             has_bounds=ops['lb'] is not None,
                             uz=ops['uz'] is not None, delta_u=delta_u),
                fd.k3d_bytes(ops))
    if kernel == 'K1':
        return (fused.k1_flops(T_, 3, 1, sums[0], sums[2], batch=n,
                               delta_u=delta_u),
                fused.k1_bytes(ops))
    nn_ops = fused.nn_op_counts(NN_H, 'sigmoid', True) if prob == 'mlp' \
        else None
    return (fused.k3_flops(T_, 3, 1, sums[0], sums[2], batch=n,
                           lindx=prob == 'lindx', nn_ops=nn_ops,
                           delta_u=delta_u),
            fused.k1_bytes(ops))


def uz_defines(ops, label):
    """(library name, defines, launch geometry) of a row's build, with
    the mask build's define where ``ops`` has a mask."""
    from mpc_tpu_torch.ops import fused
    _, prob, _, n_row, kernel, _, _, _ = uz_row(label)
    T_, n = ops['u0'].shape[:2]
    n_alpha = len(ops['alphas'])
    bounds, has_uz = ops['lb'] is not None, ops['uz'] is not None
    if kernel == 'dense':
        return ('fused_ilqr_dense', *dense_defines(ops, n_row))
    if kernel == 'K1':
        return ('fused_ilqr', fused.kernel_defines(T_, bounds,
                                                   has_uz=has_uz),
                fused.k1_launch(T_, n, n_alpha))
    return ('fused_ilqr_long', *nn_defines(ops))


def uz_build_specs():
    """Every build the u_zero_I phases run: each row with its mask, and
    without (the [time-uz] baseline)."""
    import torch
    specs = []
    for label, *_ in UZ_ROWS:
        for plain in (False, True):
            ops, _, _ = uz_operands(torch, torch.device('cpu'), label, n=4,
                                    plain=plain)
            name, defines, _ = uz_defines(ops, label)
            if (name, defines) not in specs:
                specs.append((name, defines))
    return specs


def phase_time_uz(torch, device, compare):
    """Each UZ_ROWS row's kernel timed from a CUDA graph beside the same
    row without its mask and trust region (the build and operands the
    earlier phases run) in this run, and, where it has a mask, the mask
    build with an all-zero mask on that row run once (the same arithmetic
    as the build without: the same bits, asserted, but at several
    controls without bounds, where the build without a mask factors with
    the jitter); its bound from this run's iterations, trials and QP trips
    (k1_flops, k3_flops, k3d_flops with the trust region's bounds u -+
    delta_u and the dense configuration's masked factor) and bytes, its
    registers and spills, and the plain version's device ms of
    [compare-uz].  Returns the rows."""
    rows = []
    for label, _, T_, n, kname, mask, delta, _ in UZ_ROWS:
        ops, kernel, _ = uz_operands(torch, device, label)
        _, _, st = kernel(**ops)
        ms, eager_ms = graph_ms(torch, lambda: kernel(**ops), reps=3,
                                per_graph=4)
        op0, _, _ = uz_operands(torch, device, label, plain=True)
        base = kernel(**op0)
        st0 = base[2]
        base_ms, _ = graph_ms(torch, lambda: kernel(**op0), reps=3,
                              per_graph=4)
        split = ''
        if mask is not None:
            zero = kernel(**dict(op0, uz=torch.zeros_like(ops['uz'])))
            same = all(torch.equal(a, b) for a, b in zip(zero, base))
            if not same and not (kname == 'dense' and op0['lb'] is None
                                 and op0['u0'].shape[2] > 1):
                raise AssertionError(f'{label}: the mask build with a zero '
                                     'mask is not the build without one')
            split = (f'; the mask build with a zero mask: bits '
                     f'{"equal" if same else "not equal"}')
        plain_ms = compare[label]['plain_ms']
        flops, nbytes = uz_flops(ops, label, st)
        bound_ms, by = bound(flops, nbytes)
        name, defines, geo = uz_defines(ops, label)
        des = design(name, defines, geo)
        log(f'[time-uz] {label} ({kname}; mask {mask}, delta_u {delta}), '
            f'B={n}, T={T_}: {ms:.4f} ms (from a CUDA graph; {eager_ms:.4f} '
            f'ms a call from Python), without the mask and delta_u '
            f'{base_ms:.4f} ms ({ms / base_ms:.3f}x; '
            f'{float(st0[2].double().mean()):.2f} iterations, '
            f'{float(st0[5].double().mean()):.2f} trials a solve){split}, '
            f'plain {plain_ms:.1f} ms; {flops:.4e} operations '
            f'({float(st[2].double().mean()):.2f} iterations, '
            f'{float(st[5].double().mean()):.2f} trials, '
            f'{float(st[3].double().mean()):.1f} QP trips a solve), {nbytes} '
            f'bytes; bound {bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
            f'registers {des["registers"]}, spill stores '
            f'{des["spill_store_bytes"]} bytes; {card_line()}')
        rows.append(dict(row=f'{label} B={n} T={T_}', label=label, ms=ms,
                         base_ms=base_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by,
                         registers=des['registers'],
                         spill_store_bytes=des['spill_store_bytes'],
                         design=des))
    return rows


def uz_entries(rows, serve, compare):
    """The kernels line's entries of this slice: each UZ_ROWS row's build
    with its launches in [serve-uz], max |du| and gate of [compare-uz],
    ms beside the same row without mask or delta_u, bound and plain ms."""
    out = []
    files = {'K1': ('fused_ilqr', 617), 'K3': ('fused_ilqr_long', 1126),
             'dense': ('fused_ilqr_dense', 1126)}
    for r in rows:
        label = r['label']
        _, prob, _, _, kernel, mask, delta, _ = uz_row(label)
        name, line = files[kernel]
        c = compare[label]
        e = {'name': f'{name} (u_zero_I/delta_u: {label})',
             'path': f'u_zero_I/delta_u {label}', 'route': 'cuda',
             'source': f'mpc_tpu_torch/csrc/{name}.cu',
             'replaces': f'mpc_tpu/ops/fused.py:{line}',
             'mask': mask, 'delta_u': delta, 'design': r['design'],
             'launches': serve['launches'][label],
             'max_abs_err': c['max_abs_err'],
             'tolerance': (f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
                           f'<{TAIL_SHARE}, n_iter equal'
                           if c['gate'] == 'tail' else
                           'at most 2x the plain f32 run\'s mean |du| from a '
                           f'f64 plain run, n_iter equal in '
                           f'{TEAMS_SAME_ITER} of the examples') +
                          (f' (|du|/{CART_U_SCALE})' if prob == 'cartpole'
                           else '') + '; pinned controls 0.0',
             'gate': c['gate'], 'library_ms': None,
             'without_mask_and_delta_u_ms': r['base_ms'],
             **{k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')}}
        if label == 'uzero shared':
            e.update({k: serve[k] for k in serve if k != 'launches'},
                     launches_delta_u=serve['launches']['delta_u'])
        out.append(e)
    return out

# ---------------------------------------------------------------------------
# learned dynamics at any size: the dense configuration's MLP build
# (MPC_MODEL 4, csrc/nn_dense.cuh)
# ---------------------------------------------------------------------------

# (label, row of mpc_tpu_torch/utils/problems.MLP_ROWS, B, bounds, gate):
# bench_nn_dynamics under slew 0.5 (4 augmented states), the (64, 64)
# model of examples/gym_pendulum_approximate.py at B=2048 and at the
# example's own B=1, and the reference's default width at 8 states and 4
# controls with box +-1 and, at B=2050, without bounds (the jittered
# Cholesky).  The gate ([compare-mlp]) is the float32 tail where the row
# was measured inside it on the H100, float64 where two float32 solves
# part beyond it (mlp-slew: 0.61% of the controls past 1e-3; mlp-deep:
# n_iter equal in 97.6% of the examples at eps 1e-2, both float32 runs
# up to 0.2 from float64 in a first chip run, PERF.md section 6).
MLP_CASES = (
    ('mlp-slew', 'mlp-slew', 2048, True, 'float64'),
    ('mlp-deep', 'mlp-deep', 2048, True, 'float64'),
    ('mlp-deep B=1', 'mlp-deep', 1, True, 'tail'),
    ('mlp-multictrl', 'mlp-multictrl', 2048, True, 'tail'),
    ('mlp-multictrl unbounded', 'mlp-multictrl', 2050, False, 'tail'),
)
MLP_REQUESTS = 4
# the rows whose build this is, and the TPU kernel mode each replaces: the
# stream form (one hidden layer, mpc_tpu/ops/fused.py:1252) or the tuple
# path (deeper, :1307)
MLP_REPLACES = {1: 'mpc_tpu/ops/fused.py:1252', 2: 'mpc_tpu/ops/fused.py:1307'}


def mlp_case(label):
    return next(r for r in MLP_CASES if r[0] == label)


def mlp_problem(torch, device, label, dtype=None, n=None):
    """(cfg, x0, cost, model, bounds, prev_ctrl) of an MLP_CASES row at its
    own sizes (or on its first n examples), on the kernel route; the
    model's weights from problems.mlp_row's numpy seed, in ``dtype``."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils.convert import nn_dynamics_from_numpy
    from mpc_tpu_torch.utils.problems import mlp_row
    dtype = dtype or torch.float32
    _, row, n0, bounded, _ = mlp_case(label)
    r = mlp_row(row, n or n0, bounded=bounded)
    cfg = mt.MPCConfig(n_state=r['n_state'], n_ctrl=r['n_ctrl'], T=r['T'],
                       exit_unconverged=False, detach_unconverged=False,
                       backprop=False, grad_method=mt.GradMethods.AUTO_DIFF,
                       **r['cfg'])
    model = nn_dynamics_from_numpy(r['weights'], r['activation'],
                                   r['passthrough'], device=device).to(dtype)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)
    bk = {} if r['u_lower'] is None else dict(u_lower=r['u_lower'],
                                              u_upper=r['u_upper'])
    return (cfg, t(r['x0']), mt.QuadCost(t(r['C']), t(r['c'])), model, bk,
            None if r['prev_ctrl'] is None else t(r['prev_ctrl']))


def mlp_operands(torch, device, label, dtype=None, n=None):
    """An MLP_CASES row's dense-kernel operands (the slew-augmented problem
    where the row has a slew penalty)."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    cfg, x0, cost, model, bk, prev = mlp_problem(torch, device, label, dtype,
                                                 n)
    if prev is not None:
        cfg, x0, cost, model = fused.slew_problem(cfg, x0, cost, model, prev)
    return fd.k3d_operands(cfg, x0, cost, model, **bk)


def mlp_build_specs():
    """The MLP build of each MLP_CASES row (one a define set)."""
    import torch
    specs = []
    for label, *_ in MLP_CASES:
        spec = ('fused_ilqr_dense', dense_defines(mlp_operands(
            torch, torch.device('cpu'), label, n=1))[0])
        if spec not in specs:
            specs.append(spec)
    return specs


def mlp_worker(device, *labels):
    """[compare-mlp]'s process for the MLP_CASES rows ``labels``, one
    after another, run under CUDA_LAUNCH_BLOCKING=1, so that a load
    through a wrong address faults at its own launch: the kernel launched
    once, finite, the reversed batch, B = 1, 7, 33 alone (where the row
    has that many) and the batch with two more examples bitwise.  Prints
    a JSON line: each row's digest of its outputs and its log lines."""
    import torch
    device = torch.device(device)
    out = []
    for label in labels:
        print(f'# {label}', flush=True)
        lines = collect_log()
        t0 = time.perf_counter()
        n = mlp_case(label)[2]
        what = f'{label}, B={n}'
        ops = mlp_operands(torch, device, label)
        full = bitwise_worker(torch, device, what, ops)
        log(f'  {what}: one launch, reversed and B={n + min(2, n)} bitwise '
            f'equal; {time.perf_counter() - t0:.1f} s')
        out.append({'label': label, 'digest': uz_digest(full),
                    'lines': lines})
    print(json.dumps(out))


def phase_compare_mlp(torch, device):
    """Each MLP_CASES row first in a process under CUDA_LAUNCH_BLOCKING=1
    (``mlp_worker``, the rows one after another), beside the rows' plain
    runs (``plain_worker``); then here,
    each row's kernel (the worker's bits) against its plain version by the
    row's gate: the float32 tail (mean |du| < TAIL_MEAN, share past
    TAIL_ENTRY < TAIL_SHARE) with n_iter equal, or, where a stiff MLP
    parts two float32 solves beyond it, at most twice the plain float32
    run's distance from a float64 plain run (n_iter's agreement shown).
    Returns each row's summary (max |du|, gate, the plain float32 run's
    device ms, the kernel's stats)."""
    from mpc_tpu_torch.ops import fused_dense as fd
    t0 = time.perf_counter()
    bits = start_workers([['--mlp-worker', device.type,
                           *(r[0] for r in MLP_CASES)]],
                         [{'CUDA_LAUNCH_BLOCKING': '1'}])
    pending = start_plain(device, 'mlp', [r[0] for r in MLP_CASES], 3)
    (out,) = join_workers(bits)
    runs = plain_runs(torch, device, pending)
    log(f'[compare-mlp] {len(MLP_CASES)} rows in one process under '
        f'CUDA_LAUNCH_BLOCKING=1, and their plain versions, each row in '
        f'float32 and in float64, over 3 processes, all at once: '
        f'{time.perf_counter() - t0:.1f} s')
    res = {}
    for (label, _, n, bounded, gate), summary in zip(MLP_CASES, out):
        what = f'{label}, B={n}'
        log(f'[compare-mlp] {what}: the kernel vs its plain version')
        for line in summary['lines']:
            log(line)
        t1 = time.perf_counter()
        ops = mlp_operands(torch, device, label)
        ops64 = mlp_operands(torch, device, label, torch.float64)
        xk, uk, sk = fd.fused_ilqr_dense(**ops)
        if uz_digest((xk, uk, sk)) != summary['digest']:
            raise AssertionError(f'{what}: not the bits of its '
                                 'CUDA_LAUNCH_BLOCKING=1 process')
        times = []
        plain = preloaded(torch, runs[label], times)
        _, up, sp = plain(**ops)
        _, u64, _ = plain(**ops64)
        mean, share, mx = tail(uk, up)
        same_iter = same_share(sk[2], sp[2])
        if gate == 'tail':
            check_tail(f'{what} (f32)', uk, up)
            if same_iter != 1.0:
                raise AssertionError(f'{what}: n_iter differs')
        else:
            check_tail(f'{what} (f32)', uk, up, None)
        hold_equidistance(what, uk, up, u64)
        if bounded and float(uk.abs().max()) > float(ops['ub'].max()):
            raise AssertionError(f'{what}: a control outside its box')
        log(f'  {what}: gate {gate}; n_iter equal in {same_iter:.4f} of the '
            f'examples, a solve {float(sk[2].double().mean()):.2f}, trials a '
            f'solve {float(sk[5].double().mean()):.2f}, QP trips a solve '
            f'{float(sk[3].double().mean()):.1f}; max |u - f64|: kernel '
            f'{float((uk.double() - u64).abs().max()):.3e}, plain '
            f'{float((up.double() - u64).abs().max()):.3e}; plain '
            f'{times[0]:.1f} ms; {time.perf_counter() - t1:.1f} s')
        res[label] = dict(gate=gate, max_abs_err=mx, mean=mean, share=share,
                          same_iter=same_iter, plain_ms=times[0])
    log(f'[compare-mlp] {time.perf_counter() - t0:.1f} s')
    return res


def mlp_served(torch, device, label, sol, req, u, cost, model):
    """A served answer holds up: finite, in its box, x the rollout of u
    through the model from the request (the augmented state's model part
    under slew) and, without slew, costs its objective."""
    from mpc_tpu_torch.solver import rollout, trajectory_cost
    _, _, _, bounded, _ = mlp_case(label)
    u = u.to(device)
    with torch.no_grad():
        xr = rollout(model, req, u)
    x_gap = float((xr - sol.x).abs().max() / sol.x.abs().max())
    gap = 0.0
    if mlp_case(label)[1] != 'mlp-slew':
        cr = trajectory_cost(cost, sol.x, u)
        gap = float((cr - sol.costs).abs().max() / sol.costs.abs().max())
    from mpc_tpu_torch.utils.problems import MLP_ROWS
    lim = MLP_ROWS[mlp_case(label)[1]][7] if bounded else math.inf
    log(f'  last answer: max |x - rollout| / max |x| {x_gap:.2e}, relative '
        f'cost gap {gap:.2e}, max |u| {float(u.abs().max()):.3f}')
    if not (torch.isfinite(u).all() and float(u.abs().max()) <= lim
            and x_gap < 1e-3 and gap < 1e-3):
        raise AssertionError(f'{label}: a served answer is not a feasible '
                             'solve')


def phase_serve_mlp(torch, device):
    """Each MLP_CASES row through the entry points, every count set to 0
    before and read after: MLP_REQUESTS distinct batches through
    batched_solve (new starts from the row's seeds) and one through MPC,
    host to host, one dense launch a request and no eager solve, MPC
    bitwise batched_solve, the last answer a feasible solve; beside it
    the eager route's (use_fused='never') ms of the first request in this
    process.  Returns the launches by row and the request and eager ms."""
    import dataclasses
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils.problems import mlp_row
    out = {'launches': {}, 'request_ms': {}, 'mpc_ms': {}, 'eager_ms': {}}
    for label, row, n, bounded, _ in MLP_CASES:
        cfg, x0, cost, model, bk, prev = mlp_problem(torch, device, label)
        reqs = [torch.tensor(mlp_row(row, n, seed=100 + i)['x0'],
                             dtype=torch.float32)
                for i in range(MLP_REQUESTS)]
        kw = dict(bk, prev_ctrl=prev, device=device)
        mt.batched_solve(cfg, x0, cost, model, **kw).u.cpu()
        slew = cfg.slew_rate_penalty
        ctrl = mt.MPC(cfg.n_state, cfg.n_ctrl, cfg.T, lqr_iter=cfg.lqr_iter,
                      eps=cfg.eps, linesearch_decay=cfg.linesearch_decay,
                      max_linesearch_iter=cfg.max_linesearch_iter,
                      grad_method=mt.GradMethods.AUTO_DIFF,
                      slew_rate_penalty=slew, prev_ctrl=prev,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, device=device, **bk)

        def serve():
            lat, sols = [], []
            for req in reqs:
                t0 = time.perf_counter()
                sol = mt.batched_solve(cfg, req.to(device), cost, model,
                                       **kw)
                u = sol.u.cpu()
                lat.append(1e3 * (time.perf_counter() - t0))
                sols.append((sol, u))
            t0 = time.perf_counter()
            um = ctrl(reqs[0].to(device), cost, model)[1].cpu()
            return lat, sols, um, 1e3 * (time.perf_counter() - t0)

        (lat, sols, um, mpc_ms), counts, n_eager = soa_counted(torch, serve)
        ms = median(lat)
        log(f'[serve-mlp] {label}, B={n}: {MLP_REQUESTS} batched_solve '
            'requests, latency ms ' + ' '.join(f'{v:.3f}' for v in lat) +
            f', median {ms:.3f} ({n / ms * 1e3:.0f} solves/s); MPC '
            f'{mpc_ms:.3f} ms; launches {counts}, eager solves {n_eager}')
        if n_eager or (device.type == 'cuda' and counts != {
                'fused_ilqr_dense': MLP_REQUESTS + 1}):
            raise AssertionError(f'{label}: each request must launch the '
                                 'dense kernel once and nothing else')
        if not torch.equal(um, sols[0][1]):
            raise AssertionError(f'{label}: MPC and batched_solve answer '
                                 'differently')
        mlp_served(torch, device, label, sols[-1][0],
                   reqs[-1].to(device), sols[-1][1], cost, model)
        never = dataclasses.replace(cfg, use_fused='never')
        (eager, eager_ms), n_eager = eager_counted(torch, lambda: timed(
            torch, device, lambda: mt.batched_solve(
                never, reqs[0].to(device), cost, model, **kw).u, 1))
        log(f'  the eager route (use_fused=\'never\') of the first request: '
            f'{eager_ms:.1f} ms ({eager_ms / ms:.0f}x the kernel route), '
            f'eager solves {n_eager}, max |u - kernel route\'s| '
            f'{float((eager[0].cpu() - sols[0][1]).abs().max()):.3e}; '
            f'{card_line()}')
        out['launches'][label] = MLP_REQUESTS + 1
        out['request_ms'][label], out['mpc_ms'][label] = ms, mpc_ms
        out['eager_ms'][label] = eager_ms
    return out


def mlp_flops(ops, stats):
    """The operations of an MLP row's solve from this run's counts (the
    MLP's step in every rollout and its Jacobian before every sweep,
    fused_dense.mlp_op_counts; the QP trips at several bounded controls)
    and the bytes it must move."""
    from mpc_tpu_torch.ops import fused_dense as fd
    T_, n, nc = ops['u0'].shape
    ns = ops['x0'].shape[1]
    sums = [float(stats[i].double().sum()) for i in (2, 3, 5)]
    return (fd.k3d_flops(T_, ns, nc, sums[0], sums[2], batch=n,
                         has_bounds=ops['lb'] is not None,
                         n_qp=sums[1] if nc > 1 and ops['lb'] is not None
                         else 0,
                         model_ops=fd.model_op_counts(
                             'mlp', fd.mlp_spec(ops['model']))),
            fd.k3d_bytes(ops))


def phase_time_mlp(torch, device, compare):
    """Each MLP_CASES row's kernel timed from a CUDA graph, its bound from
    this run's iterations, trials and QP trips (mlp_flops) and bytes, its
    registers, spills and shared memory, beside the plain version's ms of
    [compare-mlp]; and, as the reference point of the same run,
    bench_nn_dynamics on K3's MLP configuration (NN, B=2048, T=20).
    Returns the rows and K3's ms."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.ops import fused_dense as fd
    ops = nn_k3_operands(torch, device)
    k3_ms, _ = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                        per_graph=4)
    log(f'[time-mlp] the reference point: bench_nn_dynamics (3 states, 1 '
        f'control, H={NN_H}, B={NN_B}, T={NN_T}) in K3\'s MLP configuration '
        f'{k3_ms:.4f} ms (from a CUDA graph); {card_line()}')
    rows = []
    for label, _, n, _, _ in MLP_CASES:
        ops = mlp_operands(torch, device, label)
        _, _, st = fd.fused_ilqr_dense(**ops)
        ms, eager_ms = graph_ms(torch, lambda: fd.fused_ilqr_dense(**ops),
                                reps=3, per_graph=4)
        flops, nbytes = mlp_flops(ops, st)
        bound_ms, by = bound(flops, nbytes)
        defines, geo = dense_defines(ops)
        des = design('fused_ilqr_dense', defines, geo)
        sizes = fd.mlp_spec(ops['model'])[0]
        log(f'[time-mlp] {label}, B={n}, T={ops["u0"].shape[0]}, widths '
            f'{sizes}: {ms:.4f} ms (from a CUDA graph; {eager_ms:.4f} ms a '
            f'call from Python), plain {compare[label]["plain_ms"]:.1f} ms; '
            f'{flops:.4e} operations ({float(st[2].double().mean()):.2f} '
            f'iterations, at most {float(st[2].max()):.0f}, '
            f'{float(st[5].double().mean()):.2f} trials, '
            f'{float(st[3].double().mean()):.1f} QP trips a solve), {nbytes} '
            f'bytes; bound {bound_ms:.5f} ms by {by} ({ms / bound_ms:.1f}x); '
            f'{n / ms * 1e3:.0f} solves/s; registers {des["registers"]}, '
            f'spill stores {des["spill_store_bytes"]} bytes, shared memory '
            f'{geo["smem_bytes"]} bytes a block, '
            f'{fd.blocks_an_sm(geo["smem_bytes"])} blocks an SM by it, '
            f'Jacobian chunk {geo["chunk"]}; {card_line()}')
        rows.append(dict(row=f'{label} B={n}', label=label, ms=ms,
                         plain_ms=compare[label]['plain_ms'],
                         bound_ms=bound_ms, bound_by=by, depth=len(sizes) - 2,
                         registers=des['registers'],
                         spill_store_bytes=des['spill_store_bytes'],
                         design=des))
    return rows, k3_ms


def mlp_grads(torch, device, primal=None, dtype=None):
    """A loss of a differentiable mlp-multictrl solve with gradients to the
    MLP's weights and x_init: through the kernels (the dense forward and
    the dense backward), or, given the Solution ``primal`` of the
    kernels' phase 1, through the eager fixed point on it (in
    ``dtype``).  Returns [loss, d weights..., d x_init] and the kernels'
    Solution."""
    import dataclasses
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    dtype = dtype or torch.float32
    cfg, x0, cost, model, bk, _ = mlp_problem(torch, device, 'mlp-multictrl',
                                              dtype)
    cfg = dataclasses.replace(cfg, backprop=True)
    x0 = x0.requires_grad_()
    n = x0.shape[0]
    u_exp = torch.tensor(0.3 * np.random.RandomState(19).randn(
        cfg.T, n, cfg.n_ctrl), dtype=dtype, device=device)
    sol = None
    if primal is None:
        sol = mt.batched_solve(cfg, x0, cost, model, device=device, **bk)
        x, u = sol.x, sol.u
    else:
        lb = torch.tensor(bk['u_lower'], dtype=dtype, device=device)
        x, u = solver.fixed_point_phase(cfg, x0, cost, model,
                                        primal.x.to(dtype),
                                        primal.u.to(dtype), lb, -lb,
                                        primal.converged)
    loss = ((u - u_exp) ** 2).mean() + 0.1 * (x ** 2).mean()
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()] + [
        x0.grad], sol


def phase_grad_mlp(torch, device):
    """Gradients of an mlp-multictrl loss to the MLP's weights and x_init
    through one dense forward and one dense-backward launch, against the
    eager fixed point on the same converged trajectory and the float64
    eager fixed point on it (each within BWD_TOL relative to the
    gradient's largest entry).  Returns the launches and the largest
    gradient error."""
    from mpc_tpu_torch import solver
    n = mlp_case('mlp-multictrl')[2]
    log(f'[grad-mlp] mlp-multictrl, B={n}: gradients to the MLP\'s weights '
        'and x_init through the dense configuration and the dense backward')
    (kk, sol), counts, n_eager = soa_counted(
        torch, lambda: mlp_grads(torch, device))
    if solver.eager_counts['eager_fixed_point'] or n_eager or (
            device.type == 'cuda' and counts != {
                'fused_ilqr_dense': 1, 'fused_kkt_bwd_dense': 1}):
        raise AssertionError('a differentiable mlp-multictrl solve must '
                             'launch the dense forward and the dense backward '
                             f'once each and nothing else: {counts}')
    log(f'  launches {counts}, eager solves {n_eager}; converged '
        f'{float(sol.converged.double().mean()):.3f}, n_iter a solve '
        f'{float(sol.n_iter.double().mean()):.2f}')
    primal = sol._replace(x=sol.x.detach(), u=sol.u.detach())
    ref, _ = mlp_grads(torch, device, primal)
    ref64, _ = mlp_grads(torch, device, primal, torch.float64)
    names = [f'layer {i // 2} {"W" if i % 2 == 0 else "b"}'
             for i in range(len(kk) - 2)] + ['x_init']
    err = 0.0
    for name, g, r, r64 in zip(names, kk[1:], ref[1:], ref64[1:]):
        e, e64 = rel_err(g, r), rel_err(g, r64)
        err = max(err, e, e64)
        log(f'  {name}: max |dense backward - eager| / max |eager| {e:.3e}; '
            f'vs the f64 eager {e64:.3e} (eager f32: {rel_err(r, r64):.3e})')
        if not (torch.isfinite(g).all() and float(g.abs().max()) > 0):
            raise AssertionError(f'{name}: gradient not finite or zero')
    if not err < BWD_TOL:
        raise AssertionError('mlp-multictrl gradients through the dense '
                             'backward are off the eager fixed point')
    return counts, err


def mlp_entries(rows, serve, compare, grad_counts, grad_err, k3_ms):
    """The kernels line's entries of this slice: the MLP build at each
    MLP_CASES row with its launches in [serve-mlp], max |du| and gate of
    [compare-mlp], ms, bound and plain ms; the first also the gradient
    path's launches and error and K3's MLP configuration's ms beside."""
    out = []
    for r in rows:
        label = r['label']
        c = compare[label]
        e = {'name': f'fused_ilqr_dense (mlp: {label})',
             'path': f'learned dynamics {label}', 'route': 'cuda',
             'source': 'mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
             'headers': ['mpc_tpu_torch/csrc/nn_dense.cuh',
                         'mpc_tpu_torch/csrc/nn.cuh',
                         'mpc_tpu_torch/csrc/box_qp.cuh'],
             'replaces': MLP_REPLACES[min(r['depth'], 2)],
             'design': r['design'], 'launches': serve['launches'][label],
             'max_abs_err': c['max_abs_err'], 'gate': c['gate'],
             'tolerance': (f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
                           f'<{TAIL_SHARE}, n_iter equal'
                           if c['gate'] == 'tail' else
                           'at most 2x the plain f32 run\'s mean |du| from a '
                           'f64 plain run'),
             'request_ms': serve['request_ms'][label],
             'eager_ms': serve['eager_ms'][label], 'library_ms': None,
             **{k: r[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')}}
        if label == 'mlp-multictrl':
            e.update(launches_grad_mlp=grad_counts, grad_err_vs_eager=grad_err)
        if label == 'mlp-slew':
            e.update(k3_bench_nn_dynamics_ms=k3_ms)
        out.append(e)
    return out


CLOSED_LOOP_BS = (1, 16, 256, B)
CLOSED_LOOP_STEPS = 100
# the step of the B=4096 loop whose K1 operands are held against the
# plain version and timed (a warm-started solve mid-swing)
CLOSED_LOOP_HELD_STEP = 50
# the double integrator (p, v) under a slew penalty, at the long
# configuration's T and B (the JAX package has no slew configuration):
# F = [[1, dt, 0], [0, 1, dt]], C = diag(1, 0.1, 0.01), c the target
# position 1 (shared, as the long configuration's cost is), box +-2,
# x0 and prev_ctrl per example
SLEW_DT = 0.05
SLEW = dict(n_state=2, n_ctrl=1, T=LONG_T, lqr_iter=4, eps=0.0,
            exit_unconverged=False, detach_unconverged=False, backprop=False,
            linesearch_decay=0.2, max_linesearch_iter=3,
            slew_rate_penalty=0.5)
SLEW_B = LONG_B
# the headline's solve under the same penalty on the eager route, pinned
# there with use_fused='never' (the kernels take the augmented pendulum
# of 4 states in the dense configuration's model-step build, [compare-soa]):
# a closed loop of 10 steps at B=256, ~38,600 operations a solve (a CPU
# count)
SLEW_EAGER = dict(HEADLINE, slew_rate_penalty=0.5, use_fused='never')
SLEW_EAGER_B, SLEW_EAGER_STEPS = 256, 5
# The card's float64 loop against the CPU's.  Each solve of the loop
# starts from the last one's solution and runs 10 iterations with eps = 0,
# so its later iterations take steps at round-off: there every trial cost
# ties the current one and each machine's line search picks its own step
# size (on an NVIDIA H100 80GB HBM3 at 700 W: 227 of 256 examples part
# somewhere, their applied controls within 2.95e-8 of the CPU's, the rest
# within 1.7e-15).  Where a full step s is a tie follows from the cost's
# round-off: near the solution a step changes the objective (~20) by about
# 1/2 Quu s^2 with Quu ~ 0.5 (the slew block), and float64 evaluates the
# objective to ~3e-14, so steps below ~4e-7 cannot be told apart.  A
# parting at an iteration whose full step is below SLEW_TIE_STEP (on
# either run) counts as such a tie (the largest seen on that card:
# 6.14e-7; no parting at a larger step).
# Held: the examples that never part within EAGER_F64_TOL, the share that
# parts at a step of SLEW_TIE_STEP or more below PARTED_SHARE (0 of 256
# seen; 13 would fail), every example's applied controls within
# SLEW_CTRL_TOL of the CPU's (relative to max |u|).
SLEW_TIE_STEP = 1e-6
SLEW_CTRL_TOL = 1e-6
# Each float32 solve of the float32 loop against a float64 solve on the
# same inputs.  Where a float32 full step is small the trial costs equal
# the current one to float32 round-off and the line search takes another
# step size than float64 does (the alpha ties of the verify notes): the
# example stops short by up to ~3e-3 in u, so the float32 tail's share
# (TAIL_SHARE) is not held here (a CPU rehearsal: 0.68% of the entries
# off by more than 1e-3).  What is held is the objective: float32's line
# search compares two costs it evaluates with an error of at most E (the
# largest |J32(u32) - J64(u32)| of the solve, over the batch), so its
# decisions can leave it at most 2 E above the float64 solve's objective.
# Held: each example's objective of its float32 controls, evaluated in
# float64, exceeds the float64 solve's by at most F32_DECISIONS E (a CPU
# rehearsal: at most 0.58 E); E itself below F32_EVAL_TOL of max |J|, an
# ulp a term of the sum over T (rehearsal: 4.4e-7, its largest step);
# and the mean |du| in the tail (TAIL_MEAN).
F32_DECISIONS = 2.0
F32_EVAL_TOL = T * 2.0 ** -23
# the O(log T) scan against the sequential recursion in float64: the
# same solve by another association of the same products
PSCAN_F64_TOL = 1e-9
# the long imitation configuration in float64, differentiated through
# the eager fixed point with 'auto' (the scan) against False; B keeps
# phase 1 (~105,000 operations at any B, a CPU count) near 1-2 s.  The
# sequential masked solve adds PSCAN_REG = 1e-11 to the free control
# block (as the JAX package's does; its scan does not).  The scan is held
# at PSCAN_GRAD_EXACT_TOL against the sequential solve without it
# (3.6e-16 in a CPU rehearsal, 2.9e-16 on an H100).  Against the
# sequential solve with it, the first-order change is a relative one of
# reg / Quu in each free control pivot, Quu >= the cost's control block
# (the value functions are PSD), so it is held at PSCAN_REG_ROOM reg /
# lambda_min(C_uu) (= 1e-8 here: 9.99e-10 measured on an H100, 1e-9 from
# the first-order estimate).
PSCAN_GRAD_B = 256
PSCAN_GRAD_EXACT_TOL, PSCAN_REG, PSCAN_REG_ROOM = 1e-12, 1e-11, 10.0


# ---------------------------------------------------------------------------
# The dense kernels' phase account
# ---------------------------------------------------------------------------

# [phases-dense]'s rows: the dense forward at the medium row (24s4c), the
# 5-state box row (each B=2048), TVLQR (B=128), the wide rows 4s12c and
# 2s16c (B=2048), the model-step build's rows config 3 and the cartpole
# at T=200 (B=512) and the headline under slew 0.5 (B=4096), and the MLP
# build's rows mlp-deep, mlp-slew and mlp-multictrl (B=2048); the dense
# backward at the medium imitation row (20s4c) and at 4s12c (B=1024), on
# the operands the other phases build for them
PHASE_ROWS = ('24s4c', '5s1c', 'tvlqr', 'wide-4s12c', 'wide-2s16c',
              'config 3', f'cartpole T={SOA_LONG_T}', 'slew 0.5',
              'mlp-deep', 'mlp-slew', 'mlp-multictrl',
              'backward 20s4c', 'backward 4s12c')


def phase_row_operands(torch, device, label, n=None):
    """A PHASE_ROWS row's operands: the forward's keyword operands, or the
    backward's (operands, keyword arguments); ``n`` cuts the batch (the
    build specs read n=1 on the CPU)."""
    if label == '24s4c':
        return dense_operands(torch, device, 'medium', 24, 4, n or 2048)
    if label == '5s1c':
        return dense_operands(torch, device, 'box', 5, 1, n or 2048)
    if label == 'tvlqr':
        return dense_operands(torch, device, 'tvlqr', 3, 4, n or TVLQR_B)
    if label.startswith('wide-'):
        return wide_operands(torch, device, label, n=n)
    if any(label == r[0] for r in SOA_ROWS):
        return soa_operands(torch, device, label, n=n)[0]
    if label.startswith('mlp-'):
        return mlp_operands(torch, device, label, n=n)
    if label == 'backward 20s4c':
        return bwd_dense_operands(torch, device, 'medium', 20, 4,
                                  n or TRAIN_DENSE_B)
    return wide_bwd_operands(torch, device, n=n)


def phases_build_specs():
    """The clocked builds (MPC_PHASE_CLOCKS = 1) of the PHASE_ROWS rows."""
    import torch
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    specs = []
    for label in PHASE_ROWS:
        if label.startswith('backward'):
            ns, nc = (20, 4) if label.endswith('20s4c') else (4, 12)
            s = ('fused_kkt_bwd_dense', dict(fbd.bwd_dense_kernel_defines(
                ns, nc, True, False), MPC_PHASE_CLOCKS=1))
        else:
            # the forward's operands on the CPU (the backward's would
            # solve them first), the layout at the row's batch
            n = next((r[3] for r in SOA_ROWS if r[0] == label), None)
            defines = dense_defines(phase_row_operands(
                torch, torch.device('cpu'), label, n=1), n)[0]
            s = ('fused_ilqr_dense', dict(defines, MPC_PHASE_CLOCKS=1))
        if s not in specs:
            specs.append(s)
    return specs


def phase_phases_dense(torch, device, rows=PHASE_ROWS):
    """The phase account of both dense kernels at the PHASE_ROWS rows:
    each row's clocked build (utils/phase_account.py) launched once after
    a warm-up, every phase's share of the warps' cycles and its mean
    cycles a warp; the backward's gradient pass and chunk-order sums
    apart by CUDA events.  The clocked outputs are set beside the op's
    build's (the same arithmetic; logged, not held); a forward row's
    iterations (stats row 2: the launch lasts as long as its slowest warp)
    and, in the MLP build, its Jacobian chunk beside.  Returns the
    accounts by row."""
    from mpc_tpu_torch.ops import fused_bwd_dense as fbd
    from mpc_tpu_torch.ops import fused_dense as fd
    from mpc_tpu_torch.utils import phase_account as pa
    accounts = {}
    for label in rows:
        ops = phase_row_operands(torch, device, label)
        if label.startswith('backward'):
            o, kw = ops
            pa.clocked_backward(o, kw)
            outs, clocks, part_ms = pa.clocked_backward(o, kw)
            ref = fbd.fused_kkt_backward_dense(**o, **kw)
            n = o['x_star'].shape[1]
        else:
            pa.clocked_forward(ops)
            *outs, clocks = pa.clocked_forward(ops)
            ref, part_ms = fd.fused_ilqr_dense(**ops), {}
            n = ops['x0'].shape[0]
        torch.cuda.synchronize()
        same = all(a is None or b is None or torch.equal(a, b)
                   for a, b in zip(outs, ref))
        shares = pa.phase_shares(clocks)
        total = sum(v[1] for v in shares.values())
        extra = ''
        if not label.startswith('backward'):
            it = outs[2][2].double()
            extra = (f'; n_iter mean {float(it.mean()):.2f}, max '
                     f'{float(it.max()):.0f}')
            if ops.get('model') is not None and fd.dense_model(
                    ops['model'])[0] == 'mlp':
                extra += f'; chunk {dense_defines(ops)[1]["chunk"]}'
        log(f'[phases-dense] {label}, B={n}: {total:.0f} cycles a warp; '
            + pa.format_shares(shares)
            + ''.join(f'; {k} {v:.4f} ms' for k, v in part_ms.items())
            + extra
            + f'; outputs bitwise the op\'s build: {same}; {card_line()}')
        accounts[label] = dict(cycles_a_warp=total, **{
            k: round(v[0], 4) for k, v in shares.items()}, **{
            f'{k}_ms': v for k, v in part_ms.items()})
    return accounts


def phases_dense_main(*rows):
    """``python3 chip_smoke.py --phases-dense [ROW ...]``: [phases-dense]
    alone (its builds, then the account), at the PHASE_ROWS rows named
    (all by default)."""
    import torch
    from mpc_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card is visible', file=sys.stderr)
        return 2
    from mpc_tpu_torch.ops import fused_dense as fd
    t0 = time.perf_counter()
    clocked = phases_build_specs()
    # the ops' builds of the same rows, and the forward the backward rows
    # solve first, all at once
    plain = [(name, {k: v for k, v in d.items() if k != 'MPC_PHASE_CLOCKS'})
             for name, d in clocked]
    plain.append(('fused_ilqr_dense', fd.dense_kernel_defines(20, 4, True,
                                                              False)))
    _build.build(clocked + [s for s in plain if s not in clocked])
    log(f'[build] the clocked builds and the ops\' builds of their rows '
        f'({time.perf_counter() - t0:.1f} s)')
    phase_phases_dense(torch, torch.device('cuda'), rows or PHASE_ROWS)
    log(card_line())
    return 0


# ---------------------------------------------------------------------------
# K3's MLP configuration's phase account
# ---------------------------------------------------------------------------

# [phases-nn]'s rows, each at bench_nn_dynamics' sizes (B=2048, T=20,
# H=100): the QuadCost build ([time-nn]'s row), the pseudo-Huber cost
# build (HUBER_ROWS' 'MLP') and the mask build (UZ_ROWS' 'MLP')
NN_PHASE_ROWS = ('bench', 'cost', 'mask')


def nn_phase_operands(torch, device, label, n=None):
    """An NN_PHASE_ROWS row's K3 operands (``n`` cuts the batch)."""
    if label == 'cost':
        return huber_operands(torch, device, 'MLP', n=n)[0]
    if label == 'mask':
        return uz_operands(torch, device, 'MLP', n=n)[0]
    return nn_k3_operands(torch, device, n or NN_B)


def nn_defines(ops, clocks=False):
    """(nvcc defines, launch geometry) of K3's build for the operands
    ``ops`` (an MLP's, or the team kernel's) at their batch: those that
    ``custom.k3_run`` launches with."""
    from mpc_tpu_torch.ops import custom, fused
    return custom.k3_build(*fused.k3_args(**ops), clocks=clocks)


def nn_residency(torch, ops):
    """Registers, spills, blocks an SM (by registers and by shared memory)
    and waves of K3's build for the MLP operands ``ops``."""
    from mpc_tpu_torch.ops import fused_dense as fd
    defines, geo = nn_defines(ops)
    des = design('fused_ilqr_long', defines, geo)
    by_regs = fd.blocks_by_registers(des['registers'], geo['warps'])
    by_smem = fd.blocks_an_sm(geo['smem_bytes'], geo['warps'])
    return (f'registers {des["registers"]}, spill stores '
            f'{des["spill_store_bytes"]} bytes; {geo["warps"]} warps, '
            f'{geo["examples"]} examples a block, {geo["smem_bytes"]} bytes '
            f'of shared memory a block; blocks an SM {by_regs} by registers, '
            f'{by_smem} by shared memory; {geo["blocks"]} blocks, '
            f'{fd.waves(geo["blocks"], min(by_regs, by_smem))} wave(s)')


def clocked_regs(ops):
    """Registers and spill stores of K3's clocked build for ``ops``."""
    defines, geo = nn_defines(ops, clocks=True)
    des = design('fused_ilqr_long', defines, geo)
    return (f'registers {des["registers"]}, spill stores '
            f'{des["spill_store_bytes"]} bytes')


def phase_phases_nn(torch, device, rows=NN_PHASE_ROWS):
    """The phase account of K3's MLP configuration at the NN_PHASE_ROWS
    rows: each row's clocked build (utils/phase_account.clocked_k3)
    launched once after a warm-up, every phase's share of the warps'
    cycles and its mean cycles a warp, the row's iterations and trials
    (stats rows 2 and 5), its build's registers, spills, blocks an SM and
    waves; the clocked outputs set beside the op's build's (logged, not
    held).  Returns the accounts by row."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.utils import phase_account as pa
    accounts = {}
    for label in rows:
        ops = nn_phase_operands(torch, device, label)
        pa.clocked_k3(ops)
        *outs, clocks = pa.clocked_k3(ops)
        ref = fused.fused_ilqr_long(**ops)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
        ms, _ = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                         per_graph=4)
        shares = pa.phase_shares(clocks, fused.K3_PHASES)
        total = sum(v[1] for v in shares.values())
        st = outs[2].double()
        log(f'[phases-nn] {label}, B={ops["x0"].shape[0]}: the op\'s build '
            f'{ms:.4f} ms (from a CUDA graph); {total:.0f} '
            f'cycles a warp; ' + pa.format_shares(shares)
            + f'; n_iter mean {float(st[2].mean()):.2f}, max '
            f'{float(st[2].max()):.0f}; selected index + 1 a solve '
            f'{float(st[5].mean()):.2f}; {nn_residency(torch, ops)}; '
            f'the clocked build: {clocked_regs(ops)}; '
            f'outputs bitwise the op\'s build: {same}; {card_line()}')
        accounts[label] = dict(ms=ms, cycles_a_warp=total, **{
            k: round(v[0], 4) for k, v in shares.items()})
    return accounts


def phases_nn_build_specs():
    """The NN_PHASE_ROWS rows' builds, clocked and not."""
    import torch
    specs = []
    for label in NN_PHASE_ROWS:
        ops = nn_phase_operands(torch, torch.device('cpu'), label, n=1)
        for clocks in (True, False):
            s = ('fused_ilqr_long', nn_defines(ops, clocks)[0])
            if s not in specs:
                specs.append(s)
    return specs


def phases_nn_main(*rows):
    """``python3 chip_smoke.py --phases-nn [ROW ...]``: [phases-nn] alone
    (its builds, then the account), at the NN_PHASE_ROWS rows named (all
    by default)."""
    import torch
    from mpc_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card is visible', file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(phases_nn_build_specs())
    log(f'[build] the clocked builds and the ops\' builds of their rows '
        f'({time.perf_counter() - t0:.1f} s)')
    phase_phases_nn(torch, torch.device('cuda'), rows or NN_PHASE_ROWS)
    log(card_line())
    return 0


# ---------------------------------------------------------------------------
# K3's team kernel's phase account
# ---------------------------------------------------------------------------

# [phases-k3]'s rows: the damped pendulum at T=196 (K3_T_RESIDENT, the
# LinDx build's horizon) and at T=200 (SOA_ROWS' row; the pendulum's own
# horizon is fused.k3_t_resident's, 202 for its 8 lanes), the simple
# pendulum at T=200 in the QuadCost build and in the pseudo-Huber cost
# build (HUBER_ROWS' 'pendulum T=200' and its QuadCost twin) and the long
# LinDx system at T=160 (LONG), each at its own batch
K3_PHASE_ROWS = ('damped T=196', f'damped T={SOA_LONG_T}',
                 f'pendulum T={SOA_LONG_T}', f'cost pendulum T={SOA_LONG_T}',
                 'long LinDx')


def k3_phase_operands(torch, device, label, n=None):
    """A K3_PHASE_ROWS row's K3 operands (``n`` cuts the batch)."""
    import dataclasses
    from mpc_tpu_torch.ops import fused
    if label == 'long LinDx':
        return long_k3_operands(torch, device, n or LONG_B)
    if label.startswith(('pendulum', 'cost pendulum')):
        return huber_operands(torch, device, f'pendulum T={SOA_LONG_T}', n=n,
                              quad=label.startswith('pendulum'))[0]
    cfg, x0, cost, dx, bk, _ = soa_problem(torch, device,
                                           f'damped T={SOA_LONG_T}', n=n)
    cfg = dataclasses.replace(cfg, T=int(label.split('T=')[1]))
    return fused.k3_operands(cfg, x0, cost, dx, **bk)


def k3_kernel_registers(defines):
    """Each kernel of a K3 library's ptxas report: (its mangled name,
    registers, spill store bytes)."""
    import re
    from mpc_tpu_torch.ops import _build
    regs, spills, entry, props = {}, {}, None, None
    for line in _build.ptxas_report('fused_ilqr_long', defines).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            props = m.group(1)
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and props is not None:
            spills[props] = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
    return [(k, v, spills.get(k)) for k, v in regs.items()]


def phase_phases_k3(torch, device, rows=K3_PHASE_ROWS):
    """The phase account of K3's team kernel at the K3_PHASE_ROWS rows:
    each row's clocked build (utils/phase_account.clocked_k3, the same
    layout as the op's build) launched once after a warm-up, every
    phase's share of the examples' cycles and its mean cycles an example
    (a team's lane 0 counts them), the row's iterations and trials (stats
    rows 2 and 5), the op's build's time from a CUDA graph, its geometry
    and each kernel's registers and spills in its library and in the
    clocked one; the clocked outputs set beside the op's build's (logged,
    not held).  Returns the accounts by row."""
    from mpc_tpu_torch.ops import fused
    from mpc_tpu_torch.utils import phase_account as pa
    accounts = {}
    for label in rows:
        ops = k3_phase_operands(torch, device, label)
        pa.clocked_k3(ops)
        *outs, clocks = pa.clocked_k3(ops)
        ref = fused.fused_ilqr_long(**ops)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
        ms, _ = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops), reps=3,
                         per_graph=4)
        shares = pa.phase_shares(clocks, fused.K3_PHASES)
        total = sum(v[1] for v in shares.values())
        slowest = float(clocks.sum(1).max())
        st = outs[2].double()
        defines, geo = nn_defines(ops)
        cdefines, _ = nn_defines(ops, clocks=True)
        T_ = ops['u0'].shape[0]
        log(f'[phases-k3] {label}, B={ops["x0"].shape[0]}, T={T_}: the op\'s '
            f'build {ms:.4f} ms (from a CUDA graph); {total:.0f} cycles an '
            f'example (the slowest {slowest:.0f}), {total / T_:.0f} a step; '
            + pa.format_shares(shares)
            + f'; n_iter mean {float(st[2].mean()):.2f}, max '
            f'{float(st[2].max()):.0f}; selected index + 1 a solve '
            f'{float(st[5].mean()):.2f}; geometry {geo}; kernels '
            f'(registers, spill stores) {k3_kernel_registers(defines)}, '
            f'clocked {k3_kernel_registers(cdefines)}; outputs bitwise the '
            f'op\'s build: {same}; {card_line()}')
        accounts[label] = dict(ms=ms, cycles_an_example=total, **{
            k: round(v[0], 4) for k, v in shares.items()})
    return accounts


def phases_k3_build_specs():
    """The K3_PHASE_ROWS rows' builds, clocked and not."""
    import torch
    specs = []
    for label in K3_PHASE_ROWS:
        ops = k3_phase_operands(torch, torch.device('cpu'), label, n=1)
        for clocks in (True, False):
            s = ('fused_ilqr_long', nn_defines(ops, clocks)[0])
            if s not in specs:
                specs.append(s)
    return specs


def phases_k3_main(*rows):
    """``python3 chip_smoke.py --phases-k3 [ROW ...]``: [phases-k3] alone
    (its builds, then the account), at the K3_PHASE_ROWS rows named (all
    by default)."""
    import torch
    from mpc_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card is visible', file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(phases_k3_build_specs())
    log(f'[build] the clocked builds and the ops\' builds of their rows '
        f'({time.perf_counter() - t0:.1f} s)')
    phase_phases_k3(torch, torch.device('cuda'), rows or K3_PHASE_ROWS)
    log(card_line())
    return 0


def count_ops(torch, fn):
    """(result, the number of PyTorch operators ``fn()`` dispatches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def host_ms(torch, device, fn):
    """Host-to-host ms of ``fn()`` ending in a synchronise, and its
    result."""
    sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, device)
    return 1e3 * (time.perf_counter() - t0), out


def swingup_host_loop(torch, device, x, cost, dx, steps, lqr_iter=10,
                      eps=0.0, record=None):
    """The [swingup] host loop: an MPC a step, warm-started from the last
    solve shifted left with a zero tail; with ``record`` a list [k], the
    state and warm start of step k are appended to it."""
    import mpc_tpu_torch as mt
    u_init = None
    xs, us = [x], []
    for i in range(steps):
        if record is not None and i == record[0]:
            record.append((x, torch.zeros(T, x.shape[0], 1, device=device)
                           if u_init is None else u_init))
        ctrl = mt.MPC(3, 1, T, u_lower=-2., u_upper=2., lqr_iter=lqr_iter,
                      n_batch=x.shape[0], u_init=u_init,
                      grad_method=mt.GradMethods.AUTO_DIFF, eps=eps,
                      exit_unconverged=False, detach_unconverged=False,
                      backprop=False, linesearch_decay=0.2,
                      max_linesearch_iter=5, device=device)
        _, u, _ = ctrl(x, cost, dx)
        x = dx(x, u[0])
        u_init = torch.cat([u[1:], torch.zeros_like(u[:1])], 0)
        xs.append(x)
        us.append(u[0])
    return torch.stack(xs), torch.stack(us)


def timed_plain(torch, plain, times):
    """``plain`` that appends the device ms of each call to ``times``."""
    def run(**ops):
        out = []
        times.append(event_ms(torch, lambda: out.append(plain(**ops))))
        return out[0]
    return run


def phase_closed_loop(torch, device):
    """make_closed_loop at bench_closed_loop's sizes: us per environment
    step against the [swingup] host loop on the same steps in the same
    process, K1 launches one a step, the loop bitwise equal to the host
    loop; K1 against its plain version on a step's operands at B=4096 and
    its time there; the swing-up at B=4096 through make_closed_loop."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    steps = CLOSED_LOOP_STEPS
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **HEADLINE)
    dx, cost = problem(torch, device)
    log(f'[closed-loop] make_closed_loop, {steps} steps, T={T}, '
        f'lqr_iter={cfg.lqr_iter}, eps=0, box +-2, 5 step sizes; '
        f'{card_line()}')
    rows, launches = [], None
    for n in CLOSED_LOOP_BS:
        x0 = x0_batch(n, 0, torch, device)
        roll = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                                   device=device)
        roll(x0, 2)
        fused.reset_launch_counts()
        loop_ms, out = host_ms(torch, device, lambda: roll(x0, steps))
        k1 = fused.launch_counts['fused_ilqr']
        if device.type == 'cuda' and (
                k1 != steps or fused.launch_counts['fused_ilqr_long']):
            raise AssertionError(f'closed loop B={n}: {k1} K1 launches for '
                                 f'{steps} steps')
        loop_ms = min(loop_ms, host_ms(torch, device,
                                       lambda: roll(x0, steps))[0])
        swingup_host_loop(torch, device, x0, cost, dx, 2)
        host = [host_ms(torch, device, lambda: swingup_host_loop(
            torch, device, x0, cost, dx, steps)) for _ in range(2)]
        xs, us = host[-1][1]
        same_bits(f'B={n}: closed loop vs host loop, xs and us', torch,
                  [(out['xs'], xs), (out['us'], us)])
        loop_us = 1e3 * loop_ms / steps
        host_us = 1e3 * min(h[0] for h in host) / steps
        n_ops = count_ops(torch, lambda: roll(x0, 10))[1] / 10
        log(f'  B={n}: {loop_us:.1f} us a step (make_closed_loop), host '
            f'loop {host_us:.1f} us a step; host / closed '
            f'{host_us / loop_us:.2f}; K1 launches {k1}; PyTorch operators '
            f'a step {n_ops:.1f}')
        rows.append({'B': n, 'closed_loop_us_per_step': loop_us,
                     'host_loop_us_per_step': host_us,
                     'operators_a_step': n_ops})
        if n == B:
            launches = k1
    # K1 on a step's operands at the headline's width
    rec = [CLOSED_LOOP_HELD_STEP]
    swingup_host_loop(torch, device, x0_batch(B, 0, torch, device), cost, dx,
                      CLOSED_LOOP_HELD_STEP + 1, record=rec)
    x, u_init = rec[1]
    dx64, cost64 = problem(torch, device, torch.float64)
    kw = dict(u_lower=-2.0, u_upper=2.0)
    ops = fused.k1_operands(cfg, x, cost, dx, u_init=u_init, **kw)
    ops64 = fused.k1_operands(cfg, x.double(), cost64, dx64,
                              u_init=u_init.double(), **kw)
    plain_times = []
    log(f'[closed-loop] K1 vs its plain version on step '
        f'{CLOSED_LOOP_HELD_STEP}\'s operands, B={B}')
    (_, _, sk), mx = hold_k1(torch, 'K1 vs plain, closed loop', ops, ops64,
                             plain=timed_plain(torch, fused.fused_solve_plain,
                                               plain_times))
    ms, eager_ms = graph_ms(torch, lambda: fused.fused_ilqr(**ops))
    flops = fused.k1_flops(T, 3, 1, float(sk[2].double().sum()),
                           float(sk[5].double().sum()), batch=B)
    bound_ms, by = bound(flops, fused.k1_bytes(ops))
    log(f'  K1 {ms:.4f} ms from a CUDA graph ({eager_ms:.4f} a call from '
        f'Python), plain {plain_times[0]:.2f} ms, bound {bound_ms:.5f} ms '
        f'by {by}')
    # the swing-up of [swingup] through make_closed_loop
    sw_cfg = mt.MPCConfig(**dict(HEADLINE, lqr_iter=50, eps=1e-2,
                                 grad_method=mt.GradMethods.AUTO_DIFF))
    roll = mt.make_closed_loop(sw_cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                               device=device)
    fused.reset_launch_counts()
    sw_ms, out = host_ms(torch, device, lambda: roll(
        x0_batch(B, 0, torch, device), steps))
    share = float((out['xs'][-1][:, 0] > 0.9).double().mean())
    log(f'  swing-up through make_closed_loop, B={B}, {steps} steps: '
        f'{sw_ms:.1f} ms, K1 launches {fused.launch_counts["fused_ilqr"]}, '
        f'share within 0.1 of cos th = 1: {share:.4f} (threshold '
        f'{SWINGUP_MIN_SHARE})')
    if not (torch.isfinite(out['xs']).all() and share >= SWINGUP_MIN_SHARE
            and fused.launch_counts['fused_ilqr'] == steps * (
                device.type == 'cuda')):
        raise AssertionError('the closed-loop swing-up did not reach its '
                             'success share')
    return dict(launches=launches, max_abs_err=mx, ms=ms,
                plain_ms=plain_times[0], bound_ms=bound_ms, bound_by=by,
                rows=rows)


def slew_data(torch, device, n, dtype=None, seed=31):
    """The slew configuration's data, made with numpy: x0 [n, 2], the
    shared C [3, 3] and c [3] (the target position 1), the shared F
    [T-1, 2, 3], prev_ctrl [n, 1]."""
    import numpy as np
    import mpc_tpu_torch as mt
    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)
    Tn = SLEW['T']
    F = np.broadcast_to(np.array([[1., SLEW_DT, 0.], [0., 1., SLEW_DT]]),
                        (Tn - 1, 2, 3))
    c = np.array([-1., 0., 0.])
    x0 = 0.5 * rng.randn(n, 2)
    pc = rng.uniform(-1, 1, (n, 1))
    t = [torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
         for a in (x0, np.diag([1., 0.1, 0.01]), c, F, pc)]
    return t[0], mt.QuadCost(t[1], t[2]), mt.LinDx(t[3], None), t[4]


def slew_augmented(torch, cfg, device, x0, cost, dyn, prev):
    """The slew configuration's augmented problem on ``device``, written
    out from its definition: state (u_{t-1}, p, v), cost C + slew (u_t -
    u_{t-1})^2 / 2 on (u_{t-1}, p, v, u_t), next state (u_t, F (p, v,
    u_t)), x0 (prev, p0, v0)."""
    import mpc_tpu_torch as mt
    s = cfg.slew_rate_penalty
    C = torch.zeros(4, 4, dtype=cost.C.dtype)
    C[1:, 1:] = cost.C.cpu()
    C[0, 0] += s
    C[3, 3] += s
    C[0, 3] -= s
    C[3, 0] -= s
    c = torch.cat([torch.zeros(1, dtype=cost.c.dtype), cost.c.cpu()])
    F = dyn.F.cpu()
    Fa = torch.zeros(F.shape[0], 3, 4, dtype=F.dtype)
    Fa[:, 0, 3] = 1.0
    Fa[:, 1:, 1:] = F
    acfg = mt.MPCConfig(**dict(SLEW, n_state=3, slew_rate_penalty=None))
    return (acfg, torch.cat([prev, x0], -1).to(device),
            mt.QuadCost(C.to(device), c.to(device)),
            mt.LinDx(Fa.to(device), None))


def phase_slew_k3(torch, device, n_requests=4):
    """A slew penalty on the double integrator through K3: K3 against its
    plain version on the augmented problem (and both against float64),
    requests through batched_solve (one K3 launch each; the last held
    against the plain K3 on its own augmented operands), K3's time there,
    and gradients to c, F and prev_ctrl (K3, then the eager fixed point)
    against the float64 eager fixed point on the same primal."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    from mpc_tpu_torch.ops import fused
    n, Tn = SLEW_B, SLEW['T']
    cfg = mt.MPCConfig(**SLEW)
    log(f'[slew-k3] the double integrator under slew 0.5 (LinDx, 3 '
        f'augmented states), T={Tn}, B={n}, lqr_iter=4; {card_line()}')
    kw = dict(u_lower=-2.0, u_upper=2.0)
    ops, ops64 = (fused.k3_operands(*fused.slew_problem(
        cfg, *slew_data(torch, device, n, dtype)), **kw)
        for dtype in (torch.float32, torch.float64))
    plain_times = []
    (_, _, sk), mx = hold_k1(
        torch, 'K3 vs plain, slew-augmented', ops, ops64,
        kernel=fused.fused_ilqr_long,
        plain=timed_plain(torch, fused.fused_solve_long_plain, plain_times),
        limits=(LONG_TAIL_MEAN, LONG_TAIL_SHARE))
    ms, eager_ms = graph_ms(torch, lambda: fused.fused_ilqr_long(**ops),
                            reps=5, per_graph=4)
    flops = fused.k3_flops(Tn, 3, 1, float(sk[2].double().sum()),
                           float(sk[5].double().sum()), batch=n, lindx=True,
                           has_f=False)
    bound_ms, by = bound(flops, fused.k3_bytes(ops))
    log(f'  K3 {ms:.4f} ms from a CUDA graph ({eager_ms:.4f} a call from '
        f'Python), plain {plain_times[0]:.2f} ms, bound {bound_ms:.5f} ms '
        f'by {by}')
    # requests through batched_solve: one K3 launch each, no eager solve
    reqs = [slew_data(torch, 'cpu', n, seed=40 + i) for i in range(
        n_requests + 1)]

    def request(r):
        x0, cost, dyn, pc = r
        sol = mt.batched_solve(cfg, x0.to(device), cost, dyn,
                               prev_ctrl=pc.to(device), device=device, **kw)
        return sol.u.cpu(), sol

    request(reqs[0])
    fused.reset_launch_counts()
    solver.reset_eager_counts()
    lat = []
    for r in reqs[1:]:
        t, (u, sol) = host_ms(torch, device, lambda: request(r))
        lat.append(t)
    launches = fused.launch_counts['fused_ilqr_long']
    log(f'  {n_requests} requests: ' + ' '.join(f'{v:.3f}' for v in lat)
        + f' ms host to host; K3 launches {launches}, eager solves '
        f'{solver.eager_counts["eager_solve"]}')
    if launches != n_requests * (device.type == 'cuda') or \
            solver.eager_counts['eager_solve'] or \
            fused.launch_counts['fused_ilqr']:
        raise AssertionError('slew requests did not each launch K3 once')
    if not (torch.isfinite(u).all() and u.abs().max() <= 2.0
            and sol.x.shape == (Tn, n, 2)):
        raise AssertionError('slew requests: not a feasible solve')
    # the last request against the plain K3 on its own augmented problem,
    # written out here from the slew's definition (not fused.slew_problem)
    ops_r = fused.k3_operands(*slew_augmented(torch, cfg, device, *reqs[-1]),
                              **kw)
    xp, up, _ = fused.fused_solve_long_plain(**ops_r)
    check_tail('last request vs plain K3 on its augmented operands, u', u,
               up.cpu(), (LONG_TAIL_MEAN, LONG_TAIL_SHARE))
    check_tail('last request vs plain K3 on its augmented operands, x '
               '(u_{-1} stripped)', sol.x, xp[..., 1:],
               (LONG_TAIL_MEAN, LONG_TAIL_SHARE))
    # gradients: K3 phase 1, eager fixed point, against the float64 eager
    # fixed point on the same primal
    x0, cost, dyn, pc = slew_data(torch, device, n)
    w = torch.randn(Tn, n, 1, generator=torch.Generator().manual_seed(3)).to(
        device)

    def grads(dtype, primal=None):
        leaves = [a.to(dtype).clone().requires_grad_()
                  for a in (cost.c, dyn.F, pc)]
        gcfg = mt.MPCConfig(**dict(SLEW, backprop=True))
        args = (x0.to(dtype), mt.QuadCost(cost.C.to(dtype), leaves[0]),
                mt.LinDx(leaves[1], None))
        if primal is None:
            sol = mt.batched_solve(gcfg, *args, prev_ctrl=leaves[2],
                                   device=device, **kw)
            x, u = sol.x, sol.u
        else:
            x, u = solver.fixed_point_phase(
                gcfg, *args, *(a.to(dtype) for a in primal[:2]), -2.0, 2.0,
                primal[2], leaves[2])
        ((u * w.to(dtype)).sum() + 0.5 * (x ** 2).sum()).backward()
        return [a.grad for a in leaves], (x.detach(), u.detach(),
                                          torch.ones(n, dtype=torch.bool,
                                                     device=device))

    fused.reset_launch_counts()
    solver.reset_eager_counts()
    g32, primal = grads(torch.float32)
    if fused.launch_counts['fused_ilqr_long'] != (device.type == 'cuda') \
            or solver.eager_counts['eager_fixed_point'] != 1:
        raise AssertionError('the slew gradient did not run K3 and the '
                             'eager fixed point')
    g64, _ = grads(torch.float64, primal)
    errs = {name: rel_err(a, b) for name, a, b in
            zip(('c', 'F', 'prev_ctrl'), g32, g64)}
    log('  gradients (K3 + eager fixed point, float32) vs the float64 eager '
        'fixed point, same primal, max |d| / max |g64|: '
        + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    if not all(torch.isfinite(g).all() for g in g32) or \
            max(errs.values()) > BWD_TOL:
        raise AssertionError(f'slew gradients outside {BWD_TOL}')
    return dict(launches=launches, max_abs_err=mx, ms=ms,
                plain_ms=plain_times[0], bound_ms=bound_ms, bound_by=by,
                request_ms=sorted(lat)[len(lat) // 2], grad_err=errs)


def traced_slew_loop(torch, cfg, x, cost, dx, steps):
    """The closed-loop protocol of make_closed_loop on the eager route,
    written out here as a second copy, each solve's decisions traced and
    padded to lqr_iter entries so that two runs' traces line up step by
    step.  Returns a Solution-like with the visited states [steps + 1, B,
    3] as xs, the applied controls [steps, B, 1] as u, the summed costs
    and each step's inputs (x, u_init, prev_ctrl), Solution and trace;
    and the padded trace."""
    from types import SimpleNamespace
    from mpc_tpu_torch import solver
    B_ = x.shape[0]
    u_warm = torch.zeros(cfg.T, B_, 1, dtype=x.dtype, device=x.device)
    prev = torch.zeros(B_, 1, dtype=x.dtype, device=x.device)
    xs, us, costs, trace, solves = [x], [], [], [], []
    for _ in range(steps):
        tr = []
        sol = solver.eager_batched_solve(cfg, x, cost, dx, u_init=u_warm,
                                         u_lower=-2.0, u_upper=2.0,
                                         prev_ctrl=prev, trace=tr)
        solves.append(((x, u_warm, prev), sol, tr))
        idle = {k: torch.zeros_like(v) for k, v in tr[0].items()}
        trace += tr + [idle] * (cfg.lqr_iter - len(tr))
        u0 = sol.u[0]
        x = dx(x, u0)
        prev = u0
        u_warm = torch.cat([sol.u[1:], torch.zeros_like(sol.u[:1])])
        xs.append(x)
        us.append(u0)
        costs.append(sol.costs)
    return SimpleNamespace(xs=torch.stack(xs), u=torch.stack(us),
                           costs=torch.stack(costs).sum(0),
                           solves=solves), trace


def hold_closed_loop_ties(torch, what, sa, ta, sb, tb):
    """Hold two float64 eager closed loops of one problem (their applied
    controls and padded traces, ``traced_slew_loop``) as SLEW_TIE_STEP's
    comment says; returns the never-parted examples' error."""
    ta, tb = ([{k: v.cpu() for k, v in d.items()} for d in t]
              for t in (ta, tb))
    parted = parted_examples(torch, ta, tb)
    step = torch.zeros(parted.shape, dtype=torch.float64)
    for e in torch.nonzero(parted).flatten().tolist():
        for a, b in zip(ta, tb):
            if any(a[k][e].item() != b[k][e].item()
                   for k in ('active', 'alpha', 'n_qp')):
                step[e] = max(a['full_du'][e].item(), b['full_du'][e].item())
                break
    real = parted & (step >= SLEW_TIE_STEP)
    ua, ub = sa.u.detach().double().cpu(), sb.u.detach().double().cpu()
    scale = ub.abs().max()
    err = float((ua[:, ~parted] - ub[:, ~parted]).abs().max() / scale) \
        if (~parted).any() else 0.0
    tied = float((ua - ub).abs().max() / scale)
    ties, reals = step[parted & ~real], step[real]
    log(f'  {what}: {int(parted.sum())} of {parted.numel()} examples part '
        f'at a line-search decision; full step at the first parting: '
        f'largest below {SLEW_TIE_STEP} (a tie) '
        f'{float(ties.max()) if ties.numel() else 0.0:.3e}, smallest at or '
        f'above it (a real parting) '
        + (f'{float(reals.min()):.3e}, {int(real.sum())} examples'
           if reals.numel() else 'none')
        + f'; never parted: max |du| / max |u| {err:.3e}; all: {tied:.3e}')
    for line in first_parting(torch, ta, tb, real if real.any() else parted):
        log(f'    {line}')
    if not (err < EAGER_F64_TOL and tied < SLEW_CTRL_TOL
            and float(real.double().mean()) < PARTED_SHARE):
        raise AssertionError(f'{what}: the loops differ beyond their ties')
    return err


def slew_objective(torch, cfg, cost, dx, x_init, u, prev):
    """The slew-penalised objective of controls u [T, B, 1] from x_init
    [B, 3] after prev [B, 1], in the dtype of ``cost`` and ``dx``: the
    rollout, then sum_t 1/2 tau' C tau + c' tau + 1/2 slew (u_t -
    u_{t-1})^2 (the reference's mpc/mpc.py:362-372)."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    dt = cost.C.dtype
    x_init, u, prev = x_init.to(dt), u.to(dt), prev.to(dt)
    x = solver.rollout(dx, x_init, u)
    blk = solver.slew_block(cfg.slew_rate_penalty, cfg.n_state, cfg.n_ctrl,
                            dt, x.device)
    C, c = solver.augment_cost(cost.C, cost.c, blk, cfg.n_ctrl)
    xa = torch.cat([torch.cat([prev.unsqueeze(0), u[:-1]]), x], -1)
    return solver.trajectory_cost(mt.QuadCost(C, c), xa, u)


def hold_f32_solves(torch, cfg, cost64, dx64, solves):
    """Each float32 solve of a float32 closed loop (``traced_slew_loop``'s
    ``solves``) against a float64 solve on the same inputs, held as
    F32_DECISIONS's comment says; returns max |du|."""
    from mpc_tpu_torch import solver
    d32, d64, ratios, evals = [], [], [], []
    for (x, u_init, prev), s32, _ in solves:
        s64 = solver.eager_batched_solve(
            cfg, x.double(), cost64, dx64, u_init=u_init.double(),
            u_lower=-2.0, u_upper=2.0, prev_ctrl=prev.double())
        j32 = slew_objective(torch, cfg, cost64, dx64, x, s32.u, prev)
        E = (s32.costs.double() - j32).abs().max()
        gap = j32 - s64.costs
        ratios.append(float(gap.max() / E))
        evals.append(float(E / s64.costs.abs().max()))
        d32.append(s32.u.double())
        d64.append(s64.u)
    du = (torch.stack(d32) - torch.stack(d64)).abs()     # [steps, T, B, 1]
    mean = float(du.mean())
    parted = du.amax((1, 3)) > TAIL_ENTRY                # [steps, B]
    log(f'  each float32 solve of the loop vs float64 on its inputs: mean '
        f'|du| {mean:.3e} (held < {TAIL_MEAN}), share |du|>{TAIL_ENTRY} '
        f'{float((du > TAIL_ENTRY).double().mean()):.5f} (shown), max '
        f'{float(du.max()):.3e}; {int(parted.sum())} of {parted.numel()} '
        f'solves of an example part by more than {TAIL_ENTRY}')
    log(f'  objective of the float32 controls (in float64) above the float64 '
        f'solve\'s, over float32\'s largest error on its own objective E: '
        f'largest {max(ratios):.3f} (held <= {F32_DECISIONS}); E / max |J| '
        f'largest {max(evals):.3e} (held < {F32_EVAL_TOL:.3e})')
    if not (mean < TAIL_MEAN and max(ratios) <= F32_DECISIONS
            and max(evals) < F32_EVAL_TOL):
        raise AssertionError('slew eager: float32 off float64 beyond its '
                             'resolution')
    return float(du.max())


def phase_slew_eager(torch, device, records, n=SLEW_EAGER_B,
                     steps=SLEW_EAGER_STEPS):
    """The pendulum under slew 0.5 in a closed loop on the eager route.
    make_closed_loop runs in float32 (timed) and in float64 on the card,
    and each run is held bitwise against ``traced_slew_loop``, this
    script's own copy of the loop's protocol, on the same device and
    inputs.  Through that tie: the card's float64 loop against the CPU's
    (``hold_closed_loop_ties``), and each float32 solve of the float32
    loop against a float64 solve on the same inputs (``hold_f32_solves``).
    The float32 loop against the float64 loop is shown, not held: over
    the steps the float32 line search's ties at round-off move the
    states, and the next solves start elsewhere (on an NVIDIA H100 80GB
    HBM3 at 700 W: 0.547% of the applied controls off by more than 1e-3,
    mean 5.3e-5; a CPU rehearsal 0.27%)."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.ops import fused
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **SLEW_EAGER)
    log(f'[slew-eager] the pendulum under slew 0.5, closed loop of {steps} '
        f'steps on the eager route, B={n}, T={T}, lqr_iter={cfg.lqr_iter}')
    dx, cost = problem(torch, device)
    dx64, cost64 = problem(torch, device, torch.float64)
    x0 = x0_batch(n, 7, torch, device)
    if fused.scope_gap(cfg, cost, dx) is not None:
        raise AssertionError('the kernels do not take the slew-augmented '
                             'pendulum: this phase would not be pinned')
    kw = dict(u_lower=-2.0, u_upper=2.0, device=device)
    roll = mt.make_closed_loop(cfg, cost, dx, **kw)
    (ms, out), n_eager = eager_counted(torch, lambda: host_ms(
        torch, device, lambda: roll(x0, steps)))
    if n_eager != steps:
        raise AssertionError(f'{n_eager} eager solves for {steps} steps')
    out64, n64 = eager_counted(torch, lambda: mt.make_closed_loop(
        cfg, cost64, dx64, **kw)(x0.double(), steps))
    if n64 != steps:
        raise AssertionError(f'{n64} eager solves for {steps} float64 steps')
    l32, _ = traced_slew_loop(torch, cfg, x0, cost, dx, steps)
    same_bits('make_closed_loop float32 vs the traced loop, xs and us',
              torch, [(out['xs'], l32.xs), (out['us'], l32.u)])
    runs = []
    for dev in (device, torch.device('cpu')):
        d64, c64 = problem(torch, dev, torch.float64)
        runs += traced_slew_loop(torch, cfg, x0.double().to(dev), c64,
                                 d64, steps)
    same_bits('make_closed_loop float64 vs the traced loop, xs and us',
              torch, [(out64['xs'], runs[0].xs), (out64['us'], runs[0].u)])
    e64 = hold_closed_loop_ties(torch, 'card f64 vs CPU f64, applied '
                                'controls', *runs)
    check_tail('closed loop f32 vs f64, applied controls (not held)',
               out['us'], out64['us'], None)
    err = hold_f32_solves(torch, cfg, cost64, dx64, l32.solves)
    log(f'  {ms:.1f} ms for {steps} steps ({ms / steps:.1f} ms a step, '
        f'{n_eager} eager solves), {card_line()}')
    eager_record(records, 'slew-eager', f'pendulum, slew 0.5, closed loop '
                 f'of {steps} steps, B={n}, T={T}, float32', n_eager, err,
                 f'float64 on the card, each step on the same inputs; '
                 f'card f64 vs CPU f64 {e64:.2e}',
                 f'mean|du|<{TAIL_MEAN}; objective within {F32_DECISIONS} '
                 'E (F32_DECISIONS)',
                 ms / steps)


def unregularised_masked_solve(on):
    """A context in which the eager solver's masked control solve
    (``linalg.masked_free_matrix``) adds no PSCAN_REG to the control
    block: the exact arm of PSCAN_GRAD_B's comment."""
    import contextlib
    from mpc_tpu_torch.ops import linalg

    @contextlib.contextmanager
    def patched():
        orig = linalg.masked_free_matrix
        linalg.masked_free_matrix = (
            lambda H, free, clamped_diag=1.0, reg=0.0: orig(H, free,
                                                            clamped_diag, 0.0))
        try:
            yield
        finally:
            linalg.masked_free_matrix = orig
    return patched() if on else contextlib.nullcontext()


def phase_pscan(torch, device, records, seq):
    """bench_long_horizon's two arms (benchmarks/configs.py:596-644): the
    pendulum at T=512, B=16, unconstrained, use_fused='never', with the
    O(log T) scan against [eager-long]'s sequential solves in the same
    process; then the long imitation configuration in float64
    differentiated through the eager fixed point with 'auto' (the scan)
    against False."""
    import dataclasses
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import solver
    s32, s64, seq_ms, (x0, cost, dx), (x64, cost64, dx64) = seq
    n, T_ = LONG_EAGER_B, LONG_EAGER['T']
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                       **dict(LONG_EAGER, parallel_riccati=True))
    log(f'[pscan] the pendulum at T={T_}, B={n}, unconstrained, both arms '
        '(the sequential arm from [eager-long])')
    (runs, par_ms), n_eager = eager_counted(torch, lambda: timed(
        torch, device, lambda: mt.batched_solve(cfg, x0, cost, dx,
                                                device=device), 1))
    p32 = runs[-1]
    p64 = mt.batched_solve(cfg, x64, cost64, dx64, device=device)
    e64 = rel_err(p64.u, s64.u)
    log(f'  f64: parallel vs sequential max |du| / max |u| {e64:.3e} '
        f'(tolerance {PSCAN_F64_TOL})')
    if not e64 < PSCAN_F64_TOL:
        raise AssertionError('the scan is off the sequential solve in f64')
    e32 = check_tail('f32: parallel vs sequential', p32.u, s32.u)
    check_tail('f32 parallel vs f64 (not held)', p32.u, s64.u, None)
    check_tail('f32 sequential vs f64 (not held)', s32.u, s64.u, None)
    # operator counts of one iteration of each arm (the host's work)
    one = dict(LONG_EAGER, lqr_iter=1)
    counts = {arm: count_ops(torch, lambda: mt.batched_solve(
        mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF,
                     **dict(one, parallel_riccati=arm)), x0, cost, dx,
        device=device))[1] for arm in (False, True)}
    log(f'  {card_line()}: a solve {seq_ms:.1f} ms sequential, {par_ms:.1f} '
        f'ms parallel ({n_eager} eager solve); sequential / parallel '
        f'{seq_ms / par_ms:.2f}; operators of one iteration: sequential '
        f'{counts[False]}, parallel {counts[True]}')
    eager_record(records, 'pscan', f'pendulum, T={T_}, B={n}, float32, '
                 'parallel_riccati=True', n_eager, e32, 'the sequential arm '
                 f'([eager-long]); f64 parallel vs sequential {e64:.2e}',
                 f'mean|du|<{TAIL_MEAN}, share(|du|>{TAIL_ENTRY})'
                 f'<{TAIL_SHARE}; f64 {PSCAN_F64_TOL}', par_ms)
    records[-1]['sequential_ms'] = seq_ms
    # the long imitation configuration, float64, differentiated with the
    # scan and without it on the same phase 1
    m = PSCAN_GRAD_B
    gcfg, x0l, costl, dyn, u_exp = long_problem(
        torch, device, m, torch.float64, use_fused='never')
    p1_ms, sol = host_ms(torch, device, lambda: solver.eager_batched_solve(
        gcfg, x0l, costl, dyn, u_lower=-2.0, u_upper=2.0))
    grads, bwd_ms = {}, {}
    for arm in ('auto', False, 'exact'):
        c = costl.c.clone().requires_grad_()
        acfg = dataclasses.replace(gcfg, parallel_riccati=arm == 'auto')

        def backward():
            _, u = solver.fixed_point_phase(
                acfg, x0l, mt.QuadCost(costl.C, c), dyn, sol.x, sol.u, -2.0,
                2.0, sol.converged)
            ((u - u_exp) ** 2).mean().backward()
        with unregularised_masked_solve(arm == 'exact'):
            bwd_ms[arm], _ = host_ms(torch, device, backward)
        grads[arm] = c.grad
    g_err = rel_err(grads['auto'], grads[False])
    g_exact = rel_err(grads['auto'], grads['exact'])
    cuu = costl.C[..., gcfg.n_state:, gcfg.n_state:]
    reg_tol = PSCAN_REG_ROOM * PSCAN_REG / float(
        torch.linalg.eigvalsh(cuu).min())
    log(f'  long imitation configuration, float64, T={LONG_T}, B={m}: phase 1 '
        f'{p1_ms:.1f} ms (eager), the fixed point and its backward '
        f'{bwd_ms["auto"]:.1f} ms with the scan, {bwd_ms[False]:.1f} ms '
        f'without; dL/dc scan vs sequential without its {PSCAN_REG} '
        f'{g_exact:.3e} (tolerance {PSCAN_GRAD_EXACT_TOL}), vs sequential '
        f'{g_err:.3e} (tolerance {PSCAN_REG_ROOM} reg / min eig C_uu = '
        f'{reg_tol:.3e})')
    if not (torch.isfinite(grads['auto']).all() and g_err < reg_tol
            and g_exact < PSCAN_GRAD_EXACT_TOL):
        raise AssertionError('the scan\'s gradients are off the sequential '
                             'ones')


def analytic_pendulum(torch, device, wrong=False):
    """The simple pendulum in float64 with a ``grad_input`` from its
    hand-written step Jacobian (``step_jacobian``, the Jacobian K1
    computes); with ``wrong``, that Jacobian taken at one fixed state
    whatever x."""
    from mpc_tpu_torch.models import PendulumDx
    fixed = x0_batch(1, 0, torch, device).double()

    class Pendulum(PendulumDx):
        def grad_input(self, x, u):
            F = self.step_jacobian(fixed.expand(x.shape) if wrong else x, u)
            return F[..., :3], F[..., 3:]

    return Pendulum(device=device, dtype=torch.float64)


def phase_verbose(torch, device, n=64):
    """MPC(verbose=1) on the card prints the initial mean cost and one
    table row an iteration (the eager route, which records them);
    ANALYTIC_CHECK passes on the pendulum's hand-written Jacobian and
    raises on a wrong one, in float64 (its tolerance, 1e-8, is below
    float32's round-off: the float32 Jacobians of the two forms of the
    step differ by ~3e-7)."""
    import contextlib
    import io
    import mpc_tpu_torch as mt
    dx, cost = problem(torch, device)
    x0 = x0_batch(n, 0, torch, device)
    kw = dict(u_lower=-2., u_upper=2., eps=0.0, exit_unconverged=False,
              detach_unconverged=False, backprop=False, device=device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sol = mt.MPC(3, 1, T, lqr_iter=3, verbose=1,
                     grad_method=mt.GradMethods.AUTO_DIFF, **kw).solve(
            x0, cost, dx)
    lines = buf.getvalue().splitlines()
    log(f'[verbose] MPC(verbose=1), B={n}, T={T}, lqr_iter=3, on the card:')
    for line in lines:
        log(f'  {line}')
    if not (lines and lines[0].startswith('Initial mean(cost): ')
            and any('||full_du||_max' in line for line in lines)
            and sum(line.startswith('| ') and line[2].isdigit()
                    for line in lines) == int(sol.n_iter.max())
            and sol.iter_stats.shape == (n, 3, 4)):
        raise AssertionError('verbose did not print its table')
    ctrl = mt.MPC(3, 1, T, lqr_iter=3,
                  grad_method=mt.GradMethods.ANALYTIC_CHECK, **kw)
    cost64 = mt.QuadCost(cost.C.double(), cost.c.double())
    _, u, _ = ctrl(x0.double(), cost64, analytic_pendulum(torch, device))
    try:
        ctrl(x0.double(), cost64, analytic_pendulum(torch, device,
                                                    wrong=True))
    except AssertionError as e:
        log(f'  ANALYTIC_CHECK: the hand-written Jacobian passes; a wrong '
            f'one raises: {e}')
    else:
        raise AssertionError('ANALYTIC_CHECK passed a wrong Jacobian')
    if not torch.isfinite(u).all():
        raise AssertionError('ANALYTIC_CHECK: the solve after the check '
                             'failed')


# ---------------------------------------------------------------------------
# scale-out and artifacts: the kernels as torch.library ops, exported
# programs, the sharded paths, checkpoints
# ---------------------------------------------------------------------------

# what a serving process must not load: the solver's modules
SOLVER_MODULES = ('mpc_tpu_torch.solver', 'mpc_tpu_torch.learning',
                  'mpc_tpu_torch.mpc', 'mpc_tpu_torch.closed_loop',
                  'mpc_tpu_torch.ops.lqr', 'mpc_tpu_torch.ops.pnqp',
                  'mpc_tpu_torch.ops.diff', 'mpc_tpu_torch.ops.pscan',
                  'mpc_tpu_torch.utils.export')
EXPORT_REQUESTS = 4
FLEX_BATCHES = (1, 1000, B)
LOOP_B, LOOP_STEPS = 256, 10          # bench_closed_loop's B=256
SHARDS, SHARD_STEPS, CKPT_STEPS = 4, 3, 5
WORKER_TIMEOUT_S = 300
# [train-sharded] and [pod]: the sharded step's loss is the mean of
# equal shards' means and its gradient the mean of the shards' (K2 sums
# a shard's examples where the unsharded step sums all of them), so both
# are the unsharded ones up to float32's rounding of those sums: a CPU
# rehearsal of config 4 at B=1024 measured the first step's gradients
# 1.8e-7 apart on entries of 0.02-0.3 (~1e-6 relative, a few ulps of a
# sum of 1024 terms) and its loss 0 apart.  Each step then solves at
# parameters that differ by that much, and the solve's line search and
# active set pass such a difference on unevenly: after 3 Adam steps the
# parameters (of size 0.01-7) sat 9.1e-7 apart.  Held at 1e-5 relative
# on the loss and 1e-5 absolute on the parameters (~10x the rehearsal,
# ~100 float32 ulps of a parameter of size 1).
SHARD_LOSS_RTOL = 1e-5
SHARD_THETA_ATOL = 1e-5


def all_counts():
    from mpc_tpu_torch.ops import fused, fused_bwd
    return dict(fused.launch_counts, **fused_bwd.launch_counts)


def reset_all_counts():
    from mpc_tpu_torch.ops import fused, fused_bwd
    fused.reset_launch_counts()
    fused_bwd.reset_launch_counts()


def counted(device, record, phase, expect, fn):
    """Run ``fn`` with every launch count set to 0 before it and read
    after it, record the launches under ``phase`` and, on the card, hold
    them to ``expect`` ({kernel: launches}; every other kernel none)."""
    reset_all_counts()
    out = fn()
    got = all_counts()
    for name, n in got.items():
        if n:
            record.setdefault(name, {})[phase] = \
                record.get(name, {}).get(phase, 0) + n
    if device.type == 'cuda' and got != dict(
            {k: 0 for k in got}, **expect):
        raise AssertionError(f'[{phase}] launches {got}, expected {expect}')
    return out


def same_outputs(what, got, want):
    """Raise unless each tensor of ``got`` has the bits of ``want``'s."""
    import torch
    for a, b in zip(got, want, strict=True):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f'{what}: not bitwise equal')


def host_to_host(torch, device, fn, req):
    """ms of one request, from the host's tensors to the host's answer."""
    t0 = time.perf_counter()
    out = fn(*(a.to(device) for a in req))
    out = [a.cpu() for a in out]
    return (time.perf_counter() - t0) * 1e3, out


def median(v):
    return sorted(v)[len(v) // 2]


def run_workers(torch, argvs, envs=None):
    """Run this script in worker mode, one process per argument list, all
    at once; each gets WORKER_TIMEOUT_S and is killed at it.  Returns
    each worker's last line, parsed as JSON."""
    return join_workers(start_workers(argvs, envs))


def start_workers(argvs, envs=None):
    """Start this script in worker mode, one process per argument list,
    all at once, for ``join_workers``; the time limit runs from here."""
    procs = []
    for i, argv in enumerate(argvs):
        env = dict(os.environ, **(envs[i] if envs else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv], cwd=HERE,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return argvs, procs, time.monotonic() + WORKER_TIMEOUT_S


def join_workers(started):
    """Wait for the workers of ``start_workers``; each is killed at
    WORKER_TIMEOUT_S from its start.  Returns each worker's last line,
    parsed as JSON."""
    argvs, procs, deadline = started
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f'a worker {argvs} did not finish in '
                                     f'{WORKER_TIMEOUT_S} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f'worker failed ({p.returncode}):\n'
                                 f'{out[-4000:]}')
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def plain_case(torch, device, section, label, dtype):
    """The operands and the plain version of a row of [compare-dense] past
    8 controls ('wide'), [compare-soa], [compare-huber], [compare-uz] or
    [compare-mlp] in ``dtype``."""
    from mpc_tpu_torch.ops import fused_dense as fd
    if section in ('wide', 'mlp'):
        return ((wide_operands if section == 'wide' else mlp_operands)(
            torch, device, label, dtype), fd.fused_solve_dense_plain)
    ops, _, plain = {'soa': soa_operands, 'huber': huber_operands,
                     'uz': uz_operands}[section](torch, device, label, dtype)
    return ops, plain


def ops_digest(ops):
    """A digest of a kernel's operands, by key: each tensor's bytes, a
    model's attributes (its weights among them) taken apart the same way,
    every other value's repr."""
    import hashlib
    h = hashlib.sha256()

    def put(v, depth=0):
        if hasattr(v, 'detach'):
            h.update(str((v.dtype, tuple(v.shape))).encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(v, (list, tuple)):
            for x in v:
                put(x, depth + 1)
        elif hasattr(v, 'state_dict'):
            h.update(type(v).__name__.encode())
            put([t for _, t in sorted(v.state_dict().items())], depth + 1)
        elif hasattr(v, '__dict__') and depth < 4:
            h.update(type(v).__name__.encode())
            for k in sorted(vars(v)):
                h.update(k.encode())
                put(vars(v)[k], depth + 1)
        else:
            h.update(repr(v).encode())
    for k in sorted(ops):
        h.update(k.encode())
        put(ops[k])
    return h.hexdigest()[:16]


def plain_worker(device, section, runs):
    """Plain runs of a compare phase's rows (``plain_case``) in a process
    of its own: the plain versions are host-bound (a small kernel an
    operation), so a phase spreads its rows' float32 and float64 runs
    over a few such processes, side by side, while it launches its
    kernels.  ``runs`` is a JSON list of [label, dtype, path]: each run's
    outputs are saved to its path.  Prints a JSON line: each run's device
    ms and the digest of its operands."""
    import torch
    device = torch.device(device)
    out = []
    for label, dtype, path in json.loads(runs):
        ops, plain = plain_case(torch, device, section, label,
                                getattr(torch, dtype))
        times = []
        res = timed_plain(torch, plain, times)(**ops)
        torch.save([a.cpu() for a in res], path)
        out.append({'plain_ms': times[0], 'ops': ops_digest(ops)})
    print(json.dumps(out))


def start_plain(device, section, labels, procs):
    """Start ``plain_worker`` for each row of ``labels`` in float32 and
    in float64, the runs dealt round-robin to ``procs`` processes, all at
    once; ``plain_runs`` collects them."""
    root = os.path.join(HERE, 'build', 'chip_smoke', 'plain')
    os.makedirs(root, exist_ok=True)
    keys = [(label, dt) for label in labels
            for dt in ('float32', 'float64')]
    paths = [os.path.join(root, f'{section}-{i}.pt') for i in range(len(keys))]
    deal = [list(range(i, len(keys), procs))
            for i in range(min(procs, len(keys)))]
    return section, keys, paths, deal, start_workers(
        [['--plain-worker', device.type, section,
          json.dumps([[*keys[i], paths[i]] for i in d])] for d in deal])


def plain_runs(torch, device, pending):
    """Wait for ``start_plain``'s workers.  Returns, by row, each dtype's
    (outputs on ``device``, the run's device ms), after holding that each
    worker ran on the operands this process makes for the row."""
    section, keys, paths, deal, started = pending
    outs = [None] * len(keys)
    for d, res in zip(deal, join_workers(started)):
        for i, r in zip(d, res):
            outs[i] = r
    runs = {}
    for (label, dt), path, out in zip(keys, paths, outs):
        ops, _ = plain_case(torch, device, section, label,
                            getattr(torch, dt))
        if ops_digest(ops) != out['ops']:
            raise AssertionError(f'{section} {label} ({dt}): the plain '
                                 'worker ran on other operands')
        runs.setdefault(label, {})[dt] = (
            [a.to(device) for a in torch.load(path)], out['plain_ms'])
    return runs


def preloaded(torch, runs, times=None):
    """A plain version that answers from a row's ``plain_runs``: the
    float32 or the float64 run, by the dtype of the operands it is
    called with; the float32 run's device ms appended to ``times``."""
    def run(**ops):
        dt = 'float64' if ops['x0'].dtype == torch.float64 else 'float32'
        out, ms = runs[dt]
        if times is not None and dt == 'float32':
            times.append(ms)
        return tuple(out)
    return run


def serve_worker(device, art, req, out):
    """A serving process: torch and the ops, nothing of the solver; loads
    the artifact, answers the requests, reports the K1 launches and the
    solver modules it loaded."""
    import torch
    import mpc_tpu_torch.ops.custom  # noqa: F401  (the kernels' ops)
    from mpc_tpu_torch.ops import fused
    fn = torch.export.load(art).module()
    data = torch.load(req)
    C = data['C'].to(device)
    fused.reset_launch_counts()
    answers = []
    for x0, c in data['reqs']:
        answers.append([a.cpu() for a in fn(x0.to(device), C,
                                             c.to(device))])
    launches = fused.launch_counts['fused_ilqr']
    torch.save(answers, out)
    print(json.dumps({'launches': launches,
                      'solver_modules': [m for m in SOLVER_MODULES
                                         if m in sys.modules]}))


def phase_export_serve(torch, device, record, tmp, n=B):
    """The headline exported on the card, answered by a fresh process
    that imports torch and mpc_tpu_torch.ops.custom only: the answers
    bitwise the live batched_solve's, one K1 launch a request, the graph
    one k1_solve node; then exported against live host to host in one
    process.  Returns the ms of both."""
    import numpy as np
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import export as ex
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    data = counted(device, record, 'export-serve', {}, lambda: ex.export_solve(
        cfg, dx, cost, x0_batch(n, 200, torch, device), u_lower=-2.0,
        u_upper=2.0, device=device))
    nodes = ex.kernel_nodes(data)
    log(f'[export-serve] the headline exported on the card: '
        f'{len(data)} bytes, kernel nodes {nodes}; {card_line()}')
    if nodes != {'k1_solve': 1}:
        raise AssertionError(f'the artifact holds {nodes}, not one K1')
    rng = np.random.RandomState(7)
    reqs = [(x0_batch(n, 300 + i, torch, 'cpu'),
             cost.c.cpu() + torch.tensor(0.1 * rng.randn(4),
                                         dtype=torch.float32))
            for i in range(EXPORT_REQUESTS)]
    art, req, out = (os.path.join(tmp, f) for f in
                     ('headline.pt2', 'requests.pt', 'answers.pt'))
    with open(art, 'wb') as fh:
        fh.write(data)
    torch.save({'reqs': reqs, 'C': cost.C.cpu()}, req)
    t0 = time.perf_counter()
    (res,) = run_workers(torch, [['--serve-worker', str(device), art, req,
                                  out]])
    log(f'  a fresh process ({time.perf_counter() - t0:.1f} s) loaded it '
        f'and answered {len(reqs)} requests: K1 launches {res["launches"]}, '
        f'solver modules loaded there {res["solver_modules"]}')
    if res['solver_modules'] or (device.type == 'cuda'
                                 and res['launches'] != len(reqs)):
        raise AssertionError('the serving process loaded the solver or did '
                             'not launch K1 once a request')
    record.setdefault('fused_ilqr', {})['export-serve (fresh process)'] = \
        res['launches']
    answers = torch.load(out)

    def live(x0, c):
        sol = mt.batched_solve(cfg, x0, mt.QuadCost(cost.C, c), dx,
                               u_lower=-2.0, u_upper=2.0, device=device)
        return sol.x, sol.u, sol.costs

    for (x0, c), got in zip(reqs, answers):
        same_outputs('[export-serve] the fresh process against live', got,
                     live(x0.to(device), c.to(device)))
    fn = ex.load_fn(data)
    runs = {'live': live, 'exported': lambda x0, c: fn(x0, cost.C, c)}
    for f in runs.values():
        host_to_host(torch, device, f, reqs[0])
    times = {k: [] for k in runs}
    for i, req_i in enumerate(reqs * 2):
        outs = {}
        for what in list(runs) if i % 2 == 0 else list(runs)[::-1]:
            ms_i, outs[what] = counted(
                device, record, 'export-serve', {'fused_ilqr': 1},
                lambda: host_to_host(torch, device, runs[what], req_i))
            times[what].append(ms_i)
        same_outputs('[export-serve] in-process artifact against live',
                     outs['exported'], outs['live'])
    ms = {k: median(v) for k, v in times.items()}
    log(f'  host to host, one process, {len(times["live"])} requests each '
        f'in turns: live median {ms["live"]:.3f} ms '
        f'({" ".join(f"{v:.3f}" for v in times["live"])}), exported '
        f'{ms["exported"]:.3f} ms '
        f'({" ".join(f"{v:.3f}" for v in times["exported"])}); bitwise; '
        f'{card_line()}')
    return ms


def phase_export_flex(torch, device, record):
    """One artifact padded to max_batch=4096 at b = 1, 1000 and 4096: one
    k1_solve node, one launch a call, the first b rows bitwise the live
    solve at b."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import export as ex
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    x0 = x0_batch(B, 201, torch, device)
    data = ex.export_solve(cfg, dx, cost, x0, u_lower=-2.0, u_upper=2.0,
                           polymorphic_batch=True, max_batch=B,
                           device=device)
    nodes = ex.kernel_nodes(data)
    fn = ex.load_fn(data)
    for b in FLEX_BATCHES:
        got = counted(device, record, 'export-flex', {'fused_ilqr': 1},
                      lambda: fn(x0[:b], cost.C, cost.c))
        sol = mt.batched_solve(cfg, x0[:b], cost, dx, u_lower=-2.0,
                               u_upper=2.0, device=device)
        if got[1].shape != (T, b, 1):
            raise AssertionError(f'[export-flex] b={b}: shape '
                                 f'{tuple(got[1].shape)}')
        same_outputs(f'[export-flex] b={b}', got, (sol.x, sol.u, sol.costs))
    log(f'[export-flex] max_batch={B}, kernel nodes {nodes}: b = '
        f'{", ".join(map(str, FLEX_BATCHES))} bitwise the live solve at b, '
        'one K1 launch a call')
    if nodes != {'k1_solve': 1}:
        raise AssertionError('[export-flex] the padded artifact lost K1')


def phase_export_host(torch, device, record):
    """An artifact traced on CPU tensors for the card: the route is the
    card's, move_to_device_pass moves it, and it runs K1 there, bitwise
    the live card solve."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.models import PendulumDx
    from mpc_tpu_torch.utils import export as ex
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    x0 = x0_batch(B, 202, torch, device)
    cpu = torch.device('cpu')
    data = ex.export_solve(cfg, PendulumDx(device=cpu),
                           mt.QuadCost(cost.C.cpu(), cost.c.cpu()), x0.cpu(),
                           u_lower=-2.0, u_upper=2.0, device=device)
    fn = ex.load_fn(data)
    got = counted(device, record, 'export-host', {'fused_ilqr': 1},
                  lambda: fn(x0, cost.C, cost.c))
    sol = mt.batched_solve(cfg, x0, cost, dx, u_lower=-2.0, u_upper=2.0,
                           device=device)
    same_outputs('[export-host]', got, (sol.x, sol.u, sol.costs))
    log(f'[export-host] traced on CPU tensors, moved to {device} by '
        f'move_to_device_pass, kernel nodes {ex.kernel_nodes(data)}: one K1 '
        'launch, bitwise the live card solve')


def phase_export_long(torch, device, record):
    """The long configuration's request (T=160, B=4096, shared LinDx F,
    box +-2, lqr_iter=4) exported: one k3_solve node, bitwise live."""
    import dataclasses
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import export as ex
    cfg, x0, cost, dyn, _ = long_problem(torch, device)
    cfg = dataclasses.replace(cfg, backprop=False)
    data = ex.export_solve(cfg, dyn, cost, x0, u_lower=-2.0, u_upper=2.0,
                           device=device)
    nodes = ex.kernel_nodes(data)
    got = counted(device, record, 'export-long', {'fused_ilqr_long': 1},
                  lambda: ex.load_fn(data)(x0, cost.C, cost.c, dyn.F))
    sol = mt.batched_solve(cfg, x0, cost, dyn, u_lower=-2.0, u_upper=2.0,
                           device=device)
    same_outputs('[export-long]', got, (sol.x, sol.u, sol.costs))
    log(f'[export-long] T={LONG_T}, B={x0.shape[0]}, runtime inputs '
        f'(x_init, C, c, F), kernel nodes {nodes}: one K3 launch, bitwise '
        'live')
    if nodes != {'k3_solve': 1}:
        raise AssertionError('[export-long] the artifact does not hold K3')


def exp_saving_input(torch):
    """torch.exp whose backward recomputes exp(q) from its saved input q.
    torch.export cannot trace torch.autograd.grad through an operation
    whose backward reads its saved output (exp, sigmoid, tanh: autograd
    unpacks a copy of the output that the tracer does not know, and the
    export refuses it as a fake constant; ROADMAP section 3), so config
    4's learned cost diag(exp(q_log)) is written with this in its
    gradient program.  exp(q) recomputed is the saved output's bits, so
    the gradient is the live one's."""
    class Exp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q):
            ctx.save_for_backward(q)
            return torch.exp(q)

        @staticmethod
        def backward(ctx, g):
            (q,) = ctx.saved_tensors
            return g * torch.exp(q)
    return Exp.apply


def phase_export_grad(torch, device, record):
    """Gradient programs, torch.autograd.grad through the solve, exported:
    config 4's loss and gradients to (q_log, p) through K1 and K2, and the
    long configuration's dL/dc through K3 and K4; each bitwise the live
    gradient, one launch of each kernel a call."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import export as ex
    dx, _ = problem(torch, device)
    theta, make_cost = config4_theta(torch, device)
    x0, u_exp = config4_data(1024, torch, device)
    cfg = mt.MPCConfig(**TRAIN)
    exp = exp_saving_input(torch)

    def grad4(q_log, p, exported=True):
        th = {'q_log': q_log.detach().requires_grad_(),
              'p': p.detach().requires_grad_()}
        cost_of = make_cost if not exported else (
            lambda t: mt.QuadCost(torch.diag(exp(t['q_log'])), t['p']))
        loss = mt.imitation_loss(th, cfg, x0, u_exp, cost_of,
                                 lambda _: dx, u_lower=-2.0, u_upper=2.0,
                                 device=device)
        return (loss.detach(),
                *torch.autograd.grad(loss, [th['q_log'], th['p']]))

    F, C, xl, ul = long_data(torch, device)
    dyn = mt.LinDx(F, None)
    cfg_long = mt.MPCConfig(**LONG)

    def grad_long(c):
        c = c.detach().requires_grad_()
        loss = mt.imitation_loss({'c': c}, cfg_long, xl, ul,
                                 lambda th: mt.QuadCost(C, th['c']),
                                 lambda _: dyn, u_lower=-2.0, u_upper=2.0,
                                 device=device)
        return loss.detach(), torch.autograd.grad(loss, c)[0]

    for what, fn, args, want in (
            ('config 4, B=1024', grad4,
             (theta['q_log'].detach(), theta['p'].detach()),
             {'fused_ilqr': 1, 'fused_kkt_bwd': 1}),
            (f'long, T={LONG_T}, B={LONG_B}, dL/dc', grad_long,
             (torch.zeros(LONG_T, 4, device=device),),
             {'fused_ilqr_long': 1, 'fused_kkt_bwd_long': 1})):
        try:
            data = ex.export_fn(fn, *args)
        except Exception as e:
            raise AssertionError(f'[export-grad] torch.export cannot carry '
                                 f'the {what} gradient program: {e!r}')
        got = counted(device, record, 'export-grad', want,
                      lambda: ex.load_fn(data)(*args))
        # the live gradient: config 4's own cost, torch.exp and all
        live = grad4(*args, exported=False) if fn is grad4 else fn(*args)
        same_outputs(f'[export-grad] {what}', got, live)
        log(f'[export-grad] {what}: kernel nodes {ex.kernel_nodes(data)}, '
            f'launches {want}; loss and gradients bitwise the live ones '
            f'(largest |gradient| {float(got[1].abs().max()):.4e})')


def phase_export_loop(torch, device, record):
    """export_closed_loop at bench_closed_loop's B=256, 10 steps: ten
    k1_solve nodes, ten launches a rollout, bitwise the live loop."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import export as ex
    cfg = mt.MPCConfig(grad_method=mt.GradMethods.AUTO_DIFF, **HEADLINE)
    dx, cost = problem(torch, device)
    x0 = x0_batch(LOOP_B, 0, torch, device)
    data = ex.export_closed_loop(cfg, cost, dx, x0, LOOP_STEPS,
                                 u_lower=-2.0, u_upper=2.0, device=device)
    nodes = ex.kernel_nodes(data)
    got = counted(device, record, 'export-loop',
                  {'fused_ilqr': LOOP_STEPS},
                  lambda: ex.load_fn(data)(x0))
    ref = mt.make_closed_loop(cfg, cost, dx, u_lower=-2.0, u_upper=2.0,
                              device=device)(x0, LOOP_STEPS)
    same_outputs('[export-loop]', [got[k] for k in ref], ref.values())
    log(f'[export-loop] B={LOOP_B}, {LOOP_STEPS} steps, kernel nodes '
        f'{nodes}: bitwise the live make_closed_loop')
    if nodes != {'k1_solve': LOOP_STEPS}:
        raise AssertionError('[export-loop] not one K1 a step')


def phase_sharded(torch, device, record, reps=10):
    """solve_sharded of the headline over four shards of 1024 on the one
    card, bitwise the unsharded solve; a mesh of one card against
    batched_solve, host to host in turns, and the four shards."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.parallel import make_mesh, solve_sharded
    cfg = mt.MPCConfig(**HEADLINE)
    dx, cost = problem(torch, device)
    x0 = x0_batch(B, 203, torch, device)
    kw = dict(u_lower=-2.0, u_upper=2.0)
    mesh4, mesh1 = make_mesh([device] * SHARDS), make_mesh([device])
    sol = counted(device, record, 'sharded', {'fused_ilqr': SHARDS},
                  lambda: solve_sharded(cfg, mesh4, x0, cost, dx, **kw))
    one = mt.batched_solve(cfg, x0, cost, dx, device=device, **kw)
    same_outputs('[sharded] four shards against the unsharded solve',
                 sol[:8], one[:8])
    runs = {'batched_solve': lambda x: mt.batched_solve(
                cfg, x, cost, dx, device=device, **kw),
            'mesh of 1': lambda x: solve_sharded(cfg, mesh1, x, cost, dx,
                                                 **kw),
            f'mesh of {SHARDS}': lambda x: solve_sharded(cfg, mesh4, x, cost,
                                                         dx, **kw)}
    req = (x0.cpu(),)
    times = {k: [] for k in runs}
    for i in range(reps):
        names = list(runs) if i % 2 == 0 else list(runs)[::-1]
        for name in names:
            times[name].append(host_to_host(
                torch, device, lambda x: (runs[name](x).u,), req)[0])
    ms = {k: median(v[1:]) for k, v in times.items()}
    log(f'[sharded] headline B={B} over {SHARDS} shards of {B // SHARDS} on '
        f'{mesh4[0]}: bitwise the unsharded solve, {SHARDS} K1 launches; '
        'host to host, median of ' + str(reps - 1) + ' in turns: '
        + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items())
        + f'; {card_line()}')
    return ms


class Config4Run:
    """Config 4 from theta's start under the step that ``make_step(
    optimizer, make_cost, dx)`` builds: ``steps(k)`` takes k steps and
    returns the losses, each step's ms in ``ms``."""

    def __init__(self, torch, device, make_step, n=1024):
        self.torch, self.device = torch, device
        dx, _ = problem(torch, device)
        self.theta, make_cost = config4_theta(torch, device)
        self.x0, self.u_exp = config4_data(n, torch, device)
        self.opt = torch.optim.Adam(self.theta.values(), lr=1e-2)
        self.step = make_step(self.opt, make_cost, dx)
        self.ms = []

    def steps(self, k):
        losses = []
        for _ in range(k):
            t0 = time.perf_counter()
            losses.append(float(self.step(self.theta, self.x0, self.u_exp)))
            sync(self.torch, self.device)
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return losses


def hold_shard_step(what, losses, theta, ref_losses, ref_theta):
    gap_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gap_theta = max(float((theta[k].detach().cpu()
                           - ref_theta[k].detach().cpu()).abs().max())
                    for k in theta)
    log(f'  {what}: loss relative gap {gap_loss:.3e} (bound '
        f'{SHARD_LOSS_RTOL}), parameters {gap_theta:.3e} (bound '
        f'{SHARD_THETA_ATOL:.1e})')
    if gap_loss > SHARD_LOSS_RTOL or gap_theta > SHARD_THETA_ATOL:
        raise AssertionError(f'{what}: outside float32\'s rounding of a mean '
                             'of means')


def train_step_of(torch, device, mesh=None):
    """A ``make_step`` for Config4Run: config 4's sharded step over
    ``mesh``, or the unsharded one."""
    import mpc_tpu_torch as mt
    cfg = mt.MPCConfig(**TRAIN)
    kw = dict(u_lower=-2.0, u_upper=2.0)

    def make_step(opt, make_cost, dx):
        if mesh is None:
            return mt.make_imitation_train_step(
                cfg, opt, make_cost, lambda _: dx, device=device, **kw)
        return mt.make_sharded_train_step(cfg, mesh, opt, make_cost,
                                          lambda _: dx, **kw)
    return make_step


def phase_train_sharded(torch, device, record, timed_steps=6):
    """Config 4, B=1024: make_sharded_train_step over four shards on the
    one card against make_imitation_train_step, SHARD_STEPS steps each
    from the same start; then both step on in turns for their times."""
    from mpc_tpu_torch.parallel import make_mesh
    mesh = make_mesh([device] * SHARDS)
    sharded = Config4Run(torch, device, train_step_of(torch, device, mesh))
    unsharded = Config4Run(torch, device, train_step_of(torch, device))
    ls = counted(device, record, 'train-sharded',
                 {'fused_ilqr': SHARDS * SHARD_STEPS,
                  'fused_kkt_bwd': SHARDS * SHARD_STEPS},
                 lambda: sharded.steps(SHARD_STEPS))
    lu = unsharded.steps(SHARD_STEPS)
    log(f'[train-sharded] config 4, B=1024 over {SHARDS} shards on '
        f'{mesh[0]}, {SHARD_STEPS} steps: losses {ls}, unsharded {lu}')
    hold_shard_step('against make_imitation_train_step', ls, sharded.theta,
                    lu, unsharded.theta)
    for i in range(timed_steps):
        for run in ((sharded, unsharded) if i % 2 == 0
                    else (unsharded, sharded)):
            run.steps(1)
    step_ms = {'sharded': median(sharded.ms[SHARD_STEPS:]),
               'unsharded': median(unsharded.ms[SHARD_STEPS:])}
    log(f'  step ms, median of {timed_steps} in turns: sharded '
        f'{step_ms["sharded"]:.3f}, unsharded {step_ms["unsharded"]:.3f}; '
        f'{card_line()}')
    return step_ms


def pod_worker(device, out):
    """A process of the [pod] group: config 4's sharded step over the
    processes, SHARD_STEPS steps on its half of B=1024."""
    import torch
    import torch.distributed as dist
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import parallel
    device = torch.device(device)
    parallel.initialize(timeout_s=WORKER_TIMEOUT_S)
    mesh = parallel.make_pod_mesh()
    dx, _ = problem(torch, device)
    theta, make_cost = config4_theta(torch, device)
    parallel.replicate(theta)
    x0, u_exp = config4_data(1024, torch, device)
    sl = parallel.pod_batch_spec(1024)
    step = mt.make_sharded_train_step(
        mt.MPCConfig(**TRAIN), mesh, torch.optim.Adam(theta.values(),
                                                     lr=1e-2),
        make_cost, lambda _: dx, u_lower=-2.0, u_upper=2.0)
    reset_all_counts()
    losses = [float(step(theta, x0[sl], u_exp[:, sl]))
              for _ in range(SHARD_STEPS)]
    torch.save({k: v.detach().cpu() for k, v in theta.items()}, out)
    print(json.dumps({'rank': dist.get_rank(),
                      'backend': dist.get_backend(),
                      'mesh': list(mesh.shape), 'losses': losses,
                      'launches': all_counts()}))
    dist.destroy_process_group()


def phase_pod(torch, device, record, tmp):
    """Two processes on the one card (gloo, initialize from the
    environment) run config 4's sharded step: both ranks end with the
    same parameters, bit for bit, within the [train-sharded] bound of the
    in-process two-shard step."""
    import socket
    from mpc_tpu_torch.parallel import make_mesh
    s = socket.socket()
    s.bind(('localhost', 0))
    port = str(s.getsockname()[1])
    s.close()
    outs = [os.path.join(tmp, f'pod{r}.pt') for r in range(2)]
    envs = [dict(MASTER_ADDR='localhost', MASTER_PORT=port, WORLD_SIZE='2',
                 RANK=str(r)) for r in range(2)]
    t0 = time.perf_counter()
    res = run_workers(torch, [['--pod-worker', str(device), o]
                              for o in outs], envs)
    wall = time.perf_counter() - t0
    thetas = [torch.load(o) for o in outs]
    same = all(torch.equal(thetas[0][k], thetas[1][k]) for k in thetas[0])
    log(f'[pod] 2 processes on one card, {res[0]["backend"]}, mesh '
        f'{res[0]["mesh"]}, {SHARD_STEPS} steps ({wall:.1f} s): losses '
        f'{res[0]["losses"]} / {res[1]["losses"]}, launches '
        f'{[r["launches"] for r in res]}, parameters bitwise equal across '
        f'the ranks: {same}')
    for r in res:
        for name, n in r['launches'].items():
            if n:
                record.setdefault(name, {})[f'pod rank {r["rank"]}'] = n
        if device.type == 'cuda' and (
                r['launches']['fused_ilqr'] != SHARD_STEPS
                or r['launches']['fused_kkt_bwd'] != SHARD_STEPS):
            raise AssertionError(f'[pod] rank {r["rank"]} launches '
                                 f'{r["launches"]}')
    if not same or res[0]['losses'] != res[1]['losses']:
        raise AssertionError('[pod] the ranks took different steps')
    two = Config4Run(torch, device, train_step_of(
        torch, device, make_mesh([device] * 2)))
    hold_shard_step('rank 0 against the in-process two-shard step',
                    res[0]['losses'], thetas[0], two.steps(SHARD_STEPS),
                    two.theta)


def resume_worker(device, ckpt, out):
    """[checkpoint]'s fresh process: load the state, CKPT_STEPS more
    steps of config 4."""
    import torch
    from mpc_tpu_torch.utils import load_checkpoint
    device = torch.device(device)
    state = load_checkpoint(ckpt, device=device)
    run = Config4Run(torch, device, train_step_of(torch, device))
    with torch.no_grad():
        for k, v in run.theta.items():
            v.copy_(state['theta'][k])
    run.opt.load_state_dict(state['opt_state'])
    reset_all_counts()
    run.steps(CKPT_STEPS)
    theta = run.theta
    torch.save({k: v.detach().cpu() for k, v in theta.items()}, out)
    print(json.dumps({'step': state['step'], 'launches': all_counts()}))


def phase_checkpoint(torch, device, record, tmp):
    """Config 4: CKPT_STEPS steps, save_checkpoint, load_checkpoint in a
    fresh process, CKPT_STEPS more: bitwise the 2 CKPT_STEPS
    uninterrupted steps."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.utils import save_checkpoint
    run = Config4Run(torch, device, train_step_of(torch, device))
    counted(device, record, 'checkpoint',
            {'fused_ilqr': CKPT_STEPS, 'fused_kkt_bwd': CKPT_STEPS},
            lambda: run.steps(CKPT_STEPS))
    ckpt, out = os.path.join(tmp, 'ckpt.pt'), os.path.join(tmp, 'resumed.pt')
    save_checkpoint(ckpt, mt.TrainState(
        {k: v.detach() for k, v in run.theta.items()}, run.opt.state_dict(),
        CKPT_STEPS))
    (res,) = run_workers(torch, [['--resume-worker', str(device), ckpt,
                                  out]])
    for name in ('fused_ilqr', 'fused_kkt_bwd'):
        record.setdefault(name, {})['checkpoint (fresh process)'] = \
            res['launches'][name]
    whole = Config4Run(torch, device, train_step_of(torch, device))
    whole.steps(2 * CKPT_STEPS)
    ref = whole.theta
    resumed = torch.load(out)
    same = all(torch.equal(resumed[k], ref[k].detach().cpu()) for k in ref)
    log(f'[checkpoint] config 4: {CKPT_STEPS} steps, saved, resumed in a '
        f'fresh process at step {res["step"]} ({res["launches"]}), '
        f'{CKPT_STEPS} more: bitwise the {2 * CKPT_STEPS} uninterrupted '
        f'steps: {same}')
    if not same or (device.type == 'cuda'
                    and res['launches']['fused_ilqr'] != CKPT_STEPS):
        raise AssertionError('[checkpoint] the resumed run differs')


def scale_entries(record, timings):
    """The kernels line's entries of the scale-out and artifact paths: per
    kernel its launches in each new phase (counts set to 0 before each,
    read after), its error against its plain version and its times at
    that shape from this run's earlier phases (the same kernel, the same
    operands' shapes)."""
    entries = []
    for name, source, replaces, key in (
            ('fused_ilqr', 'fused_ilqr.cu', 'mpc_tpu/ops/fused.py:617', 'k1'),
            ('fused_kkt_bwd', 'fused_kkt_bwd.cu',
             'mpc_tpu/ops/fused_bwd.py:251', 'k2'),
            ('fused_ilqr_long', 'fused_ilqr_long.cu',
             'mpc_tpu/ops/fused.py:1126', 'k3'),
            ('fused_kkt_bwd_long', 'fused_kkt_bwd_long.cu',
             'mpc_tpu/ops/fused_bwd.py:413', 'k4')):
        phases = record.get(name, {})
        if not phases:
            raise AssertionError(f'{name} was never launched on the '
                                 'scale-out and artifact paths')
        err, timing = timings[key]
        entries.append({
            'name': f'{name} (op, artifacts and scale-out)',
            'path': 'artifacts and scale-out', 'route': 'cuda',
            'source': f'mpc_tpu_torch/csrc/{source}', 'replaces': replaces,
            'op': f'mpc_tpu_torch::{OP_OF[name]}',
            'launches': sum(phases.values()), 'launches_by_phase': phases,
            'max_abs_err': err, 'artifact_vs_live_max_abs_err': 0.0,
            'library_ms': None,
            **{k: timing[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                      'bound_by')}})
    return entries


OP_OF = {'fused_ilqr': 'k1_solve', 'fused_kkt_bwd': 'k2_backward',
         'fused_ilqr_long': 'k3_solve', 'fused_kkt_bwd_long': 'k4_backward'}


def phases_scale(torch, device):
    """The scale-out and artifact phases in order; returns the launches
    by kernel and phase, the serving and sharding ms and the phases'
    seconds."""
    import shutil
    import tempfile
    root = os.path.join(HERE, 'build', 'chip_smoke')
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    record, secs = {}, {}
    try:
        for name, run in (
                ('export-serve', lambda: phase_export_serve(
                    torch, device, record, tmp)),
                ('export-flex', lambda: phase_export_flex(
                    torch, device, record)),
                ('export-host', lambda: phase_export_host(
                    torch, device, record)),
                ('export-long', lambda: phase_export_long(
                    torch, device, record)),
                ('export-grad', lambda: phase_export_grad(
                    torch, device, record)),
                ('export-loop', lambda: phase_export_loop(
                    torch, device, record)),
                ('sharded', lambda: phase_sharded(torch, device, record)),
                ('train-sharded', lambda: phase_train_sharded(
                    torch, device, record)),
                ('pod', lambda: phase_pod(torch, device, record, tmp)),
                ('checkpoint', lambda: phase_checkpoint(
                    torch, device, record, tmp))):
            t0 = time.perf_counter()
            secs[name] = (run(), time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log('[scale] the artifact and scale-out phases took '
        + ', '.join(f'{v[1]:.1f} s [{k}]' for k, v in secs.items())
        + f': {sum(v[1] for v in secs.values()):.1f} s')
    return record, {k: v[0] for k, v in secs.items()}


WORKERS = {'--serve-worker': serve_worker, '--pod-worker': pod_worker,
           '--resume-worker': resume_worker, '--uz-worker': uz_worker,
           '--mlp-worker': mlp_worker, '--blocking-worker': blocking_worker,
           '--plain-worker': plain_worker,
           '--wide-train-worker': wide_train_worker,
           '--phases-dense': phases_dense_main,
           '--phases-nn': phases_nn_main,
           '--phases-k3': phases_k3_main}


def main():
    if len(sys.argv) > 1:
        # a worker process of [export-serve], [pod] or [checkpoint]
        sys.path.insert(0, HERE)
        return WORKERS[sys.argv[1]](*sys.argv[2:]) or 0
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card is visible', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'mpc_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository '
              '(mpc_tpu_torch/ is missing)', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device('cuda')
    card = card_line()
    log(f'[card] {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    builds = phase_build(background=True)
    # launches by kernel and phase of the phases that count with counted()
    launch_record = {}
    max_err = phase_compare(torch, device)
    launches = phase_serve(torch, device)
    phase_swingup(torch, device)
    timing = phase_time(torch, device)
    train_err = phase_compare_train(torch, device)
    bwd_err = phase_compare_bwd(torch, device)
    k1_train, k2_train = phase_train(torch, device, 1024)
    phase_train(torch, device, 8192)
    phase_learn(torch, device)
    phase_profile_train(torch, device, 'config 4',
                        config4_train_step(torch, device, 1024))
    timing_train = phase_time_train(torch, device, 1024)
    phase_time_train(torch, device, 8192)
    timing_bwd = phase_time_bwd(torch, device, 1024)
    phase_time_bwd(torch, device, 8192)
    long_err = phase_compare_long(torch, device)
    phase_compare_teams(torch, device)
    bwd_long_err = phase_compare_bwd_long(torch, device)
    k3_serve = phase_serve_long(torch, device)
    k3_train, k4_train = phase_train_long(torch, device)
    phase_learn_long(torch, device)
    phase_profile_train(torch, device, 'long',
                        long_train_step(torch, device))
    timing_long = phase_time_long(torch, device)
    timing_bwd_long = phase_time_bwd_long(torch, device)
    nn_err, nn_plain_ms = phase_compare_nn(torch, device)
    k3_nn_serve, nn_request_ms = phase_serve_nn(torch, device)
    timing_nn = phase_time_nn(torch, device, nn_plain_ms)
    nn_accounts = phase_phases_nn(torch, device)
    k3_nn_grad, k2_nn_grad, nn_grad_err, k2_nn = phase_grad_nn(torch, device)
    phase_build_report(builds)
    t_dense = time.perf_counter()
    dense_err, dense_plain_ms = phase_compare_dense(torch, device)
    dense_launches, dense_req_ms = phase_serve_dense(torch, device)
    dense_rows = phase_time_dense(torch, device, dense_plain_ms)
    log(f'[dense] the dense phases took {time.perf_counter() - t_dense:.1f} '
        's')
    t_bwd_dense = time.perf_counter()
    bwd_dense_err = phase_compare_bwd_dense(torch, device)
    train_dense = phase_train_dense(torch, device, launch_record)
    bwd_dense_rows, fwd_train_row, diff_solve = phase_time_bwd_dense(
        torch, device, train_dense)
    log(f'[bwd-dense] the dense backward\'s phases took '
        f'{time.perf_counter() - t_bwd_dense:.1f} s')
    t_wide = [time.perf_counter()]
    wide_compare, wide_held = phase_compare_wide(torch, device)
    t_wide.append(time.perf_counter())
    wide_serve = phase_serve_wide(torch, device)
    t_wide.append(time.perf_counter())
    wide_rows = phase_time_wide(torch, device, wide_compare)
    t_wide.append(time.perf_counter())
    wide_bwd_err = phase_compare_bwd_wide(torch, device)
    t_wide.append(time.perf_counter())
    wide_train = phase_train_dense(torch, device, launch_record,
                                   held=wide_held)
    t_wide.append(time.perf_counter())
    wide_bwd_row = phase_time_bwd_wide(torch, device)
    wide_fwd_row = time_dense_row(torch, 'wide-train 4s12c (the learner\'s '
                                  'start)', wide_train['fwd_ops'],
                                  tag='time-bwd-dense',
                                  plain_ms=wide_train['fwd_plain_ms'])
    t_wide.append(time.perf_counter())
    log('[wide] the phases past 8 controls took ' + ', '.join(
        f'{b - a:.1f} s [{k}]' for k, a, b in zip(
            ('compare-dense', 'serve-dense', 'time-dense',
             'compare-bwd-dense', 'train-dense', 'time-bwd-dense'),
            t_wide, t_wide[1:])) + f': {t_wide[-1] - t_wide[0]:.1f} s')
    t_soa = [time.perf_counter()]
    soa_err, soa_plain_ms = phase_compare_soa(torch, device)
    t_soa.append(time.perf_counter())
    soa_serve = phase_serve_soa(torch, device)
    t_soa.append(time.perf_counter())
    soa_rows = phase_time_soa(torch, device, soa_plain_ms)
    t_soa.append(time.perf_counter())
    grad_counts, grad_err = phase_grad_cartpole(torch, device)
    t_soa.append(time.perf_counter())
    log('[soa] the nonlinear models\' phases took ' + ', '.join(
        f'{b - a:.1f} s [{k}]' for k, a, b in zip(
            ('compare-soa', 'serve-soa', 'time-soa', 'grad-cartpole'),
            t_soa, t_soa[1:])) + f': {t_soa[-1] - t_soa[0]:.1f} s')
    t_huber = [time.perf_counter()]
    huber_err, huber_plain_ms = phase_compare_huber(torch, device)
    t_huber.append(time.perf_counter())
    huber_serve = phase_serve_huber(torch, device)
    t_huber.append(time.perf_counter())
    huber_rows = phase_time_huber(torch, device, huber_plain_ms)
    t_huber.append(time.perf_counter())
    huber_grad_launches, huber_grad_err = phase_grad_huber(torch, device)
    t_huber.append(time.perf_counter())
    log('[huber] the pseudo-Huber phases took ' + ', '.join(
        f'{b - a:.1f} s [{k}]' for k, a, b in zip(
            ('compare-huber', 'serve-huber', 'time-huber', 'grad-huber'),
            t_huber, t_huber[1:])) + f': {t_huber[-1] - t_huber[0]:.1f} s')
    t_uz = [time.perf_counter()]
    uz_compare = phase_compare_uz(torch, device)
    t_uz.append(time.perf_counter())
    uz_serve = phase_serve_uz(torch, device)
    t_uz.append(time.perf_counter())
    uz_rows = phase_time_uz(torch, device, uz_compare)
    t_uz.append(time.perf_counter())
    log('[uz] the u_zero_I and delta_u phases took ' + ', '.join(
        f'{b - a:.1f} s [{k}]' for k, a, b in zip(
            ('compare-uz', 'serve-uz', 'time-uz'), t_uz, t_uz[1:])) +
        f': {t_uz[-1] - t_uz[0]:.1f} s')
    t_mlp = [time.perf_counter()]
    mlp_compare = phase_compare_mlp(torch, device)
    t_mlp.append(time.perf_counter())
    mlp_serve = phase_serve_mlp(torch, device)
    t_mlp.append(time.perf_counter())
    mlp_rows, k3_nn_ms = phase_time_mlp(torch, device, mlp_compare)
    t_mlp.append(time.perf_counter())
    mlp_grad_launches, mlp_grad_err = phase_grad_mlp(torch, device)
    t_mlp.append(time.perf_counter())
    log('[mlp] the MLP build\'s phases took ' + ', '.join(
        f'{b - a:.1f} s [{k}]' for k, a, b in zip(
            ('compare-mlp', 'serve-mlp', 'time-mlp', 'grad-mlp'),
            t_mlp, t_mlp[1:])) + f': {t_mlp[-1] - t_mlp[0]:.1f} s')
    t_ph = time.perf_counter()
    accounts = phase_phases_dense(torch, device)
    log(f'[phases-dense] {time.perf_counter() - t_ph:.1f} s')
    t_ph = time.perf_counter()
    k3_accounts = phase_phases_k3(torch, device)
    log(f'[phases-k3] {time.perf_counter() - t_ph:.1f} s')
    t_new = time.perf_counter()
    closed = phase_closed_loop(torch, device)
    t_closed = time.perf_counter()
    slew = phase_slew_k3(torch, device)
    t_slew = time.perf_counter()
    t_eager = time.perf_counter()
    eager = []
    phase_eager_serve(torch, device, eager)
    phase_eager_tvlqr(torch, device, eager)
    phase_eager_medium(torch, device, eager)
    phase_eager_cartpole(torch, device, eager)
    seq = phase_eager_long(torch, device, eager)
    phase_eager_grad(torch, device, eager)
    phase_eager_nn(torch, device, eager, nn_request_ms)
    phase_eager_models(torch, device, eager)
    t_s = [time.perf_counter()]
    phase_slew_eager(torch, device, eager)
    t_s.append(time.perf_counter())
    phase_pscan(torch, device, eager, seq)
    t_s.append(time.perf_counter())
    phase_verbose(torch, device)
    t_s.append(time.perf_counter())
    scale, scale_ms = phases_scale(torch, device)
    log(f'[surface] the new phases took {t_closed - t_new:.1f} s '
        f'[closed-loop], {t_slew - t_closed:.1f} s [slew-k3], '
        f'{t_s[1] - t_s[0]:.1f} s [slew-eager], {t_s[2] - t_s[1]:.1f} s '
        f'[pscan], {t_s[3] - t_s[2]:.1f} s [verbose]: '
        f'{t_slew - t_new + t_s[3] - t_s[0]:.1f} s')
    log(f'[eager] the [eager-*] phases took '
        f'{time.perf_counter() - t_eager:.1f} s')
    log(f'[done] {time.perf_counter() - t0:.1f} s')
    log('[timeline] seconds by phase: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in timeline()))
    log('[timeline] the longest waits, each before the line it ended: '
        + '; '.join(f'{v:.1f} s before {k!r}' for v, k in longest_waits()))
    # one entry per kernel and main path: serving ([serve], headline
    # B=4096), training ([train], config 4 at B=1024), long-horizon
    # training ([train-long], T=160 at B=4096) and learned dynamics
    # ([serve-nn], bench_nn_dynamics at B=2048; [grad-nn] at B=1024);
    # launches are that path's count, the times and bound that path's
    # shape
    from mpc_tpu_torch.ops import fused, fused_bwd, fused_dense
    k1 = {'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr.cu',
          'replaces': 'mpc_tpu/ops/fused.py:617',
          'tolerance': f'mean|du|<{TAIL_MEAN}, '
                       f'share(|du|>{TAIL_ENTRY})<{TAIL_SHARE}',
          'library_ms': None}
    log(json.dumps({'kernels': mark_k3_team(mark_dense([
        {'name': 'fused_ilqr', 'path': 'serving', **k1,
         'design': design('fused_ilqr', fused.kernel_defines(T, True),
                          fused.k1_launch(T, B, 5)),
         'launches': launches, 'max_abs_err': max_err, **timing},
        {'name': 'fused_ilqr (training)', 'path': 'training', **k1,
         'design': design('fused_ilqr', fused.kernel_defines(TRAIN_T, True),
                          fused.k1_launch(TRAIN_T, 1024, 3)),
         'launches': k1_train, 'max_abs_err': train_err, **timing_train},
        {'name': 'fused_kkt_bwd', 'path': 'training', 'route': 'cuda',
         'source': 'mpc_tpu_torch/csrc/fused_kkt_bwd.cu',
         'replaces': 'mpc_tpu/ops/fused_bwd.py:251',
         'design': design('fused_kkt_bwd',
                          fused_bwd.kernel_defines(TRAIN_T, True, True),
                          fused_bwd.k2_launch(TRAIN_T, 1024)),
         'launches': k2_train, 'max_abs_err': bwd_err,
         'tolerance': f'max|K2-plain|/max|plain|<{BWD_TOL} per gradient',
         'library_ms': None, **timing_bwd},
        {'name': 'fused_ilqr_long', 'path': 'long training',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr_long.cu',
         'replaces': 'mpc_tpu/ops/fused.py:1126',
         'design': design('fused_ilqr_long',
                          fused.long_kernel_defines(True, True),
                          fused.k3_launch(LONG_T, LONG_B, 3)),
         'launches': k3_train, 'launches_serve_long': k3_serve,
         'max_abs_err': long_err,
         'tolerance': f'mean|du|<{LONG_TAIL_MEAN}, '
                      f'share(|du|>{TAIL_ENTRY})<{LONG_TAIL_SHARE}',
         'library_ms': None, **timing_long},
        {'name': 'fused_kkt_bwd_long', 'path': 'long training',
         'route': 'cuda',
         'source': 'mpc_tpu_torch/csrc/fused_kkt_bwd_long.cu',
         'replaces': 'mpc_tpu/ops/fused_bwd.py:413',
         'design': design('fused_kkt_bwd_long',
                          fused_bwd.long_kernel_defines(True, True),
                          fused_bwd.k4_launch(LONG_T, LONG_B)),
         'launches': k4_train, 'max_abs_err': bwd_long_err,
         'tolerance': f'max|K4-plain|/max|plain|<{BWD_TOL} per gradient',
         'library_ms': None, **timing_bwd_long},
        {'name': 'fused_ilqr_long (nn)', 'path': 'learned dynamics',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_ilqr_long.cu',
         'headers': ['mpc_tpu_torch/csrc/nn.cuh',
                     'mpc_tpu_torch/csrc/phase_clock.cuh'],
         'replaces': 'mpc_tpu/ops/fused.py:1252', 'status': 'redesigned',
         'phase_account': nn_accounts,
         'design': design('fused_ilqr_long',
                          fused.long_kernel_defines(False, True, 'sigmoid'),
                          fused.k3_launch(NN_T, NN_B, 3, NN_H)),
         'launches': k3_nn_serve, 'launches_grad_nn': k3_nn_grad,
         'max_abs_err': nn_err, 'grad_err_vs_eager': nn_grad_err,
         'tolerance': f'mean|du|<{TAIL_MEAN}, '
                      f'share(|du|>{TAIL_ENTRY})<{TAIL_SHARE}',
         'library_ms': None, **timing_nn},
        {'name': 'fused_kkt_bwd (nn)', 'path': 'learned dynamics',
         'route': 'cuda', 'source': 'mpc_tpu_torch/csrc/fused_kkt_bwd.cu',
         'replaces': 'mpc_tpu/ops/fused_bwd.py:251',
         'design': design('fused_kkt_bwd',
                          fused_bwd.kernel_defines(NN_T, True, True),
                          fused_bwd.k2_launch(NN_T, NN_GRAD_B)),
         'launches': k2_nn_grad,
         'tolerance': f'max|K2-plain|/max|plain|<{BWD_TOL} per gradient',
         'library_ms': None, **k2_nn},
        {'name': 'fused_ilqr (closed loop)', 'path': 'closed loop', **k1,
         'design': design('fused_ilqr', fused.kernel_defines(T, True),
                          fused.k1_launch(T, B, 5)),
         'launches': closed['launches'],
         'max_abs_err': closed['max_abs_err'],
         **{k: closed[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                   'bound_by')},
         'us_per_step': closed['rows']},
        {'name': 'fused_ilqr_long (slew)', 'path': 'slew', 'route': 'cuda',
         'source': 'mpc_tpu_torch/csrc/fused_ilqr_long.cu',
         'replaces': 'mpc_tpu/ops/fused.py:1126',
         'design': design('fused_ilqr_long',
                          fused.long_kernel_defines(True, True),
                          fused.k3_launch(LONG_T, SLEW_B, 3)),
         'launches': slew['launches'], 'max_abs_err': slew['max_abs_err'],
         'request_ms': slew['request_ms'], 'grad_err': slew['grad_err'],
         'tolerance': f'mean|du|<{LONG_TAIL_MEAN}, '
                      f'share(|du|>{TAIL_ENTRY})<{LONG_TAIL_SHARE}',
         'library_ms': None,
         **{k: slew[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                 'bound_by')}},
        *dense_entries(dense_rows, dense_launches, dense_req_ms, dense_err),
        *bwd_dense_entries(bwd_dense_rows, fwd_train_row, train_dense,
                           diff_solve, bwd_dense_err),
        *wide_entries(torch, wide_compare, wide_serve, wide_rows,
                      wide_bwd_err, wide_bwd_row, wide_train, wide_fwd_row),
        *soa_entries(soa_rows, soa_serve, grad_counts, grad_err, soa_err,
                     next(r for r in eager if r['phase'] == 'eager-cartpole')),
        *huber_entries(huber_rows, huber_serve, huber_grad_launches,
                       huber_grad_err, huber_err),
        *uz_entries(uz_rows, uz_serve, uz_compare),
        *mlp_entries(mlp_rows, mlp_serve, mlp_compare, mlp_grad_launches,
                     mlp_grad_err, k3_nn_ms),
        *scale_entries(scale, {'k1': (max_err, timing),
                               'k2': (bwd_err, timing_bwd),
                               'k3': (long_err, timing_long),
                               'k4': (bwd_long_err, timing_bwd_long)})],
        accounts), k3_accounts)}))
    # host-to-host ms of the scale-out and artifact phases
    log(json.dumps({'artifacts_and_scale_out': {
        'export_serve_ms': scale_ms['export-serve'],
        'sharded_ms': scale_ms['sharded'],
        'train_sharded_step_ms': scale_ms['train-sharded'],
        'card': card}}))
    # the eager solver's phases: configuration, route, eager solves
    # counted in the phase, largest error against its reference, the
    # tolerance and the median host ms of a solve (or of a backward)
    log(json.dumps({'eager': eager}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


# the dense kernels' shared device code since their redesign
DENSE_HEADERS = ('mpc_tpu_torch/csrc/riccati_dense.cuh',
                 'mpc_tpu_torch/csrc/box_qp.cuh',
                 'mpc_tpu_torch/csrc/box_qp_smem.cuh',
                 'mpc_tpu_torch/csrc/phase_clock.cuh')
DENSE_SOURCES = ('mpc_tpu_torch/csrc/fused_ilqr_dense.cu',
                 'mpc_tpu_torch/csrc/fused_kkt_bwd_dense.cu')


def mark_dense(kernels, accounts):
    """Mark the dense kernels' entries redesigned (the register tiles,
    the prefetch, the control solve across the lanes), with the shared
    headers, and give each kernel's main entry the phase account of
    [phases-dense]."""
    for e in kernels:
        if e['source'] in DENSE_SOURCES:
            e['status'] = 'redesigned'
            e['headers'] = sorted(set(e.get('headers', [])) |
                                  set(DENSE_HEADERS))
    for name in ('fused_ilqr_dense', 'fused_kkt_bwd_dense'):
        e = next(e for e in kernels if e['name'] == name)
        e['phase_account'] = {r: a for r, a in accounts.items()
                              if r.startswith('backward') == (
                                  name == 'fused_kkt_bwd_dense')}
    return kernels


# K3's team kernel's entries redesigned past its shared-memory horizon:
# the pendulum's linearisation across the team, the lanes' rings
K3_TEAM_REDESIGNED = {'fused_ilqr_long (damped pendulum)': 'damped T=200',
                      'fused_ilqr_long (pseudo-Huber pendulum)':
                      'cost pendulum T=200'}


def mark_k3_team(kernels, accounts):
    """Mark the team kernel's redesigned entries, with the clock header,
    and give each the [phases-k3] account of its row, and the long LinDx
    entry that of its own."""
    for e in kernels:
        row = K3_TEAM_REDESIGNED.get(e['name'])
        if row is not None:
            e['status'] = 'redesigned'
            e['headers'] = sorted(set(e.get('headers', [])) | {
                'mpc_tpu_torch/csrc/phase_clock.cuh'})
            e['phase_account'] = {row: accounts[row]}
        elif e['name'] == 'fused_ilqr_long':
            e['phase_account'] = {'long LinDx': accounts['long LinDx']}
    return kernels


if __name__ == '__main__':
    sys.exit(main())
